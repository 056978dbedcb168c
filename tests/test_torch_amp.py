"""The port's AMP held to the JAX package's on the CPU.

* O1 dtype flow: every layer's output dtype under
  ``auto_cast(level="O1", dtype="bfloat16")``, in a ``resnet18`` and a
  small ViT on the JAX models' weights, equal to the JAX package's (conv
  and linear outputs bf16; BatchNorm on a bf16 input with fp32 weights,
  fp32; the residual sums and the loss as JAX promotes them), the logits
  within bf16's rounding of the JAX ones (3e-2 relative to their largest),
  and a train step's loss and gradients finite with fp32 parameters; the
  white / black lists and custom lists as the JAX casts read them.
* ``GradScaler`` with fp16 semantics step for step against the JAX
  scaler: the scaled loss, the unscaled gradients, the skipped step on a
  planted inf, backoff after 2 bad steps and growth after
  ``incr_every_n_steps`` good ones, and ``state_dict``.
* ``decorate`` at O1 (no master weights unless asked) and at O2 (the
  parameters cast in place, masters on); ``tests/test_torch_amp_o2.py``
  holds O2 to the JAX package.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import amp, convert
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum


def _a(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _dtype_name(d):
    return str(d).replace("torch.", "").replace("paddle.", "")


def _record_jax(model):
    seen = {}
    for name, layer in model.named_sublayers():
        def hook(layer, inputs, out, name=name):
            seen[name] = _dtype_name(out.dtype)
        layer.register_forward_post_hook(hook)
    return seen


def _record_port(model):
    seen = {}
    for name, mod in model.named_modules():
        if name:
            mod.register_forward_hook(
                lambda m, i, out, name=name: seen.__setitem__(
                    name, _dtype_name(out.dtype)))
    return seen


@pytest.mark.parametrize("family", ["resnet18", "vit"])
def test_o1_layer_output_dtypes_match_jax(family):
    paddle.seed(21)
    if family == "resnet18":
        jm = jmodels.resnet18(num_classes=10)
        tm = convert.resnet_from_paddle_tpu(_state(jm), "resnet18",
                                            device="cpu")
    else:
        jm = jmodels.VisionTransformer(img_size=32, patch_size=8,
                                       class_num=10, embed_dim=32, depth=2,
                                       num_heads=2)
        tm = convert.vit_from_paddle_tpu(_state(jm), num_heads=2,
                                         device="cpu")
    jseen, tseen = _record_jax(jm), _record_port(tm)
    x, y = _a((2, 3, 32, 32), 1), np.array([3, 7])
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jout = jm(paddle.to_tensor(x))
        jloss = jnn.CrossEntropyLoss()(jout, paddle.to_tensor(y))
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        tout = tm(torch.from_numpy(x))
        tloss = nn.CrossEntropyLoss()(tout, torch.from_numpy(y))
    assert tseen == jseen
    assert "bfloat16" in tseen.values() and "float32" in tseen.values()
    assert _dtype_name(tloss.dtype) == _dtype_name(jloss.dtype)
    want = np.asarray(jout.astype("float32").numpy())
    np.testing.assert_allclose(tout.float().detach().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    tloss.backward()
    assert all(p.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in tm.parameters())


def test_o1_casts_only_white_listed_ops_and_custom_lists():
    x = torch.randn(2, 4)
    w = torch.randn(4, 3)
    with amp.auto_cast():
        assert F.linear(x, w).dtype == torch.bfloat16
        assert F.softmax(x).dtype == torch.float32
        assert F.layer_norm(x, 4).dtype == torch.float32
    with amp.auto_cast(custom_black_list={"linear"}):
        assert F.linear(x, w).dtype == torch.float32
    with amp.auto_cast(enable=False):
        assert F.linear(x, w).dtype == torch.float32
    with amp.auto_cast(level="O0"):
        assert F.linear(x, w).dtype == torch.float32
    with amp.auto_cast(dtype="float16"):
        assert F.conv2d(torch.randn(1, 2, 5, 5),
                        torch.randn(3, 2, 3, 3)).dtype == torch.float16
    assert F.linear(x, w).dtype == torch.float32
    assert amp.white_list == paddle.amp.white_list
    assert amp.black_list == paddle.amp.black_list


def test_o2_raises_naming_a12_and_o1_decorate_keeps_params():
    """(The name is from before the op bus: O2 raised naming A12.)  O2
    now casts the parameters in place and keeps masters; O1 keeps them."""
    lin2 = nn.Linear(2, 2)
    opt2 = Momentum(parameters=lin2.parameters())
    w = lin2.weight
    with amp.auto_cast(level="O2"):
        assert lin2(torch.ones(1, 2)).dtype == torch.bfloat16
    m, o = amp.decorate(lin2, opt2, level="O2")
    assert m is lin2 and o is opt2 and opt2._use_master_weights
    assert lin2.weight is w and w.dtype == torch.bfloat16
    lin = nn.Linear(2, 2)
    opt = Momentum(parameters=lin.parameters())
    m, o = amp.decorate(lin, opt, level="O1")
    assert m is lin and o is opt and not opt._use_master_weights
    assert lin.weight.dtype == torch.float32
    amp.decorate(lin, opt, level="O1", master_weight=True)
    assert opt._use_master_weights


def test_grad_scaler_matches_the_jax_scaler_step_for_step():
    paddle.seed(22)
    jm = jnn.Linear(4, 3)
    tm = nn.Linear(4, 3)
    convert.load_paddle_tpu_state(tm, _state(jm))
    jopt = paddle.optimizer.Momentum(learning_rate=0.01,
                                     parameters=jm.parameters())
    topt = Momentum(learning_rate=0.01, parameters=tm.parameters())
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    jsc, tsc = paddle.amp.GradScaler(**kw), amp.GradScaler(**kw)
    # steps 2 and 3 carry a planted inf: two bad steps in a row back off
    plan = [False, False, True, True, False, False, False]
    for i, bad in enumerate(plan):
        x = _a((5, 4), i)
        if bad:
            x[0, 0] = np.inf
        jl = jsc.scale(jm(paddle.to_tensor(x)).square().mean())
        tl = tsc.scale(tm(torch.from_numpy(x)).square().mean())
        np.testing.assert_allclose(float(tl.detach()), float(jl),
                                   rtol=1e-5)
        jl.backward()
        tl.backward()
        jsc.step(jopt)
        tsc.step(topt)
        assert tsc._found_inf == jsc._found_inf == bad
        assert tsc.state_dict() == jsc.state_dict(), i
        if not bad:
            np.testing.assert_allclose(
                tm.weight.grad.numpy().T,
                np.asarray(jm.weight.grad.numpy()), rtol=1e-5, atol=1e-7)
        jopt.clear_grad()
        topt.clear_grad()
    got = convert.to_paddle_tpu(tm)
    for k, v in _state(jm).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7)
    # 1024 -> 2048 (2 good) -> 1024 (2 bad) -> 2048 (2 good), then 1 good
    assert tsc.state_dict()["scale"] == 2048.0
    assert tsc.state_dict()["incr_count"] == 1
    assert float(tsc.get_loss_scaling()) == 2048.0


def test_disabled_scaler_passes_through():
    sc = amp.GradScaler(enable=False)
    lin = nn.Linear(2, 2)
    opt = Momentum(learning_rate=0.1, parameters=lin.parameters())
    loss = lin(torch.ones(1, 2)).sum()
    assert sc.scale(loss) is loss
    loss.backward()
    before = lin.weight.detach().clone()
    sc.step(opt)
    assert not torch.equal(before, lin.weight.detach())
