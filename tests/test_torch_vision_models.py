"""The port's vision models and transformer layers held to the JAX
package's on the CPU, on the JAX models' weights (``convert``) and the
same numpy inputs (from a seed).

* ``resnet18`` (10 classes) at 48x48, B=2: eval logits within 1e-4, then
  3 steps of ``Momentum(0.01, 0.9, weight_decay=1e-4)`` on
  ``CrossEntropyLoss`` with train-mode BatchNorm: each loss within 1e-5
  relative; after each step, 99% of each parameter's and BatchNorm
  buffer's elements within 1% of the tensor's largest move so far (a
  ReLU whose input rounds to the other side of 0 in one package flips one
  position's gradient mask: seen at the third step on 1 output channel of
  128 of ``layer2.1.conv2``, a 45% change of that channel's gradient with
  the loss equal to 1.8e-6); the Momentum velocities, 99% of each within
  2% of its largest value (the flipped gradient reaches every layer below
  it), crossing both ways bit for bit (``convert.optimizer_state_*``); a
  checkpoint the JAX ``paddle.save`` wrote after 2 of those steps resumes
  in the port (``framework.load``) with the JAX third step's loss (1e-5).  Train-mode BatchNorm over a
  handful of values amplifies rounding (``(x - mean) / sqrt(var + eps)``
  with a variance near ``eps``): at 32x32 the last stage normalises 2
  values a channel and the two packages' first losses already differ by
  1.4e-4, and at lr 0.1 the steps diverge chaotically (5% by the third);
  48x48 and lr 0.01 keep the comparison well conditioned.
* One ``BottleneckBlock`` with a downsample, train mode: output and
  input gradient within 1e-4.
* A ViT (D=32, depth 2, 2 heads, 32x32, patch 8, 10 classes): logits
  within 1e-5, then 3 ``AdamW`` steps (losses within 1e-5 relative,
  parameters by ``torch_train_pairs.assert_params_close``).
* ``MultiHeadAttention`` with a float and a boolean mask, with
  ``need_weights``, through ``Cache`` (step by step against the full
  causal call) and ``StaticCache``: within 1e-5.
* ``TransformerEncoder`` (post- and pre-LN, the case
  ``tests/test_torch_alignment.py:802`` holds to torch), ``Decoder`` with
  caches and ``Transformer``: within 1e-5.
* The weight round trip JAX -> port -> JAX bit for bit (fp32), buffers
  included.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.vision import models
from torch_train_pairs import assert_params_close, gradient_scales


def _a(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _state(jmodel):
    return {k: np.asarray(v.numpy()) for k, v in jmodel.state_dict().items()}


def _jn(t):
    return np.asarray(t.numpy())


def _images(B, S, seed, classes=10, scale=0.1):
    """examples/train_resnet.py's synthetic batch: noise (its std
    ``scale``) with a label-correlated stripe."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, B)
    x = rng.standard_normal((B, 3, S, S)) * scale
    for b, lab in enumerate(y):
        x[b, 0, (lab * S // classes) % S] += 1.0
    return x.astype(np.float32), y.astype(np.int64)


@pytest.fixture(scope="module")
def resnet_pair():
    paddle.seed(11)
    jm = jmodels.resnet18(num_classes=10)
    tm = convert.resnet_from_paddle_tpu(_state(jm), "resnet18",
                                        device="cpu")
    return jm, tm


def test_resnet_weights_round_trip_bit_for_bit(resnet_pair):
    jm, tm = resnet_pair
    state = _state(jm)
    back = convert.to_paddle_tpu(tm)
    assert set(back) == set(state)
    assert any(k.endswith("._mean") for k in back)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_resnet_eval_logits_match_jax(resnet_pair):
    jm, tm = resnet_pair
    jm.eval()
    tm.eval()
    x, _ = _images(2, 48, 0)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               _jn(jm(paddle.to_tensor(x))), rtol=1e-4,
                               atol=1e-4)
    jm.train()
    tm.train()


def test_resnet18_momentum_train_steps_match_jax(tmp_path):
    from paddle_tpu_torch import framework

    paddle.seed(12)
    jm = jmodels.resnet18(num_classes=10)
    start = _state(jm)
    tm = convert.resnet_from_paddle_tpu(start, "resnet18", device="cpu")
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=jm.parameters(),
                                     weight_decay=1e-4)
    topt = Momentum(learning_rate=0.01, momentum=0.9,
                    parameters=tm.parameters(), weight_decay=1e-4)
    jloss_fn, tloss_fn = jnn.CrossEntropyLoss(), nn.CrossEntropyLoss()
    path = str(tmp_path / "resnet.pdparams")
    for step in range(3):
        x, y = _images(2, 48, step, scale=1.0)
        if step == 2:
            paddle.save({"model": jm.state_dict(),
                         "opt": jopt.state_dict()}, path)
        jl = jloss_fn(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tloss_fn(tm(torch.from_numpy(x)), torch.from_numpy(y))
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl.detach()), float(jl),
                                   rtol=1e-5)
        got = convert.to_paddle_tpu(tm)
        for k, v in _state(jm).items():
            moved = np.abs(v - start[k]).max()
            off = np.abs(got[k] - v) > 1e-2 * moved
            assert off.mean() <= 0.01, (step, k, off.mean())
    # Momentum's velocity crosses both ways by the JAX parameter order
    jstate = {k: (_jn(v) if hasattr(v, "numpy") else v)
              for k, v in jopt.state_dict().items()}
    tstate = convert.optimizer_state_to_paddle_tpu(topt.state_dict(), tm)
    assert tstate["step"] == jstate["step"] == 3
    for k, v in jstate.items():
        if k != "step":
            # the third step's flipped mask reaches every layer below it
            off = np.abs(tstate[k].numpy() - v) > 2e-2 * np.abs(v).max()
            assert off.mean() <= 0.01, (k, off.mean())
    fresh = Momentum(learning_rate=0.01, momentum=0.9,
                     parameters=tm.parameters(), weight_decay=1e-4)
    fresh.set_state_dict(convert.optimizer_state_from_paddle_tpu(jstate,
                                                                 tm))
    again = convert.optimizer_state_to_paddle_tpu(fresh.state_dict(), tm)
    for k, v in jstate.items():
        if k != "step":
            np.testing.assert_array_equal(again[k].numpy(), v, err_msg=k)
    # the checkpoint paddle.save wrote after 2 JAX steps resumes in the
    # port (framework.load + convert): the third step's loss is the JAX
    # package's
    ck = framework.load(path, device="cpu")
    rm = convert.resnet_from_paddle_tpu(ck["model"], "resnet18",
                                        device="cpu")
    ropt = Momentum(learning_rate=0.01, momentum=0.9,
                    parameters=rm.parameters(), weight_decay=1e-4)
    ropt.set_state_dict(convert.optimizer_state_from_paddle_tpu(ck["opt"],
                                                                rm))
    assert ropt._step_count == 2
    x, y = _images(2, 48, 2, scale=1.0)
    loss = tloss_fn(rm(torch.from_numpy(x)), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)


def test_bottleneck_block_matches_jax():
    paddle.seed(13)
    down = jnn.Sequential(jnn.Conv2D(8, 16, 1, stride=2, bias_attr=False),
                          jnn.BatchNorm2D(16))
    jb = jmodels.resnet.BottleneckBlock(8, 4, stride=2, downsample=down)
    tdown = nn.Sequential(nn.Conv2D(8, 16, 1, stride=2, bias_attr=False,
                                    device="cpu"),
                          nn.BatchNorm2D(16, device="cpu"))
    tb = models.BottleneckBlock(8, 4, stride=2, downsample=tdown,
                                device="cpu")
    convert.load_paddle_tpu_state(tb, _state(jb))
    x = _a((2, 8, 9, 9), 1)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jout, tout = jb(jx), tb(tx)
    np.testing.assert_allclose(tout.detach().numpy(), _jn(jout), rtol=1e-4,
                               atol=1e-4)
    jout.sum().backward()
    tout.sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _jn(jx.grad), rtol=1e-4,
                               atol=1e-4)


VIT = dict(img_size=32, patch_size=8, class_num=10, embed_dim=32, depth=2,
           num_heads=2)


def test_vit_logits_and_adamw_steps_match_jax():
    paddle.seed(14)
    jm = jmodels.VisionTransformer(**VIT)
    state = _state(jm)
    tm = convert.vit_from_paddle_tpu(state, num_heads=2, device="cpu")
    back = convert.to_paddle_tpu(tm)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    x, y = _images(2, 32, 5)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               _jn(jm(paddle.to_tensor(x))), rtol=1e-5,
                               atol=1e-5)
    lr = 1e-3
    jopt = paddle.optimizer.AdamW(learning_rate=lr,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = AdamW(learning_rate=lr, parameters=tm.parameters(),
                 weight_decay=0.01)
    scales = None
    for step in range(3):
        x, y = _images(2, 32, 6 + step)
        jl = jnn.CrossEntropyLoss()(jm(paddle.to_tensor(x)),
                                    paddle.to_tensor(y))
        jl.backward()
        if scales is None:
            scales = gradient_scales(jm)
        jopt.step()
        jopt.clear_grad()
        tl = nn.CrossEntropyLoss()(tm(torch.from_numpy(x)),
                                   torch.from_numpy(y))
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl.detach()), float(jl),
                                   rtol=1e-5)
    assert_params_close(convert.to_paddle_tpu(tm), jm, scales, 3 * lr)


def _mha_pair(E=16, H=4, **kw):
    paddle.seed(15)
    jm = jnn.MultiHeadAttention(E, H, **kw)
    tm = nn.MultiHeadAttention(E, H, device="cpu", **kw)
    convert.load_paddle_tpu_state(tm, _state(jm))
    return jm, tm


@pytest.mark.parametrize("mask", [None, "float", "bool"])
def test_multi_head_attention_matches_jax(mask):
    jm, tm = _mha_pair()
    q, kv = _a((2, 5, 16), 1), _a((2, 7, 16), 2)
    m = None
    if mask == "float":
        m = _a((2, 4, 5, 7), 3)
    elif mask == "bool":
        m = _a((2, 1, 5, 7), 3) > -0.5
    jm_ = None if m is None else paddle.to_tensor(m)
    tm_ = None if m is None else torch.from_numpy(m)
    want = jm(paddle.to_tensor(q), paddle.to_tensor(kv),
              paddle.to_tensor(kv), jm_)
    got = tm(torch.from_numpy(q), torch.from_numpy(kv),
             torch.from_numpy(kv), tm_)
    np.testing.assert_allclose(got.detach().numpy(), _jn(want), rtol=1e-5,
                               atol=1e-5)


def test_multi_head_attention_need_weights_and_caches_match_jax():
    jm, tm = _mha_pair(need_weights=True)
    x = _a((2, 4, 16), 4)
    out, w = tm(torch.from_numpy(x))
    assert w is None
    np.testing.assert_allclose(out.detach().numpy(),
                               _jn(jm(paddle.to_tensor(x))[0]), rtol=1e-5,
                               atol=1e-5)
    jm, tm = _mha_pair()
    # incremental decoding: one token at a time through Cache, against the
    # JAX layer's steps
    jc, tc = jm.gen_cache(paddle.to_tensor(x)), tm.gen_cache(
        torch.from_numpy(x))
    for i in range(4):
        xi = x[:, i:i + 1]
        jo, jc = jm(paddle.to_tensor(xi), cache=jc)
        to, tc = tm(torch.from_numpy(xi), cache=tc)
        np.testing.assert_allclose(to.detach().numpy(), _jn(jo), rtol=1e-5,
                                   atol=1e-5)
    assert tc.k.shape == (2, 4, 4, 4)
    mem = _a((2, 6, 16), 5)
    js = jm.gen_cache(paddle.to_tensor(mem), type=jnn.MultiHeadAttention
                      .StaticCache)
    ts = tm.gen_cache(torch.from_numpy(mem),
                      type=nn.MultiHeadAttention.StaticCache)
    np.testing.assert_allclose(
        tm(torch.from_numpy(x), cache=ts).detach().numpy(),
        _jn(jm(paddle.to_tensor(x), cache=js)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_encoder_matches_jax(normalize_before):
    D, NH, FF, B, S = 16, 4, 32, 2, 12
    paddle.seed(16)
    jl = jnn.TransformerEncoderLayer(D, NH, FF, dropout=0.0,
                                     normalize_before=normalize_before)
    je = jnn.TransformerEncoder(jl, 2, jnn.LayerNorm(D)
                                if normalize_before else None)
    tl = nn.TransformerEncoderLayer(D, NH, FF, dropout=0.0,
                                    normalize_before=normalize_before,
                                    device="cpu")
    te = nn.TransformerEncoder(tl, 2, nn.LayerNorm(D, device="cpu")
                               if normalize_before else None)
    convert.load_paddle_tpu_state(te, _state(je))
    assert convert.paddle_parameter_order(te) == [
        n for n, _ in je.named_parameters()]
    x = _a((B, S, D), 17)
    mask = np.triu(np.full((S, S), -1e9, np.float32), 1)
    for m in (None, mask):
        want = je(paddle.to_tensor(x),
                  None if m is None else paddle.to_tensor(m))
        got = te(torch.from_numpy(x), None if m is None
                 else torch.from_numpy(m))
        np.testing.assert_allclose(got.detach().numpy(), _jn(want),
                                   rtol=1e-5, atol=1e-5)


def test_transformer_decoder_with_caches_and_full_model_match_jax():
    D, NH, FF = 16, 4, 32
    paddle.seed(18)
    jt = jnn.Transformer(D, NH, 2, 2, FF, dropout=0.0)
    tt = nn.Transformer(D, NH, 2, 2, FF, dropout=0.0, device="cpu")
    convert.load_paddle_tpu_state(tt, _state(jt))
    src, tgt = _a((2, 6, D), 19), _a((2, 5, D), 20)
    tmask = nn.Transformer.generate_square_subsequent_mask(5)
    jmask = jnn.Transformer.generate_square_subsequent_mask(5)
    np.testing.assert_array_equal(tmask.numpy(), _jn(jmask))
    want = jt(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=jmask)
    got = tt(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask)
    np.testing.assert_allclose(got.detach().numpy(), _jn(want), rtol=1e-5,
                               atol=1e-5)
    # the decoder stepped one token at a time through its caches
    mem_j = jt.encoder(paddle.to_tensor(src))
    mem_t = tt.encoder(torch.from_numpy(src))
    jc, tc = jt.decoder.gen_cache(mem_j), tt.decoder.gen_cache(mem_t)
    for i in range(5):
        ti = tgt[:, i:i + 1]
        jo, jc = jt.decoder(paddle.to_tensor(ti), mem_j, cache=jc)
        to, tc = tt.decoder(torch.from_numpy(ti), mem_t, cache=tc)
        np.testing.assert_allclose(to.detach().numpy(), _jn(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(to.detach().numpy()[:, 0],
                                   got.detach().numpy()[:, i], rtol=1e-4,
                                   atol=1e-4)


def test_sdpa_under_mha_takes_the_flash_dispatch_on_the_cpu():
    """No mask, no dropout: the no-cache attention dispatch (the CUDA flash
    kernels on the card; the composite here)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    _, tm = _mha_pair()
    tm(torch.from_numpy(_a((2, 5, 16), 6)))
    assert fa.last_path == "reference"
    q = torch.from_numpy(_a((2, 5, 4, 4), 7))
    out = F.scaled_dot_product_attention(q, q, q)
    assert out.shape == q.shape

