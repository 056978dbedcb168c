"""The port's AMP O2 (``amp/auto_cast.py`` on the op bus,
``amp/debugging.py``) held to the JAX package's on the CPU.

* The cast decisions op by op: the result dtype of the same call, on the
  same numpy inputs, at O1 and at O2, equal in both packages — among them
  LayerNorm and BatchNorm on bf16 inputs with bf16 weights (bf16: the
  black list does not cast up), fp32 weights (fp32), ``add`` of bf16 and
  fp32 (bf16 at O2, fp32 at O1), black-listed ops on fp32 (fp32).
* ``decorate``: every fp32 parameter bf16 at O2 and in place (the same
  objects), no buffer touched, the optimizer's master weights on unless
  ``master_weight=False``; the same dtypes as the JAX ``decorate``.
* ``GPTConfig.tiny()`` on the JAX weights, 3 AdamW steps at O2: the
  losses within 2 bf16 ulps of the JAX ones, the fp32 masters within 2e-3
  of their largest entry where the first gradient stands above bf16 noise
  (elsewhere within the ``2 x steps x lr`` Adam allows a noise-signed
  gradient, ROADMAP C11, whose cause — the first step's bf16 gradients
  about 1% apart — is held too), every bf16 parameter its master rounded, and
  ``low_precision_op_list()`` EQUAL to the JAX dict.
* ``resnet18`` and a small ViT at O2 on the JAX weights: every layer's
  output dtype equal to the JAX one's and the logits within 3e-2 of their
  largest entry (the forward only: the JAX bf16 convolution's backward
  raises, ROADMAP C9, shown by ``test_jax_bf16_conv_backward_raises``); an
  O2 step's gradients held to the port's fp32 gradients on the same
  (bf16-rounded) weights.
* ``tests/test_extras.py::test_low_precision_op_list_records`` mirrored,
  and the counts of a ``to_static`` step called three times equal to the
  JAX ones (each key's ops counted twice, replays not at all).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import amp, convert, nn
from paddle_tpu_torch.models import GPTConfig, GPTPretrainingCriterion
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

LEVELS = ("O1", "O2")


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    yield
    pt.set_device(None)
    for pkg in (pt, paddle):
        pkg.set_flags({"low_precision_op_list": False})
        pkg.amp.debugging.clear_low_precision_op_list()


def _a(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _name(d):
    return str(d).replace("torch.", "").replace("paddle.", "")


class _Ns:
    """One package's calls, under the same names."""

    def __init__(self, pkg, functional):
        self.pkg, self.F = pkg, functional

    def t(self, a, dtype="float32"):
        return self.pkg.to_tensor(a).astype(dtype)


JAX, PORT = _Ns(paddle, JF), _Ns(pt, F)
X, W, V = _a((2, 4), 1), _a((4, 4), 2), _a((4,), 3)
IMG, K = _a((2, 3, 5, 5), 4), _a((4, 3, 3, 3), 5)

CASES = {
    "linear": lambda n: n.F.linear(n.t(X), n.t(W), n.t(V)),
    "matmul": lambda n: n.pkg.matmul(n.t(X), n.t(W)),
    "einsum": lambda n: n.pkg.einsum("ij,jk->ik", n.t(X), n.t(W)),
    "conv2d": lambda n: n.F.conv2d(n.t(IMG), n.t(K)),
    "add_bf16_fp32": lambda n: n.pkg.add(n.t(X, "bfloat16"), n.t(X)),
    "add_fp32_bf16": lambda n: n.pkg.add(n.t(X), n.t(X, "bfloat16")),
    "multiply": lambda n: n.pkg.multiply(n.t(X), n.t(X)),
    "relu": lambda n: n.F.relu(n.t(X)),
    "gelu": lambda n: n.F.gelu(n.t(X), approximate=True),
    "reshape": lambda n: n.pkg.reshape(n.t(X), [4, 2]),
    "concat": lambda n: n.pkg.concat([n.t(X), n.t(X, "bfloat16")]),
    "embedding": lambda n: n.F.embedding(
        n.pkg.to_tensor(np.array([[0, 3]])), n.t(W)),
    "exp": lambda n: n.pkg.exp(n.t(X)),
    "mean": lambda n: n.pkg.mean(n.t(X)),
    "sum": lambda n: n.pkg.sum(n.t(X)),
    "softmax_fp32": lambda n: n.F.softmax(n.t(X)),
    "softmax_bf16": lambda n: n.F.softmax(n.t(X, "bfloat16")),
    "layer_norm_bf16_weights": lambda n: n.F.layer_norm(
        n.t(X, "bfloat16"), 4, n.t(V, "bfloat16"), n.t(V, "bfloat16")),
    "layer_norm_fp32_weights": lambda n: n.F.layer_norm(
        n.t(X, "bfloat16"), 4, n.t(V), n.t(V)),
    "batch_norm_train_bf16_weights": lambda n: n.F.batch_norm(
        n.t(IMG, "bfloat16"), n.t(np.zeros(3, np.float32)),
        n.t(np.ones(3, np.float32)), n.t(V[:3], "bfloat16"),
        n.t(V[:3], "bfloat16"), training=True),
    "batch_norm_eval_bf16_weights": lambda n: n.F.batch_norm(
        n.t(IMG, "bfloat16"), n.t(np.zeros(3, np.float32)),
        n.t(np.ones(3, np.float32)), n.t(V[:3], "bfloat16"),
        n.t(V[:3], "bfloat16"), training=False),
    "batch_norm_fp32_weights": lambda n: n.F.batch_norm(
        n.t(IMG, "bfloat16"), n.t(np.zeros(3, np.float32)),
        n.t(np.ones(3, np.float32)), n.t(V[:3]), n.t(V[:3]),
        training=True),
    "cross_entropy_bf16": lambda n: n.F.cross_entropy(
        n.t(X, "bfloat16"), n.pkg.to_tensor(np.array([1, 2]))),
    "cross_entropy_fp32": lambda n: n.F.cross_entropy(
        n.t(X), n.pkg.to_tensor(np.array([1, 2]))),
}


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_cast_decisions_match_jax(case, level):
    with paddle.amp.auto_cast(level=level):
        want = CASES[case](JAX)
    with amp.auto_cast(level=level):
        got = CASES[case](PORT)
    assert _name(got.dtype) == _name(want.dtype)
    np.testing.assert_allclose(
        got.float().detach().numpy(),
        np.asarray(want.astype("float32").numpy()), rtol=1e-2, atol=1e-2)


def test_o2_casts_what_is_not_black_and_o1_what_is_white():
    x = PORT.t(X)
    with amp.auto_cast(level="O2"):
        assert pt.add(x, x).dtype == torch.bfloat16
        assert pt.exp(x).dtype == torch.float32
        assert F.layer_norm(PORT.t(X, "bfloat16"), 4,
                            PORT.t(V, "bfloat16")).dtype == torch.bfloat16
        with amp.auto_cast(level="O2", custom_black_list={"add"}):
            assert pt.add(x, x).dtype == torch.float32
    with amp.auto_cast(level="O1"):
        assert pt.add(x, x).dtype == torch.float32
        assert pt.matmul(x, PORT.t(W)).dtype == torch.bfloat16


def _small_nets():
    jnet = jnn.Sequential(jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4),
                          jnn.ReLU(), jnn.Flatten(), jnn.Linear(36, 2))
    net = nn.Sequential(nn.Conv2D(3, 4, 3, device="cpu"),
                        nn.BatchNorm2D(4, device="cpu"), nn.ReLU(),
                        nn.Flatten(), nn.Linear(36, 2, device="cpu"))
    return jnet, net


@pytest.mark.parametrize("master_weight", [None, False])
def test_decorate_o2_casts_parameters_in_place(master_weight):
    jnet, net = _small_nets()
    jopt = paddle.optimizer.Momentum(parameters=jnet.parameters())
    params = list(net.parameters())
    opt = pt.optimizer.Momentum(parameters=params)
    paddle.amp.decorate(jnet, jopt, level="O2", master_weight=master_weight)
    m, o = amp.decorate(net, opt, level="O2", master_weight=master_weight)
    assert m is net and o is opt
    assert all(a is b for a, b in zip(params, net.parameters()))
    want = {k: _name(v.dtype) for k, v in jnet.state_dict().items()}
    got = {k: _name(v.dtype) for k, v in net.state_dict().items()}
    assert got == want
    assert got["1._mean"] == "float32" and got["0.weight"] == "bfloat16"
    assert opt._use_master_weights == jopt._use_master_weights \
        == (master_weight is None)
    # the optimizer built before decorate steps the cast parameters
    with amp.auto_cast(level="O2"):
        net(torch.from_numpy(IMG)).float().sum().backward()
    opt.step()
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


def _gpt_o2_pair(steps=3):
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny())
    state = {k: np.array(np.asarray(v.numpy()), copy=True)
             for k, v in jm.state_dict().items()}
    pm = convert.gpt_from_paddle_tpu(state, GPTConfig.tiny(), device="cpu")
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    popt = AdamW(learning_rate=1e-3, parameters=pm.parameters())
    jm, jopt = paddle.amp.decorate(jm, jopt, level="O2")
    pm, popt = amp.decorate(pm, popt, level="O2")
    for pkg in (paddle, pt):
        pkg.set_flags({"low_precision_op_list": True})
        pkg.amp.debugging.clear_low_precision_op_list()
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    jc, pc = JaxCriterion(), GPTPretrainingCriterion()
    losses, grads, port_grads = [], None, None
    for _ in range(steps):
        with paddle.amp.auto_cast(level="O2"):
            jl = jc(jm(paddle.to_tensor(ids)), paddle.to_tensor(ids))
        jl.backward()
        if grads is None:
            grads = [np.asarray(p.grad.astype("float32").numpy())
                     for p in jm.parameters()]
        jopt.step()
        jopt.clear_grad()
        with amp.auto_cast(level="O2"):
            pl = pc(pm(torch.from_numpy(ids)), torch.from_numpy(ids))
        pl.backward()
        if port_grads is None:
            # in the JAX order and layout: linear weights [in, out]
            named, lin = dict(pm.named_parameters()), convert.linear_weights(pm)
            port_grads = [
                named[n].grad.float().T.numpy() if n in lin
                else named[n].grad.float().numpy()
                for n in convert.paddle_parameter_order(pm)]
        popt.step()
        popt.clear_grad()
        losses.append((float(np.asarray(jl.astype("float32").numpy())),
                       float(pl.detach().float())))
    return jm, jopt, pm, popt, losses, grads, port_grads


@pytest.fixture(scope="module")
def gpt_o2():
    pt.set_device("cpu")
    try:
        out = _gpt_o2_pair()
        lists = (paddle.amp.debugging.low_precision_op_list(),
                 amp.debugging.low_precision_op_list())
    finally:
        for pkg in (pt, paddle):
            pkg.set_flags({"low_precision_op_list": False})
        pt.set_device(None)
    return out + lists


def test_gpt_o2_losses_within_two_bf16_ulps(gpt_o2):
    losses = gpt_o2[4]
    for want, got in losses:
        assert abs(got - want) <= 2 * _bf16_ulp(want), losses
    assert losses[-1][1] < losses[0][1]


def test_gpt_o2_first_step_gradients_about_one_percent_from_jax(gpt_o2):
    """The cause ROADMAP C11 gives for the masters' tolerance: the first
    step's bf16 gradients of the two packages, each parameter's in the JAX
    layout, differ by about 1% of their norm (their products and GELU
    round in other orders): every parameter within 2% (measured worst
    1.51%, a LayerNorm gain), all of them together within 1.2% (measured
    0.98%).  A wrong sign or a missing term is off by 100% or more."""
    grads, port_grads = gpt_o2[5], gpt_o2[6]
    assert len(port_grads) == len(grads)
    for j, p in zip(grads, port_grads):
        assert p.shape == j.shape
        assert np.linalg.norm(p - j) <= 2e-2 * np.linalg.norm(j)
    gap = np.sqrt(sum(np.sum((p - j) ** 2)
                      for j, p in zip(grads, port_grads)))
    assert gap <= 1.2e-2 * np.sqrt(sum(np.sum(j ** 2) for j in grads))


def test_gpt_o2_masters_and_bf16_parameters(gpt_o2):
    """Every fp32 master within ``2 x steps x lr`` of the JAX one, and at
    least 99.9% of the entries of the weights set by their initialisation
    (the matrices, the embeddings and the LayerNorm gains: largest entry
    above ``10 x steps x lr``) within 2e-3 of their largest entry where
    the first step's JAX gradient stands above bf16 noise (above 5% of its
    parameter's largest).  The stated 2e-3 does not hold everywhere
    (ROADMAP C11): the two packages' bf16 gradients are about 1% apart
    (held by the test before this one), Adam's normalised update turns a gradient that is noise (the key bias:
    zero but for rounding) into a move of ``lr`` of either sign, and a
    zero-initialised bias's master is only those moves."""
    jm, jopt, pm, popt, losses, grads = gpt_o2[:6]
    lr, steps = 1e-3, len(losses)
    assert all(p.dtype == torch.bfloat16 for p in pm.parameters())
    want = {k: np.asarray(v.numpy()) for k, v in jopt.state_dict().items()
            if k.endswith("/master")}
    got = convert.optimizer_state_to_paddle_tpu(popt.state_dict(), pm)
    assert set(want) == {k for k in got if k.endswith("/master")}
    within = total = 0
    for k, w in want.items():
        g = got[k].float().numpy()
        jg = np.abs(grads[int(k.split("/")[0][1:])])
        clear = jg > 0.05 * jg.max()
        if np.abs(w).max() > 10 * steps * lr:
            held = np.abs(g - w)[clear] <= 2e-3 * np.abs(w).max()
            within += int(held.sum())
            total += held.size
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * steps * lr,
                                   err_msg=k)
    assert total and within / total >= 0.999, (within, total)
    for p in pm.parameters():
        master = popt._state[id(p)]["master"]
        assert torch.equal(p.detach(), master.to(torch.bfloat16))


def test_gpt_o2_low_precision_op_list_equals_jax(gpt_o2):
    jax_list, port_list = gpt_o2[7], gpt_o2[8]
    assert port_list == jax_list
    assert {"ring_attention_fallback", "tied_head", "add_pos_embed",
            "split_qkv", "merge_heads", "getitem"} <= set(port_list)


def _record(model, jax):
    seen = {}
    if jax:
        for name, layer in model.named_sublayers():
            layer.register_forward_post_hook(
                lambda l, i, out, name=name: seen.__setitem__(
                    name, _name(out.dtype)))
    else:
        for name, mod in model.named_modules():
            if name:
                mod.register_forward_hook(
                    lambda m, i, out, name=name: seen.__setitem__(
                        name, _name(out.dtype)))
    return seen


def _vision_pair(family):
    paddle.seed(21)
    if family == "resnet18":
        jm = jmodels.resnet18(num_classes=10)
        state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
        return jm, lambda: convert.resnet_from_paddle_tpu(
            state, "resnet18", device="cpu")
    jm = jmodels.VisionTransformer(img_size=32, patch_size=8, class_num=10,
                                   embed_dim=32, depth=2, num_heads=2)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return jm, lambda: convert.vit_from_paddle_tpu(state, num_heads=2,
                                                   device="cpu")


@pytest.mark.parametrize("family", ["resnet18", "vit"])
def test_vision_o2_forward_matches_jax(family):
    jm, build = _vision_pair(family)
    tm = build()
    paddle.amp.decorate(jm, level="O2")
    amp.decorate(tm, level="O2")
    jseen, tseen = _record(jm, True), _record(tm, False)
    x = _a((2, 3, 32, 32), 1)
    with paddle.amp.auto_cast(level="O2"):
        jout = jm(paddle.to_tensor(x))
    with amp.auto_cast(level="O2"):
        tout = tm(torch.from_numpy(x))
    assert tseen == jseen
    assert _name(tout.dtype) == _name(jout.dtype) == "bfloat16"
    want = np.asarray(jout.astype("float32").numpy())
    np.testing.assert_allclose(tout.float().detach().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())


@pytest.mark.parametrize("family", ["resnet18", "vit"])
def test_vision_o2_gradients_match_fp32(family):
    """An O2 step's gradients against the port's fp32 gradients on the
    same weights (bf16-rounded): each parameter's within 10% of its norm
    (a gradient above 1e-3 of the largest norm; below, it is rounding
    noise, a key bias's), all of them within 5% of their joint norm — bf16
    rounding through the layers.  In eval mode: train-mode BatchNorm over
    two images amplifies rounding without bound."""
    _, build = _vision_pair(family)
    tm, ref = build().eval(), build().eval()
    amp.decorate(tm, level="O2")
    with torch.no_grad():
        for p, q in zip(ref.parameters(), tm.parameters()):
            p.copy_(q.float())
    x, y = torch.from_numpy(_a((2, 3, 32, 32), 1)), torch.tensor([3, 7])
    with amp.auto_cast(level="O2"):
        loss = nn.CrossEntropyLoss()(tm(x), y)
    loss.backward()
    nn.CrossEntropyLoss()(ref(x), y).backward()
    errs = []
    for (name, p), q in zip(tm.named_parameters(), ref.parameters()):
        assert p.grad.dtype == torch.bfloat16
        g, want = p.grad.float(), q.grad
        errs.append((name, float((g - want).norm()), float(want.norm())))
    top = max(n for _, _, n in errs)
    for name, err, norm in errs:
        # a gradient that is zero but for rounding (a key bias) is noise
        if norm > 1e-3 * top:
            assert err <= 1e-1 * norm, (name, err, norm)
    total = sum(e * e for _, e, _ in errs) ** 0.5
    assert total <= 5e-2 * sum(n * n for _, _, n in errs) ** 0.5


def test_jax_bf16_conv_backward_raises():
    """ROADMAP C9: the JAX package's bf16 convolution runs with an fp32
    accumulator and casts after (``paddle_tpu/nn/functional/conv.py:61-70``),
    so its transpose rule meets mixed dtypes and the backward raises; the
    port's runs."""
    x = paddle.to_tensor(IMG).astype("bfloat16")
    w = paddle.to_tensor(K).astype("bfloat16")
    w.stop_gradient = False
    out = JF.conv2d(x, w)
    with pytest.raises(Exception, match="same dtypes"):
        out.astype("float32").sum().backward()
    tw = PORT.t(K, "bfloat16").requires_grad_(True)
    F.conv2d(PORT.t(IMG, "bfloat16"), tw).float().sum().backward()
    assert tw.grad.dtype == torch.bfloat16 and torch.isfinite(tw.grad).all()


def test_low_precision_op_list_records():
    """``tests/test_extras.py::test_low_precision_op_list_records``."""
    pt.set_flags({"low_precision_op_list": True})
    amp.debugging.clear_low_precision_op_list()
    x = pt.to_tensor(np.ones((4, 4), "float32"))
    w = pt.to_tensor(np.ones((4, 4), "float32"))
    with amp.auto_cast(custom_white_list={"matmul"}):
        pt.matmul(x, w)
    ops = amp.debugging.low_precision_op_list()
    assert ops.get("matmul", 0) >= 1
    amp.debugging.clear_low_precision_op_list()
    assert amp.debugging.low_precision_op_list() == {}


def test_to_static_step_counts_as_one_trace():
    """A ``to_static`` key's ops reach the op bus twice in the JAX package
    (its discovery pass and its trace) and never on a replay; the port's
    first call and its capture (here on the CPU, its first inline run)
    count the same, and later calls nothing."""
    lists = []
    for pkg, F_ in ((paddle, JF), (pt, F)):
        pkg.set_flags({"low_precision_op_list": True})
        pkg.amp.debugging.clear_low_precision_op_list()
        w = pkg.to_tensor(W)

        @pkg.jit.to_static
        def step(x):
            with pkg.amp.auto_cast(level="O2"):
                return F_.relu(pkg.matmul(x, w))

        for _ in range(3):
            step(pkg.to_tensor(X))
        lists.append(pkg.amp.debugging.low_precision_op_list())
    assert lists[1] == lists[0] == {"matmul": 2, "relu": 2}


def test_check_numerics_counts():
    t = PORT.t(np.array([np.nan, np.inf, 0.0, 1.0], np.float32))
    with pytest.raises(FloatingPointError, match="nan=1 inf=1"):
        amp.debugging.check_numerics(t, "op", "v")
    n_nan, n_inf, n_zero = amp.debugging.check_numerics(
        t, debug_mode=amp.debugging.DebugMode.CHECK_NAN_INF)
    want = paddle.amp.debugging.check_numerics(
        paddle.to_tensor(t.numpy()),
        debug_mode=paddle.amp.debugging.DebugMode.CHECK_NAN_INF)
    assert [int(v) for v in (n_nan, n_inf, n_zero)] == [
        int(np.asarray(v.numpy())) for v in want] == [1, 1, 1]
