"""The port's ``nn`` modules held to the JAX package's on the CPU: the same
numpy inputs (from a seed) through both, the tolerance stated per check.

* ``Linear`` (weights carried across transposed), ``Embedding`` with a
  padding index, ``LayerNorm`` in fp32 (1e-6) and bf16 (equal to the JAX
  rounding order: affine applied after the cast), ``Flatten``,
  ``Identity``, the ``Dropout`` layer.
* Every activation of ``nn/functional/activation.py`` in fp32 within 1e-6
  (the random ones in eval form, or by their invariants).
* ``dropout`` at p=0, in eval mode (both modes), its training statistics,
  ``axis`` and its generator.
* ``scaled_dot_product_attention`` and ``flash_attention`` with and
  without a mask, causal and not, within 1e-5; ``sequence_mask`` exactly.
* The containers: the JAX naming and slicing rules, and parameter lists in
  the JAX order.
* Initializers: shape, dtype and device, mean and std against the
  distribution's under a seed (and against the JAX initializer's sample),
  the same seed drawing the same tensor; the deterministic ones equal to
  the JAX ones exactly.
* Schedulers: ``PolynomialDecay`` against the JAX one, and every
  scheduler's ``state_dict`` equal to the JAX one's, crossing both ways.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as init
from paddle_tpu_torch.optimizer import lr as lr_mod


def _rng(seed=0):
    return np.random.default_rng(seed)


def _x(shape=(3, 5, 8), seed=0, scale=2.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _j(a):
    return paddle.to_tensor(a)


def _jn(t):
    return np.asarray(t.numpy())


# --- layers -------------------------------------------------------------------

def test_linear_matches_jax():
    paddle.seed(0)
    jl = jnn.Linear(8, 6)
    state = {k: _jn(v) for k, v in jl.state_dict().items()}
    tl = nn.Linear(8, 6, device="cpu")
    convert.load_paddle_tpu_state(tl, state)
    x = _x()
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               _jn(jl(_j(x))), rtol=1e-6, atol=1e-6)
    assert tuple(tl.weight.shape) == (6, 8)
    assert nn.Linear(8, 6, bias_attr=False, device="cpu").bias is None
    # the functional keeps Paddle's [in, out] weight
    w = _x((8, 6), seed=1)
    np.testing.assert_allclose(
        F.linear(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        _jn(JF.linear(_j(x), _j(w))), rtol=1e-6, atol=1e-6)


def test_embedding_matches_jax_with_padding_index():
    paddle.seed(0)
    je = jnn.Embedding(10, 4, padding_idx=2)
    te = nn.Embedding(10, 4, padding_idx=2, device="cpu")
    convert.load_paddle_tpu_state(te, {"weight": _jn(je.weight)})
    ids = _rng().integers(0, 10, (3, 7))
    got = te(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(got, _jn(je(_j(ids))))
    assert not got[ids == 2].any()
    assert not te.weight.detach()[2].any()   # the pad row starts at zero


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    x = _x((4, 6, 32))
    rng = _rng(1)
    w = (rng.standard_normal(32) + 1).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    jln = jnn.LayerNorm(32, epsilon=1e-5)
    jln.to(dtype=dtype)
    jln.set_state_dict({"weight": w, "bias": b})
    tdt = getattr(torch, dtype)
    tln = nn.LayerNorm(32, epsilon=1e-5, device="cpu", dtype=tdt)
    with torch.no_grad():
        tln.weight.copy_(torch.from_numpy(w))
        tln.bias.copy_(torch.from_numpy(b))
    xj = _j(x).astype(dtype)
    got = tln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    want = _jn(jln(xj).astype("float32"))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6)
    else:
        # the JAX order: normalise in fp32, round, then the affine in bf16
        np.testing.assert_array_equal(got.detach().float().numpy(), want)
    assert [n for n, _ in nn.LayerNorm(8, bias_attr=False, device="cpu")
            .named_parameters()] == ["weight"]


def test_flatten_identity_and_dropout_layer():
    x = torch.from_numpy(_x((2, 3, 4, 5)))
    assert tuple(nn.Flatten()(x).shape) == (2, 60)
    assert tuple(nn.Flatten(0, 1)(x).shape) == (6, 4, 5)
    assert nn.Identity()(x) is x
    d = nn.Dropout(0.5, generator=torch.Generator().manual_seed(0))
    d.eval()
    assert d(x) is x
    d.train()
    assert not torch.equal(d(x), x)


# --- activations --------------------------------------------------------------

ACTIVATIONS = {
    "relu": {}, "relu6": {}, "sigmoid": {}, "tanh": {}, "silu": {},
    "swish": {}, "mish": {}, "tanhshrink": {}, "softsign": {},
    "log_sigmoid": {}, "hardsigmoid": {}, "hardswish": {},
    "gelu": {}, "gelu_tanh": {"approximate": True}, "elu": {"alpha": 0.7},
    "celu": {"alpha": 1.3}, "selu": {}, "leaky_relu": {"negative_slope": 0.2},
    "rrelu": {"training": False}, "hardtanh": {"min": -0.5, "max": 1.5},
    "hardshrink": {"threshold": 0.3}, "softshrink": {"threshold": 0.4},
    "softplus": {"beta": 2.0, "threshold": 3.0},
    "thresholded_relu": {"threshold": 0.5, "value": -1.0},
    "softmax": {"axis": 1}, "log_softmax": {},
    "maxout": {"groups": 4, "axis": 2},
    "glu": {},
}


@pytest.mark.parametrize("name", list(ACTIVATIONS))
def test_activation_matches_jax(name):
    kw = ACTIVATIONS[name]
    fn = name.replace("_tanh", "")
    x = _x()
    got = getattr(F, fn)(torch.from_numpy(x), **kw).numpy()
    want = _jn(getattr(JF, fn)(_j(x), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_prelu_and_the_in_place_and_dtype_forms():
    x = _x((2, 3, 4))
    w = np.array([0.1, 0.2, 0.3], np.float32)
    for weight in (w, w[:1]):
        np.testing.assert_allclose(
            F.prelu(torch.from_numpy(x), torch.from_numpy(weight)).numpy(),
            _jn(JF.prelu(_j(x), _j(weight))), rtol=1e-6, atol=1e-6)
    t = torch.from_numpy(x.copy())
    assert F.elu_(t) is t
    np.testing.assert_allclose(t.numpy(), _jn(JF.elu(_j(x))), rtol=1e-6,
                               atol=1e-6)
    t = torch.from_numpy(x.copy())
    assert F.softmax_(t, axis=-1) is t
    np.testing.assert_allclose(t.numpy(), _jn(JF.softmax(_j(x))),
                               rtol=1e-6, atol=1e-6)
    got = F.softmax(torch.from_numpy(x).to(torch.bfloat16), dtype="float32")
    assert got.dtype == torch.float32


def test_random_activations_by_their_invariants():
    x = torch.from_numpy(_x((64, 10)))
    gen = torch.Generator().manual_seed(0)
    y = F.rrelu(x, 0.1, 0.3, training=True, generator=gen)
    neg = x < 0
    ratio = (y[neg] / x[neg])
    assert torch.equal(y[~neg], x[~neg])
    assert ratio.min() >= 0.1 and ratio.max() <= 0.3
    g = F.gumbel_softmax(x, temperature=0.5,
                         generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(g.sum(-1), torch.ones(64))
    h = F.gumbel_softmax(x, hard=True,
                         generator=torch.Generator().manual_seed(1))
    assert torch.equal(h.detach().sum(-1), torch.ones(64))
    assert set(h.detach().unique().tolist()) <= {0.0, 1.0}
    again = F.gumbel_softmax(x, temperature=0.5,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(g, again)


# --- dropout ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_at_zero_and_in_eval_matches_jax(mode):
    x = _x()
    t = torch.from_numpy(x)
    assert F.dropout(t, 0.0, mode=mode) is t
    got = F.dropout(t, 0.3, training=False, mode=mode).numpy()
    want = _jn(JF.dropout(_j(x), 0.3, training=False, mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dropout_training_statistics_axis_and_generator():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = F.dropout(x, 0.25, generator=gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    z = F.dropout(x, 0.25, mode="downscale_in_infer",
                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(z != 0, kept)             # same generator, same mask
    assert torch.equal(z[kept], x[kept])
    a = F.dropout(x, 0.5, axis=0, generator=torch.Generator().manual_seed(2))
    rows = (a != 0).float()
    assert torch.equal(rows, rows[:, :1].expand_as(rows))


# --- attention ----------------------------------------------------------------

def _qkv(B=2, S=24, H=3, D=16, seed=0):
    rng = _rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_scaled_dot_product_attention_matches_jax(masked, causal):
    q, k, v = _qkv()
    mask = None
    if masked:
        keep = _rng(3).random((2, 1, 24, 24)) > 0.3
        mask = np.where(keep, 0.0, -1e4).astype(np.float32)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal).numpy()
    want = _jn(JF.scaled_dot_product_attention(
        _j(q), _j(k), _j(v), attn_mask=None if mask is None else _j(mask),
        is_causal=causal))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal):
    q, k, v = _qkv(seed=1)
    out, sm = F.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                causal=causal)
    jout, jsm = JF.flash_attention(_j(q), _j(k), _j(v), causal=causal)
    assert sm is None and jsm is None
    np.testing.assert_allclose(out.numpy(), _jn(jout), rtol=1e-5, atol=1e-5)


def test_attention_dropout_off_in_eval_and_drawn_in_training():
    q, k, v = (torch.from_numpy(a) for a in _qkv(seed=2))
    plain = F.scaled_dot_product_attention(q, k, v)
    assert torch.equal(F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, training=False), plain)
    a = F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, generator=torch.Generator().manual_seed(0))
    b = F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.allclose(a, plain)


@pytest.mark.parametrize("maxlen", [None, 9])
def test_sequence_mask_matches_jax(maxlen):
    lens = np.array([3, 0, 7, 5])
    got = F.sequence_mask(torch.from_numpy(lens), maxlen=maxlen)
    want = _jn(JF.sequence_mask(_j(lens), maxlen=maxlen))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


# --- containers ---------------------------------------------------------------

def test_containers_follow_the_jax_rules():
    lin = [nn.Linear(2, 2, device="cpu") for _ in range(3)]
    seq = nn.Sequential(*lin)
    assert [n for n, _ in seq.named_children()] == ["0", "1", "2"]
    named = nn.Sequential(("a", lin[0]), ("b", lin[1]))
    assert [n for n, _ in named.named_children()] == ["a", "b"]
    assert [n for n, _ in nn.Sequential([("x", lin[2])]).named_children()] \
        == ["x"]
    tail = seq[1:]
    assert isinstance(tail, nn.Sequential)
    assert [n for n, _ in tail.named_children()] == ["0", "1"]
    assert seq[-1] is lin[2]
    x = torch.ones(1, 2)
    torch.testing.assert_close(seq(x), lin[2](lin[1](lin[0](x))))
    ll = nn.LayerList(lin[:2])
    assert isinstance(ll[0:1], nn.LayerList) and ll[-1] is lin[1]
    ll.append(lin[2])
    ll.insert(0, nn.Identity())
    assert len(ll) == 4 and ll[1] is lin[0]
    ld = nn.LayerDict({"b": lin[0], "a": lin[1]})
    assert list(ld.keys()) == ["b", "a"] and "a" in ld
    assert ld.pop("b") is lin[0] and len(ld) == 1
    pl = nn.ParameterList([torch.nn.Parameter(torch.ones(2))])
    pl.append(torch.nn.Parameter(torch.zeros(3)))
    assert len(pl) == 2 and pl[1].shape == (3,)


def test_container_parameters_in_the_jax_order():
    jseq = jnn.Sequential(jnn.Linear(2, 3), jnn.LayerNorm(3),
                          jnn.LayerList([jnn.Linear(3, 3)]))
    tseq = nn.Sequential(nn.Linear(2, 3, device="cpu"),
                         nn.LayerNorm(3, device="cpu"),
                         nn.LayerList([nn.Linear(3, 3, device="cpu")]))
    assert convert.paddle_parameter_order(tseq) == \
        [n for n, _ in jseq.named_parameters()]


# --- initializers -------------------------------------------------------------

SHAPE = (256, 512)
RANDOM_INITS = {
    # name: (kwargs, mean, std) of the distribution at SHAPE = [in, out]
    "Uniform": ({"low": -0.5, "high": 1.5}, 0.5, 2 / math.sqrt(12)),
    "Normal": ({"mean": 0.3, "std": 0.2}, 0.3, 0.2),
    "TruncatedNormal": ({"mean": 0.1, "std": 0.5}, 0.1,
                        0.5 * 0.8796256610342398),
    "XavierUniform": ({}, 0.0, math.sqrt(6 / 768) / math.sqrt(3)),
    "XavierNormal": ({"gain": 2.0}, 0.0, 2 * math.sqrt(2 / 768)),
    "KaimingUniform": ({}, 0.0, math.sqrt(2) * math.sqrt(3 / 256)
                       / math.sqrt(3)),
    "KaimingNormal": ({"negative_slope": 0.1}, 0.0,
                      math.sqrt(2 / 1.01) / math.sqrt(256)),
    "Orthogonal": ({"gain": 1.5}, 0.0, 1.5 / math.sqrt(512)),
}


@pytest.mark.parametrize("name", list(RANDOM_INITS))
def test_random_initializers_by_their_moments(name):
    kw, mean, std = RANDOM_INITS[name]
    t = getattr(init, name)(**kw)(SHAPE, torch.float32, "cpu",
                                  torch.Generator().manual_seed(0))
    assert t.shape == SHAPE and t.dtype == torch.float32
    n = t.numel()
    assert abs(t.mean().item() - mean) < 5 * std / math.sqrt(n) + 1e-6
    assert abs(t.std().item() / std - 1) < 0.02
    paddle.seed(0)
    j = np.asarray(getattr(jinit, name)(**kw)(SHAPE, "float32"))
    assert abs(t.std().item() / float(j.std()) - 1) < 0.03
    assert abs(t.mean().item() - float(j.mean())) < 10 * std / math.sqrt(n)
    again = getattr(init, name)(**kw)(SHAPE, torch.float32, "cpu",
                                      torch.Generator().manual_seed(0))
    assert torch.equal(t, again)
    other = getattr(init, name)(**kw)(SHAPE, torch.float32, "cpu",
                                      torch.Generator().manual_seed(1))
    assert not torch.equal(t, other)
    assert getattr(init, name)(**kw)((4, 8), torch.bfloat16).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("name, args, shape", [
    ("Constant", (0.7,), (3, 4)),
    ("Dirac", (), (4, 2, 3, 3)),
    ("Assign", (np.arange(12.0).reshape(3, 4),), (3, 4)),
    ("Bilinear", (), (2, 2, 4, 4)),
])
def test_deterministic_initializers_equal_jax(name, args, shape):
    got = getattr(init, name)(*args)(shape, torch.float32, "cpu")
    want = np.asarray(getattr(jinit, name)(*args)(shape, "float32"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_gains_and_fan_rules():
    for nl, p in (("tanh", None), ("relu", None), ("leaky_relu", 0.2),
                  ("selu", None), ("conv2d", None)):
        assert init.calculate_gain(nl, p) == jinit.calculate_gain(nl, p)
    with pytest.raises(ValueError):
        init.calculate_gain("nope")
    assert init._fan_in_out((3, 4, 5, 5)) == jinit._fan_in_out((3, 4, 5, 5))
    with init.LazyGuard():
        pass
    assert init.MSRAInitializer is init.KaimingUniform


# --- schedulers ---------------------------------------------------------------

def _values(sched, n=14):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


@pytest.mark.parametrize("cycle", [False, True])
def test_polynomial_decay_matches_jax(cycle):
    kw = dict(learning_rate=0.1, decay_steps=5, end_lr=0.01, power=2.0,
              cycle=cycle)
    assert _values(lr_mod.PolynomialDecay(**kw)) == \
        _values(jlr.PolynomialDecay(**kw))


SCHEDULERS = {
    "cosine": lambda m: m.CosineAnnealingDecay(1e-3, T_max=6, eta_min=1e-5),
    "polynomial": lambda m: m.PolynomialDecay(0.1, 5, end_lr=0.0),
    "warmup_constant": lambda m: m.LinearWarmup(0.5, 4, 0.0, 0.5),
    "warmup_polynomial": lambda m: m.LinearWarmup(
        m.PolynomialDecay(2e-3, decay_steps=6, end_lr=0.0), 2, 0.0, 2e-3),
}


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_state_crosses_both_ways(name):
    make = SCHEDULERS[name]
    j, t = make(jlr), make(lr_mod)
    for _ in range(3):
        j.step()
        t.step()
    assert t.state_dict() == j.state_dict()
    # JAX state into a fresh port scheduler, and the port's into JAX
    t2, j2 = make(lr_mod), make(jlr)
    t2.set_state_dict(j.state_dict())
    j2.set_state_dict(t.state_dict())
    assert _values(t2) == _values(j) == _values(j2)
