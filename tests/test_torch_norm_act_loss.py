"""The port's norms, activation layers and losses held to the JAX
package's on the CPU: the same numpy inputs (from a seed) through both.

* ``BatchNorm1D/2D/3D`` (and ``BatchNorm``): 3 train-mode steps, each
  step's output and the ``_mean`` / ``_variance`` buffers after it within
  1e-5 (Paddle's momentum 0.9 and the unbiased running variance), the
  input and affine gradients within 1e-4, then eval; NHWC; bf16 input
  with fp32 weights gives the JAX dtype (fp32) and values within bf16's
  rounding (1e-2).  ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
  ``LocalResponseNorm`` and ``normalize`` within 1e-5.
* Every activation layer of ``paddle_tpu/nn/activation.py`` in fp32
  within 1e-6 (``RReLU`` in eval, ``PReLU`` with its weight carried).
* Every loss layer of ``paddle_tpu/nn/loss.py`` and every loss functional
  with no layer within 1e-5 (fp32; ``rnnt_loss`` and ``ctc_loss`` 1e-4,
  their recursions sum in another order), and the gradient of the
  cross-entropy; ``class_center_sample`` by its rule (the draw differs).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import convert
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F


def _a(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _j(a):
    return paddle.to_tensor(a)


def _jn(t):
    return np.asarray(t.numpy())


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- batch norm ---------------------------------------------------------------

@pytest.mark.parametrize("layer,xs,fmt", [
    ("BatchNorm1D", (6, 4), "NCHW"),
    ("BatchNorm1D", (3, 4, 5), "NCHW"),
    ("BatchNorm2D", (3, 4, 5, 6), "NCHW"),
    ("BatchNorm2D", (3, 5, 6, 4), "NHWC"),
    ("BatchNorm3D", (2, 4, 3, 4, 3), "NCDHW"),
    ("BatchNorm", (3, 4, 5, 6), "NCHW"),
])
def test_batch_norm_train_steps_and_buffers_match_jax(layer, xs, fmt):
    jl = getattr(jnn, layer)(4, data_format=fmt)
    tl = getattr(nn, layer)(4, data_format=fmt, device="cpu")
    state = {k: _jn(v) for k, v in jl.state_dict().items()}
    assert set(state) == {"weight", "bias", "_mean", "_variance"}
    convert.load_paddle_tpu_state(tl, state)
    for step in range(3):
        x = _a(xs, step, scale=2.0) + 1.5
        jx = paddle.to_tensor(x, stop_gradient=False)
        tx = _t(x).requires_grad_()
        probe = _a(xs, 10 + step)
        jout, tout = jl(jx), tl(tx)
        np.testing.assert_allclose(tout.detach().numpy(), _jn(jout),
                                   rtol=1e-5, atol=1e-5)
        (jout * _j(probe)).sum().backward()
        (tout * _t(probe)).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), _jn(jx.grad),
                                   rtol=1e-4, atol=1e-4)
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(getattr(tl, name).numpy(),
                                       _jn(getattr(jl, name)), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(tl.weight.grad.numpy(), _jn(jl.weight.grad),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl.bias.grad.numpy(), _jn(jl.bias.grad),
                               rtol=1e-4, atol=1e-4)
    jl.eval()
    tl.eval()
    x = _a(xs, 7)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(), _jn(jl(_j(x))),
                               rtol=1e-5, atol=1e-5)


def test_batch_norm_bf16_input_keeps_the_jax_dtype_flow():
    """bf16 x, fp32 weights: statistics in fp32, the normalised value
    rounded to bf16, then the fp32 affine (an fp32 result), as the JAX
    function computes it; the buffers stay fp32."""
    jl, tl = jnn.BatchNorm2D(4), nn.BatchNorm2D(4, device="cpu")
    x = _a((3, 4, 5, 6), 1, 2.0)
    jout = jl(_j(x).astype("bfloat16"))
    tout = tl(_t(x).bfloat16())
    assert tout.dtype == torch.float32 and str(jout.dtype) == "float32"
    np.testing.assert_allclose(tout.detach().numpy(), _jn(jout), rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(tl._mean.numpy(), _jn(jl._mean), rtol=1e-5,
                               atol=1e-6)
    assert tl._mean.dtype == torch.float32


def test_use_global_stats_reads_the_buffers_in_training():
    jl = jnn.BatchNorm2D(4, use_global_stats=True)
    tl = nn.BatchNorm2D(4, use_global_stats=True, device="cpu")
    x = _a((3, 4, 5, 6), 2)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(), _jn(jl(_j(x))),
                               rtol=1e-5, atol=1e-5)
    assert float(tl._mean.abs().max()) == 0.0


@pytest.mark.parametrize("layer,args,xs,kw", [
    ("GroupNorm", (2, 4), (3, 4, 5, 6), {}),
    ("GroupNorm", (4, 8), (3, 5, 6, 8), {"data_format": "NHWC"}),
    ("InstanceNorm1D", (4,), (3, 4, 7), {}),
    ("InstanceNorm2D", (4,), (3, 4, 5, 6), {}),
    ("InstanceNorm3D", (4,), (2, 4, 3, 4, 3), {}),
    ("LocalResponseNorm", (3,), (2, 6, 4, 4), {}),
    ("LocalResponseNorm", (4,), (2, 7, 4, 4), {"alpha": 0.1}),
])
def test_other_norm_layers_match_jax(layer, args, xs, kw):
    jl = getattr(jnn, layer)(*args, **kw)
    tl = getattr(nn, layer)(*args, **kw)
    state = {k: _jn(v) for k, v in jl.state_dict().items()}
    if state:
        state["weight"] = state["weight"] + _a(state["weight"].shape, 3)
        convert.load_paddle_tpu_state(tl, state)
        jl.set_state_dict({k: _j(v) for k, v in state.items()})
    x = _a(xs, 4, 2.0)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(), _jn(jl(_j(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p,axis", [(2, 1), (1, -1), (3, 0)])
def test_normalize_matches_jax(p, axis):
    x = _a((4, 5, 3), 5)
    np.testing.assert_allclose(
        F.normalize(_t(x), p=p, axis=axis).numpy(),
        _jn(JF.normalize(_j(x), p=p, axis=axis)), rtol=1e-5, atol=1e-6)


# --- activation layers --------------------------------------------------------

ACTIVATIONS = [
    ("ReLU", ()), ("ReLU6", ()), ("GELU", ()), ("GELU", (True,)),
    ("Sigmoid", ()), ("Tanh", ()), ("Softmax", ()), ("Softmax", (0,)),
    ("LogSoftmax", ()), ("LeakyReLU", (0.2,)), ("RReLU", ()), ("ELU", ()),
    ("ELU", (0.5,)), ("CELU", (0.7,)), ("SELU", ()), ("Silu", ()),
    ("Swish", ()), ("Mish", ()), ("Hardshrink", ()), ("Hardsigmoid", ()),
    ("Hardswish", ()), ("Hardtanh", ()), ("Hardtanh", (-0.5, 2.0)),
    ("Softplus", ()), ("Softplus", (2.0, 1.0)), ("Softshrink", (0.3,)),
    ("Softsign", ()), ("Tanhshrink", ()), ("ThresholdedReLU", (0.5,)),
    ("LogSigmoid", ()), ("Maxout", (2,)), ("GLU", ()), ("Softmax2D", ()),
    ("PReLU", ()), ("PReLU", (4, 0.1)),
]


@pytest.mark.parametrize("name,args", ACTIVATIONS,
                         ids=[f"{n}{a}" for n, a in ACTIVATIONS])
def test_activation_layers_match_jax(name, args):
    jl = getattr(jnn, name)(*args)
    tl = getattr(nn, name)(*args)
    if name == "RReLU":
        jl.eval()
        tl.eval()
    if name == "PReLU":
        state = {k: _jn(v) for k, v in jl.state_dict().items()}
        convert.load_paddle_tpu_state(tl, state)
    x = _a((2, 4, 3, 6), 6, 3.0)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(), _jn(jl(_j(x))),
                               rtol=1e-6, atol=1e-6)


# --- losses -------------------------------------------------------------------

def _prob(shape, seed):
    return 1.0 / (1.0 + np.exp(-_a(shape, seed, 2.0)))


def _pm1(shape, seed):
    return np.where(_a(shape, seed) > 0, 1.0, -1.0).astype(np.float32)


def _labels(n, c, seed):
    return np.random.default_rng(seed).integers(0, c, n).astype(np.int64)


def _loss_cases():
    x, y = _a((6, 5), 0), _a((6, 5), 1)
    lab = _labels(6, 5, 2)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    w5 = np.abs(_a((5,), 3)) + 0.5
    return [
        ("CrossEntropyLoss", {}, [x, lab]),
        ("CrossEntropyLoss", {"weight": w5, "label_smoothing": 0.1},
         [x, lab]),
        ("CrossEntropyLoss", {"ignore_index": 1, "reduction": "sum"},
         [x, lab]),
        ("CrossEntropyLoss", {"soft_label": True},
         [x, np.exp(logp).astype(np.float32)]),
        ("MSELoss", {}, [x, y]),
        ("L1Loss", {"reduction": "sum"}, [x, y]),
        ("NLLLoss", {}, [logp, lab]),
        ("NLLLoss", {"weight": w5, "ignore_index": 0}, [logp, lab]),
        ("BCELoss", {}, [_prob((6, 5), 4), _prob((6, 5), 5).round()]),
        ("BCEWithLogitsLoss", {}, [x, _prob((6, 5), 5).round()]),
        ("BCEWithLogitsLoss", {"pos_weight": w5},
         [x, _prob((6, 5), 5).round()]),
        ("KLDivLoss", {"reduction": "batchmean"}, [logp, _prob((6, 5), 6)]),
        ("KLDivLoss", {"log_target": True}, [logp, logp[::-1].copy()]),
        ("SmoothL1Loss", {"delta": 0.5}, [x, y]),
        ("HuberLoss", {"delta": 0.7}, [x, y]),
        ("MarginRankingLoss", {"margin": 0.2},
         [x[:, 0].copy(), y[:, 0].copy(), _pm1((6,), 7)]),
        ("CosineEmbeddingLoss", {"margin": 0.1}, [x, y, _pm1((6,), 8)]),
        ("TripletMarginLoss", {}, [x, y, _a((6, 5), 9)]),
        ("TripletMarginLoss", {"p": 1.0, "swap": True},
         [x, y, _a((6, 5), 9)]),
        ("MultiLabelSoftMarginLoss", {}, [x, _prob((6, 5), 5).round()]),
        ("SoftMarginLoss", {}, [x, _pm1((6, 5), 10)]),
        ("HingeEmbeddingLoss", {}, [x, _pm1((6, 5), 11)]),
        ("PoissonNLLLoss", {}, [x, np.abs(y)]),
        ("PoissonNLLLoss", {"log_input": False, "full": True},
         [np.abs(x) + 0.1, np.abs(y) * 3]),
        ("GaussianNLLLoss", {"full": True}, [x, y, np.abs(_a((6, 5), 12))]),
        ("MultiMarginLoss", {}, [x, lab]),
        ("MultiMarginLoss", {"p": 2, "margin": 0.5, "weight": w5}, [x, lab]),
        ("TripletMarginWithDistanceLoss", {"swap": True},
         [x, y, _a((6, 5), 9)]),
    ]


def _jax_arg(v):
    return _j(v) if isinstance(v, np.ndarray) else v


def _port_arg(v):
    return _t(v) if isinstance(v, np.ndarray) else v


@pytest.mark.parametrize("name,kw,inputs", _loss_cases(),
                         ids=[f"{c[0]}{sorted(c[1])}" for c in _loss_cases()])
def test_loss_layers_match_jax(name, kw, inputs):
    jkw = {k: _jax_arg(v) for k, v in kw.items()}
    tkw = {k: _port_arg(v) for k, v in kw.items()}
    want = getattr(jnn, name)(**jkw)(*[_j(a) for a in inputs])
    got = getattr(nn, name)(**tkw)(*[_t(a) for a in inputs])
    np.testing.assert_allclose(got.detach().numpy(), _jn(want), rtol=1e-5,
                               atol=1e-6)


def test_cross_entropy_gradient_matches_jax():
    x, lab = _a((6, 5), 0), _labels(6, 5, 2)
    jx = paddle.to_tensor(x, stop_gradient=False)
    JF.cross_entropy(jx, _j(lab), label_smoothing=0.1).backward()
    tx = _t(x).requires_grad_()
    F.cross_entropy(tx, _t(lab), label_smoothing=0.1).backward()
    np.testing.assert_allclose(tx.grad.numpy(), _jn(jx.grad), rtol=1e-5,
                               atol=1e-7)


def _functional_cases():
    x, y = _a((6, 5), 0), _a((6, 5), 1)
    lab = _labels(6, 5, 2)
    return [
        ("softmax_with_cross_entropy", {}, [x, lab[:, None]]),
        ("base_softmax_with_cross_entropy", {}, [x, lab[:, None]]),
        ("square_error_cost", {}, [x, y]),
        ("log_loss", {}, [_prob((6, 1), 4), _prob((6, 1), 5).round()]),
        ("sigmoid_focal_loss", {}, [x, _prob((6, 5), 5).round()]),
        ("sigmoid_focal_loss", {"reduction": "mean", "gamma": 1.0},
         [x, _prob((6, 5), 5).round()]),
        ("dice_loss", {}, [_prob((4, 3, 5), 6), _labels(12, 5, 7)
                           .reshape(4, 3, 1)]),
        ("npair_loss", {}, [x, y, _labels(6, 3, 8).astype(np.float32)]),
        ("margin_cross_entropy", {}, [np.tanh(x), lab]),
        ("margin_cross_entropy", {"reduction": "none", "margin2": 0.3},
         [np.tanh(x), lab]),
        ("hsigmoid_loss", {"num_classes": 5},
         [x[:, :4].copy(), lab, _a((4, 4), 9), _a((4,), 10)]),
        ("hsigmoid_loss", {"num_classes": 6},
         [x[:, :4].copy(), lab, _a((5, 4), 9), None]),
    ]


@pytest.mark.parametrize("name,kw,inputs", _functional_cases(),
                         ids=[f"{c[0]}{sorted(c[1])}"
                              for c in _functional_cases()])
def test_loss_functionals_match_jax(name, kw, inputs):
    if name == "hsigmoid_loss":
        x, lab, w, b = inputs
        want = JF.hsigmoid_loss(_j(x), _j(lab), kw["num_classes"], _j(w),
                                None if b is None else _j(b))
        got = F.hsigmoid_loss(_t(x), _t(lab), kw["num_classes"], _t(w),
                              None if b is None else _t(b))
    else:
        want = getattr(JF, name)(*[_j(a) for a in inputs], **kw)
        got = getattr(F, name)(*[_t(a) for a in inputs], **kw)
    np.testing.assert_allclose(got.detach().numpy(), _jn(want), rtol=1e-5,
                               atol=1e-6)


def test_ctc_loss_matches_jax():
    T, B, K, L = 12, 3, 6, 4
    lp = _a((T, B, K), 13)
    labels = np.random.default_rng(14).integers(1, K, (B, L))
    il = np.array([12, 10, 9], np.int64)
    ll = np.array([4, 3, 2], np.int64)
    for reduction in ("mean", "sum", "none"):
        want = JF.ctc_loss(_j(lp), _j(labels), _j(il), _j(ll),
                           reduction=reduction)
        got = nn.CTCLoss(reduction=reduction)(_t(lp), _t(labels), _t(il),
                                              _t(ll))
        np.testing.assert_allclose(got.numpy(), _jn(want), rtol=1e-4,
                                   atol=1e-4)


def test_rnnt_loss_matches_jax():
    B, T, U, V = 2, 5, 3, 6
    logits = _a((B, T, U + 1, V), 15)
    labels = np.random.default_rng(16).integers(1, V, (B, U))
    il, ll = np.array([5, 4]), np.array([3, 2])
    for reduction in ("mean", "none"):
        want = JF.rnnt_loss(_j(logits), _j(labels), _j(il), _j(ll),
                            reduction=reduction)
        got = nn.RNNTLoss(reduction=reduction)(_t(logits), _t(labels),
                                               _t(il), _t(ll))
        np.testing.assert_allclose(got.numpy(), _jn(want), rtol=1e-4,
                                   atol=1e-4)


def test_hsigmoid_layer_carries_the_jax_weights():
    paddle.seed(1)
    jl = jnn.HSigmoidLoss(4, 6)
    tl = nn.HSigmoidLoss(4, 6, device="cpu")
    convert.load_paddle_tpu_state(tl, {k: _jn(v) for k, v in
                                       jl.state_dict().items()})
    x, lab = _a((5, 4), 17), _labels(5, 6, 18)
    np.testing.assert_allclose(tl(_t(x), _t(lab)).detach().numpy(),
                               _jn(jl(_j(x), _j(lab))), rtol=1e-5)


def test_class_center_sample_keeps_every_positive():
    lab = torch.tensor([3, 7, 3, 1, 9])
    gen = torch.Generator().manual_seed(0)
    remapped, sampled = F.class_center_sample(lab, 20, 8, generator=gen)
    assert len(sampled) == 8 and torch.equal(sampled,
                                             torch.sort(sampled).values)
    assert {1, 3, 7, 9} <= set(sampled.tolist())
    assert torch.equal(sampled[remapped], lab)
    # more positives than samples: all kept
    _, few = F.class_center_sample(lab, 20, 2, generator=gen)
    assert few.tolist() == [1, 3, 7, 9]
