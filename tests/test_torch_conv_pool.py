"""The port's convolutions and pools held to the JAX package's on the CPU:
the same numpy inputs (from a seed) through both.

* ``conv1d/2d/3d`` and their transposes: int, per-dim, per-side and
  ``"SAME"`` / ``"VALID"`` padding, strides, dilation, groups, NHWC, with
  and without bias; outputs within 1e-5 and the gradients of the input,
  the weight and the bias within 1e-4 (fp32; the products sum in another
  order).  The conv layers with the JAX layer's weights.
* Every pool: max and average (``exclusive`` both ways) in 1-3 dims,
  padding modes, NHWC, ``return_mask`` (the argmax indices exactly);
  adaptive pools (divisible and not); LP pools; within 1e-6 and their
  input gradients within 1e-5.  ``ceil_mode`` and ``adaptive_max_pool``'s
  ``return_mask``, which the JAX functions ignore, are checked against
  their definitions.
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


def _a(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_call(fn, arrays):
    """``fn`` on JAX tensors that need gradients: its output and the
    gradients of ``sum(out * probe)`` for every input."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    probe = _a(tuple(out.shape), 99)
    (out * paddle.to_tensor(probe)).sum().backward()
    return np.asarray(out.numpy()), [np.asarray(t.grad.numpy())
                                     for t in ts], probe


def _port_call(fn, arrays, probe):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(probe)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _hold(jfn, tfn, arrays, rtol=1e-5, grad_rtol=1e-4):
    jout, jgrads, probe = _jax_call(jfn, arrays)
    tout, tgrads = _port_call(tfn, arrays, probe)
    np.testing.assert_allclose(tout, jout, rtol=rtol, atol=rtol)
    for tg, jg in zip(tgrads, jgrads):
        np.testing.assert_allclose(tg, jg, rtol=grad_rtol, atol=grad_rtol)


# (name, x shape, w shape, kwargs)
CONVS = [
    ("conv1d", (2, 4, 11), (6, 4, 3), dict(padding=1)),
    ("conv1d", (2, 4, 11), (6, 2, 3), dict(stride=2, groups=2,
                                          padding="SAME")),
    ("conv1d", (2, 11, 4), (6, 4, 3), dict(padding=[1, 2],
                                          data_format="NLC")),
    ("conv2d", (2, 3, 9, 8), (5, 3, 3, 3), dict(padding=1)),
    ("conv2d", (2, 3, 9, 8), (5, 3, 3, 2), dict(stride=2, padding=[1, 0])),
    ("conv2d", (2, 3, 9, 8), (5, 3, 3, 3), dict(padding=[1, 2, 0, 1])),
    ("conv2d", (2, 3, 9, 8), (5, 3, 3, 3), dict(padding="SAME", stride=2)),
    ("conv2d", (2, 3, 9, 8), (5, 3, 3, 3), dict(padding="VALID",
                                               dilation=2)),
    ("conv2d", (2, 4, 9, 8), (6, 2, 3, 3), dict(groups=2, padding=1)),
    ("conv2d", (2, 9, 8, 3), (5, 3, 3, 3), dict(padding=1,
                                               data_format="NHWC")),
    ("conv2d", (2, 3, 10, 10), (5, 3, 7, 7), dict(stride=2, padding=3)),
    ("conv3d", (1, 2, 5, 6, 5), (3, 2, 3, 3, 3), dict(padding=1)),
    ("conv3d", (1, 5, 6, 5, 2), (3, 2, 2, 3, 2), dict(
        stride=2, padding="SAME", data_format="NDHWC")),
]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", CONVS, ids=lambda c: f"{c[0]}-{c[3]}")
def test_conv_forward_and_gradients_match_jax(case, bias):
    name, xs, ws, kw = case
    arrays = [_a(xs, 0), _a(ws, 1) * 0.3]
    if bias:
        arrays.append(_a((ws[0],), 2))
    _hold(lambda *t: getattr(JF, name)(*t, **kw),
          lambda *t: getattr(F, name)(*t, **kw), arrays)


TRANSPOSES = [
    ("conv1d_transpose", (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1)),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3), dict(stride=2,
                                                         padding=1)),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3), dict(
        stride=2, padding=1, output_padding=1)),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 2, 3, 3), dict(groups=2,
                                                         dilation=2)),
    ("conv2d_transpose", (2, 4, 5, 6), (4, 3, 3, 3), dict(
        stride=2, padding=[0, 1, 1, 2])),
    ("conv2d_transpose", (2, 5, 6, 4), (4, 3, 3, 3), dict(
        stride=2, padding=1, data_format="NHWC")),
    ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 3, 3, 3, 3), dict(stride=2)),
]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("case", TRANSPOSES, ids=lambda c: f"{c[0]}-{c[3]}")
def test_conv_transpose_matches_jax(case, bias):
    name, xs, ws, kw = case
    groups = kw.get("groups", 1)
    arrays = [_a(xs, 0), _a(ws, 1) * 0.3]
    if bias:
        arrays.append(_a((ws[1] * groups,), 2))
    _hold(lambda *t: getattr(JF, name)(*t, **kw),
          lambda *t: getattr(F, name)(*t, **kw), arrays)


@pytest.mark.parametrize("layer,args,xs", [
    ("Conv1D", (4, 6, 3), (2, 4, 9)),
    ("Conv2D", (3, 5, 3), (2, 3, 8, 8)),
    ("Conv3D", (2, 3, 3), (1, 2, 5, 5, 5)),
    ("Conv2DTranspose", (3, 4, 3), (2, 3, 5, 5)),
])
def test_conv_layers_carry_the_jax_weights(layer, args, xs):
    paddle.seed(3)
    jl = getattr(jnn, layer)(*args, stride=2, padding=1)
    tl = getattr(nn, layer)(*args, stride=2, padding=1, device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    convert.load_paddle_tpu_state(tl, state)
    x = _a(xs, 5)
    np.testing.assert_allclose(
        tl(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jl(paddle.to_tensor(x)).numpy()), rtol=1e-5, atol=1e-5)
    # the JAX initializers: Uniform(+-1/sqrt(fan_in)) weights, zero bias
    bound = 1.0 / np.sqrt(args[0] * np.prod(tl.weight.shape[2:]))
    assert float(tl.weight.detach().abs().max()) <= bound
    no_bias = getattr(nn, layer)(*args, bias_attr=False, device="cpu")
    assert no_bias.bias is None


# (functional, x shape, kwargs)
POOLS = [
    ("max_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=2)),
    ("max_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2,
                                      padding="SAME")),
    ("max_pool2d", (2, 9, 8, 3), dict(kernel_size=3, stride=1, padding=1,
                                      data_format="NHWC")),
    ("max_pool3d", (1, 2, 5, 6, 5), dict(kernel_size=2, stride=2)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool1d", (2, 3, 11), dict(kernel_size=3, stride=2, padding=1,
                                    exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1,
                                      exclusive=False)),
    ("avg_pool2d", (2, 3, 9, 8), dict(kernel_size=[3, 2],
                                      padding="SAME")),
    ("avg_pool2d", (2, 9, 8, 3), dict(kernel_size=2, stride=2,
                                      data_format="NHWC")),
    ("avg_pool3d", (1, 2, 5, 6, 5), dict(kernel_size=3, padding=1,
                                         stride=2)),
    ("adaptive_avg_pool1d", (2, 3, 12), dict(output_size=4)),
    ("adaptive_avg_pool2d", (2, 3, 9, 8), dict(output_size=(3, 4))),
    ("adaptive_avg_pool2d", (2, 3, 7, 10), dict(output_size=(3, 4))),
    ("adaptive_avg_pool2d", (2, 7, 10, 3), dict(output_size=(1, 1),
                                                data_format="NHWC")),
    ("adaptive_avg_pool3d", (1, 2, 6, 5, 4), dict(output_size=(2, 3, 2))),
    ("adaptive_max_pool1d", (2, 3, 11), dict(output_size=4)),
    ("adaptive_max_pool2d", (2, 3, 9, 8), dict(output_size=(3, 4))),
    ("adaptive_max_pool3d", (1, 2, 6, 5, 4), dict(output_size=2)),
    ("lp_pool1d", (2, 3, 11), dict(norm_type=2, kernel_size=3, stride=2)),
    ("lp_pool2d", (2, 3, 9, 8), dict(norm_type=3, kernel_size=2,
                                     stride=2)),
]


@pytest.mark.parametrize("case", POOLS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_pool_forward_and_gradients_match_jax(case):
    name, xs, kw = case
    x = _a(xs, 7)
    if name.startswith("lp"):
        x = np.abs(x) + 0.1
    _hold(lambda t: getattr(JF, name)(t, **kw),
          lambda t: getattr(F, name)(t, **kw), [x], rtol=1e-5,
          grad_rtol=1e-5)


@pytest.mark.parametrize("n,xs,kw", [
    (1, (2, 3, 11), dict(kernel_size=3, stride=2, padding=1)),
    (2, (2, 3, 9, 8), dict(kernel_size=3, stride=2, padding=1)),
    (2, (2, 3, 9, 8), dict(kernel_size=2)),
    (3, (1, 2, 5, 6, 5), dict(kernel_size=2, stride=2)),
])
def test_max_pool_mask_matches_jax(n, xs, kw):
    x = _a(xs, 8)
    jout, jmask = getattr(JF, f"max_pool{n}d")(paddle.to_tensor(x),
                                               return_mask=True, **kw)
    tout, tmask = getattr(F, f"max_pool{n}d")(torch.from_numpy(x),
                                              return_mask=True, **kw)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout.numpy()))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask.numpy()))
    assert tmask.dtype == torch.int32


def test_ceil_mode_keeps_the_partial_window():
    """The JAX function ignores ceil_mode; the port keeps the last, partial
    window, as Paddle (and torch) define it."""
    x = torch.from_numpy(_a((2, 3, 9, 9), 9))
    got = F.max_pool2d(x, 2, stride=2, ceil_mode=True)
    want = torch.nn.functional.max_pool2d(x, 2, stride=2, ceil_mode=True)
    assert got.shape == (2, 3, 5, 5)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    avg = F.avg_pool2d(x, 2, stride=2, ceil_mode=True)
    # the last window holds one real element: exclusive divides by 1
    np.testing.assert_allclose(avg[..., -1, -1].numpy(),
                               x[..., -1, -1].numpy(), rtol=1e-6)
    floor = F.avg_pool2d(x, 2, stride=2)
    np.testing.assert_allclose(avg[..., :4, :4].numpy(), floor.numpy(),
                               rtol=1e-6)


def test_adaptive_max_pool_mask_indexes_the_maxima():
    """The JAX function returns no mask; the port's indexes each maximum
    in the flat spatial dims."""
    x = torch.from_numpy(_a((2, 3, 7, 10), 10))
    out, mask = F.adaptive_max_pool2d(x, (3, 4), return_mask=True)
    picked = torch.gather(x.flatten(2), 2, mask.flatten(2).long())
    np.testing.assert_array_equal(picked.reshape(out.shape).numpy(),
                                  out.numpy())


@pytest.mark.parametrize("layer,args,kw,xs", [
    ("MaxPool2D", (3,), dict(stride=2, padding=1), (2, 3, 9, 8)),
    ("AvgPool2D", (2,), dict(stride=2), (2, 3, 9, 8)),
    ("AvgPool1D", (3,), dict(stride=1, padding=1), (2, 3, 9)),
    ("MaxPool1D", (2,), {}, (2, 3, 9)),
    ("MaxPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    ("AvgPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    ("AdaptiveAvgPool2D", ((1, 1),), {}, (2, 3, 9, 8)),
    ("AdaptiveAvgPool1D", (3,), {}, (2, 3, 9)),
    ("AdaptiveAvgPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    ("AdaptiveMaxPool1D", (3,), {}, (2, 3, 9)),
    ("AdaptiveMaxPool2D", (2,), {}, (2, 3, 8, 8)),
    ("AdaptiveMaxPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    ("LPPool1D", (2, 3), {}, (2, 3, 9)),
    ("LPPool2D", (2, 2), {}, (2, 3, 8, 8)),
])
def test_pool_layers_match_jax(layer, args, kw, xs):
    x = np.abs(_a(xs, 11)) + 0.1
    want = np.asarray(getattr(jnn, layer)(*args, **kw)(
        paddle.to_tensor(x)).numpy())
    got = getattr(nn, layer)(*args, **kw)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
