"""Activation functionals: the port of
``paddle_tpu/nn/functional/activation.py``.

The same formulas as the JAX package (``jax.nn``'s where it calls them),
in torch ops.  The random ones (``rrelu`` in training, ``gumbel_softmax``)
draw from ``generator`` when given, else from torch's default generator.
The in-place ``elu_`` and ``softmax_`` write into their input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.dispatch import op, run_op
from ...core.dtype import convert_dtype

def _unary(opname, fn):
    # the paddle-API ``name=`` kwarg is not the op's name
    def f(x, name=None):
        return run_op(opname, fn, x)

    f.__name__ = opname
    return f


def _clip01(v):
    return torch.clamp(v, 0.0, 1.0)


relu = _unary("relu", torch.relu)
# hardtanh: no gradient at 0 and 6, as jax.nn.relu6's (clamp passes it)
relu6 = _unary("relu6", lambda v: F.hardtanh(v, 0.0, 6.0))
sigmoid = _unary("sigmoid", torch.sigmoid)
tanh = _unary("tanh", torch.tanh)
silu = _unary("silu", F.silu)
swish = silu
mish = _unary("mish", lambda v: v * torch.tanh(F.softplus(v)))
tanhshrink = _unary("tanhshrink", lambda v: v - torch.tanh(v))
softsign = _unary("softsign", lambda v: v / (torch.abs(v) + 1))
log_sigmoid = _unary("log_sigmoid", F.logsigmoid)
hardsigmoid = _unary("hardsigmoid", lambda v: _clip01(v / 6.0 + 0.5))
hardswish = _unary("hardswish", lambda v: v * _clip01(v / 6.0 + 0.5))


@op("gelu")
def gelu(x, approximate=False, name=None):
    """``x * Phi(x)``; ``approximate=True`` is the tanh form (GPT's)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


@op("elu")
def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def elu_(x, alpha=1.0, name=None):
    with torch.no_grad():
        return x.copy_(elu(x, alpha))


@op("celu")
def celu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


@op("selu")
def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


@op("leaky_relu")
def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, negative_slope * x)


@op("prelu")
def prelu(x, weight, data_format="NCHW", name=None):
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    c_axis = 1 if data_format == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[c_axis] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


@op("rrelu")
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None,
          generator=None):
    if training:
        a = torch.empty_like(x).uniform_(lower, upper, generator=generator)
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


@op("hardtanh")
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


@op("hardshrink")
def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


@op("softshrink")
def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


@op("softplus")
def softplus(x, beta=1.0, threshold=20.0, name=None):
    # jax.nn.softplus is logaddexp(x, 0)
    soft = torch.logaddexp(beta * x, torch.zeros_like(x)) / beta
    return torch.where(beta * x > threshold, x, soft)


@op("thresholded_relu")
def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


@op("softmax")
def softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)
    return torch.softmax(x if d is None else x.to(d), dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    with torch.no_grad():
        return x.copy_(softmax(x, axis, dtype))


@op("log_softmax")
def log_softmax(x, axis=-1, dtype=None, name=None):
    d = convert_dtype(dtype)
    return torch.log_softmax(x if d is None else x.to(d), dim=axis)


@op("gumbel_softmax")
def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None,
                   generator=None):
    u = torch.empty_like(x).uniform_(generator=generator)
    # -log(-log(u)) with u kept off 0, as jax.random.gumbel draws it
    tiny = torch.finfo(x.dtype).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard - y.detach() + y   # straight-through estimator
    return y


@op("maxout")
def maxout(x, groups, axis=1, name=None):
    c = x.shape[axis]
    new_shape = list(x.shape)
    new_shape[axis] = c // groups
    new_shape.insert(axis + 1, groups)
    return torch.amax(x.reshape(new_shape), dim=axis + 1)


@op("glu")
def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)



__all__ = [
    "relu", "relu6", "sigmoid", "tanh", "silu", "swish", "mish",
    "tanhshrink", "softsign", "log_sigmoid", "hardsigmoid", "hardswish",
    "gelu", "elu", "elu_", "celu", "selu", "leaky_relu", "prelu", "rrelu",
    "hardtanh", "hardshrink", "softshrink", "softplus", "thresholded_relu",
    "softmax", "softmax_", "log_softmax", "gumbel_softmax", "maxout", "glu",
]
