"""Weight initializers: the port of ``paddle_tpu/nn/initializer.py``.

An initializer is called as ``init(shape, dtype, device=None,
generator=None)`` and returns a new tensor of ``shape`` on ``device``.
Random ones draw from ``generator`` (a ``torch.Generator`` on ``device``)
when given, else from torch's default generator; the JAX package draws
from its global key instead, so the draws differ and only the
distributions agree.  Shapes are in Paddle's layout: a linear weight is
``[in, out]`` (``_fan_in_out`` reads ``shape[0]`` as the fan-in), so the
port's ``Linear`` calls its initializer with ``[in, out]`` and stores the
transpose.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels: paddle layout [out_c, in_c, *spatial]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _empty(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _in_fp32(shape, dtype, device, fill):
    """``fill`` an fp32 tensor in place, then cast: the draws whose torch
    functions take no half-precision input (``erfinv``, QR)."""
    t = _empty(shape, torch.float32, device)
    fill(t)
    return t.to(dtype)


class Initializer:
    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return _empty(shape, dtype, device).uniform_(
            self.low, self.high, generator=generator)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return _empty(shape, dtype, device).normal_(
            self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` a standard normal truncated to
    ``[a, b]`` (the bounds in standard units, as the JAX package reads
    them)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        def fill(t):
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, self.a, self.b,
                                        generator=generator)
            t.mul_(self.std).add_(self.mean)

        return _in_fp32(shape, dtype, device, fill)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _empty(shape, dtype, device).uniform_(-limit, limit,
                                                     generator=generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _empty(shape, dtype, device).normal_(0.0, std,
                                                    generator=generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return _empty(shape, dtype, device).uniform_(-limit, limit,
                                                     generator=generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        fi, _ = _fan_in_out(shape)
        fi = self.fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        std = gain / math.sqrt(fi)
        return _empty(shape, dtype, device).normal_(0.0, std,
                                                    generator=generator)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        return _in_fp32(shape, dtype, device, lambda t: torch.nn.init
                        .orthogonal_(t, self.gain, generator=generator))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        out = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        mid = tuple(s // 2 for s in shape[2:])
        for i in range(min(oc, ic * self.groups)):
            out[(i, i % ic) + mid] = 1.0
        return torch.from_numpy(out).to(device=device, dtype=dtype)


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        v = (self.value.detach().cpu() if isinstance(self.value, torch.Tensor)
             else torch.from_numpy(np.array(self.value)))
        return v.to(device=device, dtype=dtype).reshape(tuple(shape))


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity}")
    return gains[nonlinearity]


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


_global_weight_init = None
_global_bias_init = None


class Bilinear(Initializer):
    """Transposed-conv upsampling kernels: weight ``[C_out, C_in, kh, kw]``
    filled with the bilinear interpolation stencil."""

    def __call__(self, shape, dtype=torch.float32, device=None,
                 generator=None):
        if len(shape) != 4:
            raise ValueError(
                f"Bilinear expects a 4-D conv weight, got {shape}")
        _, _, kh, kw = shape
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        cy = fh - 1 if kh % 2 == 1 else fh - 0.5
        cx = fw - 1 if kw % 2 == 1 else fw - 0.5
        og = np.ogrid[:kh, :kw]
        stencil = ((1 - abs(og[0] - cy) / fh)
                   * (1 - abs(og[1] - cx) / fw)).astype("float32")
        w = np.zeros(shape, "float32")
        w[range(shape[0]),
          range(shape[0]) if shape[0] == shape[1] else 0] = stencil
        return torch.from_numpy(w).to(device=device, dtype=dtype)


class LazyGuard:
    """A no-op context kept for API parity: parameters are made at once."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# legacy *Initializer aliases (fluid-era names the reference still exports)
ConstantInitializer = Constant
NormalInitializer = Normal
TruncatedNormalInitializer = TruncatedNormal
UniformInitializer = Uniform
XavierInitializer = XavierUniform
MSRAInitializer = KaimingUniform
NumpyArrayInitializer = Assign
