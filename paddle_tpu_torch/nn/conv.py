"""Convolution layers: the port of ``paddle_tpu/nn/conv.py``.

A weight ``[out, in / groups, *k]`` (a transposed conv's ``[in, out /
groups, *k]``) drawn from ``Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))``
with ``fan_in = in / groups * prod(k)``, and a bias of zeros, as the JAX
layers make them; ``bias_attr=False`` drops the bias.  Built on
``device`` in ``dtype`` from ``generator`` (``nn/common.py``'s rules).
"""

from __future__ import annotations

import math

import numpy as np
from torch import nn

from . import functional as F
from .common import make_parameter
from .initializer import Constant, Uniform


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, dims, transposed=False,
                 output_padding=0, device=None, dtype=None, generator=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: the JAX layers pad with "
                f"zeros only")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, dims)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.output_padding = output_padding
        self._transposed = transposed
        if transposed:
            shape = (in_channels, out_channels // groups, *self.kernel_size)
        else:
            shape = (out_channels, in_channels // groups, *self.kernel_size)
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        k = 1.0 / math.sqrt(fan_in)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = make_parameter(weight_attr, Uniform(-k, k), shape,
                                     **kw)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = make_parameter(bias_attr, Constant(0.0),
                                       (out_channels,), **kw)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


def _conv_layer(dims, fn, default_format):
    class Conv(_ConvNd):
        def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                     padding=0, dilation=1, groups=1, padding_mode="zeros",
                     weight_attr=None, bias_attr=None,
                     data_format=default_format, device=None, dtype=None,
                     generator=None):
            super().__init__(in_channels, out_channels, kernel_size, stride,
                             padding, dilation, groups, padding_mode,
                             weight_attr, bias_attr, data_format, dims,
                             device=device, dtype=dtype, generator=generator)

        def forward(self, x):
            return fn(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups, self.data_format)

    return Conv


def _conv_transpose_layer(dims, fn, default_format):
    class ConvTranspose(_ConvNd):
        def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                     padding=0, output_padding=0, groups=1, dilation=1,
                     weight_attr=None, bias_attr=None,
                     data_format=default_format, device=None, dtype=None,
                     generator=None):
            super().__init__(in_channels, out_channels, kernel_size, stride,
                             padding, dilation, groups, "zeros", weight_attr,
                             bias_attr, data_format, dims, transposed=True,
                             output_padding=output_padding, device=device,
                             dtype=dtype, generator=generator)

        def forward(self, x, output_size=None):
            return fn(x, self.weight, self.bias, self.stride, self.padding,
                      self.output_padding, self.groups, self.dilation,
                      output_size, self.data_format)

    return ConvTranspose


Conv1D = _conv_layer(1, F.conv1d, "NCL")
Conv2D = _conv_layer(2, F.conv2d, "NCHW")
Conv3D = _conv_layer(3, F.conv3d, "NCDHW")
Conv1DTranspose = _conv_transpose_layer(1, F.conv1d_transpose, "NCL")
Conv2DTranspose = _conv_transpose_layer(2, F.conv2d_transpose, "NCHW")
Conv3DTranspose = _conv_transpose_layer(3, F.conv3d_transpose, "NCDHW")
for _cls, _name in ((Conv1D, "Conv1D"), (Conv2D, "Conv2D"),
                    (Conv3D, "Conv3D"), (Conv1DTranspose, "Conv1DTranspose"),
                    (Conv2DTranspose, "Conv2DTranspose"),
                    (Conv3DTranspose, "Conv3DTranspose")):
    _cls.__name__ = _cls.__qualname__ = _name
del _cls, _name
