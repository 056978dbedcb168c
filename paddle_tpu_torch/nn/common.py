"""Common layers: the port of ``paddle_tpu/nn/common.py``, every layer of
it, each over its functional in ``nn/functional/common.py``.

Parameters are created on ``device`` in ``dtype`` (torch's defaults when
not given) and initialised at construction from ``generator`` (a
``torch.Generator`` on ``device``; torch's default generator when not
given).  ``weight_attr`` / ``bias_attr`` take an initializer of
``nn/initializer.py`` in place of the layer's default, and
``bias_attr=False`` drops the bias; Paddle's ``ParamAttr`` is not ported.

``Linear`` stores its weight ``[out, in]``, torch's layout; the JAX
package's is ``[in, out]`` (``convert.py`` transposes, and the weight is
drawn in the ``[in, out]`` shape so fan-in rules read as in the JAX
package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF
from torch import nn

from ..core.dispatch import run_op
from . import functional as F
from .initializer import Constant, Initializer, Normal, Uniform, XavierNormal


def make_parameter(attr, default, shape, dtype=None, device=None,
                   generator=None):
    """A parameter drawn by the initializer ``attr`` (a ``weight_attr`` /
    ``bias_attr``), or by ``default`` when it is None."""
    if attr is None:
        attr = default
    if not isinstance(attr, Initializer):
        raise TypeError(f"a parameter attribute here is an initializer or "
                        f"None, got {type(attr).__name__} (ParamAttr is not "
                        f"ported)")
    return nn.Parameter(attr(shape, dtype or torch.get_default_dtype(),
                             device, generator))


Identity = nn.Identity


class Linear(nn.Module):
    """``y = x W^T + b`` with ``W`` ``[out_features, in_features]``, the
    op ``linear`` on the bus (cast under ``amp.auto_cast``)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        kw = dict(dtype=dtype, device=device, generator=generator)
        w = make_parameter(weight_attr, XavierNormal(),
                           (in_features, out_features), **kw)
        self.weight = nn.Parameter(w.detach().t().contiguous())
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = make_parameter(bias_attr, Constant(0.0),
                                       (out_features,), **kw)

    def forward(self, x):
        return run_op("linear", TF.linear, x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(nn.Module):
    """Lookup table ``weight`` ``[num_embeddings, embedding_dim]`` (N(0, 1)
    by default); the ``padding_idx`` row starts at zero and looks up as
    zero."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = make_parameter(weight_attr, Normal(0.0, 1.0),
                                     (num_embeddings, embedding_dim),
                                     dtype, device, generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """``F.dropout`` in training, the identity (or the ``1 - p`` scale of
    ``downscale_in_infer``) in eval; masks from ``generator``."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 generator=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode, generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Unflatten(nn.Module):
    """Axis ``axis`` split into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self.shape = shape

    def forward(self, x):
        new_shape = list(x.shape)
        new_shape[self.axis: self.axis + 1] = list(self.shape)
        return x.reshape(new_shape)


class Dropout2D(nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None, generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class Dropout3D(nn.Module):
    def __init__(self, p=0.5, data_format="NCDHW", name=None,
                 generator=None):
        super().__init__()
        self.p = p
        self.data_format = data_format
        self.generator = generator

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self.generator)


class AlphaDropout(nn.Module):
    def __init__(self, p=0.5, name=None, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training,
                               generator=self.generator)


class Upsample(nn.Module):
    """``F.interpolate`` with the JAX package's rules."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", align_corners=True,
                         data_format=data_format)


class Bilinear(nn.Module):
    """``out[b, o] = x1[b] W[o] x2[b] + bias[o]``, ``W`` ``[out, in1,
    in2]``; both ``Uniform(-1/sqrt(in1), 1/sqrt(in1))`` by default."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        k = 1.0 / in1_features ** 0.5
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.weight = make_parameter(
            weight_attr, Uniform(-k, k),
            (out_features, in1_features, in2_features), **kw)
        if bias_attr is False:
            self.register_parameter("bias", None)
        else:
            self.bias = make_parameter(bias_attr, Uniform(-k, k),
                                       (out_features,), **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _PadNd(nn.Module):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(nn.Module):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(nn.Module):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class PixelShuffle(nn.Module):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(nn.Module):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = (downscale_factor,
                                                   data_format)

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(nn.Module):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(nn.Module):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(nn.Module):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)
