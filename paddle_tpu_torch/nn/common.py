"""Common layers: the port of ``paddle_tpu/nn/common.py`` for the layers
the GPT, BERT and ERNIE models use (``Identity``, ``Linear``,
``Embedding``, ``Dropout``) and ``Flatten``.  The module's other layers
wait for ROADMAP A13's rest.

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

from ..amp.auto_cast import cast_args
from . import functional as F
from .initializer import Constant, Initializer, Normal, XavierNormal


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
    """``y = x W^T + b`` with ``W`` ``[out_features, in_features]`` (under
    ``amp.auto_cast`` the inputs cast as the JAX op ``linear``'s)."""

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
        x, w, b = cast_args("linear", x, self.weight, self.bias)
        return TF.linear(x, w, b)

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
