"""Normalisation layers: the port of ``paddle_tpu/nn/norm.py`` for
``LayerNorm`` and ``RMSNorm`` (the batch, group and instance norms wait for
ROADMAP A12)."""

from __future__ import annotations

import torch
from torch import nn

from .common import make_parameter
from .functional.norm import layer_norm, rms_norm
from .initializer import Constant


class LayerNorm(nn.Module):
    """Layer norm over the trailing ``normalized_shape`` with a learned
    ``weight`` (ones) and ``bias`` (zeros); ``weight_attr=False`` /
    ``bias_attr=False`` drop them."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        shape = tuple(self.normalized_shape)
        for pname, attr, value in (("weight", weight_attr, 1.0),
                                   ("bias", bias_attr, 0.0)):
            self.register_parameter(pname, None if attr is False else
                                    make_parameter(attr, Constant(value),
                                                   shape, dtype, device))

    def forward(self, x):
        return layer_norm(x, self.normalized_shape, self.weight, self.bias,
                          self.epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self.normalized_shape}, "
                f"epsilon={self.epsilon}")


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned per-channel ``weight`` (ones at
    construction), created directly on ``device``."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
