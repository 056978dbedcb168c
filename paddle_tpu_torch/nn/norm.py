"""Normalisation layers: the port of ``paddle_tpu/nn/norm.py``
(``SpectralNorm`` waits for ROADMAP A12; ``SyncBatchNorm`` for A11).

The batch norms keep the JAX package's state: learned ``weight`` (ones)
and ``bias`` (zeros), and the fp32 buffers ``_mean`` (zeros) and
``_variance`` (ones), which ``F.batch_norm`` updates in place in training
with Paddle's ``momentum`` (0.9: ``r = 0.9 r + 0.1 batch``).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import make_parameter
from .functional.norm import (
    batch_norm,
    group_norm,
    instance_norm,
    layer_norm,
    local_response_norm,
    rms_norm,
)
from .initializer import Constant


def _affine_params(module, shape, weight_attr, bias_attr, dtype, device):
    """``weight`` (ones) and ``bias`` (zeros), each dropped by ``False``."""
    for pname, attr, value in (("weight", weight_attr, 1.0),
                               ("bias", bias_attr, 0.0)):
        module.register_parameter(pname, None if attr is False else
                                  make_parameter(attr, Constant(value),
                                                 shape, dtype, device))


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
        _affine_params(self, tuple(self.normalized_shape), weight_attr,
                       bias_attr, dtype, device)

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


class _BatchNormBase(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        _affine_params(self, (num_features,), weight_attr, bias_attr, dtype,
                       device)
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight,
                          self.bias, training=self.training,
                          momentum=self.momentum, epsilon=self.epsilon,
                          data_format=self.data_format,
                          use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name,
                         device, dtype)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm: needs the port's collectives (ROADMAP
    A11)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm needs the port's distributed collectives "
            "(ROADMAP A11); use BatchNorm2D on one card")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError(
            "SyncBatchNorm needs the port's distributed collectives "
            "(ROADMAP A11)")


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        _affine_params(self, (num_channels,), weight_attr, bias_attr, dtype,
                       device)

    def forward(self, x):
        return group_norm(x, self.num_groups, self.epsilon, self.weight,
                          self.bias, self.data_format)


class _InstanceNormBase(nn.Module):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__()
        self.num_features = num_features
        self.epsilon = epsilon
        self.data_format = data_format
        _affine_params(self, (num_features,), weight_attr, bias_attr, dtype,
                       device)

    def forward(self, x):
        return instance_norm(x, weight=self.weight, bias=self.bias,
                             eps=self.epsilon, data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(nn.Module):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return local_response_norm(x, self.size, self.alpha, self.beta,
                                   self.k, self.data_format)
