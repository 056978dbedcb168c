"""Normalisation layers: the port of ``paddle_tpu/nn/norm.py``
(``SpectralNorm`` waits for ROADMAP A12).

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
    _bn_apply,
    _bn_update,
    _channel_axis,
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


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a group forward; the gradient, which every
    rank's output sends back to the sum, all-reduced backward."""

    @staticmethod
    def forward(ctx, x, group):
        from ..distributed import collective

        ctx.group = group
        return collective.all_reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        from ..distributed import collective

        return collective.all_reduced(g, ctx.group), None


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose training statistics are the whole dp group's
    batch's: each rank's per-channel sums are all-reduced over the
    topology's dp group (else the world), the mean first and then the
    squared deviations from it (the two passes of ``var_mean``), and the
    running statistics take the group's batch size in their ``n / (n -
    1)``.  The JAX layer is one process holding the whole batch; the port's
    ranks, each holding its share, compute its outputs and running
    statistics, and gradients whose sum over the ranks is its gradient.
    Without a group of more than one rank, or in eval, it is
    :class:`BatchNorm`."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, None, name, device, dtype)

    @staticmethod
    def _group():
        from ..distributed import collective, topology

        hcg = topology.get_hybrid_communicate_group()
        return (hcg.get_data_parallel_group() if hcg is not None
                else collective.world_group())

    def forward(self, x):
        group = self._group() if self.training else None
        if group is None or group.nranks == 1:
            return super().forward(x)
        ca = _channel_axis(x, self.data_format)
        axes = tuple(i for i in range(x.dim()) if i != ca)
        shape = [1] * x.dim()
        shape[ca] = -1
        xf = x.to(torch.float32)
        n_local = xf.numel() // xf.shape[ca]
        sums = torch.cat([xf.sum(dim=axes),
                          torch.full((1,), float(n_local), device=x.device)])
        sums = _SumOverGroup.apply(sums, group)
        n = sums[-1].detach()
        mean = sums[:-1] / n
        dev = torch.square(xf - mean.reshape(shape)).sum(dim=axes)
        var = _SumOverGroup.apply(dev, group) / n
        with torch.no_grad():
            unbias = n / torch.clamp(n - 1, min=1)    # no host read
            self._mean.copy_(_bn_update(self._mean, mean.detach(),
                                        self.momentum, 1.0))
            self._variance.copy_(
                (self.momentum * self._variance + (1 - self.momentum)
                 * var.detach() * unbias).to(self._variance.dtype))
        return _bn_apply(x, mean, var, self.weight, self.bias, shape,
                         self.epsilon, xf)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm in it replaced by a
        ``SyncBatchNorm`` holding its parameters and running statistics
        (``layer`` itself when it is a batch norm: its replacement)."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            w = layer.weight if layer.weight is not None else layer._mean
            out = cls(layer.num_features, layer.momentum, layer.epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer.data_format, device=w.device,
                      dtype=w.dtype)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    if getattr(layer, name) is not None:
                        getattr(out, name).copy_(getattr(layer, name))
                out._mean.copy_(layer._mean)
                out._variance.copy_(layer._variance)
            out.train(layer.training)
            return out
        for name, child in list(layer.named_children()):
            new = cls.convert_sync_batchnorm(child)
            if new is not child:
                setattr(layer, name, new)
        return layer


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
