"""Normalisation functions: the port of
``paddle_tpu/nn/functional/norm.py`` (``spectral_norm`` waits for ROADMAP
A12).

Each norm rounds as the JAX package does: statistics and the
normalisation in fp32, the result cast back to ``x``'s dtype, and only
THEN the weight (and bias) applied.  ``torch.nn.functional.layer_norm`` applies the affine in
fp32 and rounds afterwards, which differs in bf16.
"""

from __future__ import annotations

import torch

from ...core.dispatch import op, run_op


@op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    ns = ((normalized_shape,) if isinstance(normalized_shape, int)
          else tuple(normalized_shape))
    axes = tuple(range(x.dim() - len(ns), x.dim()))
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, keepdim=True, correction=0)
    out = ((xf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@op("rms_norm")
def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm with the JAX package's rounding: statistics and the scaling
    in fp32, the result cast back to ``x``'s dtype, THEN multiplied by the
    weight."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


@op("normalize")
def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def _channel_axis(x, data_format):
    if x.dim() == 2:
        return 1
    return x.dim() - 1 if data_format.endswith("C") else 1


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm with Paddle's conventions, as the JAX function computes
    it (``paddle_tpu/nn/functional/norm.py:72``), in the same four ops:

    * ``bn_stats``: batch statistics in fp32 whatever ``x``'s dtype (the
      population variance), differentiated through in training; it also
      returns its fp32 copy of ``x``, which ``batch_norm`` reuses, so a
      bf16 activation is cast once a step and not twice;
    * ``bn_update_mean`` / ``bn_update_var``: ``r = momentum r + (1 -
      momentum) batch``, the variance's batch term times ``n / (n - 1)``,
      in that order of operations, computed in the dtype the op receives
      (at AMP O2 the bus casts both to bf16, as in the JAX package) and
      written IN PLACE into the buffers (so a captured step's replay
      updates the module's own buffers; the JAX package rebinds them, so
      its buffers turn bf16 at O2 where the port's keep their dtype and
      hold the same bf16 values);
    * ``batch_norm``: ``(x - mean) * rsqrt(var + eps)`` in fp32, rounded to
      ``x``'s dtype, THEN the weight and bias, in their dtype's promotion
      with it (bf16 ``x`` and fp32 weights give an fp32 result, bf16
      weights a bf16 one).  The port computes this itself: torch's
      ``batch_norm`` refuses a bf16 input with fp32 statistics.

    ``momentum=0.9`` here is torch's ``momentum=0.1``."""
    ca = _channel_axis(x, data_format)
    axes = tuple(i for i in range(x.dim()) if i != ca)
    shape = [1] * x.dim()
    shape[ca] = -1
    xf = None
    if training and not use_global_stats:
        var, mean, xf = run_op("bn_stats", _bn_stats, x, axes)
        n = 1
        for i in axes:
            n *= x.shape[i]
        unbias = n / max(n - 1, 1)
        with torch.no_grad():
            running_mean.copy_(run_op(
                "bn_update_mean", _bn_update, running_mean, mean.detach(),
                momentum, 1.0))
            running_var.copy_(run_op(
                "bn_update_var", _bn_update, running_var, var.detach(),
                momentum, unbias))
    else:
        mean, var = running_mean, running_var
    if x.dtype == torch.float32:
        xf = None    # at O2 the stats may have seen a bf16 cast of x
    return run_op("batch_norm", _bn_apply, x, mean, var, weight, bias,
                  shape, epsilon, xf)


def _bn_stats(x, axes):
    """``(var, mean, x in fp32)``: the fp32 copy is returned so that the
    normalisation reuses it, one cast of the activation a step."""
    xf = x.to(torch.float32)
    var, mean = torch.var_mean(xf, dim=axes, correction=0)
    return var, mean, xf


def _bn_update(r, batch, momentum, unbias):
    if unbias == 1.0:
        return (momentum * r + (1 - momentum) * batch).to(r.dtype)
    return (momentum * r + (1 - momentum) * batch * unbias).to(r.dtype)


def _bn_apply(x, mean, var, weight, bias, shape, epsilon, xf=None):
    xf = x.to(torch.float32) if xf is None else xf.to(torch.float32)
    out = ((xf - mean.reshape(shape))
           * torch.rsqrt(var.reshape(shape).to(torch.float32) + epsilon))
    return _affine(out.to(x.dtype), weight, bias, shape)


@op("instance_norm")
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each sample's each channel normalised over its spatial dims (fp32
    statistics, the result in ``x``'s dtype, then the affine); the running
    statistics are neither read nor written, as in the JAX function."""
    ca = 1 if not data_format.endswith("C") or x.dim() <= 2 else x.dim() - 1
    axes = (tuple(range(2, x.dim())) if ca == 1
            else tuple(range(1, x.dim() - 1)))
    xf = x.to(torch.float32)
    var, mean = torch.var_mean(xf, dim=axes, correction=0, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    shape = [1] * x.dim()
    shape[ca] = -1
    return _affine(out, weight, bias, shape)


@op("group_norm")
def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format.endswith("C") and x.dim() > 2
    v = x.movedim(-1, 1) if channel_last else x
    N, C = v.shape[:2]
    g = v.reshape((N, num_groups, C // num_groups) + tuple(v.shape[2:]))
    gf = g.to(torch.float32)
    var, mean = torch.var_mean(gf, dim=tuple(range(2, g.dim())),
                               correction=0, keepdim=True)
    out = ((gf - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    out = _affine(out.reshape(v.shape), weight, bias,
                  [1, C] + [1] * (v.dim() - 2))
    return out.movedim(1, -1) if channel_last else out


@op("local_response_norm")
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * s) ** beta`` with ``s`` the sum of squares over
    ``size`` neighbouring channels (``size // 2`` before): the JAX
    function's formula (alpha is not divided by ``size``)."""
    ca = 1 if not data_format.endswith("C") or x.dim() <= 2 else x.dim() - 1
    sq = torch.square(x).movedim(ca, -1)
    half = size // 2
    sq = torch.nn.functional.pad(sq, (half, size - 1 - half))
    summed = sq.unfold(-1, size, 1).sum(-1).movedim(-1, ca)
    return x / (k + alpha * summed) ** beta
