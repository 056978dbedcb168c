"""Normalisation functions (the port of ``paddle_tpu/nn/functional/norm.py``
for ``layer_norm`` and ``rms_norm``; batch norm and the others wait for
ROADMAP A12).

Both round as the JAX package does: statistics and the normalisation in
fp32, the result cast back to ``x``'s dtype, and only THEN the weight (and
bias) applied.  ``torch.nn.functional.layer_norm`` applies the affine in
fp32 and rounds afterwards, which differs in bf16.
"""

from __future__ import annotations

import torch


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
