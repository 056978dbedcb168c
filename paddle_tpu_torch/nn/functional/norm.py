"""Normalisation functions (the port of ``paddle_tpu/nn/functional/norm.py``,
the part Llama uses)."""

from __future__ import annotations

import torch


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
