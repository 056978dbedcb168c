"""Common functionals: the port of ``paddle_tpu/nn/functional/common.py``
for ``linear``, ``embedding`` and ``dropout``.  The module's other
functions (pads, interpolation, one-hot, ...) wait for ROADMAP A13's
rest.

``linear`` keeps Paddle's weight layout, ``[in, out]``: a caller passes the
weight itself.  Only the ``Linear`` layer (``nn/common.py``) stores
``[out, in]``.  ``dropout`` draws its mask from ``generator`` (a
``torch.Generator`` on the input's device) when given, else from torch's
default generator; the JAX package draws from its global key, so masks
differ and only their statistics agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...amp.auto_cast import cast_args


def linear(x, weight, bias=None, name=None):
    """``y = x @ W + b`` with ``W`` ``[in, out]`` (Paddle's layout); under
    ``amp.auto_cast`` the JAX op ``linear``'s casts."""
    x, weight, bias = cast_args("linear", x, weight, bias)
    return F.linear(x, weight.t(), bias)


def embedding(x, weight, padding_idx=None, sparse=False, max_norm=None,
              norm_type=2.0, name=None):
    """Rows of ``weight`` at ``x``; where ``x == padding_idx`` the row is
    zero (so is its gradient), as in the JAX package."""
    out = F.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Zero each element (each slice along the dims not in ``axis``, when
    ``axis`` is given) with probability ``p``.  ``upscale_in_train`` scales
    the kept ones by ``1 / (1 - p)`` in training and is the identity in
    eval; ``downscale_in_infer`` keeps them as they are in training and
    multiplies by ``1 - p`` in eval."""
    if not training or p == 0.0:
        if not training and p > 0.0 and mode == "downscale_in_infer":
            return (x * (1.0 - p)).to(x.dtype)
        return x
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, device=x.device, generator=generator) < 1.0 - p
    kept = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)
