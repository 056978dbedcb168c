"""Pooling: the port of ``paddle_tpu/nn/functional/pooling.py``.

The JAX package pools with ``lax.reduce_window`` (XLA code); the port with
``torch.nn.functional``'s pools on an input padded beforehand, so any
padding (an int, one a dim, or ``"SAME"`` / ``"VALID"``) reads as the JAX
function reads it: max pools pad with ``-inf``; average pools sum the
window (``divisor_override=1``) and divide by the count of real elements
(``exclusive=True``, the default) or by the window's size.  Adaptive pools
take Paddle's windows, ``[floor(i n / m), ceil((i + 1) n / m))``, which
are torch's.

Departures from the JAX package, each where it ignores an argument:

* ``ceil_mode=True`` keeps the last, partial window (Paddle's and torch's
  rule: a window must start inside the input or its leading padding); the
  JAX function ignores ``ceil_mode``.
* ``adaptive_max_pool*d(return_mask=True)`` returns ``(out, mask)``, the
  flat spatial index of each maximum; the JAX function returns ``out``
  alone.

``return_mask`` of the max pools is the flat index, in the unpadded
input's spatial dims, of the first maximum of each window.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import op

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else [v[0]] * n))
    return (int(v),) * n


def _pads(padding, n, spatial, k, s, ceil_mode):
    """(before, after) a spatial dim: the padding asked for, plus what a
    ceil-mode window past the end needs."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        pads = []
        for i in range(n):
            total = max((math.ceil(spatial[i] / s[i]) - 1) * s[i] + k[i]
                        - spatial[i], 0)
            pads.append((total // 2, total - total // 2))
        return pads
    pads = [(p, p) for p in _tup(padding, n)]
    if ceil_mode:
        for i in range(n):
            lo, hi = pads[i]
            span = spatial[i] + lo + hi - k[i]
            out = -(-span // s[i]) + 1
            if (out - 1) * s[i] >= spatial[i] + lo:
                out -= 1
            extra = max((out - 1) * s[i] + k[i] - (spatial[i] + lo + hi), 0)
            pads[i] = (lo, hi + extra)
    return pads


def _padded(v, pads, value):
    if not any(lo or hi for lo, hi in pads):
        return v
    return TF.pad(v, [p for pair in reversed(pads) for p in pair],
                  value=value)


def _as_2d(pool_fn, v, k, s, n, **kw):
    """1-d windows through the 2-d pool (torch has no divisor_override in
    1-d)."""
    if n == 1:
        return pool_fn(v.unsqueeze(-2), (1, k[0]), (1, s[0]),
                       **kw).squeeze(-2)
    return pool_fn(v, k, s, **kw)


def _pool(x, kernel, stride, padding, n, op, channel_last, ceil_mode=False,
          exclusive=True, return_mask=False):
    k = _tup(kernel, n)
    s = _tup(stride if stride is not None else kernel, n)
    v = x.movedim(-1, 1) if channel_last else x
    spatial = tuple(v.shape[2:])
    pads = _pads(padding, n, spatial, k, s, ceil_mode)
    if op == "max":
        if all(lo == hi and lo <= ki // 2 for (lo, hi), ki in zip(pads, k)):
            # torch pads with -inf itself and indexes the unpadded input
            res = _MAX[n](v, k, s, tuple(lo for lo, _ in pads),
                          return_indices=return_mask)
            out, mask = res if return_mask else (res, None)
        else:
            fill = (float("-inf") if v.is_floating_point()
                    else torch.iinfo(v.dtype).min)
            res = _MAX[n](_padded(v, pads, fill), k, s,
                          return_indices=return_mask)
            out, mask = res if return_mask else (res, None)
            if return_mask:
                mask = _unpadded_index(mask, spatial, pads)
        if return_mask:
            mask = mask.to(torch.int32)
            if channel_last:
                return out.movedim(1, -1), mask.movedim(1, -1)
            return out, mask
    else:
        summed = _as_2d(lambda *a, **kw: _AVG[max(n, 2)](*a, **kw),
                        _padded(v, pads, 0.0), k, s, n, divisor_override=1)
        if exclusive:
            ones = torch.ones((1, 1) + spatial, dtype=v.dtype,
                              device=v.device)
            counts = _as_2d(lambda *a, **kw: _AVG[max(n, 2)](*a, **kw),
                            _padded(ones, pads, 0.0), k, s, n,
                            divisor_override=1)
            out = summed / counts
        else:
            out = summed / float(np.prod(k))
    return out.movedim(1, -1) if channel_last else out


def _unpadded_index(idx, spatial, pads):
    """Flat indices into the padded spatial dims → the unpadded input's."""
    padded = [n + lo + hi for n, (lo, hi) in zip(spatial, pads)]
    flat = torch.zeros_like(idx)
    rem = idx
    coords = []
    for size in reversed(padded):
        coords.append(rem % size)
        rem = rem // size
    coords.reverse()
    for c, n, (lo, _) in zip(coords, spatial, pads):
        flat = flat * n + (c - lo)
    return flat.to(torch.int32)


@op("max_pool1d")
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "max",
                 data_format == "NLC", ceil_mode, return_mask=return_mask)


@op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _pool(x, kernel_size, stride, padding, 2, "max",
                 data_format == "NHWC", ceil_mode, return_mask=return_mask)


@op("max_pool3d")
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _pool(x, kernel_size, stride, padding, 3, "max",
                 data_format == "NDHWC", ceil_mode, return_mask=return_mask)


@op("avg_pool1d")
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg",
                 data_format == "NLC", ceil_mode, exclusive)


@op("avg_pool2d")
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg",
                 data_format == "NHWC", ceil_mode, exclusive)


@op("avg_pool3d")
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg",
                 data_format == "NDHWC", ceil_mode, exclusive)


def _adaptive(x, output_size, n, op, channel_last, return_mask=False):
    o = _tup(output_size, n)
    v = x.movedim(-1, 1) if channel_last else x
    fn = _ADAPTIVE[(op, n)]
    if op == "max" and return_mask:
        out, idx = fn(v, o, return_indices=True)
        return out, idx.to(torch.int32)
    out = fn(v, o)
    return out.movedim(1, -1) if channel_last else out


@op("adaptive_avg_pool1d")
def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", False)


@op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format == "NHWC")


@op("adaptive_avg_pool3d")
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format == "NDHWC")


@op("adaptive_max_pool1d")
def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "max", False, return_mask)


@op("adaptive_max_pool2d")
def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "max", False, return_mask)


@op("adaptive_max_pool3d")
def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "max", False, return_mask)


def _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode, n,
             channel_last):
    """``(sum over the window of |x|^p)^(1/p)``: the JAX function's window
    mean of ``|x|^p`` times the window size, then the root."""
    p = float(norm_type)
    pooled = _pool(torch.abs(x) ** p, kernel_size, stride, padding, n,
                   "avg", channel_last, ceil_mode, exclusive=False)
    k = _tup(kernel_size, n)
    return (pooled * float(np.prod(k))) ** (1.0 / p)


@op("lp_pool1d")
def lp_pool1d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCL", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    1, data_format == "NLC")


@op("lp_pool2d")
def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    return _lp_pool(x, norm_type, kernel_size, stride, padding, ceil_mode,
                    2, data_format == "NHWC")
