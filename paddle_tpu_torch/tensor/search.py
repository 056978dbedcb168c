"""Search, sort and statistics ops: the port of
``paddle_tpu/tensor/search.py``.

``argmax`` / ``argmin`` without an axis index the flattened tensor;
``topk`` takes the last axis by default and returns int64 indices;
``where`` with only a condition is ``nonzero(as_tuple=True)``;
``median`` averages the two middle values (``mode="avg"``) or takes the
lower one; ``kthvalue`` is 1-based.  ``nonzero``, ``histogram``,
``histogramdd`` and ``bincount`` have data-dependent shapes and read the
data, as the JAX ones do.  ``top_p_sampling`` draws from the port's RNG
(``core/random.py``), so its draws differ from the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import random as rng
from ..core.dispatch import run_op
from ..core.tensor import to_tensor


def _ensure(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _axis(axis):
    if isinstance(axis, torch.Tensor):
        return int(axis.item())
    return axis


def _arg(fn, v, axis, keepdim, d):
    if axis is None:
        out = fn(v.reshape(-1))
        return out.reshape((1,) * v.dim()).to(d) if keepdim else out.to(d)
    return fn(v, dim=_axis(axis), keepdim=keepdim).to(d)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = dtype_mod.convert_dtype(dtype)
    return run_op("argmax", lambda v: _arg(torch.argmax, v, axis, keepdim,
                                           d), _ensure(x))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    d = dtype_mod.convert_dtype(dtype)
    return run_op("argmin", lambda v: _arg(torch.argmin, v, axis, keepdim,
                                           d), _ensure(x))


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return run_op("argsort", lambda v: torch.argsort(
        v, dim=_axis(axis), descending=descending, stable=stable),
        _ensure(x))


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return run_op("sort", lambda v: torch.sort(
        v, dim=_axis(axis), descending=descending, stable=stable).values,
        _ensure(x))


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    k = int(k.item()) if isinstance(k, torch.Tensor) else k

    def f(v):
        ax = v.dim() - 1 if axis is None else _axis(axis)
        r = torch.topk(v, k, dim=ax, largest=largest, sorted=True)
        return r.values, r.indices

    return tuple(run_op("topk", f, _ensure(x)))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(v):
        ax = _axis(axis) % v.dim()
        vals, idxs = torch.sort(v, dim=ax, stable=True)
        tk = vals.select(ax, k - 1)
        ti = idxs.select(ax, k - 1)
        if keepdim:
            tk, ti = tk.unsqueeze(ax), ti.unsqueeze(ax)
        return tk, ti

    return tuple(run_op("kthvalue", f, _ensure(x)))


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the first in order among
    equally frequent ones) and the LAST index where it occurs, as the JAX
    op computes them."""
    def f(v):
        ax = _axis(axis) % v.dim()
        vm = v.movedim(ax, -1)
        n = vm.shape[-1]
        counts = (vm[..., :, None] == vm[..., None, :]).sum(-1)
        best = torch.argmax(counts, dim=-1)
        val = torch.gather(vm, -1, best[..., None])[..., 0]
        pos = torch.arange(n, device=v.device)
        idx = torch.where(vm == val[..., None], pos,
                          torch.full_like(pos, -1)).amax(-1)
        if keepdim:
            val = val[..., None].movedim(-1, ax)
            idx = idx[..., None].movedim(-1, ax)
        return val, idx

    return tuple(run_op("mode", f, _ensure(x)))


def nonzero(x, as_tuple=False):
    t = _ensure(x)
    if as_tuple:
        return tuple(torch.nonzero(t, as_tuple=True))
    return torch.nonzero(t)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)

    def f(c, a, b):
        return torch.where(c.bool(), a, b)

    return run_op("where", f, _ensure(condition), _ensure(x), _ensure(y))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return run_op("searchsorted", lambda s, v: torch.searchsorted(
        s, v, out_int32=out_int32, right=right), _ensure(sorted_sequence),
        _ensure(values))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def index_fill(x, index, axis, value, name=None):
    return run_op("index_fill", lambda v, idx: torch.index_fill(
        v, axis, idx.long().to(v.device), value), _ensure(x),
        _ensure(index))


# --- statistics -------------------------------------------------------------

def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return run_op("std", lambda v: torch.std(
        v, dim=_ax(axis), correction=1 if unbiased else 0, keepdim=keepdim),
        _ensure(x))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return run_op("var", lambda v: torch.var(
        v, dim=_ax(axis), correction=1 if unbiased else 0, keepdim=keepdim),
        _ensure(x))


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    def f(v):
        ax = _axis(axis)
        if mode == "avg":
            if ax is None:
                return torch.quantile(v.reshape(-1), 0.5)
            return torch.quantile(v, 0.5, dim=ax, keepdim=keepdim)
        if ax is None:
            flat = torch.sort(v.reshape(-1)).values
            return flat[(flat.shape[0] - 1) // 2]
        out = torch.sort(v, dim=ax).values.select(ax, (v.shape[ax] - 1) // 2)
        return out.unsqueeze(ax) if keepdim else out

    return run_op("median", f, _ensure(x))


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    def f(v):
        ax = _axis(axis)
        if ax is None:
            return torch.nanquantile(v.reshape(-1), 0.5)
        return torch.nanquantile(v, 0.5, dim=ax, keepdim=keepdim)

    return run_op("nanmedian", f, _ensure(x))


def _quantile(fn, v, q, axis, keepdim, interpolation):
    qv = q.to(v.device, v.dtype) if isinstance(q, torch.Tensor) else \
        torch.as_tensor(q, dtype=v.dtype, device=v.device)
    if isinstance(axis, (list, tuple)):
        # several axes: move them last, flatten them, take the quantile
        axes = [a % v.dim() for a in axis]
        rest = [i for i in range(v.dim()) if i not in axes]
        flat = v.permute(rest + axes).reshape(
            [v.shape[i] for i in rest] + [-1])
        out = fn(flat, qv, dim=-1, interpolation=interpolation)
        if keepdim:
            for a in sorted(axes):
                out = out.unsqueeze(a + (out.dim() - len(rest)))
        return out
    if axis is None:
        out = fn(v.reshape(-1), qv, interpolation=interpolation)
        if keepdim:
            out = out.reshape(out.shape + (1,) * v.dim())
        return out
    return fn(v, qv, dim=axis, keepdim=keepdim, interpolation=interpolation)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return run_op("quantile", lambda v: _quantile(
        torch.quantile, v, q, axis, keepdim, interpolation), _ensure(x))


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return run_op("nanquantile", lambda v: _quantile(
        torch.nanquantile, v, q, axis, keepdim, interpolation), _ensure(x))


def _host(t):
    return t.detach().cpu().numpy()


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    t = _ensure(input)
    xv = _host(t)
    lo, hi = (min, max) if (min != 0 or max != 0) else (xv.min(), xv.max())
    wv = _host(weight) if isinstance(weight, torch.Tensor) else weight
    h, _ = np.histogram(xv.reshape(-1), bins=bins, range=(lo, hi),
                        weights=wv, density=density)
    out = h if density or weight is not None else h.astype(np.int64)
    return to_tensor(out, place=t.device)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    t = _ensure(x)
    wv = _host(weights) if isinstance(weights, torch.Tensor) else weights
    h, edges = np.histogramdd(_host(t), bins=bins, range=ranges,
                              density=density, weights=wv)
    return (to_tensor(h, place=t.device),
            [to_tensor(e, place=t.device) for e in edges])


def bincount(x, weights=None, minlength=0, name=None):
    t = _ensure(x)
    wv = _host(weights) if isinstance(weights, torch.Tensor) else weights
    return to_tensor(np.bincount(_host(t), weights=wv, minlength=minlength),
                     place=t.device)


def top_p_sampling(x, ps, threshold=None, seed=None, name=None):
    """Nucleus sampling per row of probabilities ``x``: the smallest
    descending prefix whose mass reaches ``ps`` (at least one token), less
    what is below ``threshold``, renormalised; one draw a row.  Returns
    ``(values, ids)`` with a trailing dim of 1."""
    t, p = _ensure(x), _ensure(ps)
    gen = (torch.Generator(device=t.device).manual_seed(seed)
           if seed is not None and seed >= 0 else rng.generator_for(t.device))

    def f(probs, pv):
        order = torch.argsort(-probs, dim=-1, stable=True)
        sorted_p = torch.gather(probs, -1, order)
        cum = torch.cumsum(sorted_p, -1)
        keep = (cum - sorted_p) < pv.to(probs.device)[..., None]
        if threshold is not None:
            keep = keep & (sorted_p >= threshold)
            keep[..., 0] |= ~keep.any(-1)
        masked = torch.where(keep, sorted_p, torch.zeros_like(sorted_p))
        masked = masked / masked.sum(-1, keepdim=True).clamp(min=1e-9)
        flat = masked.reshape(-1, masked.shape[-1])
        choice = torch.multinomial(flat, 1, generator=gen).reshape(
            masked.shape[:-1] + (1,))
        ids = torch.gather(order, -1, choice)
        return torch.gather(probs, -1, ids), ids

    return run_op("top_p_sampling", f, t, p)
