"""Shape and layout ops: the port of ``paddle_tpu/tensor/manipulation.py``.

Paddle's meanings: ``reshape`` keeps a dim where the shape says 0,
``transpose`` takes a full permutation, ``split`` takes a section count or
sizes (one of them -1), ``squeeze`` drops only the listed dims of size 1,
``expand`` keeps a dim where the shape says -1, ``gather`` / ``scatter``
work on rows of the first axis.  Every op runs through the op bus under
the JAX op's name; the host ops (``masked_select``, ``unique``,
``unique_consecutive``, ``as_strided``) read the data, as the JAX ones
do.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.tensor import to_tensor


def _ensure(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _ints(seq):
    if isinstance(seq, torch.Tensor):
        return tuple(int(v) for v in seq.reshape(-1).tolist())
    if isinstance(seq, (int, np.integer)):
        return (int(seq),)
    return tuple(int(s) for s in seq)


def _paddle_shape(v, shape):
    """Paddle's reshape target: 0 keeps the input's dim."""
    return tuple(v.shape[i] if s == 0 else s for i, s in enumerate(shape))


def reshape(x, shape, name=None):
    shp = _ints(shape)
    return run_op("reshape", lambda v: torch.reshape(
        v, _paddle_shape(v, shp)), _ensure(x))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    d = dtype_mod.convert_dtype(shape_or_dtype)
    return run_op("view_dtype", lambda v: v.view(d), _ensure(x))


def transpose(x, perm, name=None):
    p = _ints(perm)
    return run_op("transpose", lambda v: v.permute(p), _ensure(x))


def t(x, name=None):
    return run_op("t", lambda v: v.t() if v.dim() <= 2
                  else v.transpose(-1, -2), _ensure(x))


def moveaxis(x, source, destination, name=None):
    return run_op("moveaxis", lambda v: torch.movedim(v, source, destination),
                  _ensure(x))


def swapaxes(x, axis1, axis2, name=None):
    return run_op("swapaxes", lambda v: torch.transpose(v, axis1, axis2),
                  _ensure(x))


swapdims = swapaxes


def _axis_int(axis):
    return int(axis.item()) if isinstance(axis, torch.Tensor) else axis


def concat(x, axis=0, name=None):
    ts = [_ensure(t) for t in x]
    axis = _axis_int(axis)
    return run_op("concat", lambda *xs: torch.cat(xs, axis), *ts)


def stack(x, axis=0, name=None):
    ts = [_ensure(t) for t in x]
    return run_op("stack", lambda *xs: torch.stack(xs, axis), *ts)


def hstack(x, name=None):
    ts = [_ensure(t) for t in x]
    return run_op("hstack", lambda *xs: torch.hstack(xs), *ts)


def vstack(x, name=None):
    ts = [_ensure(t) for t in x]
    return run_op("vstack", lambda *xs: torch.vstack(xs), *ts)


def dstack(x, name=None):
    ts = [_ensure(t) for t in x]
    return run_op("dstack", lambda *xs: torch.dstack(xs), *ts)


def column_stack(x, name=None):
    ts = [_ensure(t) for t in x]
    return run_op("column_stack", lambda *xs: torch.column_stack(xs), *ts)


def row_stack(x, name=None):
    ts = [_ensure(t) for t in x]
    return run_op("row_stack", lambda *xs: torch.vstack(xs), *ts)


def split(x, num_or_sections, axis=0, name=None):
    """Paddle's split: a count of equal sections (which must divide the
    dim), or the section sizes with at most one -1."""
    x = _ensure(x)
    axis = _axis_int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"paddle.split: dimension {dim} on axis {axis} is not "
                f"divisible by num {num_or_sections}; pass explicit sections "
                f"instead")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = list(_ints(num_or_sections))
        if builtins.any(s < 0 for s in sections):
            known = builtins.sum(s for s in sections if s >= 0)
            sections = [s if s >= 0 else dim - known for s in sections]
    return list(run_op("split", lambda v: tuple(torch.split(
        v, sections, dim=axis)), x))


def chunk(x, chunks, axis=0, name=None):
    x = _ensure(x)
    dim = x.shape[axis]
    base = (dim + chunks - 1) // chunks
    sections, rem = [], dim
    while rem > 0:
        sections.append(builtins.min(base, rem))
        rem -= base
    return split(x, sections, axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    x = _ensure(x)
    dim = x.shape[axis]
    if isinstance(num_or_indices, int):
        base, extra = divmod(dim, num_or_indices)
        sections = [base + (1 if i < extra else 0)
                    for i in range(num_or_indices)]
        return split(x, sections, axis)
    idx = [0] + list(_ints(num_or_indices)) + [dim]
    return split(x, [idx[i + 1] - idx[i] for i in range(len(idx) - 1)], axis)


def split_by_indices(t, num_or_indices, axis):
    """numpy-style split: an int is equal sections, a list the cuts."""
    t = _ensure(t)
    n = t.shape[axis]
    if isinstance(num_or_indices, int):
        if n % num_or_indices != 0:
            raise ValueError(
                f"dim {axis} size {n} not divisible into {num_or_indices}")
        cuts = [n // num_or_indices * i for i in range(1, num_or_indices)]
    else:
        cuts = list(_ints(num_or_indices))
    bounds = [0] + cuts + [n]
    sizes = [bounds[i + 1] - bounds[i] for i in range(len(bounds) - 1)]
    return list(run_op("split_by_indices", lambda v: tuple(torch.split(
        v, sizes, dim=axis)), t))


def hsplit(x, num_or_indices, name=None):
    t = _ensure(x)
    return split_by_indices(t, num_or_indices, 0 if t.dim() == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return split_by_indices(_ensure(x), num_or_indices, 0)


def dsplit(x, num_or_indices, name=None):
    return split_by_indices(_ensure(x), num_or_indices, 2)


def squeeze(x, axis=None, name=None):
    """Drop the listed dims that have size 1 (all size-1 dims without
    ``axis``); a listed dim of another size stays."""
    x = _ensure(x)
    if axis is None:
        return run_op("squeeze", torch.squeeze, x)
    ax = _ints(axis if isinstance(axis, (list, tuple)) else [axis])
    ax = tuple(a for a in ax if x.shape[a] == 1)
    return run_op("squeeze", lambda v: torch.squeeze(v, ax) if ax else v, x)


def unsqueeze(x, axis, name=None):
    ax = _ints(axis if isinstance(axis, (list, tuple, torch.Tensor))
               else [axis])

    def f(v):
        nd = v.dim() + len(ax)
        for a in sorted(a % nd for a in ax):
            v = v.unsqueeze(a)
        return v

    return run_op("unsqueeze", f, _ensure(x))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = _ensure(x)
    if x.dim() == 0:
        return run_op("flatten", lambda v: v.reshape(1), x)
    return run_op("flatten", lambda v: torch.flatten(v, start_axis,
                                                     stop_axis), x)


def tile(x, repeat_times, name=None):
    r = _ints(repeat_times)
    return run_op("tile", lambda v: torch.tile(v, r), _ensure(x))


def expand(x, shape, name=None):
    tgt = _ints(shape)

    def f(v):
        full = list(tgt)
        off = len(full) - v.dim()
        for i in range(v.dim()):
            if full[off + i] == -1:
                full[off + i] = v.shape[i]
        return v.expand(tuple(full))

    return run_op("expand", f, _ensure(x))


def expand_as(x, y, name=None):
    return run_op("expand_as", lambda v, w: v.expand(w.shape), _ensure(x),
                  _ensure(y))


def broadcast_to(x, shape, name=None):
    s = _ints(shape)
    return run_op("broadcast_to", lambda v: torch.broadcast_to(v, s),
                  _ensure(x))


def broadcast_tensors(inputs, name=None):
    ts = [_ensure(t) for t in inputs]
    return list(run_op("broadcast_tensors",
                       lambda *xs: tuple(torch.broadcast_tensors(*xs)), *ts))


def flip(x, axis, name=None):
    ax = _ints(axis if isinstance(axis, (list, tuple)) else [axis])
    return run_op("flip", lambda v: torch.flip(v, ax), _ensure(x))


def rot90(x, k=1, axes=(0, 1), name=None):
    return run_op("rot90", lambda v: torch.rot90(v, k, tuple(axes)),
                  _ensure(x))


def roll(x, shifts, axis=None, name=None):
    sh = _ints(shifts) if isinstance(shifts, (list, tuple)) else int(shifts)
    ax = (_ints(axis) if isinstance(axis, (list, tuple))
          else (int(axis) if axis is not None else None))

    def f(v):
        if ax is None:
            return torch.roll(v, sh)
        return torch.roll(v, sh, ax)

    return run_op("roll", f, _ensure(x))


def _long(idx, like):
    return idx.long().to(like.device)


def gather(x, index, axis=0, name=None):
    axis = _axis_int(axis)
    return run_op("gather", lambda v, idx: torch.index_select(
        v, axis, _long(idx, v).reshape(-1)), _ensure(x), _ensure(index))


def gather_nd(x, index, name=None):
    def f(v, idx):
        idx = _long(idx, v)
        return v[tuple(idx.movedim(-1, 0))]

    return run_op("gather_nd", f, _ensure(x), _ensure(index))


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` replaced by ``updates`` (the last write of a
    repeated index wins, as XLA's scatter), or with ``overwrite=False``
    zeroed and then summed over the repeats."""
    def f(v, idx, upd):
        idx = _long(idx, v).reshape(-1)
        if overwrite:
            out = v.clone()
            out[idx] = upd.to(v.dtype)
            return out
        return v.index_fill(0, idx, 0).index_add(0, idx, upd.to(v.dtype))

    return run_op("scatter", f, _ensure(x), _ensure(index), _ensure(updates))


def scatter_nd_add(x, index, updates, name=None):
    def f(v, idx, upd):
        idx = _long(idx, v)
        return v.index_put(tuple(idx.movedim(-1, 0)), upd.to(v.dtype),
                           accumulate=True)

    return run_op("scatter_nd_add", f, _ensure(x), _ensure(index),
                  _ensure(updates))


def scatter_nd(index, updates, shape, name=None):
    s = _ints(shape)

    def f(idx, upd):
        z = torch.zeros(s, dtype=upd.dtype, device=upd.device)
        return z.index_put(tuple(_long(idx, upd).movedim(-1, 0)), upd,
                           accumulate=True)

    return run_op("scatter_nd", f, _ensure(index), _ensure(updates))


def index_select(x, index, axis=0, name=None):
    return run_op("index_select", lambda v, idx: torch.index_select(
        v, axis, _long(idx, v).reshape(-1)), _ensure(x), _ensure(index))


def index_sample(x, index, name=None):
    return run_op("index_sample", lambda v, idx: torch.gather(
        v, 1, _long(idx, v)), _ensure(x), _ensure(index))


def index_add(x, index, axis, value, name=None):
    return run_op("index_add", lambda v, idx, val: torch.index_add(
        v, axis, _long(idx, v), val.to(v.dtype)), _ensure(x),
        _ensure(index), _ensure(value))


def index_put(x, indices, value, accumulate=False, name=None):
    def f(v, val):
        idx = tuple(_long(i, v) if isinstance(i, torch.Tensor)
                    and i.dtype != torch.bool else i for i in indices)
        return v.index_put(idx, val.to(v.dtype), accumulate=accumulate)

    return run_op("index_put", f, _ensure(x), _ensure(value))


def masked_select(x, mask, name=None):
    """A host op: the selected count is data (as the JAX one)."""
    x, mask = _ensure(x), _ensure(mask)
    return torch.masked_select(x, mask.to(x.device).bool())


def masked_fill(x, mask, value, name=None):
    def f(v, m):
        val = value.to(v.dtype) if isinstance(value, torch.Tensor) else value
        return torch.where(m.bool(), torch.as_tensor(val, dtype=v.dtype,
                                                     device=v.device), v)

    return run_op("masked_fill", f, _ensure(x), _ensure(mask))


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    def f(v, idx):
        idx = _long(idx, v)
        if broadcast:
            shape = [builtins.max(a, b) if i != axis % v.dim() else b
                     for i, (a, b) in enumerate(zip(v.shape, idx.shape))]
            idx = idx.expand(shape)
            vshape = list(shape)
            vshape[axis % v.dim()] = v.shape[axis]
            v = v.expand(vshape)
        return torch.gather(v, axis, idx)

    return run_op("take_along_axis", f, _ensure(arr), _ensure(indices))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    def f(v, idx, val):
        idx = _long(idx, v)
        val = torch.broadcast_to(val.to(v.dtype), idx.shape)
        if reduce == "assign":
            return torch.scatter(v, axis, idx, val)
        if reduce in ("add", "sum"):
            return torch.scatter_add(v, axis, idx, val)
        if reduce in ("mul", "multiply"):
            return torch.scatter_reduce(v, axis, idx, val, "prod")
        raise ValueError(f"unknown reduce {reduce}")

    return run_op("put_along_axis", f, _ensure(arr), _ensure(indices),
                  _ensure(values))


def repeat_interleave(x, repeats, axis=None, name=None):
    def f(v):
        r = repeats.to(v.device) if isinstance(repeats, torch.Tensor) \
            else repeats
        if axis is None:
            return torch.repeat_interleave(v.reshape(-1), r)
        return torch.repeat_interleave(v, r, dim=axis)

    return run_op("repeat_interleave", f, _ensure(x))


def unbind(x, axis=0, name=None):
    return list(run_op("unbind", lambda v: torch.unbind(v, axis),
                       _ensure(x)))


def unstack(x, axis=0, num=None):
    t = _ensure(x)
    n = t.shape[axis]
    if num is not None and num != n:
        raise ValueError(f"num ({num}) != dim size ({n})")
    return list(run_op("unstack", lambda v: torch.unbind(v, axis), t))


def slice(input, axes, starts, ends, name=None):
    axes, starts, ends = _ints(axes), _ints(starts), _ints(ends)

    def f(v):
        idx = [builtins.slice(None)] * v.dim()
        for a, s, e in zip(axes, starts, ends):
            idx[a] = builtins.slice(s, e)
        return v[tuple(idx)]

    return run_op("slice", f, _ensure(input))


def _strided(v, axes, starts, ends, strides):
    """``v``'s strided slice, negative strides included (torch slicing
    takes none: flip, then slice the mirrored bounds)."""
    for a, s, e, st in zip(axes, starts, ends, strides):
        n = v.shape[a]
        if st > 0:
            v = v[(builtins.slice(None),) * (a % v.dim())
                  + (builtins.slice(s, e, st),)]
        else:
            r = builtins.range(n)[builtins.slice(s, e, st)]
            idx = torch.as_tensor(list(r), dtype=torch.long, device=v.device)
            v = torch.index_select(v, a, idx)
    return v


def strided_slice(x, axes, starts, ends, strides, name=None):
    axes, starts, ends, strides = map(_ints, (axes, starts, ends, strides))
    return run_op("strided_slice", lambda v: _strided(
        v, axes, starts, ends, strides), _ensure(x))


def crop(x, shape=None, offsets=None, name=None):
    shp = _ints(shape)
    off = _ints(offsets) if offsets is not None else (0,) * len(shp)

    def f(v):
        for a, (o, n) in enumerate(zip(off, shp)):
            n = v.shape[a] - o if n == -1 else n
            v = v.narrow(a, o, n)
        return v

    return run_op("crop", f, _ensure(x))


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ..nn import functional as F

    return F.pad(x, pad, mode=mode, value=value, data_format=data_format)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """A host op over ``numpy.unique`` (as the JAX one); the results on
    ``x``'s device."""
    t = _ensure(x)
    res = np.unique(t.detach().cpu().numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return to_tensor(res, place=t.device)
    return tuple(to_tensor(r, place=t.device) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    t = _ensure(x)
    if axis is not None:
        raise NotImplementedError(
            "unique_consecutive with axis is not supported (as in the JAX "
            "package)")
    out = torch.unique_consecutive(t.reshape(-1),
                                   return_inverse=return_inverse,
                                   return_counts=return_counts)
    return out


def as_strided(x, shape, stride, offset=0, name=None):
    t = _ensure(x).contiguous()
    return torch.as_strided(t.reshape(-1), _ints(shape), _ints(stride),
                            offset).clone()


def tensordot(x, y, axes=2, name=None):
    ax = axes.tolist() if isinstance(axes, torch.Tensor) else axes
    return run_op("tensordot", lambda a, b: torch.tensordot(a, b, dims=ax),
                  _ensure(x), _ensure(y))


def _atleast(opname, fn, inputs):
    outs = [run_op(opname, fn, _ensure(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs, name=None):
    return _atleast("atleast_1d", torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast("atleast_2d", torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    return _atleast("atleast_3d", lambda v: v.reshape(1, 1, 1)
                    if v.dim() == 0 else v.reshape(1, -1, 1)
                    if v.dim() == 1 else v.unsqueeze(-1)
                    if v.dim() == 2 else v, inputs)


def unfold(x, axis, size, step, name=None):
    """Windows of ``size`` every ``step`` along ``axis``, laid out as the
    JAX op stacks them: the window index at ``axis``, each window's
    elements right after it."""
    def f(v):
        w = v.unfold(axis, size, step)          # axis: windows, last: size
        return w.movedim(-1, (axis % v.dim()) + 1)

    return run_op("unfold", f, _ensure(x))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(v):
        size = index_num // nshards
        return torch.where(v // size == shard_id, v % size,
                           torch.full_like(v, ignore_value))

    return run_op("shard_index", f, _ensure(input))


def cast(x, dtype):
    d = dtype_mod.convert_dtype(dtype)
    return run_op("cast", lambda v: v.to(d), _ensure(x))


def unflatten(x, axis, shape, name=None):
    t = _ensure(x)
    return run_op("unflatten", lambda v: torch.unflatten(
        v, axis, _ints(shape)), t)


def view_as(x, other, name=None):
    return reshape(x, list(_ensure(other).shape))


def as_complex(x, name=None):
    t = _ensure(x)
    if t.shape[-1] != 2:
        raise ValueError(
            f"as_complex requires the last dimension to be 2, got shape "
            f"{tuple(t.shape)}")
    return run_op("as_complex", lambda v: torch.complex(v[..., 0],
                                                        v[..., 1]), t)


def as_real(x, name=None):
    return run_op("as_real", lambda v: torch.stack(
        [torch.real(v), torch.imag(v)], -1), _ensure(x))


def tolist(x):
    return _ensure(x).tolist()


def masked_scatter(x, mask, value, name=None):
    """The ``True`` positions of ``mask`` filled with ``value``'s elements
    in row-major order."""
    t, m, v = _ensure(x), _ensure(mask), _ensure(value)
    needed = int(torch.broadcast_to(m.bool(), t.shape).sum())
    if v.numel() < needed:
        raise ValueError(
            f"masked_scatter: value has {v.numel()} elements but mask "
            f"selects {needed}")

    def f(xv, vv):
        return torch.masked_scatter(xv, torch.broadcast_to(
            m.to(xv.device).bool(), xv.shape), vv.to(xv.dtype))

    return run_op("masked_scatter", f, t, v)


def _diag_plane_indices(shape, offset, dim1, dim2):
    n1, n2 = shape[dim1], shape[dim2]
    if offset >= 0:
        dlen = builtins.max(0, builtins.min(n1, n2 - offset))
        i1, i2 = np.arange(dlen), np.arange(dlen) + offset
    else:
        dlen = builtins.max(0, builtins.min(n1 + offset, n2))
        i1, i2 = np.arange(dlen) - offset, np.arange(dlen)
    return i1, i2, dlen


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``y`` written onto the (offset) diagonal of the dim1/dim2 plane;
    y's last dim runs along the diagonal."""
    t, s = _ensure(x), _ensure(y)
    nd = t.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    i1, i2, dlen = _diag_plane_indices(t.shape, offset, d1, d2)

    def f(xv, yv):
        rest = [i for i in range(nd) if i not in (d1, d2)]
        perm = rest + [d1, d2]
        moved = xv.permute(perm).clone()
        yv = torch.broadcast_to(yv.to(xv.dtype),
                                tuple(moved.shape[:-2]) + (dlen,))
        moved[..., torch.as_tensor(i1, device=xv.device),
              torch.as_tensor(i2, device=xv.device)] = yv
        return moved.permute(tuple(np.argsort(perm).tolist()))

    return run_op("fill_diagonal_tensor", f, t, s)


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return fill_diagonal_tensor(x, y, offset=offset, dim1=axis1, dim2=axis2)


def select_scatter(x, values, axis, index, name=None):
    return run_op("select_scatter", lambda xv, vv: torch.select_scatter(
        xv, vv.to(xv.dtype), axis, index), _ensure(x), _ensure(values))


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    axes_, starts_, ends_, strides_ = map(_ints, (axes, starts, ends,
                                                  strides))

    def f(xv, vv):
        out = xv.clone()
        idx = [builtins.slice(None)] * xv.dim()
        for a, st, en, sr in zip(axes_, starts_, ends_, strides_):
            idx[a] = builtins.slice(st, en, sr)
        out[tuple(idx)] = vv.to(xv.dtype)
        return out

    return run_op("slice_scatter", f, _ensure(x), _ensure(value))
