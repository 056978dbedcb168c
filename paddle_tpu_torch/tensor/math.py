"""Elementwise, reduction and matmul ops: the port of
``paddle_tpu/tensor/math.py``.

Each op is a plain function on torch tensors with Paddle's signature and
meaning, run through the op bus (``core/dispatch.py``) under the JAX op's
name, so ``amp.auto_cast`` casts what the JAX package casts (``matmul``,
``mm``, ``bmm``, ``addmm`` and ``linalg.einsum`` at O1).  Paddle's
meaning where it parts from torch's: ``max`` / ``min`` return the values
only, ``axis`` takes a list, ``cumsum`` / ``cumprod`` flatten without an
axis, ``matmul`` has ``transpose_x`` / ``transpose_y``, ``scale`` keeps the
input's dtype.
"""

from __future__ import annotations

import builtins
import itertools
import math as _math

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.tensor import to_tensor


def _axis(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(v) for v in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(axis, x):
    """``axis`` as a tuple of dims: all of them for None."""
    a = _axis(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


def _ensure(x):
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def _unary(opname, fn):
    def op(x, name=None):
        return run_op(opname, fn, _ensure(x))

    op.__name__ = opname
    return op


def _binary(opname, fn):
    def op(x, y, name=None):
        x = _ensure(x)
        if isinstance(y, torch.Tensor):
            return run_op(opname, fn, x, y)
        return run_op(opname, lambda a: fn(a, y), x)

    op.__name__ = opname
    return op


def _float_of(v):
    return v if v.is_floating_point() or v.is_complex() \
        else v.to(dtype_mod.get_default_dtype())


# --- unary ----------------------------------------------------------------
abs = _unary("abs", torch.abs)
acos = _unary("acos", torch.acos)
acosh = _unary("acosh", torch.acosh)
angle = _unary("angle", torch.angle)
asin = _unary("asin", torch.asin)
asinh = _unary("asinh", torch.asinh)
atan = _unary("atan", torch.atan)
atanh = _unary("atanh", torch.atanh)
ceil = _unary("ceil", torch.ceil)
conj = _unary("conj", lambda v: torch.conj(v).resolve_conj())
cos = _unary("cos", torch.cos)
cosh = _unary("cosh", torch.cosh)
digamma = _unary("digamma", torch.digamma)
erf = _unary("erf", torch.erf)
erfinv = _unary("erfinv", torch.erfinv)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
floor = _unary("floor", torch.floor)
frac = _unary("frac", lambda v: v - torch.trunc(v))
imag = _unary("imag", lambda v: torch.imag(v) if v.is_complex()
              else torch.zeros_like(v))
lgamma = _unary("lgamma", torch.lgamma)
log = _unary("log", torch.log)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
log2 = _unary("log2", torch.log2)
logit = _unary("logit", torch.logit)
neg = _unary("neg", torch.neg)
real = _unary("real", torch.real)
reciprocal = _unary("reciprocal", torch.reciprocal)
round = _unary("round", torch.round)
rsqrt = _unary("rsqrt", torch.rsqrt)
sigmoid = _unary("sigmoid", torch.sigmoid)
sign = _unary("sign", torch.sign)
sgn = sign
sin = _unary("sin", torch.sin)
sinh = _unary("sinh", torch.sinh)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
tan = _unary("tan", torch.tan)
tanh = _unary("tanh", torch.tanh)
trunc = _unary("trunc", torch.trunc)
i0 = _unary("i0", torch.special.i0)
i0e = _unary("i0e", torch.special.i0e)
i1 = _unary("i1", torch.special.i1)
i1e = _unary("i1e", torch.special.i1e)

# --- binary ---------------------------------------------------------------
add = _binary("add", torch.add)
subtract = _binary("subtract", torch.subtract)
multiply = _binary("multiply", torch.multiply)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
mod = _binary("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
logaddexp = _binary("logaddexp", torch.logaddexp)
heaviside = _binary("heaviside", torch.heaviside)
hypot = _binary("hypot", torch.hypot)
copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", torch.nextafter)
ldexp = _binary("ldexp", torch.ldexp)
gcd = _binary("gcd", torch.gcd)
lcm = _binary("lcm", torch.lcm)
inner = _binary("inner", torch.inner)
outer = _binary("outer", lambda a, b: torch.outer(a.reshape(-1),
                                                  b.reshape(-1)))
kron = _binary("kron", torch.kron)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``) in ``x``'s
    dtype."""
    def f(v):
        s = scale
        out = v * s + bias if bias_after_scale else (v + bias) * s
        return out.to(v.dtype)

    return run_op("scale", f, _ensure(x))


def increment(x, value=1.0, name=None):
    out = run_op("increment", lambda v: v + value, _ensure(x))
    with torch.no_grad():
        x.copy_(out)
    return x


def clip(x, min=None, max=None, name=None):
    def f(v):
        lo = min.to(v.dtype) if isinstance(min, torch.Tensor) else min
        hi = max.to(v.dtype) if isinstance(max, torch.Tensor) else max
        return torch.clamp(v, lo, hi)

    return run_op("clip", f, _ensure(x))


def lerp(x, y, weight, name=None):
    if isinstance(weight, torch.Tensor):
        return run_op("lerp", lambda a, b, w: a + w * (b - a), _ensure(x),
                      _ensure(y), weight)
    return run_op("lerp", lambda a, b: a + weight * (b - a), _ensure(x),
                  _ensure(y))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return run_op("stanh", lambda v: scale_b * torch.tanh(scale_a * v),
                  _ensure(x))


def multiplex(inputs, index, name=None):
    ts = [_ensure(t) for t in inputs]
    idx = _ensure(index)

    def f(*xs):
        stacked = torch.stack(xs, 0)
        rows = torch.arange(stacked.shape[1], device=stacked.device)
        return stacked[idx.reshape(-1).long().to(stacked.device), rows]

    return run_op("multiplex", f, *ts)


# --- reductions -----------------------------------------------------------

def _sum_dtype(v, d):
    if d is not None:
        return d
    if v.dtype == torch.bool or (not v.is_floating_point()
                                 and not v.is_complex()):
        return torch.int64      # numpy's (JAX's under x64) integer sum
    return None


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = dtype_mod.convert_dtype(dtype)
    return run_op("sum", lambda v: torch.sum(
        v, dim=_dims(axis, v), keepdim=keepdim, dtype=_sum_dtype(v, d)),
        _ensure(x))


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    d = dtype_mod.convert_dtype(dtype)
    return run_op("nansum", lambda v: torch.nansum(
        v, dim=_dims(axis, v), keepdim=keepdim, dtype=_sum_dtype(v, d)),
        _ensure(x))


def mean(x, axis=None, keepdim=False, name=None):
    return run_op("mean", lambda v: torch.mean(
        _float_of(v), dim=_dims(axis, v), keepdim=keepdim), _ensure(x))


def nanmean(x, axis=None, keepdim=False, name=None):
    return run_op("nanmean", lambda v: torch.nanmean(
        _float_of(v), dim=_dims(axis, v), keepdim=keepdim), _ensure(x))


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    d = dtype_mod.convert_dtype(dtype)

    def f(v):
        out = v if d is None else v.to(d)
        for a in sorted((a % v.dim() for a in _dims(axis, v)),
                        reverse=True):
            out = torch.prod(out, dim=a, keepdim=keepdim)
        return out

    return run_op("prod", f, _ensure(x))


def _reduce_minmax(fn):
    def f(v, axis, keepdim):
        dims = _dims(axis, v)
        if not dims:
            return v
        return fn(v, dim=dims, keepdim=keepdim)
    return f


_amax = _reduce_minmax(torch.amax)
_amin = _reduce_minmax(torch.amin)


def max(x, axis=None, keepdim=False, name=None):
    """The maximum VALUES (Paddle's meaning; ``torch.max`` with a dim also
    returns indices)."""
    return run_op("max", lambda v: _amax(v, axis, keepdim), _ensure(x))


def min(x, axis=None, keepdim=False, name=None):
    return run_op("min", lambda v: _amin(v, axis, keepdim), _ensure(x))


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def all(x, axis=None, keepdim=False, name=None):
    def f(v):
        out = v.to(torch.bool)
        for a in sorted((a % v.dim() for a in _dims(axis, v)),
                        reverse=True):
            out = torch.all(out, dim=a, keepdim=keepdim)
        return out

    return run_op("all", f, _ensure(x))


def any(x, axis=None, keepdim=False, name=None):
    def f(v):
        out = v.to(torch.bool)
        for a in sorted((a % v.dim() for a in _dims(axis, v)),
                        reverse=True):
            out = torch.any(out, dim=a, keepdim=keepdim)
        return out

    return run_op("any", f, _ensure(x))


def logsumexp(x, axis=None, keepdim=False, name=None):
    return run_op("logsumexp", lambda v: torch.logsumexp(
        v, dim=_dims(axis, v), keepdim=keepdim), _ensure(x))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    def f(v):
        out = torch.count_nonzero(v, dim=_dims(axis, v))
        if keepdim:
            for a in sorted(a % v.dim() for a in _dims(axis, v)):
                out = out.unsqueeze(a)
        return out

    return run_op("count_nonzero", f, _ensure(x))


# --- scans ----------------------------------------------------------------

def cumsum(x, axis=None, dtype=None, name=None):
    d = dtype_mod.convert_dtype(dtype)

    def f(v):
        if axis is None:
            return torch.cumsum(v.reshape(-1), 0, dtype=d)
        return torch.cumsum(v, _axis(axis), dtype=d)

    return run_op("cumsum", f, _ensure(x))


def cumprod(x, dim=None, dtype=None, name=None):
    d = dtype_mod.convert_dtype(dtype)

    def f(v):
        if dim is None:
            return torch.cumprod(v.reshape(-1), 0, dtype=d)
        return torch.cumprod(v, _axis(dim), dtype=d)

    return run_op("cumprod", f, _ensure(x))


def cummax(x, axis=None, dtype="int64", name=None):
    """Running maxima and the LAST index of each (the JAX scan's)."""
    return run_op("cummax", lambda v: _cum_last(v, axis, dtype, True),
                  _ensure(x))


def cummin(x, axis=None, dtype="int64", name=None):
    return run_op("cummin", lambda v: _cum_last(v, axis, dtype, False),
                  _ensure(x))


def _cum_last(v, axis, dtype, is_max):
    vv = v.reshape(-1) if axis is None else v
    a = (0 if axis is None else _axis(axis)) % vv.dim()
    vals = (torch.cummax if is_max else torch.cummin)(vv, a).values
    n = vv.shape[a]
    shape = [-1 if i == a else 1 for i in range(vv.dim())]
    idx = torch.arange(n, device=v.device).reshape(shape).expand(vv.shape)
    hit = torch.where(vv == vals, idx, torch.full_like(idx, -1))
    return vals, torch.cummax(hit, a).values.to(
        dtype_mod.convert_dtype(dtype))


def logcumsumexp(x, axis=None, name=None):
    def f(v):
        if axis is None:
            return torch.logcumsumexp(v.reshape(-1), 0)
        return torch.logcumsumexp(v, _axis(axis))

    return run_op("logcumsumexp", f, _ensure(x))


# --- checks ---------------------------------------------------------------
isfinite = _unary("isfinite", torch.isfinite)
isinf = _unary("isinf", torch.isinf)
isnan = _unary("isnan", torch.isnan)
isneginf = _unary("isneginf", torch.isneginf)
isposinf = _unary("isposinf", torch.isposinf)
isreal = _unary("isreal", torch.isreal)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return run_op("nan_to_num", lambda v: torch.nan_to_num(
        v, nan=nan, posinf=posinf, neginf=neginf), _ensure(x))


# --- the matmul family ------------------------------------------------------

def _matmul(a, b, transpose_x, transpose_y):
    if transpose_x and a.dim() > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return run_op("matmul", _matmul, _ensure(x), _ensure(y), transpose_x,
                  transpose_y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return run_op("bmm", torch.matmul, _ensure(x), _ensure(y))


def dot(x, y, name=None):
    return run_op("dot", lambda a, b: torch.sum(a * b, dim=-1), _ensure(x),
                  _ensure(y))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return run_op("addmm", lambda i, a, b: beta * i + alpha
                  * torch.matmul(a, b), _ensure(input), _ensure(x),
                  _ensure(y))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("trace", lambda v: torch.diagonal(
        v, offset, axis1, axis2).sum(-1), _ensure(x))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return run_op("diagonal", lambda v: torch.diagonal(
        v, offset, axis1, axis2), _ensure(x))


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def add_n(inputs, name=None):
    ts = [_ensure(t) for t in (inputs if isinstance(inputs, (list, tuple))
                               else [inputs])]

    def f(*xs):
        out = xs[0]
        for v in xs[1:]:
            out = out + v
        return out

    return run_op("add_n", f, *ts)


def deg2rad(x, name=None):
    return run_op("deg2rad", lambda v: torch.deg2rad(_float_of(v)),
                  _ensure(x))


def rad2deg(x, name=None):
    return run_op("rad2deg", lambda v: torch.rad2deg(_float_of(v)),
                  _ensure(x))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return run_op("diff", lambda v: torch.diff(
        v, n=n, dim=axis, prepend=prepend, append=append), _ensure(x))


def gammaln(x, name=None):
    return lgamma(x)


def polygamma(x, n, name=None):
    return run_op("polygamma", lambda v: torch.special.polygamma(n, v),
                  _ensure(x))


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(v):
        if x is not None:
            return torch.trapezoid(v, x, dim=axis)
        return torch.trapezoid(v, dx=1.0 if dx is None else dx, dim=axis)

    return run_op("trapezoid", f, _ensure(y))


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def f(v):
        if x is not None:
            return torch.cumulative_trapezoid(v, x, dim=axis)
        return torch.cumulative_trapezoid(v, dx=1.0 if dx is None else dx,
                                          dim=axis)

    return run_op("cumulative_trapezoid", f, _ensure(y))


def vander(x, n=None, increasing=False, name=None):
    return run_op("vander", lambda v: torch.vander(
        v, N=n, increasing=increasing), _ensure(x))


def take(x, index, mode="raise", name=None):
    """Elements of the flattened ``x`` at ``index`` (out-of-range indices
    clipped, as the JAX op's ``mode="clip"``)."""
    idx = _ensure(index)

    def f(v):
        flat = v.reshape(-1)
        i = idx.reshape(-1).long().to(v.device).clamp(0, flat.numel() - 1)
        return flat[i].reshape(idx.shape)

    return run_op("take", f, _ensure(x))


def frexp(x, name=None):
    """Mantissa in [0.5, 1) and exponent, the exponent in ``x``'s dtype."""
    def f(v):
        m, e = torch.frexp(v)
        return m, e.to(v.dtype)

    return run_op("frexp", f, _ensure(x))


def gammainc(x, y, name=None):
    return run_op("gammainc", torch.special.gammainc, _ensure(x), _ensure(y))


def gammaincc(x, y, name=None):
    return run_op("gammaincc", torch.special.gammaincc, _ensure(x),
                  _ensure(y))


def multigammaln(x, p, name=None):
    def f(v):
        j = torch.arange(p, dtype=v.dtype, device=v.device)
        terms = torch.lgamma(v[..., None] - j / 2.0)
        const = p * (p - 1) / 4.0 * _math.log(_math.pi)
        return const + torch.sum(terms, dim=-1)

    return run_op("multigammaln", f, _ensure(x))


def signbit(x, name=None):
    return run_op("signbit", torch.signbit, _ensure(x))


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` rescaled to p-norm ``max_norm`` where it
    is above it (``max_norm / (norm + 1e-7)``, the JAX formula)."""
    nd = _ensure(x).dim()
    if not -nd <= axis < nd:
        raise ValueError(f"axis {axis} out of range for rank {nd}")
    ax = axis % nd

    def f(v):
        red = tuple(i for i in range(v.dim()) if i != ax)
        norms = torch.sum(torch.abs(v) ** p, dim=red, keepdim=True) \
            ** (1.0 / p)
        s = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                        torch.ones_like(norms))
        return v * s

    return run_op("renorm", f, _ensure(x))


def combinations(x, r=2, with_replacement=False, name=None):
    """All r-combinations of a 1-D tensor, rows in lexicographic index
    order."""
    v = _ensure(x)
    n = v.shape[0]
    gen = (itertools.combinations_with_replacement if with_replacement
           else itertools.combinations)
    idx = np.array(list(gen(builtins.range(n), r)), dtype=np.int64)
    if idx.size == 0:
        idx = idx.reshape(0, r)
    return run_op("combinations",
                  lambda t: t[torch.as_tensor(idx, device=t.device)], v)
