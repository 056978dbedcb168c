"""``paddle.tensor`` of the port: the op namespace of
``paddle_tpu/tensor/__init__.py`` (``array.py`` waits for ROADMAP A12),
and the Paddle methods of ``Tensor``.

The port's ``Tensor`` is ``torch.Tensor``.  Of the JAX ``Tensor``'s public
names, the ones ``torch.Tensor`` lacks (``_PADDLE_METHODS``: ``astype``,
``cast``, ``stop_gradient``, ``clear_grad``, ``concat``, ``gather_nd``
...) are added here, each bound to the port's function; a name torch
already has is never replaced, so ``x.transpose``, ``x.reshape``,
``x.max`` ... keep torch's meaning (ROADMAP C10) and Paddle's is
``paddle_tpu_torch.transpose(x, perm)`` and so on.  The in-place
variants (``add_``, ``sqrt_`` ...) write their result into the input.
"""

from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.tensor import Parameter, Tensor, getitem, to_tensor
from . import creation, linalg, logic, manipulation, math, random, search
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
# the module functions that shadow a Python builtin
from .math import abs, all, any, max, min, pow, round, sum  # noqa: F401,A004
from .manipulation import slice  # noqa: F401,A004
from .creation import complex  # noqa: F401,A004


def rank(x):
    return torch.tensor(x.dim())


def shape(x):
    return torch.tensor(list(x.shape), dtype=torch.int64)


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64)


def is_floating_point(x):
    return dtype_mod.is_floating_point(x.dtype)


def is_complex(x):
    return dtype_mod.is_complex(x.dtype)


def is_integer(x):
    return dtype_mod.is_integer(x.dtype)


def reverse(x, axis, name=None):
    """The legacy alias of :func:`flip`."""
    return flip(x, axis)  # noqa: F405


def _rebind(x, out):
    """Write an in-place op's result into ``x``: a copy when the shape and
    dtype stay (recorded by autograd unless ``x`` is a leaf that requires
    grad), else ``x`` takes the result's data."""
    if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        out = out.clone()            # a view of x (``t_``, ``reshape_``)
    if out.shape == x.shape and out.dtype == x.dtype:
        if x.is_leaf and x.requires_grad:
            with torch.no_grad():
                x.copy_(out)
        else:
            x.copy_(out)
    else:
        x.data = out.detach()
    return x


def _make_inplace(fn):
    def op_(x, *args, **kwargs):
        return _rebind(x, fn(x, *args, **kwargs))

    op_.__name__ = fn.__name__ + "_"
    op_.__doc__ = f"In-place variant of :func:`{fn.__name__}`."
    return op_


# the JAX package's generated in-place variants
_INPLACE_NAMES = [
    "abs", "acos", "add", "addmm", "asin", "atan", "bitwise_and",
    "bitwise_not", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "ceil", "clip", "copysign", "cos", "cosh",
    "cumprod", "cumsum", "digamma", "divide", "equal", "erf", "exp", "expm1",
    "floor", "floor_divide", "floor_mod", "frac", "gammaln", "gcd",
    "greater_equal", "greater_than", "hypot", "i0", "index_add",
    "index_fill", "index_put", "lcm", "ldexp", "less_equal", "less_than",
    "lgamma", "log", "log10", "log1p", "log2", "logical_and", "logical_not",
    "logical_or", "logical_xor", "logit", "masked_fill", "mod", "multiply",
    "nan_to_num", "neg", "polygamma", "pow", "reciprocal", "remainder",
    "round", "rsqrt", "scale", "sigmoid", "sin", "sinh", "sqrt", "square",
    "subtract", "t", "tan", "tanh", "tril", "triu", "trunc", "erfinv",
    "lerp", "not_equal", "put_along_axis", "atanh", "acosh", "asinh",
    # and the JAX modules' own
    "reshape", "flatten", "squeeze", "unsqueeze", "scatter", "cast",
    "where", "gammainc", "gammaincc", "multigammaln", "renorm",
    "masked_scatter", "fill_diagonal_tensor",
]

_g = globals()
for _name in _INPLACE_NAMES:
    if _name == "where":
        continue
    _g[_name + "_"] = _make_inplace(_g[_name])
del _name


def where_(condition, x=None, y=None, name=None):
    return _rebind(x, where(condition, x, y))  # noqa: F405


def transpose_(x, perm, name=None):
    return _rebind(x, transpose(x, perm))  # noqa: F405


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """``value`` on the diagonal: a 2-D ``x``'s (``wrap`` restarts every
    ``ncols + 1`` rows as numpy's), or for more dims, all equal, the grand
    diagonal ``x[i, ..., i]`` (no offset there)."""
    import numpy as np

    def f(v):
        out = v.clone()
        if v.dim() > 2:
            if len(set(v.shape)) != 1:
                raise ValueError(
                    "fill_diagonal on a >2-D tensor requires all dimensions "
                    f"equal, got shape {tuple(v.shape)}")
            if offset != 0:
                raise ValueError(
                    "fill_diagonal offset is only supported for 2-D input")
            i = torch.arange(v.shape[0], device=v.device)
            out[(i,) * v.dim()] = value
            return out
        rows, cols = v.shape[-2], v.shape[-1]
        if wrap and rows > cols:
            start = offset if offset >= 0 else -offset * cols
            flat = np.arange(start, rows * cols, cols + 1)
            r, c = flat // cols, flat % cols
        else:
            n = builtins.min(rows, cols)
            i = np.arange(n)
            r, c = i + builtins.max(-offset, 0), i + builtins.max(offset, 0)
            keep = (r < rows) & (c < cols)
            r, c = r[keep], c[keep]
        out[torch.as_tensor(r, device=v.device),
            torch.as_tensor(c, device=v.device)] = value
        return out

    return run_op("fill_diagonal", f, x)


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    return _rebind(x, fill_diagonal(x, value, offset=offset, wrap=wrap))


def gaussian_(x, mean=0.0, std=1.0, seed=0, name=None):
    """``x`` filled in place with N(mean, std^2) draws."""
    with torch.no_grad():
        return x.copy_(gaussian(x.shape, mean=mean, std=std, seed=seed,  # noqa: F405,E501
                                dtype=x.dtype).to(x.device))


# --- the Paddle methods of Tensor -----------------------------------------

def _astype(self, dtype):
    return cast(self, dtype)  # noqa: F405


def _clear_grad(self, set_to_zero=False):
    self.grad = None


def _set_value(self, value):
    """Replace the data in place (no gradient recorded); the shape must
    match and the dtype stays."""
    v = value if isinstance(value, torch.Tensor) else to_tensor(
        value, place=self.device)
    if tuple(v.shape) != tuple(self.shape):
        raise ValueError(
            f"set_value shape mismatch: {tuple(v.shape)} vs "
            f"{tuple(self.shape)}")
    with torch.no_grad():
        self.copy_(v)
    return self


def _slot(name, default):
    """A settable attribute with a default, stored on the tensor."""
    key = "_paddle_" + name

    def get(self):
        return self.__dict__.get(key, default(self) if callable(default)
                                 else default)

    def set(self, value):
        self.__dict__[key] = value

    return property(get, set)


def _trainable_get(self):
    return self.__dict__.get("_paddle_trainable", True)


def _trainable_set(self, value):
    self.__dict__["_paddle_trainable"] = bool(value)
    if self.is_leaf and (self.is_floating_point() or self.is_complex()):
        self.requires_grad_(bool(value))


_PADDLE_METHODS = {
    # properties
    "stop_gradient": property(lambda self: not self.requires_grad,
                              lambda self, v: self.requires_grad_(not v)),
    "persistable": _slot("persistable",
                         lambda self: isinstance(self, Parameter)),
    "trainable": property(_trainable_get, _trainable_set),
    "dist_attr": _slot("dist_attr", None),
    "dist_spec": _slot("dist_spec", None),
    "place": property(lambda self: self.device),
    "rank": property(lambda self: self.dim()),
    "item_size": property(lambda self: self.element_size()),
    # the JAX Tensor's own methods
    "astype": _astype,
    "cast": _astype,
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_grad,
    "zero_grad": _clear_grad,
    "set_value": _set_value,
    "run_op": run_op,
}
# the module functions the JAX package attaches under their own names
for _name in (
        "add_n", "as_complex", "as_real", "atleast_1d", "atleast_2d",
        "atleast_3d", "broadcast_shape", "broadcast_tensors", "bucketize",
        "cast_", "cdist", "clone_detached", "column_stack", "combinations",
        "complex", "concat", "cond", "create_global_var", "create_parameter",
        "create_tensor", "crop", "cumulative_trapezoid", "dstack", "eigh",
        "eigvals", "eigvalsh", "einsum", "empty_like", "equal_", "equal_all",
        "fill_constant", "fill_diagonal_tensor", "fill_diagonal_tensor_",
        "flatten_", "floor_mod", "floor_mod_", "full_like", "gammainc",
        "gammainc_", "gammaincc", "gammaincc_", "gammaln", "gammaln_",
        "gather_nd", "gaussian_", "greater_than", "greater_than_",
        "histogramdd", "householder_product", "hstack", "i0e", "i1", "i1e",
        "increment", "index_sample", "inv", "is_empty", "is_integer",
        "is_tensor", "less_than", "less_than_", "lu_unpack", "matrix_norm",
        "matrix_rank", "mod", "mod_", "multi_dot", "multigammaln",
        "multigammaln_", "multiplex", "ones_like", "pad", "pca_lowrank",
        "pinv", "poisson", "polar", "put_along_axis", "put_along_axis_",
        "rand_like", "randint_like", "randn_like", "reshape_", "row_stack",
        "scale", "scale_", "scatter_nd_add", "searchsorted", "shard_index",
        "shuffle", "slice", "split_by_indices", "stack", "stanh",
        "strided_slice", "svd_lowrank", "svdvals", "take_along_axis",
        "tensordot", "top_p_sampling", "trapezoid", "unstack", "vander",
        "vector_norm", "vstack", "where_", "zeros_like"):
    _PADDLE_METHODS[_name] = _g[_name]
del _name, _g


def _attach_methods():
    for name, value in _PADDLE_METHODS.items():
        if name not in vars(torch.Tensor) and not hasattr(torch.Tensor,
                                                          name):
            setattr(torch.Tensor, name, value)


_attach_methods()
