"""Tensor creation: the port of ``paddle_tpu/tensor/creation.py``.

The factories (``zeros``, ``full``, ``arange``, ``eye`` ...) put their
result on ``paddle_tpu_torch.set_device``'s place, else the card, in the
default dtype (``arange`` of ints: int64); the ``*_like`` ops follow their
input's device.  ``empty`` is zeros, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.tensor import Parameter, to_tensor  # noqa: F401  (re-export)
from ..device import place_device


def _d(dtype, default_float=True):
    d = dtype_mod.convert_dtype(dtype)
    if d is None and default_float:
        d = dtype_mod.get_default_dtype()
    return d


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_d(dtype), device=place_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_d(dtype), device=place_device())


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    d = dtype_mod.convert_dtype(dtype)
    if d is None:
        d = (torch.bool if isinstance(fill_value, bool)
             else dtype_mod.get_default_dtype())
    return torch.full(_shape(shape), fill_value, dtype=d,
                      device=place_device())


def zeros_like(x, dtype=None, name=None):
    return run_op("zeros_like", lambda v: torch.zeros_like(
        v, dtype=_d(dtype, False)), x)


def ones_like(x, dtype=None, name=None):
    return run_op("ones_like", lambda v: torch.ones_like(
        v, dtype=_d(dtype, False)), x)


def full_like(x, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    return run_op("full_like", lambda v: torch.full_like(
        v, fill_value, dtype=_d(dtype, False)), x)


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    d = dtype_mod.convert_dtype(dtype)
    if d is None:
        d = (torch.int64 if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
             else dtype_mod.get_default_dtype())
    return torch.arange(start, end, step, dtype=d, device=place_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_d(dtype), device=place_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(start, stop, int(num), base=base, dtype=_d(dtype),
                          device=place_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = int(num_columns) if num_columns else n
    return torch.eye(n, m, dtype=_d(dtype), device=place_device())


def meshgrid(*args, **kwargs):
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    ts = [t if isinstance(t, torch.Tensor) else to_tensor(t) for t in ts]
    return list(run_op("meshgrid", lambda *xs: tuple(torch.meshgrid(
        *xs, indexing="ij")), *ts))


def diag(x, offset=0, padding_value=0, name=None):
    def f(v):
        out = torch.diag(v, offset)
        if v.dim() == 1 and padding_value != 0:
            mask = torch.ones(out.shape, dtype=torch.bool,
                              device=v.device).diag(offset).diag(offset)
            out = torch.where(mask, out, torch.as_tensor(
                padding_value, dtype=out.dtype, device=v.device))
        return out

    return run_op("diag", f, x)


def diagflat(x, offset=0, name=None):
    return run_op("diagflat", lambda v: torch.diagflat(v, offset), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return run_op("diag_embed", lambda v: torch.diag_embed(
        v, offset, dim1, dim2), x)


def tril(x, diagonal=0, name=None):
    return run_op("tril", lambda v: torch.tril(v, diagonal), x)


def triu(x, diagonal=0, name=None):
    return run_op("triu", lambda v: torch.triu(v, diagonal), x)


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(row, col, offset, dtype=_d(dtype, False),
                              device=place_device())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return torch.triu_indices(row, row if col is None else col, offset,
                              dtype=_d(dtype, False), device=place_device())


def assign(x, output=None):
    v = x.detach().clone() if isinstance(x, torch.Tensor) else to_tensor(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(v)
        return output
    return v


def clone(x, name=None):
    return run_op("clone", torch.clone, x)


def complex(real, imag, name=None):
    return run_op("complex", torch.complex, real, imag)


def polar(abs_t, angle, name=None):
    return run_op("polar", torch.polar, abs_t, angle)


def clone_detached(x):
    return x.detach().clone()


def fill_constant(shape, dtype, value, force_cpu=False, out=None,
                  name=None):
    t = full(shape, value, dtype=dtype)
    if out is not None:
        with torch.no_grad():
            out.copy_(t)
        return out
    return t


def create_tensor(dtype, name=None, persistable=False):
    return torch.empty(0, dtype=_d(dtype, False), device=place_device())


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A standalone ``Parameter``: zeros for a bias, Xavier-uniform for a
    weight, unless an initializer (or a ``ParamAttr`` with one) is
    given."""
    from ..nn import initializer as init_mod

    init = default_initializer
    if init is None and attr is not None:
        init = getattr(attr, "initializer", None)
    if init is None:
        init = init_mod.Constant(0.0) if is_bias else init_mod.XavierUniform()
    return torch.nn.Parameter(init(_shape(shape), dtype=_d(dtype),
                                   device=place_device()))


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    return full(shape, value, dtype=dtype)
