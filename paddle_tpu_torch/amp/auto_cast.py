"""Automatic mixed precision: the port of ``paddle_tpu/amp/auto_cast.py``.

The cast happens in the op bus (``core/dispatch.py::run_op``), as in the
JAX package: inside ``auto_cast`` each op's fp32 tensor arguments are cast
to the AMP dtype when

* at O1 (and OD), the op's name is on the white list and not on the
  black list (``matmul``, ``linear``, ``conv2d``, ``flash_attention``
  ...);
* at O2, the op's name is not on the black list.

Every other op runs on what it is given.  The black list means "do not
cast", not "cast up": at O2 ``layer_norm`` on a bf16 input with bf16
weights computes in fp32 and returns bf16, as the JAX function does, and
the next op that is not black casts whatever fp32 it meets back down
(``add`` of bf16 and fp32 gives bf16, where torch's promotion would give
fp32).  The cast is a differentiable ``.to``: the gradient reaches the
fp32 tensor.  ``torch.autocast`` keeps other lists and casts outputs, and
is not used.

With the flag ``low_precision_op_list`` on, each cast decision counts
once under the op's name (``amp.debugging.low_precision_op_list``), except
in a pass the bus keeps quiet (``dispatch.quiet``: work the JAX package
would replay without dispatching it again).

``decorate(level="O2")`` casts every fp32 parameter to the AMP dtype in
place (``p.data``: an optimizer built before keeps its parameter objects)
and no buffer, and turns the optimizers' fp32 master weights on unless
``master_weight=False``.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional, Set

import torch

from ..core import dispatch as _dispatch
from ..core import dtype as dtype_mod
from ..core import flags

# the JAX package's default lists (paddle_tpu/amp/auto_cast.py:21-29)
white_list: Set[str] = {
    "matmul", "mm", "bmm", "einsum", "conv2d", "conv1d", "conv3d",
    "conv2d_transpose", "addmm", "attention", "flash_attention", "linear",
}
black_list: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "logsumexp",
    "softmax_with_cross_entropy", "cross_entropy", "mean", "sum", "norm",
    "softmax", "log_softmax", "layer_norm", "rms_norm", "batch_norm",
    "cumsum", "pow",
}


def _cast(a, target):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return a.to(target)
    return a


class _AmpState(threading.local):
    def __init__(self):
        self.stack = []

    def enabled(self):
        return bool(self.stack) and self.stack[-1]["enable"]

    def cast_args(self, op_name, args, kwargs):
        """``(args, kwargs)`` as the op ``op_name`` receives them."""
        if not self.stack:
            return args, kwargs
        cfg = self.stack[-1]
        if not cfg["enable"]:
            return args, kwargs
        base = op_name.split("/")[-1]
        if cfg["level"] == "O2":
            do_cast = base not in cfg["black"]
        else:
            do_cast = base in cfg["white"] and base not in cfg["black"]
        if not do_cast:
            return args, kwargs
        if flags.flag("low_precision_op_list") and not _dispatch.is_quiet():
            from . import debugging

            debugging._low_precision_ops[base] = (
                debugging._low_precision_ops.get(base, 0) + 1)
        target = cfg["dtype"]
        args = tuple(_cast(a, target) for a in args)
        if kwargs:
            kwargs = {k: _cast(v, target) for k, v in kwargs.items()}
        return args, kwargs


_state = _AmpState()
_dispatch._register_amp_state(_state)


class auto_cast:
    """``paddle.amp.auto_cast``: a context manager (thread-local, nests)."""

    def __init__(self, enable: bool = True,
                 custom_white_list: Optional[Iterable[str]] = None,
                 custom_black_list: Optional[Iterable[str]] = None,
                 level: str = "O1", dtype: str = "bfloat16",
                 use_promote: bool = True):
        if level not in ("O0", "O1", "O2", "OD"):
            raise ValueError(f"level must be O0/OD/O1/O2, got {level}")
        self.cfg = {
            "enable": enable and level != "O0",
            "level": level,
            "dtype": dtype_mod.convert_dtype(dtype),
            "white": set(white_list) | set(custom_white_list or ()),
            "black": set(black_list) | set(custom_black_list or ()),
        }

    def __enter__(self):
        _state.stack.append(self.cfg)
        _dispatch._amp_enter(1)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        _dispatch._amp_enter(-1)
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``.  O2 casts every fp32 parameter of the
    models to ``dtype`` in place; the optimizers keep fp32 master weights
    at O2 unless ``master_weight=False``, and at O1 only with
    ``master_weight=True`` (the JAX rule)."""
    target = dtype_mod.convert_dtype(dtype)
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if level == "O2":
        with torch.no_grad():
            for m in model_list:
                for p in m.parameters():
                    if p.dtype == torch.float32:
                        p.data = p.data.to(target)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        o._use_master_weights = (master_weight if master_weight is not None
                                 else level == "O2")
    return ((models if single else model_list),
            (optimizers if opt_single else opt_list))
