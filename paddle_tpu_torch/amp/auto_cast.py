"""Automatic mixed precision at O1: the port of
``paddle_tpu/amp/auto_cast.py``.

The JAX package casts in its op bus (``core/dispatch.py::run_op``): inside
``auto_cast`` every op whose name is on the white list (and not on the
black list) gets its fp32 tensor arguments cast to the AMP dtype; every
other op runs on what it is given.  The black list means "do not cast",
not "cast up": ``batch_norm`` on a conv's bf16 output with fp32 weights
computes what the JAX function computes on those dtypes (the normalised
value rounded to bf16, then the fp32 affine: an fp32 result).

The port has no op bus yet (ROADMAP A12), so O1 casts where the port's
functionals carry a white-listed JAX op name: ``linear`` (the functional
and the ``Linear`` layer), ``conv1d`` / ``conv2d`` / ``conv3d`` /
``conv2d_transpose``, ``attention`` (``scaled_dot_product_attention``, the
mask included, as the JAX op takes it as an argument) and
``flash_attention``.  Each calls :func:`cast_args` with its op name.  The
list's ``matmul`` / ``mm`` / ``bmm`` / ``einsum`` / ``addmm`` are the JAX
``paddle.tensor`` ops, which the port does not have (A12): a torch
``matmul`` in user code is not cast.  ``torch.autocast`` keeps other
lists and casts outputs, and is not used.

O2 casts every op not on the black list, which needs the op bus: it
raises, naming A12.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional, Set

import torch

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

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}
_O2 = ("AMP O2 casts every op that is not on the black list, which needs "
       "the port's op bus (ROADMAP A12); use level='O1'")


class _AmpState(threading.local):
    def __init__(self):
        self.stack = []


_state = _AmpState()


def amp_config():
    """The innermost active ``auto_cast`` configuration, or None."""
    return _state.stack[-1] if _state.stack else None


def cast_args(op_name: str, *tensors):
    """``tensors`` as the JAX op ``op_name`` receives them under the active
    ``auto_cast``: fp32 tensors cast to the AMP dtype when the op is on the
    white list and not on the black list; everything else (None, other
    dtypes, ops off the list, no ``auto_cast``) unchanged."""
    cfg = amp_config()
    if cfg is None or not cfg["enable"]:
        return tensors
    if op_name not in cfg["white"] or op_name in cfg["black"]:
        return tensors
    target = cfg["dtype"]
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.dtype == torch.float32 else t for t in tensors)


class auto_cast:
    """``paddle.amp.auto_cast``: a context manager (thread-local, nests)."""

    def __init__(self, enable: bool = True,
                 custom_white_list: Optional[Iterable[str]] = None,
                 custom_black_list: Optional[Iterable[str]] = None,
                 level: str = "O1", dtype: str = "bfloat16",
                 use_promote: bool = True):
        if level not in ("O0", "O1", "O2", "OD"):
            raise ValueError(f"level must be O0/OD/O1/O2, got {level}")
        if level == "O2" and enable:
            raise NotImplementedError(_O2)
        self.cfg = {
            "enable": enable and level != "O0",
            "level": level,
            "dtype": dtype if isinstance(dtype, torch.dtype)
            else _DTYPES[str(dtype)],
            "white": set(white_list) | set(custom_white_list or ()),
            "black": set(black_list) | set(custom_black_list or ()),
        }

    def __enter__(self):
        _state.stack.append(self.cfg)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``.  At O1 the parameters stay as they are and
    the optimizers keep no master weights unless ``master_weight=True``
    (the JAX rule: masters by default only at O2).  O2 raises, naming
    ROADMAP A12."""
    if level == "O2":
        raise NotImplementedError(_O2)
    single = isinstance(models, torch.nn.Module)
    model_list = [models] if single else list(models)
    if optimizers is None:
        return models if single else model_list
    opt_single = not isinstance(optimizers, (list, tuple))
    opt_list = [optimizers] if opt_single else list(optimizers)
    for o in opt_list:
        o._use_master_weights = bool(master_weight)
    return ((models if single else model_list),
            (optimizers if opt_single else opt_list))
