"""Numerics debugging: the port of ``paddle_tpu/amp/debugging.py``.

``low_precision_op_list`` reads the counts the AMP cast keeps under the
flag ``low_precision_op_list`` (``amp/auto_cast.py``); the tensor checker
switches the op bus's NaN/Inf check (``check_nan_inf``, and
``check_nan_inf_level`` 1 for a mode other than abort: a warning instead
of ``FloatingPointError``); ``check_numerics`` scans one tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import flags


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


# op name -> AMP low-precision dispatches (FLAGS_low_precision_op_list)
_low_precision_ops: dict = {}


def low_precision_op_list() -> dict:
    """The ops AMP ran in low precision while the flag was on, with their
    counts."""
    return dict(_low_precision_ops)


def clear_low_precision_op_list():
    _low_precision_ops.clear()


class TensorCheckerConfig:
    """Which checks ``enable_tensor_checker`` turns on."""

    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


def enable_operator_stats_collection():
    flags.set_flags({"eager_log_ops": True})


def disable_operator_stats_collection():
    flags.set_flags({"eager_log_ops": False})


def enable_tensor_checker(config: Optional[TensorCheckerConfig] = None):
    if config is None or config.enable:
        flags.set_flags({"check_nan_inf": True})
        if (config is not None
                and config.debug_mode != DebugMode.CHECK_NAN_INF_AND_ABORT):
            flags.set_flags({"check_nan_inf_level": 1})


def disable_tensor_checker():
    flags.set_flags({"check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Count the NaNs, Infs and zeros of one tensor (one host read);
    returns them as three int64 tensors on the host.  With the abort mode
    a NaN or an Inf raises ``FloatingPointError``."""
    t = tensor.detach()
    zero = torch.zeros((), dtype=torch.int64)
    n_zero = int((t == 0).sum())
    if not (t.is_floating_point() or t.is_complex()):
        return zero, zero.clone(), torch.tensor(n_zero)
    counts = torch.stack([torch.isnan(t).sum(), torch.isinf(t).sum()]).cpu()
    n_nan, n_inf = int(counts[0]), int(counts[1])
    if (n_nan or n_inf) and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
        raise FloatingPointError(
            f"check_numerics: op={op_type} var={var_name} nan={n_nan} "
            f"inf={n_inf}")
    return torch.tensor(n_nan), torch.tensor(n_inf), torch.tensor(n_zero)
