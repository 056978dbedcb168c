"""Runtime flags: the port of ``paddle_tpu/core/flags.py``.

``get_flags`` / ``set_flags`` over the flags the port acts on: the four
the op bus reads (``check_nan_inf``, ``check_nan_inf_level``,
``low_precision_op_list``, ``eager_log_ops``) and ``default_dtype``
(``core/dtype.py``).  Each is mirrored from a ``FLAGS_<name>`` environment
variable at import, as in the JAX package.

The JAX table's other flags steer XLA, Pallas, the JAX allocator or
modules the port does not have; ``set_flags`` on one of them raises
``NotImplementedError`` naming its ROADMAP item instead of storing a value
nothing reads.  A name in neither table raises ``ValueError`` as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, List, Mapping, Union

_DEFS: Dict[str, dict] = {}
_VALUES: Dict[str, Any] = {}
# called with no argument after every change: the op bus re-reads its gates
_listeners: List[Callable[[], None]] = []

# the JAX package's flags with no effect in the port, and the item they
# wait for
_UNPORTED = {
    **{k: "A12" for k in (
        "use_donated_buffers", "retain_grad_for_all", "benchmark",
        "call_stack_level", "matmul_precision", "deterministic",
        "debug_nans", "log_compiles", "jit_cache_max_entries",
        "disable_pallas_kernels", "strict_pallas", "pallas_autotune",
        "memory_fraction", "preallocate_memory", "init_allocated_mem",
        "dataloader_use_shared_memory", "dataloader_shm_slots",
        "dataloader_prefetch", "enable_profiler", "host_trace_level")},
    # the partial graph has its own switch: jit.enable_partial_graph
    "jit_partial_graph": "A12",
    **{k: "A11" for k in ("tcp_store_timeout", "watchdog_timeout",
                          "sync_collectives")},
}


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    """Register a flag; ``FLAGS_<name>`` in the environment overrides the
    default."""
    _DEFS[name] = {"default": default, "help": help_str,
                   "type": type(default)}
    env = os.environ.get("FLAGS_" + name)
    _VALUES[name] = _parse(env, type(default)) if env is not None \
        else default


def _parse(text: str, ty: type) -> Any:
    if ty is bool:
        return text.lower() in ("1", "true", "yes", "on")
    if ty in (int, float):
        return ty(text)
    return text


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key in _DEFS:
        return key
    if key in _UNPORTED:
        raise NotImplementedError(
            f"flag {name!r} steers a part of the JAX package the port does "
            f"not have (ROADMAP {_UNPORTED[key]})")
    raise ValueError(f"Unknown flag: {name}")


def set_flags(flags: Mapping[str, Any]) -> None:
    """Set one or more flags (``paddle.set_flags``)."""
    for name, value in flags.items():
        key = _key(name)
        _VALUES[key] = (_parse(value, _DEFS[key]["type"])
                        if isinstance(value, str) else value)
    for cb in _listeners:
        cb()


def get_flags(flags: Union[str, Iterable[str], None] = None
              ) -> Dict[str, Any]:
    """Read flags (``paddle.get_flags``): all of them, or the named ones
    under the names given."""
    if flags is None:
        return dict(_VALUES)
    if isinstance(flags, str):
        flags = [flags]
    return {name: _VALUES[_key(name)] for name in flags}


def flag(name: str) -> Any:
    """Fast internal accessor."""
    return _VALUES[name]


define_flag("check_nan_inf", False,
            "Scan op outputs for NaN/Inf in eager mode.")
define_flag("check_nan_inf_level", 0,
            "0: error on NaN/Inf; 1 and above: warn.")
define_flag("eager_log_ops", False, "Log every eager op dispatch (debug).")
define_flag("low_precision_op_list", False,
            "Record which ops AMP ran in low precision "
            "(read with amp.debugging.low_precision_op_list()).")
define_flag("default_dtype", "float32", "Default floating point dtype.")
