"""The kernel wrappers' launch counters, as one list.

Each wrapper adds one to its module's counter in Python where it launches
its kernel.  A replayed CUDA graph runs no Python, so the code that
replays graphs (``serving/graphs.py``, ``jit/api.py``) reads the counters
around a capture and adds the change back at every replay through these
helpers."""

from __future__ import annotations

from typing import Sequence, Tuple

from . import flash, paged_decode, ragged_paged, scaled

COUNTERS = (
    (paged_decode, ("launches", "simple_launches", "mma_launches")),
    (ragged_paged, ("launches", "simple_launches", "tma_launches")),
    (flash, ("fwd_launches", "dq_launches", "dkv_launches",
             "copy_launches")),
    (scaled, ("launches",)),
)


def read() -> Tuple[int, ...]:
    return tuple(getattr(mod, name) for mod, names in COUNTERS
                 for name in names)


def write(values: Sequence[int]) -> None:
    it = iter(values)
    for mod, names in COUNTERS:
        for name in names:
            setattr(mod, name, next(it))


def add(delta: Sequence[int]) -> None:
    """Every counter plus its entry of ``delta`` (a replay's launches)."""
    write([c + d for c, d in zip(read(), delta)])
