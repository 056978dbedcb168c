"""The op bus: the port of ``paddle_tpu/core/dispatch.py::run_op``.

Every framework op of the port — each ``paddle.tensor`` function, each
``nn.functional`` function and the named steps of the models — runs as
``run_op(name, fn, *args, **kwargs)`` under the JAX package's op name.
Torch's autograd is the tape, so the bus records nothing; it adds what the
JAX ``run_op`` adds around the call:

* the timer fan-out: every subscriber (``add_op_timer``, the legacy
  single-slot ``_set_op_timer``) is called with ``(op_name,
  wall_seconds)``; one that raises is unsubscribed with a message on
  stderr, and the op goes on;
* the AMP hook (``amp/auto_cast.py``): inside ``auto_cast`` the op's fp32
  tensor arguments are cast to the AMP dtype when the level's rule says
  so (a differentiable ``.to``: gradients reach the fp32 tensor);
* ``eager_log_ops``: one line per op on stdout;
* the NaN/Inf check (``check_nan_inf``): a floating output holding a NaN
  or an Inf raises ``FloatingPointError`` naming the op, or warns at
  ``check_nan_inf_level >= 1``.  The check reads the device, so it is
  skipped inside a ``to_static`` function and while a CUDA stream
  captures, as the JAX check skips tracers.

With nothing attached the call costs one module-global read
(``_hooked``) before ``fn``.  An op run inside another op's ``fn`` is a
plain call: the JAX op's body is pure ``jnp`` and dispatches nothing, so
nothing is cast, counted or timed twice.

``quiet()`` marks a pass that replays work the JAX package would not
dispatch again: a serving step's capture after its eager run (one
``jax.jit`` trace there), and a ``to_static`` key's CPU runs after its
first two (the JAX ``to_static`` dispatches a key's ops twice, in its
discovery pass and its trace, as the port's first call and capture do).
Under ``quiet()`` the casts still happen, but no subscriber is called and
nothing is counted.

The static Program recorder's ``notify_*`` hooks wait for the port's
``static/`` (ROADMAP A12).
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time
import warnings
from typing import Callable

import torch

from . import flags

_hooked = False          # the fast path's one gate
_op_timer = None         # the fan-out while a subscriber is attached
_op_timer_subs = ()      # immutable: fan-out iterates without the lock
_op_timer_lock = threading.Lock()
_legacy_timer = None     # the subscriber set with _set_op_timer
_amp_state = None        # amp/auto_cast.py installs its state here
_amp_active = 0          # auto_cast contexts entered, over all threads
_log_ops = False
_check_nan = False
_tls = threading.local()  # depth (inside an op), quiet


def _refresh():
    global _hooked, _op_timer, _log_ops, _check_nan
    _op_timer = _op_timer_fanout if _op_timer_subs else None
    _log_ops = bool(flags.flag("eager_log_ops"))
    _check_nan = bool(flags.flag("check_nan_inf"))
    _hooked = bool(_op_timer is not None or _amp_active or _log_ops
                   or _check_nan)


flags._listeners.append(_refresh)
_refresh()    # FLAGS_check_nan_inf / FLAGS_eager_log_ops set before import


def _register_amp_state(state):
    global _amp_state
    _amp_state = state


def _amp_enter(delta: int):
    """An ``auto_cast`` context opened (+1) or closed (-1)."""
    global _amp_active
    with _op_timer_lock:
        _amp_active += delta
        _refresh()


# --- the timer fan-out ---------------------------------------------------------

def _op_timer_fanout(name, dt):
    for cb in _op_timer_subs:
        try:
            cb(name, dt)
        except Exception as e:   # a broken subscriber must not kill ops
            remove_op_timer(cb)
            sys.stderr.write(
                f"[paddle_tpu_torch] op-timer subscriber {cb!r} raised "
                f"{e!r}; unsubscribed\n")


def add_op_timer(callback):
    """Subscribe ``callback(op_name, wall_seconds)`` to every op.  Returns
    a zero-argument remover; subscribers coexist."""
    global _op_timer_subs
    with _op_timer_lock:
        _op_timer_subs = _op_timer_subs + (callback,)
        _refresh()
    return lambda: remove_op_timer(callback)


def remove_op_timer(callback):
    global _op_timer_subs
    with _op_timer_lock:
        _op_timer_subs = tuple(s for s in _op_timer_subs
                               if s is not callback)
        _refresh()


def _set_op_timer(timer):
    """The legacy single slot: ``_set_op_timer(cb)`` replaces the timer
    set before it (other subscribers stay); ``None`` clears the slot."""
    global _legacy_timer, _op_timer_subs
    with _op_timer_lock:
        if _legacy_timer is not None:
            _op_timer_subs = tuple(s for s in _op_timer_subs
                                   if s is not _legacy_timer)
            _legacy_timer = None
        if timer is not None:
            _legacy_timer = timer
            _op_timer_subs = _op_timer_subs + (timer,)
        _refresh()


# --- quiet passes ---------------------------------------------------------------

def is_quiet() -> bool:
    return getattr(_tls, "quiet", False)


@contextlib.contextmanager
def quiet():
    """Run a replay of dispatched work: casts apply, timers and AMP counts
    do not."""
    prev = is_quiet()
    _tls.quiet = True
    try:
        yield
    finally:
        _tls.quiet = prev


# --- the bus ----------------------------------------------------------------------

def run_op(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` as the op ``name``."""
    if not _hooked:
        return fn(*args, **kwargs)
    return _run_hooked(name, fn, args, kwargs)


def _run_hooked(name, fn, args, kwargs):
    tls = _tls
    if getattr(tls, "depth", 0):
        return fn(*args, **kwargs)       # inside another op's body
    tls.depth = 1
    try:
        timer = _op_timer
        if timer is not None and not getattr(tls, "quiet", False):
            t0 = time.perf_counter()
            try:
                return _run_op_impl(name, fn, args, kwargs)
            finally:
                timer(name, time.perf_counter() - t0)
        return _run_op_impl(name, fn, args, kwargs)
    finally:
        tls.depth = 0


def _run_op_impl(name, fn, args, kwargs):
    if _log_ops:
        print(f"[paddle_tpu_torch eager] {name}")
    if _amp_active:
        state = _amp_state
        if state is not None:
            args, kwargs = state.cast_args(name, args, kwargs)
    out = fn(*args, **kwargs)
    if _check_nan:
        _maybe_check_nan(name, out)
    return out


def _in_trace() -> bool:
    from ..jit import api

    return api.in_to_static_trace()


def _maybe_check_nan(name, out):
    """``FLAGS_check_nan_inf``: one host read per floating output."""
    leaves = out if isinstance(out, (list, tuple)) else [out]
    checked = [(i, t) for i, t in enumerate(leaves)
               if isinstance(t, torch.Tensor)
               and (t.is_floating_point() or t.is_complex())]
    if not checked or _in_trace():
        return
    for i, t in checked:
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        if bool((~torch.isfinite(t)).any()):
            msg = f"NaN/Inf detected in output {i} of op '{name}'"
            if flags.flag("check_nan_inf_level") >= 1:
                warnings.warn(msg, RuntimeWarning, stacklevel=4)
            else:
                raise FloatingPointError(msg)


def defop(name: str, fn: Callable):
    """An op from a plain function: ``defop(name, fn)(*a)`` is
    ``run_op(name, fn, *a)``."""
    def op(*args, **kwargs):
        return run_op(name, fn, *args, **kwargs)

    op.__name__ = name
    op.raw = fn
    return op


def op(name: str):
    """Decorator form of :func:`defop` that keeps the function's name,
    signature and docstring: ``@op("relu") def relu(x): ...``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _hooked:
                return fn(*args, **kwargs)
            return _run_hooked(name, fn, args, kwargs)

        wrapper.raw = fn
        wrapper.op_name = name
        return wrapper
    return deco
