"""Hang/timeout watchdog for serving and training steps (the port of
``paddle_tpu/distributed/watchdog.py``, stdlib code carried over).

Capability analog of the reference's ``CommTaskManager``
(``paddle/phi/core/distributed/comm_task_manager.h:37``): per-collective
NCCL timeout detection with error propagation.  The unit of hang here is
the *step* (one engine step or train step — a wedged kernel or
collective shows up as a step that never returns), so the watchdog arms a
timer around step execution; on expiry it dumps all thread stacks and
invokes the failure callback (log / abort / custom elastic hook).
"""

from __future__ import annotations

import faulthandler
import sys
import threading
import time
import traceback
from typing import Callable, Optional


class StepWatchdog:
    """Arms a timeout around monitored sections (steps / collectives).

    Usage::

        wd = StepWatchdog(timeout=300, on_timeout=handler)
        with wd.watch("train_step"):
            loss = train_step(batch)
    """

    def __init__(self, timeout: float = 600.0,
                 on_timeout: Optional[Callable[[str, float], None]] = None,
                 abort: bool = False):
        self.timeout = timeout
        self.abort = abort
        self.on_timeout = on_timeout
        self._lock = threading.Lock()
        self._active = {}   # token -> (label, deadline)
        self._counter = 0
        from collections import deque

        self._fired = deque(maxlen=256)  # a wedged loop can fire forever
        self._thread = None
        self._stop = threading.Event()

    # --- monitoring loop --------------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(min(1.0, self.timeout / 10)):
            now = time.monotonic()
            with self._lock:
                expired = [(tok, lab) for tok, (lab, dl) in
                           self._active.items() if now > dl]
                for tok, _ in expired:
                    self._active.pop(tok, None)
            for _, label in expired:
                self._fire(label)

    def _fire(self, label: str):
        self._fired.append(label)
        dump_parts = []
        for tid, frame in sys._current_frames().items():
            dump_parts.append(f"--- thread {tid} ---\n"
                              + "".join(traceback.format_stack(frame)))
        dump = "".join(dump_parts)
        sys.stderr.write(
            f"[watchdog] section '{label}' exceeded {self.timeout}s — "
            f"possible hung collective / wedged step. Thread stacks:\n")
        sys.stderr.write(dump)
        # structured event alongside the stderr dump: lands in the process
        # span tracer (and any chrome export) with the thread dump attached
        try:
            from ..observability import get_tracer

            get_tracer().instant("watchdog_timeout", cat="watchdog",
                                 section=label,
                                 timeout_seconds=self.timeout,
                                 thread_dump=dump)
        except Exception:
            pass  # telemetry must never mask the timeout handling
        if self.on_timeout is not None:
            try:
                self.on_timeout(label, self.timeout)
            except Exception:
                pass
        if self.abort:
            faulthandler.dump_traceback()
            import os

            os._exit(124)

    # --- public API -------------------------------------------------------
    def watch(self, label: str = "step"):
        wd = self

        class _Section:
            def __enter__(self):
                wd._ensure_thread()
                with wd._lock:
                    wd._counter += 1
                    self.token = wd._counter
                    wd._active[self.token] = (label,
                                              time.monotonic() + wd.timeout)
                return self

            def __exit__(self, *exc):
                with wd._lock:
                    wd._active.pop(self.token, None)
                return False

        return _Section()

    def wrap(self, fn: Callable, label: Optional[str] = None) -> Callable:
        lab = label or getattr(fn, "__name__", "step")

        def wrapped(*a, **k):
            with self.watch(lab):
                return fn(*a, **k)

        return wrapped

    @property
    def fired(self):
        return list(self._fired)

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
