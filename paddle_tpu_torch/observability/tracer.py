"""Host span tracer: nestable named spans in a bounded ring buffer (the
port of ``paddle_tpu/observability/tracer.py``): a substrate every layer
can write to — serving engine steps, graph captures, step-profile
windows.  Design constraints:

* **thread-safe** — the serving engine, HTTP handler threads and
  exporters may record concurrently; finished spans go into
  one ring under a lock, per-thread nesting state lives in a
  ``threading.local`` stack.
* **bounded** — the ring is a ``deque(maxlen=capacity)``; a long-lived
  server keeps the most recent ``capacity`` spans and counts the rest in
  ``dropped`` instead of growing without bound.
* **exportable** — :meth:`export_chrome` writes real Chrome trace-event
  JSON (``ph:"X"`` complete events with explicit ``id``/``parent`` args,
  so nesting round-trips exactly through
  :func:`~paddle_tpu_torch.observability.load_profiler_result`).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


class Span:
    """One finished (or in-flight) named span."""

    __slots__ = ("name", "cat", "start", "duration", "tid", "attrs",
                 "span_id", "parent_id")

    def __init__(self, name: str, cat: str, start: float, tid: int,
                 span_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.start = start          # perf_counter seconds
        self.duration = 0.0         # seconds; 0.0 for instant events
        self.tid = tid
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs

    def set_attribute(self, key: str, value) -> None:
        self.attrs[key] = value

    def __repr__(self):
        return (f"Span({self.name!r}, cat={self.cat!r}, "
                f"dur={self.duration * 1e3:.3f}ms, attrs={self.attrs})")


class _SpanContext:
    """Context manager handed out by :meth:`SpanTracer.span`."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "SpanTracer", span: Span):
        self._tracer = tracer
        self._span = span

    def set_attribute(self, key: str, value) -> None:
        self._span.set_attribute(key, value)

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(self._span)
        return False


class SpanTracer:
    """Thread-safe span recorder over a bounded ring buffer."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring = deque(maxlen=capacity)  # finished spans, oldest out
        self._lock = threading.Lock()
        self._tls = threading.local()        # per-thread open-span stack
        self._ids = itertools.count(1)
        self.dropped = 0
        # perf_counter -> wall epoch offset, so exported timestamps are
        # real times comparable across processes
        self.epoch_offset = time.time() - time.perf_counter()

    # --- nesting (per-thread) ----------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        span.duration = time.perf_counter() - span.start
        st = self._stack()
        while st and st[-1] is not span:  # tolerate mis-nested exits
            st.pop()
        if st:
            st.pop()
        self._record(span)

    # --- recording ----------------------------------------------------------
    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span)

    def span(self, name: str, cat: str = "host", **attrs) -> _SpanContext:
        """``with tracer.span("engine_step", step=3) as sp: ...``"""
        parent = self.current_span()
        sp = Span(name, cat, time.perf_counter(),
                  threading.get_ident(), next(self._ids),
                  parent.span_id if parent else None, dict(attrs))
        return _SpanContext(self, sp)

    def instant(self, name: str, cat: str = "event", **attrs) -> Span:
        """Zero-duration marker (chrome ``ph:"i"``), e.g. a watchdog
        timeout or a preemption decision."""
        parent = self.current_span()
        sp = Span(name, cat, time.perf_counter(),
                  threading.get_ident(), next(self._ids),
                  parent.span_id if parent else None, dict(attrs))
        self._record(sp)
        return sp

    def add_span(self, name: str, start: float, duration: float,
                 cat: str = "host", **attrs) -> Span:
        """Record a span with explicit perf_counter timestamps — used by
        the dispatch bus, which only learns (name, wall_seconds) after the
        op ran."""
        parent = self.current_span()
        sp = Span(name, cat, start, threading.get_ident(), next(self._ids),
                  parent.span_id if parent else None, dict(attrs))
        sp.duration = duration
        self._record(sp)
        return sp

    # --- inspection ---------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # --- export -------------------------------------------------------------
    def export_chrome(self, path: str) -> str:
        """Write the ring as Chrome trace-event JSON; returns ``path``."""
        from .export import export_chrome_trace

        return export_chrome_trace(self.spans(), path,
                                   epoch_offset=self.epoch_offset)


_global_tracer: Optional[SpanTracer] = None
_global_lock = threading.Lock()


def get_tracer() -> SpanTracer:
    """The process-wide default tracer (created on first use)."""
    global _global_tracer
    if _global_tracer is None:
        with _global_lock:
            if _global_tracer is None:
                _global_tracer = SpanTracer()
    return _global_tracer


def set_tracer(tracer: Optional[SpanTracer]) -> Optional[SpanTracer]:
    """Swap the process-wide tracer (tests, custom capacity); returns the
    previous one."""
    global _global_tracer
    with _global_lock:
        prev, _global_tracer = _global_tracer, tracer
    return prev
