"""Host span tracer: nestable named spans in a bounded ring buffer (the
subset of ``paddle_tpu/observability/tracer.py`` the serving engine uses:
``span`` and ``instant``).  Chrome-trace export is ROADMAP A8."""

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
    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "SpanTracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._stack().append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        span = self._span
        if exc_type is not None:
            span.attrs.setdefault("error", exc_type.__name__)
        span.duration = time.perf_counter() - span.start
        st = self._tracer._stack()
        while st and st[-1] is not span:  # tolerate mis-nested exits
            st.pop()
        if st:
            st.pop()
        self._tracer._record(span)
        return False


class SpanTracer:
    """Thread-safe span recorder over a bounded ring buffer: the most
    recent ``capacity`` spans are kept and the rest counted in
    ``dropped``."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        self.dropped = 0

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _new(self, name: str, cat: str, attrs) -> Span:
        st = self._stack()
        return Span(name, cat, time.perf_counter(), threading.get_ident(),
                    next(self._ids), st[-1].span_id if st else None,
                    dict(attrs))

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span)

    def span(self, name: str, cat: str = "host", **attrs) -> _SpanContext:
        """``with tracer.span("engine_step", step=3) as sp: ...``"""
        return _SpanContext(self, self._new(name, cat, attrs))

    def instant(self, name: str, cat: str = "event", **attrs) -> Span:
        """Zero-duration marker."""
        sp = self._new(name, cat, attrs)
        self._record(sp)
        return sp

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)


_global_tracer: Optional[SpanTracer] = None
_global_lock = threading.Lock()


def get_tracer() -> SpanTracer:
    """The process-wide default tracer (created on first use)."""
    global _global_tracer
    with _global_lock:
        if _global_tracer is None:
            _global_tracer = SpanTracer()
        return _global_tracer
