"""Request-lifecycle tracing: bounded per-request event timelines (the
port of ``paddle_tpu/observability/lifecycle.py``).

The aggregate serving telemetry (``serving_*`` histograms, replica
gauges) answers "how is the fleet doing" but not "where did request
cmpl-17's 400 ms go".  This module adds the per-request layer production
LLM serving treats as first-class (vLLM's request-level metrics, Orca's
iteration-level scheduling — PAPERS.md): every request accumulates a
**bounded structured event timeline** — admission verdict, routing
decision (affinity vs fallback, target replica), queue wait, each
prefill chunk with token counts, sampled per-token decode ITL,
preemption/recompute, finish/abort reason — causally linked across the
router thread and the owning replica's engine thread by the request /
trace id, and exportable as a single per-request Chrome trace.

Memory contract:

* one :class:`RequestTimeline` holds at most ``max_events`` events in a
  ``deque(maxlen=...)``; overflow increments ``dropped`` (and the
  tracker-wide ``serving_lifecycle_events_dropped_total`` counter)
  instead of growing;
* the tracker keeps timelines for **in-flight** requests (bounded by
  the admission caps upstream) plus a bounded ring of ``recent``
  finished ones, so ``GET /v1/requests/{id}`` works shortly after a
  request completes without the tracker ever growing with traffic;
* streaming aggregates (ITL count/sum/max, preemption count, phase
  timestamps) are O(1) per request no matter how many tokens decode —
  the per-token event itself is **sampled** (``decode_sample``: record
  every Nth; the histograms observe every token regardless).

Everything is wall-clock-correlatable: timestamps are
``time.perf_counter`` seconds plus a per-tracker epoch offset (the
:class:`~paddle_tpu_torch.observability.SpanTracer` convention), so a
per-request export and a process-wide tracer export line up in one
Chrome viewer.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .metrics import MetricsRegistry
from .tracer import Span

# event names with first-class aggregate handling (everything else is
# recorded verbatim); kept here so the engine/router/tests share one
# vocabulary instead of scattering string literals
EV_SUBMITTED = "submitted"          # router/caller accepted the request
EV_ROUTE = "route"                  # routing decision (replica, affinity)
EV_ENQUEUED = "enqueued"            # entered an engine's waiting queue
EV_ADMITTED = "admitted"            # scheduler admission verdict (+cache)
EV_ADMISSION_REJECTED = "admission_rejected"  # unservable at admission
EV_PREFILL_CHUNK = "prefill_chunk"  # one bucketed prefill program ran
EV_FIRST_TOKEN = "first_token"
EV_DECODE_TOKEN = "decode_token"    # sampled; aggregates cover all
EV_PREEMPTED = "preempted"
EV_KV_HANDOFF = "kv_handoff"        # prefill→decode migration
EV_FINISH = "finish"

# the metric names this module registers
METRIC_NAMES = (
    "serving_lifecycle_events_total",
    "serving_lifecycle_events_dropped_total",
)


class TimelineEvent:
    """One timeline entry: monotonic timestamp, name, recording thread,
    and a small attrs dict."""

    __slots__ = ("ts", "name", "tid", "attrs")

    def __init__(self, ts: float, name: str, tid: int, attrs: Dict):
        self.ts = ts
        self.name = name
        self.tid = tid
        self.attrs = attrs

    def __repr__(self):
        return f"TimelineEvent({self.name!r}, ts={self.ts:.6f})"


class RequestTimeline:
    """One request's bounded event timeline + O(1) streaming aggregates.

    Mutated only via :meth:`LifecycleTracker.event` (which holds the
    tracker lock); readers get copies/snapshots."""

    __slots__ = (
        "request_id", "trace_id", "state", "events", "dropped", "replica",
        "prompt_tokens", "slo_ms", "lock",
        "arrival_ts", "admitted_ts", "prefill_start_ts", "first_token_ts",
        "finish_ts", "finish_reason",
        "decode_tokens", "itl_sum", "itl_max", "preemptions",
        "prefill_chunks", "prefill_tokens", "cached_tokens",
    )

    def __init__(self, request_id, trace_id: Optional[str],
                 max_events: int, lock: Optional[threading.Lock] = None):
        # writers (_add) run under the TRACKER's lock, which is shared
        # here so readers (to_dict/chrome_spans) can snapshot the event
        # deque without racing a concurrent append from the engine
        # thread — iterating a mutating deque raises RuntimeError
        self.lock = lock if lock is not None else threading.Lock()
        self.request_id = request_id
        self.trace_id = trace_id if trace_id is not None else str(request_id)
        self.state = "active"
        self.events: deque = deque(maxlen=max_events)
        self.dropped = 0
        self.replica: Optional[str] = None
        self.prompt_tokens: Optional[int] = None
        self.slo_ms: Optional[float] = None
        self.arrival_ts: Optional[float] = None
        self.admitted_ts: Optional[float] = None
        self.prefill_start_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.decode_tokens = 0
        self.itl_sum = 0.0
        self.itl_max = 0.0
        self.preemptions = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.cached_tokens = 0

    # --- recording (tracker-lock held) --------------------------------------
    def _add(self, ev: TimelineEvent, record_event: bool = True) -> None:
        if self.arrival_ts is None:
            self.arrival_ts = ev.ts
        name, attrs = ev.name, ev.attrs
        if attrs.get("slo_ms") is not None:
            self.slo_ms = float(attrs["slo_ms"])
        if attrs.get("prompt_tokens") is not None:
            self.prompt_tokens = attrs["prompt_tokens"]
        if name in (EV_ROUTE, EV_ENQUEUED) \
                and attrs.get("replica") is not None:
            self.replica = str(attrs["replica"])
        if name == EV_ADMITTED:
            self.admitted_ts = ev.ts
            self.cached_tokens = attrs.get("cached_tokens",
                                           self.cached_tokens)
        elif name == EV_PREFILL_CHUNK:
            if self.prefill_start_ts is None:
                self.prefill_start_ts = ev.ts - attrs.get("duration_s", 0.0)
            self.prefill_chunks += 1
            self.prefill_tokens += attrs.get("tokens", 0)
        elif name == EV_FIRST_TOKEN:
            self.first_token_ts = ev.ts
        elif name == EV_DECODE_TOKEN:
            # aggregates count EVERY token; the event itself may be a
            # sampled subset (the caller passes record_event=False for
            # the unsampled ones)
            itl = float(attrs.get("itl_s", 0.0))
            self.decode_tokens += 1
            self.itl_sum += itl
            self.itl_max = max(self.itl_max, itl)
        elif name == EV_PREEMPTED:
            self.preemptions += 1
        elif name in (EV_FINISH, EV_ADMISSION_REJECTED):
            self.finish_ts = ev.ts
            self.finish_reason = attrs.get("reason", self.finish_reason)
            self.state = "finished"
        if record_event:
            if len(self.events) == self.events.maxlen:
                self.dropped += 1
            self.events.append(ev)

    # --- views --------------------------------------------------------------
    @property
    def generated_tokens(self) -> int:
        # first token is emitted by the final prefill chunk, decode
        # aggregates count the rest
        return self.decode_tokens + (1 if self.first_token_ts else 0)

    def summary(self, epoch_offset: float = 0.0) -> Dict:
        """O(1) JSON-able summary (the ``GET /v1/requests`` list row)."""
        end = self.finish_ts
        out = {
            "id": str(self.request_id),
            "trace_id": self.trace_id,
            "state": self.state,
            "replica": self.replica,
            "prompt_tokens": self.prompt_tokens,
            "generated_tokens": self.generated_tokens,
            "preemptions": self.preemptions,
            "prefill_chunks": self.prefill_chunks,
            "cached_tokens": self.cached_tokens,
            "finish_reason": self.finish_reason,
            "events": len(self.events),
            "events_dropped": self.dropped,
            "slo_ms": self.slo_ms,
        }
        if self.arrival_ts is not None:
            out["arrival_unix"] = round(self.arrival_ts + epoch_offset, 6)
        # phase breakdown (whatever is measurable so far)
        if self.prefill_start_ts and self.arrival_ts is not None:
            out["queue_wait_s"] = round(
                self.prefill_start_ts - self.arrival_ts, 6)
        if self.first_token_ts and self.prefill_start_ts:
            out["prefill_s"] = round(
                self.first_token_ts - self.prefill_start_ts, 6)
        if self.first_token_ts and self.arrival_ts is not None:
            out["ttft_s"] = round(self.first_token_ts - self.arrival_ts, 6)
        if self.decode_tokens:
            out["itl_avg_s"] = round(self.itl_sum / self.decode_tokens, 6)
            out["itl_max_s"] = round(self.itl_max, 6)
        if end is not None and self.arrival_ts is not None:
            out["e2e_s"] = round(end - self.arrival_ts, 6)
            if self.slo_ms is not None:
                out["slo_met"] = (end - self.arrival_ts) * 1e3 <= self.slo_ms
        return out

    def _snapshot_events(self) -> List[TimelineEvent]:
        """Copy the event ring under the shared writer lock (safe while
        the owning engine thread is still appending)."""
        with self.lock:
            return list(self.events)

    def to_dict(self, epoch_offset: float = 0.0) -> Dict:
        """Full timeline: summary + every retained event (the
        ``GET /v1/requests/{id}`` body)."""
        events = [
            dict(ev.attrs, t=round(ev.ts + epoch_offset, 6),
                 name=ev.name, tid=ev.tid)
            for ev in self._snapshot_events()
        ]
        return {"summary": self.summary(epoch_offset), "events": events}

    # --- chrome export ------------------------------------------------------
    def chrome_spans(self) -> List[Span]:
        """Rebuild the request's lifecycle as tracer :class:`Span`
        objects: one root span, phase spans (queue / prefill / decode)
        and per-chunk spans synthesized from the aggregate timestamps,
        plus every retained event as an instant — each on the thread
        that recorded it, so the router thread and the owning replica's
        engine thread show as separate chrome rows linked by the shared
        ``request``/``trace`` args."""
        spans: List[Span] = []
        if self.arrival_ts is None:
            return spans
        events = self._snapshot_events()
        next_id = iter(range(1, 1 + 16 + 4 * len(events))).__next__
        base = {"request": str(self.request_id), "trace": self.trace_id}
        root_tid = events[0].tid if events else 0
        engine_tid = next(
            (e.tid for e in events
             if e.name in (EV_PREFILL_CHUNK, EV_FIRST_TOKEN, EV_ADMITTED)),
            root_tid)
        end = self.finish_ts if self.finish_ts is not None else (
            events[-1].ts if events else self.arrival_ts)
        root = Span(f"request {self.request_id}", "lifecycle",
                    self.arrival_ts, root_tid, next_id(), None,
                    dict(base, state=self.state,
                         finish_reason=self.finish_reason))
        root.duration = max(end - self.arrival_ts, 1e-9)
        spans.append(root)

        def phase(name, start, stop, tid, **attrs):
            if start is None or stop is None or stop < start:
                return
            sp = Span(name, "lifecycle", start, tid, next_id(),
                      root.span_id, dict(base, **attrs))
            sp.duration = max(stop - start, 1e-9)
            spans.append(sp)

        phase("queue", self.arrival_ts, self.prefill_start_ts, engine_tid)
        phase("prefill", self.prefill_start_ts, self.first_token_ts,
              engine_tid, chunks=self.prefill_chunks,
              tokens=self.prefill_tokens, cached=self.cached_tokens)
        if self.decode_tokens:
            phase("decode", self.first_token_ts, end, engine_tid,
                  tokens=self.decode_tokens,
                  itl_avg_s=(self.itl_sum / self.decode_tokens))
        for ev in events:
            if ev.name == EV_PREFILL_CHUNK:
                dur = float(ev.attrs.get("duration_s", 0.0))
                sp = Span(EV_PREFILL_CHUNK, "lifecycle", ev.ts - dur,
                          ev.tid, next_id(), root.span_id,
                          dict(base, **{k: v for k, v in ev.attrs.items()
                                        if k != "duration_s"}))
                sp.duration = max(dur, 1e-9)
                spans.append(sp)
            else:
                spans.append(Span(ev.name, "lifecycle", ev.ts, ev.tid,
                                  next_id(), root.span_id,
                                  dict(base, **ev.attrs)))
        return spans


class LifecycleTracker:
    """Process-side store of request timelines (one per fleet/engine).

    ``event(rid, name, **attrs)`` auto-creates the timeline, so the
    router (which sees the request first) and the engine (which may see
    it first in direct-engine use) need no coordination.  Listeners
    (the flight recorder) receive every event — including engine-level
    ``rid=None`` events that belong to no single request — outside the
    tracker lock."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 enabled: bool = True,
                 max_events_per_request: int = 256,
                 recent: int = 64,
                 decode_sample: int = 1):
        self.enabled = enabled
        self.registry = registry
        self.max_events_per_request = max(8, int(max_events_per_request))
        # record every Nth decode-token EVENT (aggregates see them all);
        # 0 disables decode-token events entirely
        self.decode_sample = max(0, int(decode_sample))
        self.epoch_offset = time.time() - time.perf_counter()
        self._lock = threading.Lock()
        self._active: Dict[object, RequestTimeline] = {}  # bounded by the
        # upstream admission caps: entries move to _recent on finish
        self._recent: deque = deque(maxlen=max(1, recent))
        self._listeners: tuple = ()
        self._events_c = None    # lazily registered so a tracker that is
        self._dropped_c = None   # replaced before use adds no series

    # --- metrics ------------------------------------------------------------
    def _count(self, dropped: bool = False) -> None:
        if self.registry is None:
            return
        if self._events_c is None:
            self._events_c = self.registry.counter(
                "serving_lifecycle_events_total",
                "request-lifecycle events recorded")
            self._dropped_c = self.registry.counter(
                "serving_lifecycle_events_dropped_total",
                "request-lifecycle events dropped (per-request ring full)")
        (self._dropped_c if dropped else self._events_c).inc()

    # --- listeners ----------------------------------------------------------
    def add_listener(self, fn: Callable) -> Callable[[], None]:
        """``fn(rid, name, ts, tid, attrs)`` on every event; returns a
        zero-arg remover.  Immutable-tuple fan-out (the op-bus idiom)."""
        with self._lock:
            self._listeners = self._listeners + (fn,)

        def remove():
            with self._lock:
                self._listeners = tuple(
                    f for f in self._listeners if f is not fn)
        return remove

    # --- recording ----------------------------------------------------------
    def event(self, rid, name: str, **attrs) -> None:
        """Record one event.  ``rid=None`` fans out to listeners only
        (engine-level events like a prefix-cache eviction sweep)."""
        if not self.enabled:
            return
        self._record(rid, name, time.perf_counter(),
                     threading.get_ident(), attrs)

    def merge_event(self, rid, name: str, ts: float, tid: int,
                    **attrs) -> None:
        """Inject an event with an EXPLICIT timestamp/thread id — the
        cross-process merge path (``observability.distrib``): a worker's
        streamed event lands on the router's tracker with its
        offset-corrected worker timestamp, not the merge time."""
        if not self.enabled:
            return
        self._record(rid, name, float(ts), int(tid), attrs)

    def _record(self, rid, name: str, ts: float, tid: int,
                attrs: Dict) -> None:
        record_event = True
        if rid is not None:
            with self._lock:
                tl = self._active.get(rid)
                if tl is None and name not in (EV_SUBMITTED, EV_ENQUEUED):
                    # late events (post-finish aborts etc.) still land on
                    # the finished timeline in the recent ring — but a
                    # START event under a reused id must NOT resurrect
                    # the previous request's timeline
                    tl = self._find_recent(rid)
                if tl is None:
                    tl = RequestTimeline(
                        rid, attrs.get("trace_id"),
                        self.max_events_per_request, lock=self._lock)
                    self._active[rid] = tl
                if name == EV_DECODE_TOKEN:
                    s = self.decode_sample
                    record_event = bool(s) and (tl.decode_tokens % s == 0)
                before = tl.dropped
                tl._add(TimelineEvent(ts, name, tid, dict(attrs)),
                        record_event=record_event)
                dropped = tl.dropped > before
                if tl.state == "finished" and rid in self._active:
                    self._active.pop(rid, None)
                    self._recent.append(tl)
            if record_event:
                self._count()
            if dropped:
                self._count(dropped=True)
            if not record_event:
                # sampled-out decode token: the O(1) aggregates above
                # are exact, but the per-token fan-out (flight ring
                # append + dict build per listener) is exactly the hot-
                # path cost decode_sample exists to shed — skip it
                return
        for fn in self._listeners:
            try:
                fn(rid, name, ts, tid, attrs)
            except Exception:
                pass  # swallow-ok: telemetry must never take down the engine thread; a broken listener loses its own mirror, not the timeline

    # --- lookup -------------------------------------------------------------
    def _find_recent(self, rid) -> Optional[RequestTimeline]:
        for tl in self._recent:
            if tl.request_id == rid:
                return tl
        return None

    def get(self, rid) -> Optional[RequestTimeline]:
        """Active first, then the recent ring (ids may be reused across
        runs — the newest wins)."""
        with self._lock:
            tl = self._active.get(rid)
            if tl is not None:
                return tl
            for t in reversed(self._recent):
                if t.request_id == rid or str(t.request_id) == str(rid):
                    return t
        return None

    def active(self) -> List[RequestTimeline]:
        with self._lock:
            return list(self._active.values())

    def recent(self) -> List[RequestTimeline]:
        with self._lock:
            return list(self._recent)

    def summaries(self, state: str = "active") -> List[Dict]:
        tls = self.active() if state == "active" else self.recent()
        return [tl.summary(self.epoch_offset) for tl in tls]

    # --- export -------------------------------------------------------------
    def chrome_trace(self, rid) -> Optional[Dict]:
        """The request's lifecycle as a Chrome trace-event dict
        (``None`` for an unknown id)."""
        from .export import chrome_trace_dict

        tl = self.get(rid)
        if tl is None:
            return None
        return chrome_trace_dict(tl.chrome_spans(),
                                 epoch_offset=self.epoch_offset)

    def export_chrome(self, rid, path: str) -> str:
        """Write one request's timeline as a Chrome trace JSON file."""
        from .export import export_chrome_trace

        tl = self.get(rid)
        if tl is None:
            raise KeyError(f"no timeline for request {rid!r}")
        return export_chrome_trace(tl.chrome_spans(), path,
                                   epoch_offset=self.epoch_offset)
