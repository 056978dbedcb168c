"""Cross-process tracing primitives (the port of
``paddle_tpu/observability/distrib.py``, stdlib code carried over whole).

A cross-process fleet (``serving/procfleet.py``) runs each replica's
engine in a worker process of its own (``serving/worker.py``).  These are
the pieces that carry the workers' telemetry across the process boundary:

* ``ClockSync`` — an NTP-style offset/RTT estimator over the two
  processes' *monotonic* clocks.  Every health round-trip (and every
  step round-trip — the NTP RTT formula subtracts server processing
  time, so steps are valid probes too) contributes a
  ``(t0, t1, t2, t3)`` sample; the min-RTT sample in a bounded window
  wins deterministically, and ``to_router()`` maps worker timestamps
  onto the router's clock so ONE chrome trace spans both processes.
* ``TelemetryOutbox`` — the worker-side bounded event buffer.  It is a
  ``LifecycleTracker`` listener; events are sequence-numbered so the
  router's merge is idempotent, and a full ring drops the oldest with
  an exact counter (never blocks the engine thread).
* ``DeltaMerger`` — the router-side consumer.  Deltas arrive on TWO
  connections (step replies on the engine conn, heartbeats on the
  control conn), so they can be legitimately reordered; an applied-seq
  *interval* tracker (not a naive high-water mark) makes the merge
  idempotent under both replay-after-respawn and out-of-order arrival.
  Applied events are offset-corrected onto the router clock, stamped
  with the worker's OS pid for chrome process splitting, injected into
  the router's ONE ``LifecycleTracker``, and mirrored locally.
* ``MirrorRing`` — the host-side bounded mirror of one worker's stream,
  so the ``engine_death`` flight bundle after kill -9 embeds the dead
  worker's events up to its last delta even though the worker's own
  memory is gone.

``WireStats`` attributes every cross-process step's wall time to host,
wire and engine from per-step timestamps taken at submit, worker
dequeue, engine start, engine end and reply receipt.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "ClockSync", "TelemetryOutbox", "DeltaMerger", "MirrorRing",
    "WireStats", "METRIC_NAMES",
]

# Metric series declared by this module (registered by the procfleet
# proxies that own the registry).
METRIC_NAMES = (
    "serving_wire_rtt_seconds",
    "serving_wire_queue_seconds",
    "serving_distrib_events_streamed_total",
    "serving_distrib_events_dropped_total",
    "serving_distrib_clock_offset_seconds",
    "serving_distrib_clock_rtt_seconds",
)


class ClockSync:
    """NTP-style offset/RTT estimator between two monotonic clocks.

    A sample is the classic four-timestamp exchange:

    * ``t0`` — router clock, just before the request frame is sent
    * ``t1`` — worker clock, at request receipt (dispatch entry)
    * ``t2`` — worker clock, just before the reply frame is sent
    * ``t3`` — router clock, at reply receipt

    ``offset = ((t1 - t0) + (t2 - t3)) / 2`` estimates
    ``worker_clock - router_clock``; its error is bounded by half the
    *asymmetry* of the two wire legs, so the sample with the smallest
    RTT (the least queueing noise) is the best estimate.  The filter is
    a deterministic ``min()`` over a bounded window — first-wins on
    ties, no wall clock, no randomness — so tests can drive it with
    synthetic sequences and assert exact outputs.
    """

    def __init__(self, window: int = 64):
        self._samples: deque = deque(maxlen=max(1, int(window)))
        self._lock = threading.Lock()
        self._count = 0

    def observe(self, t0: float, t1: float, t2: float,
                t3: float) -> None:
        """Record one four-timestamp exchange."""
        rtt = (t3 - t0) - (t2 - t1)
        if rtt < 0:
            return  # clock torn mid-sample (e.g. suspend); not usable
        offset = ((t1 - t0) + (t2 - t3)) / 2.0
        with self._lock:
            self._samples.append((rtt, offset))
            self._count += 1

    def _best(self) -> Optional[Tuple[float, float]]:
        with self._lock:
            if not self._samples:
                return None
            # min() scans left-to-right and keeps the FIRST minimal
            # element — deterministic under ties.
            return min(self._samples, key=lambda s: s[0])

    @property
    def offset(self) -> float:
        """Best estimate of ``worker_clock - router_clock`` (0.0 when
        no sample has been observed yet)."""
        best = self._best()
        return best[1] if best is not None else 0.0

    @property
    def rtt(self) -> float:
        """RTT of the best (minimum-RTT) sample; 0.0 when empty."""
        best = self._best()
        return best[0] if best is not None else 0.0

    @property
    def samples(self) -> int:
        with self._lock:
            return self._count

    def to_router(self, worker_ts: float) -> float:
        """Map a worker-clock timestamp onto the router's clock."""
        return worker_ts - self.offset

    def snapshot(self) -> Dict[str, Any]:
        return {
            "offset_s": round(self.offset, 9),
            "rtt_s": round(self.rtt, 9),
            "samples": self.samples,
        }


class TelemetryOutbox:
    """Worker-side bounded, sequence-numbered lifecycle event buffer.

    Registered as a ``LifecycleTracker`` listener inside the worker
    process; each event gets a monotonically increasing ``seq`` so the
    router can merge deltas idempotently (replay after a reconnect or
    reorder across the two connections adds nothing twice).  When the
    ring is full the OLDEST undelivered event is dropped and counted —
    the engine thread never blocks on telemetry.
    """

    def __init__(self, capacity: int = 1024):
        self._buf: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0

    def on_event(self, rid: str, name: str, ts: float, tid: int,
                 attrs: Dict[str, Any]) -> None:
        """LifecycleTracker listener entry point (worker process)."""
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append({
                "seq": self._seq, "rid": rid, "name": name,
                "ts": ts, "tid": tid, "attrs": dict(attrs),
            })
            self._seq += 1

    def push(self, rid: str, name: str, ts: float,
             **attrs: Any) -> None:
        """Enqueue a synthetic (non-lifecycle) event, e.g. a per-step
        record the worker wants mirrored host-side."""
        self.on_event(rid, name, ts, 0, attrs)

    def drain(self, limit: int = 256) -> Dict[str, Any]:
        """Pop up to ``limit`` oldest events for piggybacking onto a
        reply frame.  Returns the events plus the cumulative dropped
        count (so the router's gauge is absolute, not a diff)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            n = min(max(0, int(limit)), len(self._buf))
            for _ in range(n):
                out.append(self._buf.popleft())
            dropped = self._dropped
        return {"events": out, "dropped": dropped}

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._buf)


class MirrorRing:
    """Bounded host-side mirror of one worker's event stream.

    The router appends every merged event here so that when the worker
    is kill -9'd the ``engine_death`` flight bundle can embed the
    worker's events up to its last delivered delta — the worker's own
    rings died with the process.
    """

    def __init__(self, capacity: int = 512):
        self._buf: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._dropped = 0

    def append(self, event: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(event)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "events": list(self._buf),
                "dropped": self._dropped,
            }


class DeltaMerger:
    """Router-side consumer of one worker incarnation's deltas.

    Deltas for the SAME outbox arrive over two connections — step
    replies on the engine conn, heartbeat replies on the control conn —
    so batches can be legitimately reordered in arrival order even
    though each batch is internally ordered.  A naive ``last_seq``
    high-water mark would silently drop a reordered batch, so applied
    sequence numbers are tracked as merged ``(start, end)`` intervals:
    replay adds nothing, reorder loses nothing.  The interval list
    stays tiny (gaps only exist transiently) and is capped as a
    safety bound.

    One merger lives per worker *incarnation* — the proxy rebuilds it
    (with seq state reset) on every respawn, matching the fresh outbox
    in the new process.
    """

    _MAX_INTERVALS = 64

    def __init__(self, replica: str, worker_pid: int, clock: ClockSync,
                 mirror: MirrorRing,
                 lifecycle_getter: Callable[[], Any],
                 counters: Optional[Dict[str, Any]] = None):
        self.replica = str(replica)
        self.worker_pid = int(worker_pid)
        self.clock = clock
        self.mirror = mirror
        self._lifecycle_getter = lifecycle_getter
        self._counters = counters or {}
        self._lock = threading.Lock()
        self._intervals: List[List[int]] = []  # merged [start, end]
        self._applied = 0
        self._worker_dropped = 0

    # -- interval bookkeeping -------------------------------------
    def _mark(self, seq: int) -> bool:
        """Record ``seq`` as applied; False when already applied."""
        iv = self._intervals
        lo, hi = 0, len(iv)
        while lo < hi:
            mid = (lo + hi) // 2
            if iv[mid][1] < seq:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(iv) and iv[lo][0] <= seq <= iv[lo][1]:
            return False
        # extend a neighbour or insert a fresh interval, then coalesce
        if lo < len(iv) and iv[lo][0] == seq + 1:
            iv[lo][0] = seq
        elif lo > 0 and iv[lo - 1][1] == seq - 1:
            iv[lo - 1][1] = seq
            lo -= 1
        else:
            iv.insert(lo, [seq, seq])
        if lo + 1 < len(iv) and iv[lo][1] + 1 == iv[lo + 1][0]:
            iv[lo][1] = iv[lo + 1][1]
            del iv[lo + 1]
        if lo > 0 and iv[lo - 1][1] + 1 == iv[lo][0]:
            iv[lo - 1][1] = iv[lo][1]
            del iv[lo]
        if len(iv) > self._MAX_INTERVALS:
            # safety bound: collapse the oldest gap (events that far
            # behind were dropped by the worker's outbox anyway)
            iv[0] = [iv[0][0], iv[1][1]]
            del iv[1]
        return True

    # -- delta application ----------------------------------------
    def merge(self, delta: Optional[Dict[str, Any]]) -> int:
        """Apply one piggybacked delta; returns events newly applied."""
        if not delta:
            return 0
        events = delta.get("events") or ()
        applied = 0
        lc = self._lifecycle_getter()
        with self._lock:
            self._worker_dropped = max(
                self._worker_dropped, int(delta.get("dropped", 0)))
            fresh = [ev for ev in events
                     if isinstance(ev.get("seq"), int)
                     and self._mark(ev["seq"])]
            self._applied += len(fresh)
        for ev in fresh:
            attrs = dict(ev.get("attrs") or {})
            attrs.setdefault("replica", self.replica)
            attrs["chrome_pid"] = self.worker_pid
            ts = self.clock.to_router(float(ev.get("ts", 0.0)))
            mirrored = {
                "seq": ev["seq"], "rid": ev.get("rid"),
                "name": ev.get("name"), "ts": ts,
                "attrs": attrs,
            }
            self.mirror.append(mirrored)
            if lc is not None and ev.get("name") and ev.get("rid"):
                try:
                    lc.merge_event(str(ev.get("rid")),
                                   str(ev["name"]), ts,
                                   int(ev.get("tid", 0)), **attrs)
                except Exception:  # swallow-ok: telemetry merge is best-effort; a malformed delta must never take down the step/heartbeat thread applying it
                    pass
            applied += 1
        return applied

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            last = self._intervals[-1][1] if self._intervals else -1
            return {
                "applied": self._applied,
                "last_seq": last,
                "worker_dropped": self._worker_dropped,
                "intervals": len(self._intervals),
            }

    @property
    def applied(self) -> int:
        with self._lock:
            return self._applied

    @property
    def worker_dropped(self) -> int:
        with self._lock:
            return self._worker_dropped


class WireStats:
    """Per-step host-vs-wire-vs-engine latency attribution.

    Each cross-process step yields six timestamps (router clock t0/t3,
    worker clock the rest — differences within one clock need no
    offset correction):

    * ``t0``   router: just before the step frame is serialized
    * ``recv`` worker: frame decoded, dispatch entry
    * ``eng0`` worker: just before ``engine.step()``
    * ``eng1`` worker: just after ``engine.step()``
    * ``reply`` worker: just before the step_done frame is sent
    * ``t3``   router: step_done decoded

    ``wire  = (t3 - t0) - (reply - recv)`` — both wire legs plus
    serialization, the NTP trick that cancels the clock offset.
    ``queue = eng0 - recv`` — worker-side dequeue/dispatch overhead.
    ``engine = eng1 - eng0`` — real engine time.  The remainder of the
    router's step wall is host-scheduler time.  Shares are reported
    per-program (program names from the worker's step records) and in
    aggregate for ``/v1/debug/wire``, ``summary()``, and the bench
    procfleet phase.
    """

    _MAX_PROGRAMS = 64

    def __init__(self, registry: Any = None,
                 labels: Optional[Dict[str, str]] = None):
        self._lock = threading.Lock()
        self._steps = 0
        self._wire = 0.0
        self._queue = 0.0
        self._engine = 0.0
        self._total = 0.0
        self._per_program: Dict[str, Dict[str, float]] = {}
        self._h_rtt = self._h_queue = None
        if registry is not None:
            lb = labels or {}
            buckets = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                       0.05, 0.1, 0.25, 1.0)
            self._h_rtt = registry.histogram(
                "serving_wire_rtt_seconds",
                "wire round-trip share of one cross-process step "
                "(both legs + serialization, offset-free)",
                buckets=buckets, **lb)
            self._h_queue = registry.histogram(
                "serving_wire_queue_seconds",
                "worker-side dequeue/dispatch overhead of one "
                "cross-process step",
                buckets=buckets, **lb)

    def observe(self, t0: float, t3: float,
                stamps: Optional[Dict[str, Any]],
                program: Optional[str] = None) -> None:
        """Fold one step round-trip into the aggregates.  ``stamps``
        is the worker's ``{"recv","eng0","eng1","reply"}`` dict; a
        reply without stamps (telemetry off, old worker) is skipped."""
        if not stamps:
            return
        try:
            recv = float(stamps["recv"])
            eng0 = float(stamps["eng0"])
            eng1 = float(stamps["eng1"])
            reply = float(stamps["reply"])
        except (KeyError, TypeError, ValueError):
            return  # swallow-ok: stamps are an OPTIONAL protocol field — a partial dict means no attribution for this step, never a crash on the step path
        total = max(t3 - t0, 0.0)
        wire = max(total - max(reply - recv, 0.0), 0.0)
        queue = max(eng0 - recv, 0.0)
        engine = max(eng1 - eng0, 0.0)
        if self._h_rtt is not None:
            self._h_rtt.observe(wire)
        if self._h_queue is not None:
            self._h_queue.observe(queue)
        prog = str(program) if program else "idle"
        with self._lock:
            self._steps += 1
            self._wire += wire
            self._queue += queue
            self._engine += engine
            self._total += total
            pp = self._per_program.get(prog)
            if pp is None:
                if len(self._per_program) >= self._MAX_PROGRAMS:
                    prog = "_other"  # bounded: aggregate the tail
                    pp = self._per_program.get(prog)
                if pp is None:
                    pp = self._per_program[prog] = {
                        "steps": 0, "wire_s": 0.0, "queue_s": 0.0,
                        "engine_s": 0.0, "total_s": 0.0}
            pp["steps"] += 1
            pp["wire_s"] += wire
            pp["queue_s"] += queue
            pp["engine_s"] += engine
            pp["total_s"] += total

    @staticmethod
    def _shares(row: Dict[str, float]) -> Dict[str, Any]:
        total = row["total_s"]
        if total <= 0:
            return {"wire": 0.0, "engine": 0.0, "host": 0.0}
        wire = row["wire_s"] + row["queue_s"]
        engine = row["engine_s"]
        host = max(total - wire - engine, 0.0)
        return {
            "wire": round(wire / total, 4),
            "engine": round(engine / total, 4),
            "host": round(host / total, 4),
        }

    def report(self) -> Dict[str, Any]:
        """The host-vs-wire-vs-engine attribution block."""
        with self._lock:
            agg = {"steps": self._steps, "wire_s": self._wire,
                   "queue_s": self._queue, "engine_s": self._engine,
                   "total_s": self._total}
            per_prog = {
                name: dict(row,
                           wire_s=round(row["wire_s"], 6),
                           queue_s=round(row["queue_s"], 6),
                           engine_s=round(row["engine_s"], 6),
                           total_s=round(row["total_s"], 6),
                           shares=self._shares(row))
                for name, row in sorted(self._per_program.items())
            }
        return {
            "steps": agg["steps"],
            "wire_s": round(agg["wire_s"], 6),
            "queue_s": round(agg["queue_s"], 6),
            "engine_s": round(agg["engine_s"], 6),
            "total_s": round(agg["total_s"], 6),
            "shares": self._shares(agg),
            "per_program": per_prog,
        }

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps
