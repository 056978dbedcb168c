"""Bounded in-process metrics history for the serving stack (the port of
``paddle_tpu/observability/history.py``).

Every observability layer so far is point-in-time: ``/metrics`` is an
instant snapshot, the fleet gauges are only as fresh as the last
refresh, and nothing watches a series *over time*.  This module adds the
missing axis: a :class:`HistoryStore` samples a shared
:class:`~paddle_tpu_torch.observability.metrics.MetricsRegistry` on a
deterministic **engine-step cadence** into fixed-size rings per series —
the substrate the :class:`~paddle_tpu_torch.observability.alerts.AlertEngine`
evaluates its threshold / rate / SLO **burn-rate** rules over, and the
signal the planned SLO-driven replica scaling and cache-aware
rebalancing actuators will consume.

Semantics:

* **Counters** are stored as their monotone cumulative values;
  :meth:`increase` derives the windowed rate at query time as the sum of
  per-sample deltas **clamped to >= 0** — a replica rebuild that
  restarts an engine-local counter at zero reads as a reset, never as a negative rate.
* **Gauges** are sampled directly; **histograms** contribute their exact
  streaming aggregates as two derived series, ``<name>_count`` and
  ``<name>_sum`` (both cumulative, so rate rules and latency-over-window
  math work on them like counters).
* Every sample runs the registry's **collect hooks** first, then reads all series values inside ONE
  ``registry.atomic()`` block — related counters (the SLO goodput pair)
  are pairwise-consistent in every sample.
* The x-axis is the store's own **sample index** (monotone, one per
  sample) plus the triggering engine step: alert windows are measured in
  samples, never wall-clock, so an evaluation replayed over the same
  recorded window produces the same transitions (the AuditConfig /
  FaultPlan determinism discipline).

Boundedness: the
memory bound is a hard ``max_series x ring_len`` — each series ring is a
``deque(maxlen=ring_len)``; series beyond ``max_series`` are **dropped**
and counted on ``serving_history_series_dropped_total`` (once per
distinct dropped key), never silently truncated.
"""

from __future__ import annotations

import sys
import threading
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .metrics import MetricsRegistry, _label_suffix

# the metric names this module registers
METRIC_NAMES = (
    "serving_history_samples_total",
    "serving_history_series_dropped_total",
)

# listeners are a small fixed set (the alert engine, maybe a recorder);
# accumulating past this is a leak
_MAX_LISTENERS = 8


@dataclass(frozen=True)
class HistoryConfig:
    """Sampler knobs — a frozen, value-comparable config (the
    AuditConfig discipline: the fleet refuses heterogeneous replica
    configs, and two stores built from equal configs behave
    identically)."""

    sample_every_steps: int = 1   # engine-step cadence: one sample per
    # this many on_step() ticks.  The tick count is FLEET-wide at dp>1
    # (every replica's engine thread ticks the one shared store), so a
    # sample pass — collect hooks + full-registry read + rule
    # evaluation, serialized under the sample lock — runs dp times per
    # fleet step-round at the default.  Cheap next to an engine
    # step at this repo's dp, but raise this (~dp or more) on a wide
    # fleet so sampling cost stays constant per round instead of
    # scaling with dp.
    ring_len: int = 512           # samples retained per series
    max_series: int = 1024        # hard series cap; beyond it, dropped
    # + counted (memory bound = max_series x ring_len entries)

    def __post_init__(self):
        if self.sample_every_steps < 1:
            raise ValueError(f"sample_every_steps must be >= 1, got "
                             f"{self.sample_every_steps}")
        if self.ring_len < 2:
            raise ValueError(f"ring_len must be >= 2 (a rate needs two "
                             f"samples), got {self.ring_len}")
        if self.max_series < 1:
            raise ValueError(f"max_series must be >= 1, got "
                             f"{self.max_series}")


class HistoryStore:
    """Fixed-size per-series rings over one registry's series.

    The engine thread(s) drive sampling through :meth:`on_step` (the
    fleet router binds every replica's engine to ONE store, so at dp>1
    the tick count is fleet-wide); HTTP handler threads read windows
    under the store lock.  Each ring entry is ``(sample_index, step,
    value)`` — ``step`` is the triggering engine's step counter, carried
    for operator readability; all window math uses the sample index.
    """

    def __init__(self, registry: MetricsRegistry,
                 config: Optional[HistoryConfig] = None):
        self.cfg = config or HistoryConfig()
        self.registry = registry
        self._lock = threading.Lock()
        # serializes whole sample passes: two engine threads sampling
        # concurrently must not interleave their read/append phases (a
        # later sample index must never carry older values)
        self._sample_lock = threading.Lock()
        self._rings: Dict[str, deque] = {}  # unbounded-ok: capped at cfg.max_series by _ring_for (drop counter past it)
        self._kinds: Dict[str, str] = {}    # unbounded-ok: one entry per ring key, same max_series cap
        self._names: Dict[str, List[str]] = {}  # unbounded-ok: metric name -> ring keys, bounded by the ring-key cap
        self._dropped: set = set()          # unbounded-ok: distinct dropped keys, bounded by the registry's own max_series cap
        self.samples = 0                    # monotone sample index
        self._ticks = 0                     # on_step() calls since start
        self._listeners: List[Callable] = []  # unbounded-ok: add_listener refuses past _MAX_LISTENERS
        self._c_samples = registry.counter(
            "serving_history_samples_total",
            "metrics-history samples taken")
        self._c_dropped = registry.counter(
            "serving_history_series_dropped_total",
            "series dropped by the history store's max_series cap "
            "(counted once per distinct series)")

    # --- feeding ------------------------------------------------------------
    def add_listener(self, fn: Callable[[int, int], None]
                     ) -> Callable[[], None]:
        """Register ``fn(sample_index, step)``, called after every
        sample (on the sampling engine thread; exceptions swallowed
        with a stderr report — a broken evaluator must never kill the
        replica) — the alert engine's evaluation hook.  Returns a
        zero-arg remover."""
        with self._lock:
            if len(self._listeners) >= _MAX_LISTENERS:
                raise RuntimeError(
                    f"history store already has {_MAX_LISTENERS} "
                    "listeners — register one evaluator object, not one "
                    "per request")
            self._listeners.append(fn)

        def remove() -> None:
            with self._lock:
                try:
                    self._listeners.remove(fn)
                except ValueError:
                    pass  # swallow-ok: already removed — remover is idempotent

        return remove

    def on_step(self, step: int) -> Optional[int]:
        """Engine-step tick: sample every ``sample_every_steps`` ticks.
        Thread-safe (at dp>1 every replica's engine thread ticks the
        same store).  Returns the new sample index when a sample was
        taken, else ``None``."""
        with self._lock:
            self._ticks += 1
            due = self._ticks % self.cfg.sample_every_steps == 0
        if not due:
            return None
        return self.sample(step)

    def sample(self, step: Optional[int] = None) -> int:
        """Take one sample of every registry series NOW: run the collect
        hooks (fresh derived gauges), read all values inside one
        ``registry.atomic()`` block (pairwise-consistent counters), then
        append to the rings.  Returns the sample index."""
        with self._sample_lock:
            return self._sample_locked(step)

    def _sample_locked(self, step: Optional[int]) -> int:
        self.registry.run_collect_hooks()
        metrics = self.registry.series()
        # one atomic read pass: (kind, key-suffix, metric, value tuple)
        reads: List[Tuple[str, str, object, Tuple]] = []
        with self.registry.atomic():
            for m in metrics:
                key = m.name + _label_suffix(m.labels)
                if m.kind == "counter":
                    reads.append(("counter", key, m.name, (m._value,)))
                elif m.kind == "gauge":
                    reads.append(("gauge", key, m.name, (m._value,)))
                elif m.kind == "histogram":
                    # under the metric's own lock too: observe()
                    # updates count then sum under that lock only, and
                    # a torn (count, sum) pair would record a sample
                    # where a request's count arrived without its sum
                    with m._lock:
                        reads.append(("histogram", key, m.name,
                                      (m.count, m.sum)))
        with self._lock:
            self.samples += 1
            idx = self.samples
            st = -1 if step is None else int(step)
            for kind, key, name, vals in reads:
                if kind == "histogram":
                    self._append(f"{key}:count", f"{name}_count",
                                 "counter", idx, st, float(vals[0]))
                    self._append(f"{key}:sum", f"{name}_sum",
                                 "counter", idx, st, float(vals[1]))
                else:
                    self._append(key, name, kind, idx, st, float(vals[0]))
            listeners = tuple(self._listeners)
        self._c_samples.inc()
        for fn in listeners:
            try:
                fn(idx, st)
            except Exception:
                # swallow-ok: listeners run on the sampling ENGINE
                # thread (EngineCore.step -> on_step -> sample) — a
                # broken evaluator reported loudly must never kill the
                # replica (and, fleet-wide, every replica the supervisor
                # rebuilds after it), same discipline as collect hooks
                sys.stderr.write("[history] sample listener failed:\n"
                                 + traceback.format_exc())
        return idx

    def _append(self, key: str, name: str, kind: str, idx: int,
                step: int, value: float) -> None:
        # caller holds self._lock
        ring = self._rings.get(key)
        if ring is None:
            if len(self._rings) >= self.cfg.max_series:
                # hard memory bound: drop the NEW series, count it once
                if key not in self._dropped:
                    self._dropped.add(key)
                    self._c_dropped.inc()
                return
            ring = self._rings[key] = deque(maxlen=self.cfg.ring_len)
            self._kinds[key] = kind
            self._names.setdefault(name, []).append(key)
        ring.append((idx, step, value))

    # --- queries ------------------------------------------------------------
    def keys(self) -> List[str]:
        """Every tracked series key (``name{labels}[:count|:sum]``)."""
        with self._lock:
            return sorted(self._rings)

    def names(self) -> List[str]:
        """Every tracked metric name (histograms contribute their
        ``_count`` / ``_sum`` derived names)."""
        with self._lock:
            return sorted(self._names)

    def match(self, name: str) -> List[str]:
        """Ring keys whose metric name is exactly ``name`` — one per
        label set (the per-replica view of a fleet series)."""
        with self._lock:
            return list(self._names.get(name, ()))

    def kind(self, key: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(key)

    def window(self, key: str, n: Optional[int] = None) -> List[Dict]:
        """The last ``n`` samples of ``key`` (all retained when ``n`` is
        None), oldest first, as ``{"i": sample, "step": step, "v":
        value}`` rows."""
        with self._lock:
            ring = self._rings.get(key)
            rows = list(ring) if ring is not None else []
        if n is not None:
            rows = rows[-int(n):]
        return [{"i": i, "step": s, "v": v} for i, s, v in rows]

    def latest(self, key: str) -> Optional[float]:
        with self._lock:
            ring = self._rings.get(key)
            if not ring:
                return None
            return ring[-1][2]

    def increase(self, key: str, window: int) -> Optional[float]:
        """Windowed increase of a cumulative series: the sum of
        per-sample deltas over the last ``window`` samples, each clamped
        to >= 0 — a counter reset (replica rebuild restarting a counter
        at zero) contributes nothing instead of a negative rate.
        ``None`` until the series has two samples."""
        with self._lock:
            ring = self._rings.get(key)
            if ring is None or len(ring) < 2:
                return None
            rows = list(ring)[-(int(window) + 1):]
        total = 0.0
        for (_, _, prev), (_, _, cur) in zip(rows, rows[1:]):
            total += max(0.0, cur - prev)
        return total

    def covers(self, name: str, window: int) -> bool:
        """True when every series of ``name`` holds a FULL ``window`` of
        recorded deltas (ring length >= window + 1).  The burn-rate
        evaluator's cold-start guard: two samples after a restart, a
        64-sample "slow" window computed over the only delta available
        is just the fast window wearing a slow label — the sustained
        evidence it exists to demand is not there yet."""
        with self._lock:
            keys = self._names.get(name, ())
            if not keys:
                return False
            return all(len(self._rings[k]) > window for k in keys)

    def name_latest_sum(self, name: str) -> Optional[float]:
        """Fleet view of a name: sum of the latest sample across every
        label set (counters/gauges); ``None`` when untracked."""
        vals = [self.latest(k) for k in self.match(name)]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    def name_increase(self, name: str, window: int) -> Optional[float]:
        """Fleet view of a cumulative name: sum of :meth:`increase`
        across every label set (per-replica resets clamp per series)."""
        vals = [self.increase(k, window) for k in self.match(name)]
        vals = [v for v in vals if v is not None]
        return sum(vals) if vals else None

    def stats(self) -> Dict:
        """Store shape for the debug surface: sample count, tick count,
        series count, dropped count, config."""
        with self._lock:
            return {
                "samples": self.samples,
                "ticks": self._ticks,
                "series": len(self._rings),
                "dropped_series": len(self._dropped),
                "config": {
                    "sample_every_steps": self.cfg.sample_every_steps,
                    "ring_len": self.cfg.ring_len,
                    "max_series": self.cfg.max_series,
                },
            }
