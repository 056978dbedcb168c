"""Serving metrics: request-level latency + scheduler/pool health (the
subset of ``paddle_tpu/serving/metrics.py`` the port's engine records).

Registry-backed: every counter / gauge / latency distribution is a series
in a :class:`~paddle_tpu_torch.observability.metrics.MetricsRegistry`
(``serving_*`` namespace).  Tracked:

* **time-to-first-token** (arrival → first emitted token), **inter-token
  latency**, the queue-wait / prefill / e2e breakdown, and the wall time
  of each step program (prefill, decode, unified, burst);
* **queue depth**, **running-set size** and **KV-pool occupancy**, sampled
  once per engine step;
* counters: admitted, finished-by-reason, preemptions, recompute
  prefills, prefix-cache hits and misses, chunked-prefill and unified
  steps, and the captures of each graphed step family
  (``serving_{decode,ragged,burst}_jit_traces_total``).

The per-op dispatch timer, step-profiler tables and the mesh-collective
series of the JAX module are ROADMAP A8 and A11.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

from ..observability.metrics import Counter, Gauge, Histogram, MetricsRegistry
from ..observability.tracer import get_tracer

# sub-second serving latencies: finer low end than the registry default
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_COUNTER_NAMES = (
    "requests_admitted",
    "requests_finished_eos",
    "requests_finished_length",
    "requests_finished_abort",
    "requests_finished_timeout",
    "preemptions",
    "recompute_prefills",
    "engine_steps",
    "prefix_cache_hit_tokens",    # prompt tokens restored by fork (free)
    "prefix_cache_miss_tokens",   # prompt tokens that needed compute
    "prefix_cache_evictions",     # cached blocks clobbered for allocation
    "prefill_tokens_computed",    # tokens the prefill rows actually ran
    "chunked_prefill_steps",      # chunk-program launches (vs one-shot)
    "slo",                        # finished requests that carried slo_ms
    "slo_good",                   # ... and met it
    "unified_steps",              # packed ragged step launches
    # captures of the graphed step families (the JAX engine's in-trace
    # retrace counters), bounded by their bucket sets
    "decode_jit_traces",
    "ragged_jit_traces",
    "burst_jit_traces",
)

_GAUGE_NAMES = ("queue_depth", "num_running", "kv_pool_occupancy",
                "prefix_cached_token_ratio")

_HISTOGRAM_NAMES = (
    "time_to_first_token",
    "inter_token_latency",
    "prefill_step",   # wall time of one prefill or chunk program
    "decode_step",    # wall time of one batched decode step
    "unified_step",   # wall time of one packed ragged step
    "burst_step",     # wall time of one N-step decode burst
    "queue_wait",
    "prefill",
    "decode_itl",
    "e2e",
)

# the SLO breakdown, in pipeline order
SLO_PHASES = ("queue_wait", "prefill", "decode_itl", "e2e")


class ServingMetrics:
    def __init__(self):
        # one registry per engine, so counts stay per-engine
        self.registry = MetricsRegistry(max_series=512)
        self.tracer = get_tracer()
        self._counters: Dict[str, Counter] = {}
        for name in _COUNTER_NAMES:
            self._counter(name)
        self._hists: Dict[str, Histogram] = {}
        for name in _HISTOGRAM_NAMES:
            self._hist(name)
        self._gauges: Dict[str, Gauge] = {
            name: self.registry.gauge(f"serving_{name}",
                                      f"per-engine-step {name}")
            for name in _GAUGE_NAMES
        }

    # --- recording ----------------------------------------------------------
    def _counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = self.registry.counter(
                f"serving_{name}_total", f"serving {name.replace('_', ' ')}")
        return c

    def _hist(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = self.registry.histogram(
                f"serving_{name}_seconds",
                f"serving {name.replace('_', ' ')} (seconds)",
                buckets=LATENCY_BUCKETS)
        return h

    def count(self, name: str, n: int = 1) -> None:
        self._counter(name).inc(n)

    def observe(self, name: str, seconds: float) -> None:
        self._hist(name).observe(seconds)

    def observe_ttft(self, seconds: float) -> None:
        self.observe("time_to_first_token", seconds)

    def observe_inter_token(self, seconds: float) -> None:
        self.observe("inter_token_latency", seconds)
        self.observe("decode_itl", seconds)

    def observe_queue_wait(self, seconds: float) -> None:
        """Arrival → first prefill chunk."""
        self.observe("queue_wait", seconds)

    def observe_prefill_phase(self, seconds: float) -> None:
        """First prefill chunk → first emitted token."""
        self.observe("prefill", seconds)

    def observe_finish(self, e2e_seconds: float,
                       slo_ms: Optional[float] = None) -> None:
        """End-to-end latency + the SLO goodput pair, incremented under
        the registry lock so a reader never sees good > total."""
        self.observe("e2e", e2e_seconds)
        if slo_ms is not None:
            good = e2e_seconds * 1e3 <= slo_ms
            slo_c, good_c = self._counter("slo"), self._counter("slo_good")
            with self.registry.atomic():
                slo_c.inc()
                if good:
                    good_c.inc()

    def slo_counts(self) -> Tuple[int, int]:
        """(good, total), read under the registry lock."""
        good_c, slo_c = self._counter("slo_good"), self._counter("slo")
        with self.registry.atomic():
            return int(good_c.value), int(slo_c.value)

    def cached_token_ratio(self) -> Optional[float]:
        """hit / (hit + computed) over the process life; ``None`` until
        any prefill ran."""
        hit = self._counter("prefix_cache_hit_tokens").value
        computed = self._counter("prefill_tokens_computed").value
        return hit / (hit + computed) if hit + computed else None

    def set_cached_token_ratio(self) -> None:
        ratio = self.cached_token_ratio()
        if ratio is not None:
            self._gauges["prefix_cached_token_ratio"].set(ratio)

    def sample_gauges(self, queue_depth: int, num_running: int,
                      kv_occupancy: float) -> None:
        self._gauges["queue_depth"].set(queue_depth)
        self._gauges["num_running"].set(num_running)
        self._gauges["kv_pool_occupancy"].set(kv_occupancy)

    # --- inspection ---------------------------------------------------------
    @property
    def counters(self) -> Dict[str, int]:
        """{name: count} snapshot over the registry counters."""
        return {name: int(c.value) for name, c in self._counters.items()}

    def histogram(self, name: str) -> Histogram:
        return self._hist(name)

    def summary(self) -> str:
        """Render counters, latencies and gauges as text tables (printed
        AND returned)."""
        bar = "-" * 72
        lines = [bar, "Serving latency (ms)", bar,
                 f"{'Name':24s} {'Count':>8s} {'Avg':>9s} {'p50':>9s} "
                 f"{'p99':>9s} {'Max':>9s}", bar]
        for name in _HISTOGRAM_NAMES:
            h = self._hist(name)
            cells = [f"{v * 1e3:9.3f}" if v is not None else f"{'-':>9s}"
                     for v in (h.avg if h.count else None, h.quantile(0.5),
                               h.quantile(0.99), h.max if h.count else None)]
            lines.append(f"{name:24s} {h.count:8d} " + " ".join(cells))
        lines += [bar, "Serving counters", bar]
        for name, value in sorted(self.counters.items()):
            lines.append(f"{name:32s} {value:12d}")
        lines += [bar, "Scheduler/pool gauges (per engine step)", bar]
        for name in _GAUGE_NAMES:
            g = self._gauges[name]
            lines.append(f"{name:28s} samples {g.samples:6d}  avg "
                         f"{g.avg:8.3f}  max "
                         f"{g.max if g.samples else 0.0:8.3f}")
        good, total = self.slo_counts()
        lines += [bar, (f"goodput: {good}/{total} requests met their slo_ms"
                        if total else
                        "goodput: no request carried an slo_ms"), bar]
        report = "\n".join(lines)
        print(report)
        return report


class StepTimer:
    """``with StepTimer(metrics, "decode_step") as st: ...`` — observes
    the wall time into the named histogram and leaves it on ``st.dt``."""

    def __init__(self, metrics: ServingMetrics, name: str):
        self.metrics = metrics
        self.name = name
        self.dt: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self._t0
        self.metrics.observe(self.name, self.dt)
        return False
