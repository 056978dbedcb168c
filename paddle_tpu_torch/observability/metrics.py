"""Metrics registry: Counter / Gauge / Histogram with bounded memory (the
subset of ``paddle_tpu/observability/metrics.py`` the serving engine
uses).

Every aggregate is an exact streaming one — count, sum, max, min, fixed
histogram buckets — so a metric's memory is O(1) however many observations
a long-lived server records.  Series cardinality is capped
(``max_series``).  ``snapshot()`` is the JAX registry's JSON rendering;
the Prometheus text, scrape-time collect hooks and the HTTP/push exporters
are ROADMAP A8.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Tuple

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _check_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r} "
                         "(use [a-zA-Z0-9_:] only)")
    if name[0].isdigit():
        raise ValueError(f"metric name {name!r} must not start with a digit")
    return name


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically non-decreasing count."""

    kind = "counter"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} is monotonic; "
                             f"inc({n}) is negative")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snap(self):
        return {"type": "counter", "value": self._value}


class Gauge(_Metric):
    """Point-in-time value plus exact streaming aggregates over every
    sample set (n / sum / max / min)."""

    kind = "gauge"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self._value = 0.0
        self.samples = 0
        self.total = 0.0
        self.max = -math.inf
        self.min = math.inf

    def set(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._value = v
            self.samples += 1
            self.total += v
            self.max = max(self.max, v)
            self.min = min(self.min, v)

    @property
    def value(self) -> float:
        return self._value

    @property
    def avg(self) -> float:
        return self.total / self.samples if self.samples else 0.0

    def snap(self):
        return {"type": "gauge", "value": self._value,
                "samples": self.samples, "avg": self.avg,
                "max": None if self.samples == 0 else self.max,
                "min": None if self.samples == 0 else self.min}


class Histogram(_Metric):
    """Fixed-bucket histogram with exact sum/count/max/min; no raw samples
    are kept."""

    kind = "histogram"

    def __init__(self, name, labels=(), help="",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        super().__init__(name, labels, help)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.max = -math.inf
        self.min = math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)
            self.min = min(self.min, v)
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate, clamped to the observed
        range; ``None`` while empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self.count == 0:
                return None
            rank = q * self.count
            cum = 0
            lo = 0.0 if self.min >= 0 else self.min
            for bound, c in zip(self.bounds, self._counts):
                if cum + c >= rank and c:
                    est = lo + (bound - lo) * (rank - cum) / c
                    return min(max(est, self.min), self.max)
                cum += c
                lo = bound
            return self.max

    def bucket_counts(self) -> Dict[str, int]:
        """Cumulative counts keyed by ``le`` bound (incl. ``+Inf``)."""
        out, cum = {}, 0
        for b, c in zip(self.bounds, self._counts):
            cum += c
            out[_format(b)] = cum
        out["+Inf"] = cum + self._counts[-1]
        return out

    def snap(self):
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "avg": self.avg,
                "max": None if self.count == 0 else self.max,
                "min": None if self.count == 0 else self.min,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99), "buckets": self.bucket_counts()}


def _format(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _label_suffix(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create store of metric series, bounded by ``max_series``."""

    def __init__(self, max_series: int = 4096):
        self.max_series = max_series
        self._series: Dict[Tuple[str, Tuple], _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, help: str, labels: Dict[str, str],
             **kwargs) -> _Metric:
        _check_name(name)
        lk = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lk)
        with self._lock:
            m = self._series.get(key)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"requested {kind}")
                return m
            if len(self._series) >= self.max_series:
                raise RuntimeError(
                    f"metrics registry is full ({self.max_series} series) "
                    "— unbounded label cardinality?")
            m = _KINDS[kind](name, lk, help=help, **kwargs)
            self._series[key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets=buckets)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able ``{name or name{labels}: summary}`` of every series,
        as the JAX registry's ``snapshot()`` gives it."""
        with self._lock:
            series = list(self._series.values())
        return {m.name + _label_suffix(m.labels): m.snap() for m in series}

    @contextlib.contextmanager
    def atomic(self):
        """Hold the registry lock across a multi-series read or write so
        related series stay pairwise-consistent (the SLO goodput pair).
        Do not create series inside the block."""
        with self._lock:
            yield
