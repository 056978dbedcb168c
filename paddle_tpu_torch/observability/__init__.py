"""``paddle_tpu_torch.observability`` — the port of
``paddle_tpu.observability``, the one telemetry substrate of the serving
engine (the JAX package's public names, in PyTorch and stdlib idiom).

* :class:`SpanTracer` (``tracer.py``) — thread-safe nestable named spans
  in a bounded ring buffer, exported as Chrome trace-event JSON
  (``export.py``) and read back with :func:`load_profiler_result`.
* :class:`MetricsRegistry` (``metrics.py``) — Counter / Gauge /
  Histogram with exact streaming aggregates and bounded memory, rendered
  as Prometheus text (byte for byte the JAX registry's) or a JSON
  snapshot, with scrape-time collect hooks.
* :func:`start_metrics_server` (``httpd.py``) serves a registry as a
  Prometheus ``/metrics`` scrape endpoint from a daemon thread;
  :class:`PushGateway` (``push.py``) POSTs it to a gateway instead.
* :class:`LifecycleTracker` (``lifecycle.py``) — bounded per-request
  event timelines; :class:`FlightRecorder` (``flight.py``) — bounded
  per-replica event rings and atomic post-mortem bundles.
* :class:`StepProfiler` (``stepprof.py``) — bucket utilization and
  padding waste per step-program launch, compile (graph capture)
  attribution, and capture windows (with ``torch.profiler`` on a CUDA
  device).
* :class:`NumericsAuditor` (``audit.py``) — NaN/Inf sentinel, shadow
  re-execution through the kernels' plain twins, ``.npz`` repros.
* :class:`CacheStatTracker` (``cachestat.py``) — pool timeline, prefix
  heat, reuse-LRU telemetry and per-request cache attribution.
* :class:`HistoryStore` (``history.py``) and :class:`AlertEngine`
  (``alerts.py``) — metrics history sampled per engine step and rules
  evaluated over it.

* ``distrib.py`` — the cross-process layer of a process fleet:
  :class:`ClockSync`, :class:`TelemetryOutbox`, :class:`DeltaMerger`,
  :class:`MirrorRing` and :class:`WireStats`.

* :class:`TrainStepTelemetry` (``telemetry.py``) — tokens/s and MFU of
  training steps as registry series and tracer instants.

* :func:`subscribe_ops` / :func:`trace_dispatch` — subscribers of the op
  bus (``core/dispatch.py::run_op``): a callback of every op's name and
  host wall time, or a span per op on a tracer.

Process-wide defaults: :func:`get_tracer` / :func:`get_registry` return
one shared instance each.
"""

from __future__ import annotations

from .alerts import (  # noqa: F401
    AlertEngine,
    AlertRule,
    AlertRuleSet,
    default_rule_set,
)
from .audit import (  # noqa: F401
    AuditConfig,
    NumericsAuditor,
    load_repro,
    logit_stats,
    replay_repro,
)
from .cachestat import (  # noqa: F401
    CacheStatTracker,
)
from .distrib import (  # noqa: F401
    ClockSync,
    DeltaMerger,
    MirrorRing,
    TelemetryOutbox,
    WireStats,
)
from .export import (  # noqa: F401
    ProfilerResult,
    chrome_trace_dict,
    export_chrome_trace,
    load_profiler_result,
)
from .flight import (  # noqa: F401
    FlightConfig,
    FlightRecorder,
)
from .history import (  # noqa: F401
    HistoryConfig,
    HistoryStore,
)
from .httpd import (  # noqa: F401
    PROMETHEUS_CONTENT_TYPE,
    MetricsServer,
    metrics_page,
    start_metrics_server,
)
from .lifecycle import (  # noqa: F401
    LifecycleTracker,
    RequestTimeline,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from .push import (  # noqa: F401
    PushGateway,
    start_push_gateway,
)
from .stepprof import (  # noqa: F401
    CaptureBusy,
    CaptureWindow,
    StepProfiler,
)
from .telemetry import TrainStepTelemetry  # noqa: F401
from .tracer import (  # noqa: F401
    Span,
    SpanTracer,
    get_tracer,
    set_tracer,
)


def subscribe_ops(callback):
    """Attach ``callback(op_name, wall_seconds)`` to the op bus beside any
    other subscriber.  Returns a zero-argument remover."""
    from ..core import dispatch

    return dispatch.add_op_timer(callback)


def trace_dispatch(tracer: "SpanTracer" = None, cat: str = "dispatch"):
    """Record every op dispatch as a span on ``tracer`` (default: the
    process tracer), after the fact from the bus's timing.  Returns a
    zero-argument remover."""
    import time

    tr = tracer if tracer is not None else get_tracer()

    def _on_op(name, dt):
        end = time.perf_counter()
        tr.add_span(name, end - dt, dt, cat=cat)

    return subscribe_ops(_on_op)
