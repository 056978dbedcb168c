"""``paddle_tpu_torch.serving`` — the request-level continuous-batching
engine and the in-process serving fleet.

* :class:`EngineCore` / :class:`EngineConfig` (``engine.py``) — request
  queue; each engine step runs the legacy prefill/chunk/decode families,
  one packed ragged step (with speculative verify rows), or a decode
  burst; streaming, abort, KV hand-off export and import.
* :class:`ContinuousBatchingScheduler` (``scheduler.py``) — admission,
  chunked prefill under token budgets, decode-slot reservation with
  preemption-and-recompute, the speculative draft budget.
* :class:`KVCacheManager` (``kv_manager.py``) — refcounted paged block
  pool bookkeeping shared by all layers, with the prefix cache.
* :class:`ServingMetrics` (``metrics.py``) — TTFT / inter-token latency,
  queue/pool gauges, counters, ``summary()``.
* :class:`LLM` / :func:`stream_generate` (``entrypoints.py``).
* ``burst.py`` — when a decode burst may launch and how long it may be.
* :class:`SpecConfig` / :class:`SpecDecoder` (``spec.py``) — n-gram
  speculative decoding.
* ``handoff.py`` — the prefill -> decode KV hand-off (:class:`HandoffError`).
* :class:`FleetRouter` (``fleet.py``) — N engine replicas on their own
  threads behind prefix-affinity routing, with prefill/decode roles;
  :class:`FleetSupervisor` (``resilience.py``) heals it;
  :class:`FaultPlan` (``faultinject.py``) injects faults into it.
* :class:`ProcessFleet` (``procfleet.py``) — the same router and
  supervisor over worker processes (``python -m
  paddle_tpu_torch.serving.worker``, ``worker.py``) speaking ``wire.py``,
  with the :class:`FleetAutoscaler` and the :class:`CacheRebalancer`.
* :class:`CompletionServer` (``server.py`` + ``protocol.py``) — the
  asyncio HTTP/SSE frontend; ``python -m paddle_tpu_torch.serving.server``
  serves a toy model, in process (``--dp``) or over worker processes
  (``--workers``).
* :class:`AotArtifact` (``aot.py``) — AOT serving artifacts: save an
  engine's closed bucket universe, load and bind it, and warm it, so an
  engine, a fleet or a worker process captures nothing after boot.
* ``tp.py`` — tensor-parallel serving, one process a rank: the
  controller rank broadcasts each step, the follower ranks run it on
  their shards (``follow``); the server's ``--mp N``.
"""

from ..observability.alerts import (  # noqa: F401
    AlertRule,
    AlertRuleSet,
    default_rule_set,
)
from ..observability.history import HistoryConfig, HistoryStore  # noqa: F401
from .aot import (  # noqa: F401
    AotArtifact,
    AotBucketMissing,
    AotError,
    AotManifestMismatch,
)
from .engine import EngineConfig, EngineCore  # noqa: F401
from .entrypoints import LLM, CompletionOutput, stream_generate  # noqa: F401
from .faultinject import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
)
from .fleet import (  # noqa: F401
    EngineReplica,
    FleetConfig,
    FleetDown,
    FleetRouter,
    FleetSaturated,
    SubmitHandle,
    parse_roles,
)
from .handoff import HandoffError  # noqa: F401
from .kv_manager import KVCacheManager, PoolExhausted  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .procfleet import (  # noqa: F401
    AutoscalerConfig,
    CacheRebalancer,
    FleetAutoscaler,
    ProcessFleet,
    ProcessFleetConfig,
    RebalancerConfig,
    ScaleDecider,
    WorkerDied,
)
from .protocol import (  # noqa: F401
    CompletionRequest,
    ProtocolError,
    parse_completion_request,
)
from .request import (  # noqa: F401
    FinishReason,
    Request,
    RequestState,
    SamplingParams,
)
from .resilience import FleetSupervisor, SupervisorConfig  # noqa: F401
from .scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    SchedulerConfig,
    SchedulerOutput,
    bucket_size,
)
from .spec import NgramProposer, SpecConfig, SpecDecoder  # noqa: F401
from .wire import (  # noqa: F401
    ConnectionClosed,
    FrameError,
    HandshakeMismatch,
    RegistryMerger,
    WireError,
)


def __getattr__(name):
    # lazy: an eager `from .server import ...` would put the module in
    # sys.modules before `python -m paddle_tpu_torch.serving.server` runs
    # it as __main__, tripping runpy's double-import warning
    if name in ("CompletionServer", "ServerConfig", "server"):
        import importlib

        _server = importlib.import_module(f"{__name__}.server")
        return _server if name == "server" else getattr(_server, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
