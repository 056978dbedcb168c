"""``paddle_tpu_torch.serving`` — the request-level continuous-batching
engine.

* :class:`EngineCore` / :class:`EngineConfig` (``engine.py``) — request
  queue; each engine step runs the legacy prefill/chunk/decode families,
  one packed ragged step, or a decode burst; streaming, abort.
* :class:`ContinuousBatchingScheduler` (``scheduler.py``) — admission,
  chunked prefill under token budgets, decode-slot reservation with
  preemption-and-recompute.
* :class:`KVCacheManager` (``kv_manager.py``) — refcounted paged block
  pool bookkeeping shared by all layers, with the prefix cache.
* :class:`ServingMetrics` (``metrics.py``) — TTFT / inter-token latency,
  queue/pool gauges, counters, ``summary()``.
* :class:`LLM` / :func:`stream_generate` (``entrypoints.py``).
* ``burst.py`` — when a decode burst may launch and how long it may be.
"""

from .engine import EngineConfig, EngineCore  # noqa: F401
from .entrypoints import LLM, CompletionOutput, stream_generate  # noqa: F401
from .kv_manager import KVCacheManager, PoolExhausted  # noqa: F401
from .metrics import ServingMetrics  # noqa: F401
from .request import (  # noqa: F401
    FinishReason,
    Request,
    RequestState,
    SamplingParams,
)
from .scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    SchedulerConfig,
    SchedulerOutput,
    bucket_size,
)
