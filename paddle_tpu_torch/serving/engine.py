"""EngineCore: request-level continuous-batching serving engine (the port
of ``paddle_tpu/serving/engine.py``: its legacy program families, its
decode bursts and its unified ragged step).

Above the block pool sits an engine that owns a request queue, admission
control and preemption.  Each engine step runs the scheduler's plan in one
of three ways, as the JAX engine does:

* **The legacy families** (``unified_step=False``, the default of the
  keyword construction ``EngineCore(model, num_blocks=..., ...)``): each
  prefill chunk runs alone — one-shot over a dense cache when nothing is
  cached and no budget splits the prompt (``_prefill_fn``), else through
  the paged pools (``_chunk_prefill_fn``) — and the decode rows run as one
  batched decode step (``_decode_fn``), whose attention is the CUDA decode
  kernel on the card.
* **The unified ragged step** (``unified_step=True``): decode rows and
  prefill chunks pack into one flat token batch (``_unified_fn``), whose
  attention is the CUDA ragged kernel on the card.
* **A decode burst** (``burst_steps >= 2``, either mode): when the running
  set is a decode-only resident cohort, up to ``burst_steps`` decode steps
  run back to back on the device, one burst iteration (``_burst_fn`` →
  ``ops/decode_burst.burst_iteration``) after another, and only the
  ``[B, N]`` token buffer comes back to the host.

All sequences share ONE paged KV pool per layer (``[num_blocks,
block_size, Hkv, D]``, allocated once on the device and written in place);
per-step routing arrays (block tables, lengths, slot indices, positions)
are data, padded to power-of-two buckets so a step's shapes come from
bounded sets (``decode_buckets``, ``prefill_buckets``, ``ragged_buckets``,
``burst_buckets``).  Pool exhaustion preempts (lowest priority, newest
arrival first) and recomputes instead of failing the request.  Pad rows
and pad tokens write their K/V into the null page (block 0) and read it.

Every family runs on the device of the model's parameters and ends in
the sampling epilogue; only sampled token ids come back to the host.  Every
family is compiled once per bucket, as the JAX engine jits them:
``serving/graphs.py`` captures each as a CUDA graph at its first
``(family, buckets, any_sampled)`` key and replays it from then on,
counting captures in ``prefill_trace_count`` (one-shot and chunk prefill)
/ ``decode_trace_count`` / ``burst_trace_count`` / ``ragged_trace_count``
and the ``*_jit_traces`` metrics (``graphs.disable_graphs()`` runs them
eagerly).  Positions a family takes as data are device tensors, never
read on the host.  ``serving_host_roundtrips_total`` counts family
launches (a burst counts once).

Observability is the JAX engine's, recorded at the same points
(``paddle_tpu_torch/observability/``): a :class:`StepProfiler`
(``self.stepprof``: per-launch bucket utilization, each graph capture as
a compile, capture windows), a :class:`CacheStatTracker`
(``self.cachestat``: the pool timeline sampled every step, prefix heat,
reuse-LRU telemetry fed by the pool's ``on_evict`` / ``on_revive`` hooks,
per-request attribution), a :class:`LifecycleTracker`
(``self.lifecycle``: per-request timelines), a :class:`NumericsAuditor`
(``self.audit``: the NaN/Inf sentinel and the shadow re-execution through
the kernels' plain twins) and, once :meth:`EngineCore.set_history` binds
one, a metrics history ticked every step.  They use host-side numbers the
step already has; the auditor alone reads the step's logit stats (and,
on sampled steps, its logits) back from the device, so only with it on do
the graphs keep those as outputs.

**Speculative decoding** (``EngineConfig(spec=SpecConfig(...))``, with
``unified_step=True`` and a ``max_tokens_per_step`` budget): the n-gram
proposer of ``serving/spec.py`` upgrades decode rows to verify rows
``[last_token, d1..dk]`` packed as short chunks into the same unified
step and bucket lattice; the longest prefix of drafts that matches the
per-token targets the step samples is accepted, and the rejected tail's
slots roll back (``kv.commit`` / ``kv.truncate``).  **Disaggregation**:
``EngineConfig.role`` is the replica's routing role in a fleet
(``serving/fleet.py``); :meth:`EngineCore.export_kv_run` /
:meth:`EngineCore.import_kv_run` move a request's computed prompt KV
between engines (``serving/handoff.py``), writing the pools in place, so
the captured graphs read the imported pages.  **AOT artifacts**
(``EngineConfig(aot=...)`` / ``aot_path``, ``serving/aot.py``):
:meth:`EngineCore.bind_aot` validates one and seals the step graphs to its
saved universe; ``AotArtifact.warm`` captures every key of it before the
engine serves.

**Tensor-parallel serving** (a hybrid topology of mp > 1,
``distributed.topology.init_mesh(mp=...)`` on every rank before the model
and the engine are built; ``EngineConfig.mp`` must agree with it): one
process a rank, as ``serving/tp.py`` sets out.  Every rank of the mp group
builds the engine over its shard of the model; the first rank is the
controller and runs everything above, the others follow
(``serving.tp.follow``).  A rank's pools hold its ``Hkv/mp`` KV heads
(``ops.paged_attention.kv_pool_shape``) and its families launch the CUDA
kernels on its own heads, the legacy decode family included (ROADMAP
C13).  Each launch is broadcast to the followers before the controller
runs it; every family runs eagerly (``graphs.eager_reason``), its wall
time also lands in ``serving_collective_seconds{phase}``.  A KV hand-off
(:meth:`EngineCore.export_kv_run`, :meth:`EngineCore.import_kv_run`) is a
step of the control channel too: every rank of the replica sends or
writes its head slice, and the run is the global one.  What waits for the
rest of ROADMAP A11 raises naming it: the auditor, speculative decoding
and AOT artifacts at mp > 1.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..observability import lifecycle as _lc
from ..observability.audit import AuditConfig, NumericsAuditor, logit_stats
from ..observability.cachestat import CacheStatTracker
from ..observability.lifecycle import LifecycleTracker
from ..observability.stepprof import StepProfiler
from ..ops.decode_burst import BurstState, burst_iteration
from ..ops.paged_attention import PagedCache, PoolExhausted, kv_pool_shape
from ..ops.sampling import sample_tokens
from ..parallel.utils import axis_group
from .burst import burst_eligible, clamp_burst
from .burst import register_metrics as _register_burst_metrics
from .graphs import StepGraphs
from .kv_manager import KVCacheManager
from .metrics import ServingMetrics, StepTimer
from .request import FinishReason, Request, RequestState, SamplingParams
from .sampling import SamplingPack
from .sampling import register_metrics as _register_sampling_metrics
from .scheduler import (
    ContinuousBatchingScheduler,
    SchedulerConfig,
    bucket_size,
)
from .spec import SpecDecoder
from .tp import StepChannel

# per-step cap on individual prefix_cache_eviction lifecycle events: the
# counters and histograms stay exact per eviction, but a pool-thrash step
# must not flood the bounded flight-recorder ring — evictions past the cap
# collapse into one prefix_cache_eviction_burst summary event
_EVICT_EVENTS_PER_STEP = 8

# each step program's inputs in launch order (the sampling quartet follows)
_PROGRAM_INPUTS = {
    "decode": ("ids", "pos", "tables", "lens", "slot_blocks",
               "slot_offsets"),
    "burst": ("ids", "pos", "lens", "active", "buf", "last", "j", "tables",
              "slot_blocks", "slot_offsets", "eos_ids"),
    "ragged": ("ids", "pos", "seg_ids", "last_idx", "tables", "lens",
               "slot_blocks", "slot_offsets"),
    "prefill": ("ids", "last_pos", "blocks", "offs"),
    "chunk": ("ids", "start", "last_pos", "tables", "lens", "blocks",
              "offs"),
}


@dataclass
class EngineConfig:
    """Engine-level deployment knobs, with the JAX package's names and
    defaults: ``EngineCore(model, config=EngineConfig(...))``, or the
    keyword form ``EngineCore(model, num_blocks=..., ...)``, which folds
    into one of these.

    Fields asking for what the port does not implement yet raise
    ``NotImplementedError`` at engine build (see :func:`check_supported`).
    The telemetry fields are the JAX engine's: ``lifecycle_events``
    (per-request timelines; ``lifecycle`` shares a tracker across engines,
    ``decode_event_sample`` records every Nth decode-token event),
    ``step_profile`` (the :class:`StepProfiler`), ``audit`` (an
    :class:`AuditConfig`; None = off), ``cache_stats`` (the
    :class:`CacheStatTracker`) and ``history`` (whether this engine ticks
    a bound :class:`HistoryStore`).  All default on except the auditor,
    and none changes the tokens or the graphs captured."""

    num_blocks: int = 256
    block_size: int = 16
    dtype: object = None              # pool dtype; None = torch.float32
    prefix_cache: bool = True
    profile_ops: bool = False
    scheduler: Optional[SchedulerConfig] = None
    # attention-kernel routing (decode and ragged): None/True = the CUDA
    # kernel on a CUDA device (True raises on the CPU), False = the plain
    # PyTorch version
    use_pallas_paged: Optional[bool] = None
    mp: Optional[int] = None
    lifecycle_events: bool = True
    lifecycle: Optional[LifecycleTracker] = None
    decode_event_sample: int = 8
    step_profile: bool = True
    audit: Optional[AuditConfig] = None
    cache_stats: bool = True
    history: bool = True
    # ONE packed ragged step per engine step instead of the legacy
    # prefill / chunk / decode families
    unified_step: bool = False
    # AOT serving artifacts (serving/aot.py): a saved artifact directory
    # loaded at build, or a loaded AotArtifact object (the fleet-sharing
    # form, which wins)
    aot_path: Optional[str] = None
    aot: Optional[object] = None
    # speculative decoding (a serving.spec.SpecConfig; None = off):
    # needs unified_step=True and SchedulerConfig.max_tokens_per_step
    spec: Optional[object] = None
    # decode bursts: up to this many decode steps per host round trip for
    # a decode-only resident cohort; 0/1 = off
    burst_steps: int = 0
    # the replica's role in a role-aware fleet: "prefill" specialists
    # admit and prefill, "decode" specialists take requests handed off at
    # their first token, "unified" replicas do both.  Routing policy only:
    # every engine runs the whole pipeline
    role: str = "unified"


def check_supported(config: EngineConfig) -> None:
    """Raise for every :class:`EngineConfig` setting the port does not
    implement — nothing is silently ignored."""
    if config.role not in ("unified", "prefill", "decode"):
        raise ValueError(
            f"EngineConfig.role must be 'unified', 'prefill' or 'decode'; "
            f"got {config.role!r}")


def resolve_mp(config: EngineConfig, model) -> int:
    """The engine's tensor-parallel degree: the hybrid topology's mp axis.
    What waits for the rest of ROADMAP A11 at mp > 1 raises first
    (``NotImplementedError``); then ``EngineConfig.mp`` must equal the
    topology's degree, mp must divide the query and KV heads, and the
    model must hold a rank's heads (built after ``init_mesh``) — each a
    ``ValueError``, as in the JAX engine."""
    mp = axis_group("mp").nranks
    asked = config.mp if config.mp is not None else mp
    if asked > 1:
        waiting = (
            (config.audit is not None and config.audit.enabled,
             "the numerics auditor (its replicated re-run)"),
            (config.spec is not None and config.spec.enabled,
             "speculative decoding"),
            (config.aot is not None or bool(config.aot_path),
             "AOT artifacts"))
        for bad, what in waiting:
            if bad:
                raise NotImplementedError(
                    f"EngineConfig mp={asked}: {what} at mp > 1 is not "
                    f"ported to paddle_tpu_torch yet (ROADMAP A11)")
    if config.mp is not None and config.mp != mp:
        raise ValueError(
            f"EngineConfig.mp={config.mp} but the hybrid topology has "
            f"mp={mp}; call distributed.topology.init_mesh(mp=...) on every "
            f"rank before building the model and the engine")
    if mp > 1:
        cfg = model.config
        if cfg.num_key_value_heads % mp or cfg.num_attention_heads % mp:
            raise ValueError(
                f"mp={mp} must divide num_key_value_heads="
                f"{cfg.num_key_value_heads} and num_attention_heads="
                f"{cfg.num_attention_heads} (the KV pools shard along the "
                f"head dim)")
        held = model.llama.layers[0].self_attn.num_kv_heads
        if held * mp != cfg.num_key_value_heads:
            raise ValueError(
                f"the model holds {held} of {cfg.num_key_value_heads} KV "
                f"heads a rank, not those of mp={mp}: build it after "
                f"distributed.topology.init_mesh(mp={mp})")
    return mp


class EngineCore:
    """Continuous-batching engine over one causal-LM model.

    ``add_request`` enqueues; each ``step()`` asks the scheduler for a
    plan (decode-slot reservation with preemption, then admission and
    prefill chunks), runs it — as a decode burst, as one packed ragged
    step, or as the legacy prefill and decode families — with in-step
    sampling, and retires finished requests.  ``stream()`` exposes a
    per-request generator that drives ``step()`` on demand.

    Construction: ``config=EngineConfig(...)`` WINS over the keyword
    arguments, which are otherwise folded into an :class:`EngineConfig`
    (``self.engine_config``) — the JAX engine's rule, so the keyword form
    builds the legacy families (``unified_step=False``).

    ``ragged_launches`` counts packed steps run; with the CUDA kernels the
    ragged kernel launches once per layer per packed step, and the decode
    kernel once per layer per decode step or burst iteration.

    ``registry`` (default: a registry of the engine's own) and
    ``metrics_labels`` (e.g. ``{"replica": "0"}``, riding every series)
    let several engines publish on one Prometheus page."""

    def __init__(self, model, num_blocks: int = 256, block_size: int = 16,
                 dtype=torch.float32,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 profile_ops: bool = False, registry=None,
                 prefix_cache: bool = True,
                 config: Optional[EngineConfig] = None,
                 use_pallas_paged: Optional[bool] = None,
                 metrics_labels: Optional[Dict[str, str]] = None):
        if config is None:
            config = EngineConfig(
                num_blocks=num_blocks, block_size=block_size, dtype=dtype,
                prefix_cache=prefix_cache, profile_ops=profile_ops,
                scheduler=scheduler_config, use_pallas_paged=use_pallas_paged)
        check_supported(config)
        self.engine_config = config
        num_blocks, block_size = config.num_blocks, config.block_size
        cfg = model.config
        self.mp = resolve_mp(config, model)
        # the control plane of mp > 1: the controller broadcasts each
        # launch, the followers run it (serving/tp.py); None at mp = 1
        self.tp = StepChannel(axis_group("mp")) if self.mp > 1 else None
        self.model = model
        self.device = next(model.parameters()).device
        self.kv = KVCacheManager(num_blocks, block_size,
                                 enable_prefix_cache=config.prefix_cache)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.scheduler = ContinuousBatchingScheduler(
            config.scheduler or SchedulerConfig(), self.kv)
        self.metrics = ServingMetrics(registry=registry,
                                      labels=metrics_labels)
        self.tracer = self.metrics.tracer
        self._sampling_counters = _register_sampling_metrics(
            self.metrics.registry)
        # step-level introspection: bucket utilization and padding per
        # launch, each graph capture as a compile, capture windows
        self.stepprof = StepProfiler(registry=self.metrics.registry,
                                     labels=metrics_labels,
                                     enabled=config.step_profile)
        self.metrics.attach_step_profiler(self.stepprof)
        # KV-cache observability, fed by the pool's event-driven hooks
        self.cachestat = CacheStatTracker(self.kv,
                                          registry=self.metrics.registry,
                                          labels=metrics_labels,
                                          enabled=config.cache_stats)
        self._evict_events_step = 0  # per-step lifecycle-event budget
        self.kv.on_evict = self._on_pool_evict
        self.kv.on_revive = self._on_pool_revive
        # the numerics auditor: sentinel on every launch, shadow
        # re-execution through the kernels' plain twins on sampled steps
        self.audit = NumericsAuditor(self, config=config.audit,
                                     registry=self.metrics.registry,
                                     labels=metrics_labels)
        # request-lifecycle timelines; set_lifecycle() rebinds the engine
        # onto a shared tracker
        self._replica_label = (metrics_labels or {}).get("replica", "0")
        self._lifecycle_on = config.lifecycle_events
        if config.lifecycle is not None:
            self.lifecycle = config.lifecycle
        else:
            self.lifecycle = LifecycleTracker(
                registry=self.metrics.registry,
                enabled=config.lifecycle_events,
                decode_sample=config.decode_event_sample)
        self.requests: Dict[object, Request] = {}
        self.step_seq = 0
        # metrics history: set_history() binds a HistoryStore that every
        # step ticks (gated by EngineConfig.history)
        self.history = None
        self.metrics.set_mp_shards(self.mp)
        self._burst_counters = _register_burst_metrics(
            self.metrics.registry, labels=self.metrics.labels)
        self._unified = bool(config.unified_step)
        # attention-kernel routing of every family (PagedCache.use_pallas)
        self._use_pallas = config.use_pallas_paged
        self._pool_dtype = (config.dtype if config.dtype is not None
                            else torch.float32)
        # allocated once; every step writes its K/V into them in place; at
        # mp > 1 a rank's pools hold its Hkv/mp heads
        shape = kv_pool_shape(num_blocks, block_size,
                              cfg.num_key_value_heads, cfg.head_dim, self.mp)
        self._k_pools = [torch.zeros(shape, dtype=self._pool_dtype,
                                     device=self.device)
                         for _ in range(cfg.num_hidden_layers)]
        self._v_pools = [torch.zeros(shape, dtype=self._pool_dtype,
                                     device=self.device)
                         for _ in range(cfg.num_hidden_layers)]
        self.decode_buckets = set()
        self.prefill_buckets = set()
        self.ragged_buckets = set()
        self.burst_buckets = set()
        self.ragged_launches = 0
        # captures of each graphed family (the JAX engine's retrace
        # counters): once per (buckets, any_sampled) key; the one-shot and
        # the chunk prefill both count in prefill_trace_count
        self.prefill_trace_count = 0
        self.decode_trace_count = 0
        self.burst_trace_count = 0
        self.ragged_trace_count = 0
        # the bound AOT artifact (bind_aot); set before any capture
        self._aot = None
        self.graphs = StepGraphs(self.device, on_capture=self._on_capture)
        if self.mp > 1:
            self.graphs.eager_reason = (
                f"mp={self.mp}: the step's collectives run between its "
                f"kernels, outside any CUDA graph (ROADMAP A11 item 7)")
            self.metrics.set_graphs_eager(self.graphs.eager_reason)
        # each rows bucket's last-logits buffer of the burst iteration
        self._burst_last: Dict[int, torch.Tensor] = {}
        # decode bursts: the tables of a burst are padded to ONE width (the
        # full pool's width bucket), so rows crossing block boundaries
        # mid-burst never change it; the kernel reads only live pages
        self._burst_steps = max(0, int(config.burst_steps or 0))
        self._burst_width = bucket_size(max(1, num_blocks - 1))
        # the fault injector a fleet binds (set_fault_injector); None = off
        self._fault = None
        # speculative decoding: the host-side proposer and verify-row
        # bookkeeping; drafts pack into the unified step as short chunks,
        # so spec on and off share one step family and bucket lattice
        self.spec = None
        if config.spec is not None and config.spec.enabled:
            if not self._unified:
                raise ValueError(
                    "EngineConfig.spec requires unified_step=True: draft "
                    "verification packs into the unified ragged step "
                    "(there is no legacy-family verify path)")
            if self.scheduler.config.max_tokens_per_step is None:
                raise ValueError(
                    "EngineConfig.spec requires "
                    "SchedulerConfig.max_tokens_per_step: draft tokens "
                    "compete for the step's leftover token budget — an "
                    "unbounded budget would unbound the packed bucket")
            self.spec = SpecDecoder(config.spec,
                                    registry=self.metrics.registry,
                                    labels=metrics_labels)
        model.eval()
        # AOT serving artifacts, bound LAST: validate() compares against
        # the fully built engine.  A loaded artifact object (config.aot,
        # the fleet-sharing form) wins over a path.
        art = config.aot
        if art is None and config.aot_path:
            from .aot import AotArtifact

            art = AotArtifact.load(config.aot_path, device=self.device)
        if art is not None:
            self.bind_aot(art)

    # --- AOT artifact binding ------------------------------------------------
    @property
    def aot_artifact(self):
        """The bound :class:`~paddle_tpu_torch.serving.aot.AotArtifact`, or
        ``None``."""
        return self._aot

    def bind_aot(self, artifact, record_load: bool = True) -> None:
        """Validate and bind an AOT artifact (as the JAX engine's
        ``bind_aot``): admission caps sequences at the artifact's
        ``max_seq_len``, bursts launch at its table width, the step
        graphs are sealed to its universe (a key outside it raises
        ``AotBucketMissing``), and the trace counters never move again.
        ``record_load=False`` (a supervisor's rebind of an already-loaded
        artifact) records no load sample.  Raises
        ``AotManifestMismatch`` on any deployment disagreement, binding
        nothing."""
        self._single_rank("AOT artifacts")
        artifact.validate(self)
        self._aot = artifact
        # admission-side guard (the backstop stays in AotArtifact.call)
        self.scheduler.seq_len_cap = int(artifact.manifest["max_seq_len"])
        # the burst programs' tables are as wide as the artifact's bound
        cap = self.scheduler.seq_len_cap
        self._burst_width = bucket_size(
            max(1, (cap + self.block_size - 1) // self.block_size))
        self.graphs.seal(artifact)
        # one disk load = one serving_aot_load_seconds sample per registry
        sp = self.stepprof
        observe = record_load
        if observe and sp.enabled and sp.registry is not None:
            observe = artifact.mark_load_observed(sp.registry)
        sp.record_aot_load(artifact.load_seconds, artifact.program_count,
                           observe=observe)

    # --- the step families (run on the device) -------------------------------
    def _caches(self, tables, lens, slot_blocks, slot_offsets,
                q_start=None, seg_ids=None):
        """One routed :class:`PagedCache` per layer over the engine's
        pools (the routing tensors are already on the device)."""
        caches = []
        for k, v in zip(self._k_pools, self._v_pools):
            c = PagedCache(k, v)
            c.route(tables, lens, slot_blocks, slot_offsets,
                    q_start=q_start, seg_ids=seg_ids)
            c.use_pallas = self._use_pallas
            caches.append(c)
        return caches

    @staticmethod
    def _sample(logits, temps, top_ks, top_ps, keys, any_sampled: bool):
        """The sampling epilogue.  ``any_sampled`` is False when every row
        is greedy: the reduction then equals its argmax, which is taken
        directly instead of sorting the vocabulary."""
        if any_sampled:
            return sample_tokens(logits, temps, top_ks, top_ps, keys)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _decode_fn(self, ids, pos, tables, lens, slot_blocks, slot_offsets,
                   temps, top_ks, top_ps, keys, any_sampled: bool):
        """One batched decode step: each row writes its token's K/V into
        its (block, offset) slot and attends through its block table (the
        CUDA decode kernel on the card), then the next token of every row
        is sampled.  Returns tokens, last-position logits and their
        :func:`logit_stats`, on the device."""
        caches = self._caches(tables, lens, slot_blocks, slot_offsets)
        with torch.no_grad():
            logits = self.model(ids, caches=caches, pos=pos)
            last = logits[:, -1, :].float()
            tokens = self._sample(last, temps, top_ks, top_ps, keys,
                                  any_sampled)
            return tokens, last, logit_stats(last)

    def _burst_fn(self, ids, pos, lens, act, buf, last, j, tables,
                  slot_blocks, slot_offsets, eos_ids, temps, top_ks, top_ps,
                  keys, any_sampled: bool):
        """One iteration of a decode burst: the ``_decode_fn`` body (route,
        forward, sampling) through
        :func:`~paddle_tpu_torch.ops.decode_burst.burst_iteration`, which
        feeds the sampled token straight back as the next input and
        updates the burst state (``ids`` .. ``j``) in place.  A burst of
        ``n`` steps is ``n`` calls.  Returns the ``[B, Nb]`` token buffer
        (``-1`` = not emitted), on the device."""

        def model_step(ids_j, pos_j, lens_j, sb, so, kp, vp):
            # kp / vp are the engine's pools, written in place
            caches = self._caches(tables, lens_j, sb, so)
            logits = self.model(ids_j, caches=caches, pos=pos_j)
            return logits[:, -1, :].float(), kp, vp

        with torch.no_grad():
            burst_iteration(model_step,
                            BurstState(ids, pos, lens, act, buf, last, j),
                            eos_ids, slot_blocks, slot_offsets, temps, top_ks,
                            top_ps, keys, self._k_pools, self._v_pools,
                            any_sampled=any_sampled)
        return (buf,)

    def _prefill_fn(self, ids, last_pos, blocks, offs, temps, top_ks,
                    top_ps, keys, any_sampled: bool):
        """One-shot prefill: the dense-cache forward over the (padded)
        prompt from position 0, then every layer's K/V scattered into the
        sequence's pages — pad positions scatter into the null page, whose
        content no real row reads.  ``last_pos`` (0-d, on the device) is
        the last real position, read by a device index.  The dense caches
        are allocated here, inside the program (from the graphs' pool when
        captured).  Returns the token sampled off that position, its
        logits and their stats."""
        cfg = self.model.config
        shape = (1, ids.shape[1], cfg.num_key_value_heads // self.mp,
                 cfg.head_dim)
        dense = [(torch.zeros(shape, dtype=self._pool_dtype,
                              device=self.device),
                  torch.zeros(shape, dtype=self._pool_dtype,
                              device=self.device))
                 for _ in range(cfg.num_hidden_layers)]
        with torch.no_grad():
            logits = self.model(ids, caches=dense, pos=0)
            last = logits[0].index_select(0, last_pos.reshape(1).long())
            del logits
            last = last.float()
            tokens = self._sample(last, temps, top_ks, top_ps, keys,
                                  any_sampled)
            for kp, vp, (kb, vb) in zip(self._k_pools, self._v_pools, dense):
                kp.index_put_((blocks, offs), kb[0])
                vp.index_put_((blocks, offs), vb[0])
            return tokens, last[0], logit_stats(last[0])

    def _chunk_prefill_fn(self, ids, start, last_pos, tables, lens,
                          slot_blocks, slot_offsets, temps, top_ks, top_ps,
                          keys, any_sampled: bool):
        """Chunked / resumed prefill: ``ids`` (one bucketed chunk starting
        at absolute position ``start``, 0-d on the device) runs through
        the PAGED pools — the chunk's K/V scatters into its slots and
        attention covers the computed prefix plus the chunk itself.
        Returns the token sampled off the chunk's last real position
        (``last_pos``, 0-d on the device), its logits and their stats."""
        caches = self._caches(tables, lens, slot_blocks, slot_offsets,
                              q_start=start)
        with torch.no_grad():
            logits = self.model(ids, caches=caches, pos=start)
            last = logits[0].index_select(0, last_pos.reshape(1).long())
            last = last.float()
            tokens = self._sample(last, temps, top_ks, top_ps, keys,
                                  any_sampled)
            return tokens, last[0], logit_stats(last[0])

    def _unified_fn(self, ids, pos, seg_ids, last_idx, tables, lens,
                    slot_blocks, slot_offsets, temps, top_ks, top_ps, keys,
                    any_sampled: bool):
        """ONE packed ragged step: ``ids`` is a flat ``[1, Tb]`` token batch
        mixing decode rows and prefill chunks, with per-token absolute
        positions ``pos`` ([1, Tb]), per-token row routing ``seg_ids``
        ([Tb]) and per-ROW block tables / KV lengths ([Tb, TWb] / [Tb];
        rows past the real count are null-page pads).  Every token writes
        its K/V into its own (block, offset) slot and attends causally over
        its row's pages.  Returns the token sampled at every packed
        position, each row's last-token logits (gathered at ``last_idx``)
        and their :func:`logit_stats`, all on the device."""
        caches = self._caches(tables, lens, slot_blocks, slot_offsets,
                              q_start=pos[0], seg_ids=seg_ids)
        with torch.no_grad():
            logits = self.model(ids, caches=caches, pos=pos)[0].float()
            last = logits[last_idx]
            tokens = self._sample(logits, temps, top_ks, top_ps, keys,
                                  any_sampled)
            return tokens, last, logit_stats(last)

    def _tokens_fn(self, family, any_sampled: bool):
        """The graphed form of a one-step family.  With the auditor off:
        its sampled tokens alone, as a 1-tuple — the last logits and their
        stats are still computed, as in the JAX program, but no graph keeps
        them as outputs (a unified bucket's are ``[Tb, vocab]`` fp32).  With
        the auditor on: ``(tokens, last logits, stats)``, all kept as
        static outputs and read after the replay.  The key is the same
        either way, so the auditor changes no capture count."""
        fn = functools.partial(family, any_sampled=any_sampled)
        if self.audit.enabled:
            return fn
        return lambda *args: fn(*args)[:1]

    def _family_fn(self, program: str, any_sampled: bool):
        """The function a step program of ``program`` captures."""
        if program == "burst":
            return functools.partial(self._burst_fn, any_sampled=any_sampled)
        family = {"decode": self._decode_fn, "ragged": self._unified_fn,
                  "prefill": self._prefill_fn,
                  "chunk": self._chunk_prefill_fn}[program]
        return self._tokens_fn(family, any_sampled)

    def _on_capture(self, key) -> None:
        """A step program was captured (the JAX engine's retrace): the
        family's trace counter (``prefill_trace_count`` for the one-shot
        and the chunk prefill alike, as in the JAX engine), its
        ``*_jit_traces`` metric and a ``jit`` tracer instant, as the
        traced bodies of the JAX engine record, and the capture's wall
        time as the step profiler's compile of this (program, bucket).
        With an AOT artifact bound none of these move — the capture of a
        key of the saved universe is counted in ``graphs.captures`` only,
        as the JAX engine's lazy compile of a loaded program is."""
        if self._aot is not None:
            return
        family, dims = key[0], key[1:-1]
        self.stepprof.record_compile(
            family, dims, self.graphs.programs[key].capture_seconds)
        counter = "prefill" if family == "chunk" else family
        setattr(self, f"{counter}_trace_count",
                getattr(self, f"{counter}_trace_count") + 1)
        self.metrics.count(f"{counter}_jit_traces")
        names = {"decode": ("batch", "table_width"),
                 "burst": ("batch", "burst_bucket"),
                 "ragged": ("token_bucket", "table_bucket"),
                 "prefill": ("prompt_bucket",),
                 "chunk": ("chunk_bucket", "table_bucket")}[family]
        self.tracer.instant(f"{counter}_jit_trace", cat="jit",
                            any_sampled=key[-1], **dict(zip(names, dims)))

    # --- request lifecycle --------------------------------------------------
    def set_lifecycle(self, tracker: LifecycleTracker,
                      replica: Optional[str] = None) -> None:
        """Rebind this engine onto a shared lifecycle tracker (before any
        request exists), so several engines' events land in one tracker.
        ``replica`` pins the identity this engine stamps on every event.
        ``EngineConfig.lifecycle_events`` still gates this engine."""
        self.lifecycle = tracker
        if replica is not None:
            self._replica_label = str(replica)

    def _lc(self, rid, name: str, **attrs) -> None:
        """One lifecycle event, replica-stamped; no-op when gated off."""
        if self._lifecycle_on:
            self.lifecycle.event(rid, name, replica=self._replica_label,
                                 **attrs)

    def _on_pool_evict(self, block: int, depth: int, lifetime: int,
                       cause: str) -> None:
        """BlockPool eviction hook: a reuse-parked cached block was
        clobbered for an allocation.  The counter, the cause/depth series
        and the lifecycle ``prefix_cache_eviction`` event (within the
        per-step budget; the rest collapse into one burst summary at the
        end of the step) fire here, at the eviction."""
        self.metrics.count("prefix_cache_evictions")
        self.cachestat.record_eviction(depth, lifetime, cause)
        self._evict_events_step += 1
        if self._evict_events_step <= _EVICT_EVENTS_PER_STEP:
            self._lc(None, "prefix_cache_eviction", block=int(block),
                     depth=int(depth), lifetime_steps=int(lifetime),
                     cause=cause)

    def _flush_evict_burst(self) -> None:
        """End of step: one summary event for evictions past the per-step
        lifecycle-event budget, then reset the budget."""
        suppressed = self._evict_events_step - _EVICT_EVENTS_PER_STEP
        self._evict_events_step = 0
        if suppressed > 0:
            self._lc(None, "prefix_cache_eviction_burst",
                     suppressed=suppressed,
                     total=suppressed + _EVICT_EVENTS_PER_STEP)

    def _on_pool_revive(self, block: int, depth: int, lru_depth: int,
                        lifetime: int) -> None:
        """BlockPool revive hook: a prefix fork revived a reuse-parked
        block; its LRU position feeds the hit-depth histogram."""
        self.cachestat.record_revive(lru_depth, lifetime)

    def set_history(self, history) -> None:
        """Bind a :class:`~paddle_tpu_torch.observability.HistoryStore`
        that every step ticks.  Ignored when ``EngineConfig.history`` is
        off."""
        if self.engine_config.history:
            self.history = history

    def set_fault_injector(self, injector) -> None:
        """Bind a :class:`~paddle_tpu_torch.serving.faultinject.FaultInjector`,
        consulted at the named injection points inside :meth:`step`.  The
        fleet router owns the instance, so its exactly-once schedule
        survives supervisor rebuilds."""
        self._fault = injector

    def hot_prefixes(self, top_k=None):
        """Heat-table-hot cached prefixes with full chain digests (see
        :meth:`CacheStatTracker.hot_prefixes`).  Engine-thread callers
        only."""
        return self.cachestat.hot_prefixes(top_k)

    def add_request(self, prompt_ids, sampling: Optional[SamplingParams] = None,
                    request_id=None, priority: int = 0,
                    trace_id: Optional[str] = None,
                    prefix_hashes: Optional[List[bytes]] = None,
                    slo_ms: Optional[float] = None,
                    resume_tokens: Optional[List[int]] = None) -> Request:
        """Enqueue a request (admission happens inside ``step``).
        ``prefix_hashes`` carries leading-block chain hashes already
        computed over this prompt at this engine's block size
        (``ops.paged_attention.prefix_chain_hashes``).  ``resume_tokens``
        seeds already-emitted output tokens of a request migrating in
        mid-stream (the prefill -> decode hand-off): the prefill target
        becomes prompt + outputs and the recompute discipline continues
        the stream from the next position; with the donor's KV imported
        first, that prefill is a prefix-cache hit."""
        req = Request(prompt_ids=list(np.asarray(prompt_ids).reshape(-1)),
                      sampling=sampling or SamplingParams(),
                      request_id=request_id, priority=priority,
                      trace_id=trace_id, prefix_hashes=prefix_hashes,
                      slo_ms=slo_ms)
        if req.request_id in self.requests:
            raise ValueError(f"request id {req.request_id!r} already exists")
        if resume_tokens:
            req.output_tokens.extend(int(t) for t in resume_tokens)
        req.arrival_time = time.perf_counter()
        self.requests[req.request_id] = req
        self.scheduler.add(req)
        self.metrics.count("requests_admitted")
        self._lc(req.request_id, _lc.EV_ENQUEUED, trace_id=req.trace_id,
                 prompt_tokens=len(req.prompt_ids), slo_ms=slo_ms,
                 queue_depth=self.scheduler.queue_depth)
        return req

    def abort_request(self, request_id,
                      reason: FinishReason = FinishReason.ABORT) -> bool:
        """Abort: frees blocks immediately, ends any stream with
        ``reason``.  True if the request was still live."""
        req = self.requests.get(request_id)
        if req is None or req.finished:
            return False
        self.scheduler.remove(req)
        self.kv.free(req.request_id)
        self._finish(req, reason)
        self.requests.pop(request_id, None)
        return True

    def _finish(self, req: Request, reason: FinishReason) -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        self.metrics.count(f"requests_finished_{reason.value}")
        e2e = req.finish_time - req.arrival_time
        self.metrics.observe_finish(e2e, req.slo_ms)
        self._lc(req.request_id, _lc.EV_FINISH, reason=reason.value,
                 e2e_s=round(e2e, 6), generated=len(req.output_tokens),
                 preemptions=req.num_preemptions)
        # park the attribution row in the bounded recent ring
        self.cachestat.close_request(req.request_id)

    def _emit(self, req: Request, tok: int) -> None:
        """Append one sampled token + finish-state bookkeeping."""
        now = time.perf_counter()
        if req.first_token_time is None:
            req.first_token_time = now
            ttft = now - req.arrival_time
            self.metrics.observe_ttft(ttft)
            if req.prefill_start_time is not None:
                self.metrics.observe_prefill_phase(
                    now - req.prefill_start_time)
            self._lc(req.request_id, _lc.EV_FIRST_TOKEN,
                     ttft_s=round(ttft, 6))
        else:
            itl = now - req._last_emit
            self.metrics.observe_inter_token(itl)
            self._lc(req.request_id, _lc.EV_DECODE_TOKEN,
                     itl_s=round(itl, 6))
        req._last_emit = now
        req.append_token(tok)
        if req.hit_eos(tok):
            self._finish(req, FinishReason.EOS)
        elif len(req.output_tokens) >= req.sampling.max_new_tokens:
            self._finish(req, FinishReason.LENGTH)

    def _emit_device(self, req: Request, tok: int) -> None:
        """Emit one token sampled on the device (the draw key is the pure
        ``(seed, output_position)`` pair, so no host RNG is consumed)."""
        kind = "greedy" if req.sampling.temperature == 0.0 else "sampled"
        self._sampling_counters[kind].inc()
        self._emit(req, int(tok))

    def _retire(self, req: Request) -> None:
        self.scheduler.remove(req)
        self.kv.free(req.request_id)
        # the caller keeps the object from add_request
        self.requests.pop(req.request_id, None)

    def _begin_prefill_chunk(self, req: Request, t0: float):
        """Resolve + reserve this step's prefill chunk for ``req``.
        Returns ``(ids_full, target, start, n, recompute)``."""
        rid = req.request_id
        ids_full = req.prompt_ids + req.output_tokens
        target = len(ids_full)
        start = self.kv.seq_len(rid)  # cached fork + earlier chunks
        n = req._chunk_tokens if req._chunk_tokens else target - start
        req._chunk_tokens = None
        recompute = bool(req.output_tokens
                         and start == req.num_cached_tokens)
        if req.prefill_start_time is None:
            req.prefill_start_time = t0
            self.metrics.observe_queue_wait(t0 - req.arrival_time)
        if recompute:
            self.metrics.count("recompute_prefills")  # first chunk only
        if not self.kv.allocate(rid, n, cause="prefill_chunk"):
            raise PoolExhausted(  # scheduler planning guarantees room
                f"prefill chunk of {n} tokens for {rid!r} after admission")
        return ids_full, target, start, n, recompute

    def _finish_prefill_chunk(self, req: Request, ids_full, target: int,
                              start: int, n: int, recompute: bool,
                              t0: float, tok: int) -> None:
        """Post-launch bookkeeping for one prefill chunk: commit, lifecycle
        event, counters, prefix-hash registration, and — when the prefill
        completes — the emission of ``tok``, sampled off the chunk's last
        position."""
        rid = req.request_id
        self.kv.commit(rid, n)
        self._lc(rid, _lc.EV_PREFILL_CHUNK, start=start, tokens=n,
                 target=target, chunk=bool(start or n != target),
                 recompute=recompute,
                 duration_s=round(time.perf_counter() - t0, 6))
        self.metrics.count("prefill_tokens_computed", n)
        if self.kv.prefix_cache_enabled:
            # index the fully-written blocks NOW, so a same-prefix request
            # admitted next step shares them even mid-prefill
            self.kv.record_block_hashes(rid, ids_full, start + n)
        if start + n >= target:
            self._emit_device(req, tok)

    # --- execution ----------------------------------------------------------
    def _pad_inputs(self, program: str, bucket):
        """The host inputs of one ``(program, bucket)`` launch with every
        row a pad row, by the engine's pad convention: token 0, KV slots
        in the null page 0, tables of null pages, lengths 1 (one token of
        the null page, never 0), temperature 0.  Returns the named arrays
        (the burst's last-logits buffer is the engine's device tensor for
        that rows bucket) and the sampling pack.  The dispatch sites fill
        the real rows in; :meth:`warm_program` launches them as they are,
        so a warm launch writes the null page only."""
        i32, i64 = np.int32, np.int64
        if program == "decode":
            B, W = bucket
            rows = B
            a = dict(ids=np.zeros((B, 1), i64), pos=np.zeros((B,), i32),
                     tables=np.zeros((B, W), i32), lens=np.ones((B,), i32),
                     slot_blocks=np.zeros((B,), i64),
                     slot_offsets=np.zeros((B,), i64))
        elif program == "burst":
            B, N = bucket
            rows = B
            last = self._burst_last.get(B)
            if last is None:
                last = self._burst_last[B] = torch.zeros(
                    (B, self.model.config.vocab_size), dtype=torch.float32,
                    device=self.device)
            a = dict(ids=np.zeros((B, 1), i64), pos=np.zeros((B,), i32),
                     lens=np.ones((B,), i32),
                     active=np.zeros((B,), np.bool_),
                     buf=np.full((B, N), -1, i32), last=last,
                     j=np.zeros((1,), i64),
                     tables=np.zeros((B, self._burst_width), i32),
                     slot_blocks=np.zeros((B, N), i64),
                     slot_offsets=np.zeros((B, N), i64),
                     eos_ids=np.full((B,), -1, i32))
        elif program == "ragged":
            T, W = bucket
            rows = T
            a = dict(ids=np.zeros((1, T), i64), pos=np.zeros((1, T), i32),
                     seg_ids=np.zeros((T,), i32),
                     last_idx=np.zeros((T,), i64),
                     tables=np.zeros((T, W), i32), lens=np.ones((T,), i32),
                     slot_blocks=np.zeros((T,), i64),
                     slot_offsets=np.zeros((T,), i64))
        elif program == "prefill":
            (T,) = bucket
            rows = 1
            a = dict(ids=np.zeros((1, T), i64), last_pos=np.zeros((), i32),
                     blocks=np.zeros((T,), i64),
                     offs=np.arange(T, dtype=i64) % self.block_size)
        elif program == "chunk":
            W, TW = bucket
            rows = 1
            a = dict(ids=np.zeros((1, W), i64), start=np.zeros((), i32),
                     last_pos=np.zeros((), i32),
                     tables=np.zeros((1, TW), i32), lens=np.ones((1,), i32),
                     blocks=np.zeros((1, W), i64),
                     offs=np.zeros((1, W), i64))
        else:
            raise ValueError(f"unknown step program {program!r}")
        return a, SamplingPack(rows)

    def program_inputs(self, program: str, bucket) -> list:
        """The ordered inputs of one ``(program, bucket)`` launch, every
        row a pad row (:meth:`_pad_inputs`): what ``AotArtifact`` records
        as the program's argument signature."""
        a, pack = self._pad_inputs(program, bucket)
        return [a[n] for n in _PROGRAM_INPUTS[program]] + list(pack.arrays())

    def _step_call(self, program: str, bucket, sampled: bool, a, pack,
                   steps: int = 1):
        """Launch one step family through its step program (key
        ``(program, bucket..., sampled)``).  Every call is one
        host->device round trip — the denominator of the burst saving —
        counted here so per-step and burst launches share one ledger.
        With an AOT artifact bound, the artifact checks the launch
        against its saved universe and signature first, and the launch
        counts as a hit of ``program``."""
        self._burst_counters["roundtrips"].inc()
        if self.tp is not None:
            # the followers launch the same family on their shards
            self.tp.send_step(program, bucket, sampled, steps, a,
                              pack.arrays())
        inputs = [a[n] for n in _PROGRAM_INPUTS[program]] + list(
            pack.arrays())
        if self._aot is not None:
            self._aot.call(program, bucket, *inputs)
            self.stepprof.record_aot_hit(program)
        return self.graphs.run((program, *bucket, sampled),
                               self._family_fn(program, sampled), inputs,
                               steps=steps)

    def follow_step(self, program: str, bucket, sampled: bool, steps: int,
                    host: dict, pack_arrays) -> tuple:
        """A follower rank's half of one launch (``serving.tp.follow``):
        the controller's host arrays over this rank's own pad inputs (its
        device state, a burst's last-logits buffer, stays its own), then
        the same family on this rank's shard and pools.  Returns the
        family's outputs, its sampled tokens first."""
        a, _ = self._pad_inputs(program, tuple(bucket))
        a.update(host)
        inputs = [a[n] for n in _PROGRAM_INPUTS[program]] + list(pack_arrays)
        return self.graphs.run((program, *bucket, sampled),
                               self._family_fn(program, sampled), inputs,
                               steps=steps)

    def _single_rank(self, what: str) -> None:
        """Raise naming ROADMAP A11 for ``what`` at mp > 1 (AOT
        artifacts)."""
        if self.mp > 1:
            raise NotImplementedError(
                f"{what} at mp={self.mp} are not ported to paddle_tpu_torch "
                f"yet (ROADMAP A11)")

    def _collective_phase(self, phase: str) -> Optional[str]:
        """StepTimer's label for ``serving_collective_seconds{phase}``:
        only when the step spans the mp group's ranks."""
        return phase if self.mp > 1 else None

    def warm_program(self, program: str, bucket, any_sampled: bool) -> None:
        """Capture the step program ``(program, bucket..., any_sampled)``
        now, on pad inputs (:meth:`_pad_inputs`): its first run writes the
        null page only.  ``AotArtifact.warm`` calls this for every key of
        its universe before the engine serves."""
        self._single_rank("AOT artifacts")
        self.graphs.run((program, *bucket, any_sampled),
                        self._family_fn(program, any_sampled),
                        self.program_inputs(program, tuple(bucket)))

    def _prefill(self, req: Request) -> None:
        """Run one prefill program for ``req`` — the whole prompt (cold
        one-shot over a dense cache), or one chunk of it (token-budgeted
        chunked prefill and/or resume past a prefix-cache hit) through the
        pools.  Emits the request's next token only when the prefill
        completes (the final chunk's last-position logits ARE that
        token).  Both families are step programs (keys ``("prefill", Tb,
        any_sampled)`` and ``("chunk", Wb, TWb, any_sampled)``) whose
        positions are device data."""
        rid = req.request_id
        t0 = time.perf_counter()
        ids, target, start, n, recompute = self._begin_prefill_chunk(req, t0)
        table = self.kv.table(rid)
        bs = self.block_size
        pos = np.arange(start, start + n)
        if start == 0 and n == target:
            Tb = bucket_size(target)
            program, bucket = "prefill", (Tb,)
            a, pack = self._pad_inputs(program, bucket)
            a["ids"][0, :target] = ids
            a["last_pos"][...] = target - 1
            a["blocks"][:target] = [table[p // bs] for p in pos]   # pads ->
            # null page
            span = dict(tokens=target, bucket=Tb, recompute=recompute)
            prog_attrs = dict(scheduled=n, capacity=Tb)
            audit_inputs = {"ids": a["ids"], "blocks": a["blocks"],
                            "offs": a["offs"]}
        else:
            Wb = bucket_size(n)
            TWb = bucket_size(len(table))
            program, bucket = "chunk", (Wb, TWb)
            a, pack = self._pad_inputs(program, bucket)
            a["ids"][0, :n] = ids[start:start + n]
            a["start"][...] = start
            a["last_pos"][...] = n - 1
            a["tables"][0, :len(table)] = table
            a["lens"][0] = start + n
            a["blocks"][0, :n] = [table[p // bs] for p in pos]   # pads ->
            # null page
            a["offs"][0, :n] = pos % bs
            self.metrics.count("chunked_prefill_steps")
            span = dict(tokens=n, bucket=Wb, chunk=True, start=start,
                        cached=req.num_cached_tokens, recompute=recompute)
            prog_attrs = dict(scheduled=n, capacity=Wb, start=start,
                              table_width=len(table))
            audit_inputs = {"ids": a["ids"], "start": np.int32(start),
                            "tables": a["tables"], "lens": a["lens"],
                            "slot_blocks": a["blocks"],
                            "slot_offsets": a["offs"]}
        self.prefill_buckets.add((program, *bucket))
        # one sampling row: the final chunk's last-position draw
        pack.set_request(0, req)
        sampled = bool((pack.temps > 0).any())
        with self.tracer.span("prefill_step", cat="serving",
                              request=str(rid), trace=req.trace_id, **span):
            with StepTimer(self.metrics, "prefill_step",
                           self._collective_phase("prefill")) as st:
                out = self._step_call(program, bucket, sampled, a, pack)
                tok = int(out[0][0])
        self.stepprof.record_program(
            program, bucket, wall_s=st.dt, request=str(rid), **prog_attrs)
        if self.audit.enabled:
            self.audit.observe_program(
                program, out[2].cpu().numpy(), bucket,
                logits=out[1].cpu().numpy()[None, :], inputs=audit_inputs,
                requests=[{"id": str(rid),
                           "greedy": req.sampling.temperature == 0.0}])
        self._finish_prefill_chunk(req, ids, target, start, n, recompute,
                                   t0, tok)

    def _audit_launch(self, program: str, out, rows: int, bucket,
                      inputs, pre_pools, reqs: List[Request]) -> None:
        """Hand one graphed launch to the auditor: the stats of its
        ``rows`` real rows (pad rows attend the null page), and its last
        logits on a sampled step or when a row is non-finite.  The graph's
        outputs are read here, before the next step program runs."""
        stats = out[2][:rows].cpu().numpy()
        logits = (out[1][:rows].cpu().numpy()
                  if self.audit.sampled or stats[:, 0].any() else None)
        if (self._fault is not None and self.audit.sampled
                and logits is not None):
            # kernel_corrupt: a corrupted COPY reaches the auditor only;
            # the tokens were sampled on the device from the real logits
            logits = self._fault.corrupt_logits(self.step_seq, logits)
        self.audit.observe_program(
            program, stats, bucket, logits=logits, inputs=inputs,
            pre_pools=pre_pools,
            requests=[{"id": str(r.request_id),
                       "greedy": r.sampling.temperature == 0.0}
                      for r in reqs])

    def _decode(self, reqs: List[Request]) -> Dict[object, int]:
        """One bucketed decode step for ``reqs`` (slots already reserved by
        the scheduler on ``req._slot``)."""
        B = len(reqs)
        Bb = bucket_size(B)
        width = max(len(self.kv.table(r.request_id)) for r in reqs)
        Wb = bucket_size(width)
        # pad rows: 1 token of the null page, temp 0 (argmax, ignored)
        a, pack = self._pad_inputs("decode", (Bb, Wb))
        for i, r in enumerate(reqs):
            rid = r.request_id
            t = self.kv.table(rid)
            p = self.kv.seq_len(rid)
            a["ids"][i, 0] = r.last_token
            a["pos"][i] = p
            a["tables"][i, :len(t)] = t
            a["lens"][i] = p + 1           # cache length AFTER this token
            a["slot_blocks"][i], a["slot_offsets"][i] = r._slot
            pack.set_request(i, r)
        self.decode_buckets.add(("decode", Bb, Wb))
        sampled = bool((pack.temps > 0).any())
        inputs = {n: a[n] for n in _PROGRAM_INPUTS["decode"]}
        # shadow-oracle capture: on sampled audit steps the pages this step
        # reads are copied on the device before it writes the pools
        pre_pools, inputs = self.audit.snapshot_pools(
            self._k_pools, self._v_pools, inputs)
        with self.tracer.span("decode_step", cat="serving", batch=B,
                              batch_bucket=Bb, width_bucket=Wb,
                              requests=",".join(str(r.request_id)
                                                for r in reqs)):
            with StepTimer(self.metrics, "decode_step",
                           self._collective_phase("decode")) as st:
                out = self._step_call("decode", (Bb, Wb), sampled, a, pack)
                toks = out[0].cpu().numpy()
        # token/row accounting: B real rows in the Bb row bucket (the
        # scheduler's tokens_planned axis); width padding rides as attrs
        self.stepprof.record_program(
            "decode", (Bb, Wb), scheduled=B, capacity=Bb, wall_s=st.dt,
            table_width=width,
            requests=",".join(str(r.request_id) for r in reqs))
        if self.audit.enabled:
            self._audit_launch("decode", out, B, (Bb, Wb), inputs,
                               pre_pools, reqs)
        result = {}
        for i, r in enumerate(reqs):
            self.kv.commit(r.request_id, 1)
            tok = int(toks[i])
            self._emit_device(r, tok)
            result[r.request_id] = tok
        return result

    def _burst_exec(self, reqs: List[Request],
                    n_steps: int) -> Dict[object, int]:
        """Launch ONE decode burst covering ``n_steps`` decode steps for a
        decode-only resident cohort.  The host pre-extends every row's
        block table to its burst length (the clamp guaranteed the pool can
        back it), launches the loop, then reconciles the whole burst after
        the fact: per-token emission through the normal ``_emit``
        bookkeeping, KV commit of what was actually written, and
        truncation of the unused pre-allocated tail."""
        B = len(reqs)
        Bb = bucket_size(B)
        Nb = bucket_size(n_steps)
        W = self._burst_width
        starts: Dict[object, int] = {}
        for r in reqs:
            rid = r.request_id
            starts[rid] = self.kv.seq_len(rid)
            # positions p..p+n-1 all get slots up front (the decode slot
            # reservation already covers p); failure means burst_capacity
            # promised more than the pool holds
            if not self.kv.allocate(rid, n_steps, cause="burst"):
                raise PoolExhausted(
                    f"burst pre-allocation failed for {rid!r}: "
                    f"burst_capacity promised {n_steps} steps x {B} rows")
        # the burst state (ids .. j) starts from the host each burst; the
        # iterations update it in place
        a, pack = self._pad_inputs("burst", (Bb, Nb))
        assert a["tables"].shape[1] == W
        bs = self.block_size
        for i, r in enumerate(reqs):
            rid = r.request_id
            t = self.kv.table(rid)
            p = starts[rid]
            a["ids"][i, 0] = r.last_token
            a["pos"][i] = p
            a["tables"][i, :len(t)] = t
            a["lens"][i] = p + 1
            q = np.arange(p, p + n_steps)
            a["slot_blocks"][i, :n_steps] = [t[x // bs] for x in q]
            a["slot_offsets"][i, :n_steps] = q % bs
            a["active"][i] = True
            if r.sampling.eos_token_id is not None:
                a["eos_ids"][i] = int(r.sampling.eos_token_id)
            pack.set_request(i, r)
        self.burst_buckets.add(("burst", Bb, Nb))
        sampled = bool((pack.temps > 0).any())
        with self.tracer.span("burst_step", cat="serving", batch=B,
                              batch_bucket=Bb, burst_len=n_steps,
                              burst_bucket=Nb,
                              requests=",".join(str(r.request_id)
                                                for r in reqs)):
            with StepTimer(self.metrics, "burst_step",
                           self._collective_phase("burst")) as st:
                (buf,) = self._step_call("burst", (Bb, Nb), sampled, a, pack,
                                         steps=n_steps)
                buf = buf.cpu().numpy()
        result = {}
        emitted_total = 0
        for i, r in enumerate(reqs):
            rid = r.request_id
            e = 0
            for j in range(n_steps):
                tok = int(buf[i, j])
                if tok < 0:   # -1: the row went inactive (EOS)
                    break
                self._emit_device(r, tok)
                result[rid] = tok
                e += 1
                if r.finished:
                    break
            emitted_total += e
            # iteration j wrote the KV of its input token at p+j, so e
            # emissions committed e positions — as e per-step decodes
            # would; unfinished rows hand back the unused tail (finished
            # rows free wholesale when they retire)
            self.kv.commit(rid, e)
            if not r.finished:
                self.kv.truncate(rid, starts[rid] + e)
        # the scheduler planned one decode token per row; the burst's extra
        # emissions are decode work the engine added
        self.scheduler.tokens_planned_decode += emitted_total - B
        self.stepprof.record_program(
            "burst", (Bb, Nb), scheduled=emitted_total, capacity=Bb * Nb,
            wall_s=st.dt, burst_len=n_steps,
            requests=",".join(str(r.request_id) for r in reqs))
        c = self._burst_counters
        c["launches"].inc()
        c["tokens"].inc(emitted_total)
        c["length"].observe(float(n_steps))
        return result

    def _unified_exec(self, prefills: List[Request],
                      decodes: List[Request],
                      draft_budget: int = 0) -> Dict[object, int]:
        """Pack this step's whole plan — decode rows + prefill chunks —
        into ONE ragged step.  The token dim buckets on the TOTAL scheduled
        token count and the row/table arrays are padded to the same bucket,
        so the shapes come from (token-bucket × table-bucket) pairs.

        With speculative decoding on, decode rows may become ``verify``
        rows: the proposer's k drafts ride as a short chunk
        ``[last_token, d1..dk]`` at positions ``p..p+k``, inside the
        step's leftover ``draft_budget``.  The step samples a target at
        every position; the longest ``d_{j+1} == T_j`` prefix is accepted,
        ``T_0..T_a`` are emitted (a+1 tokens in one step) and the KV tail
        past the last consumed position rolls back (``kv.truncate``)."""
        rows: List[Dict] = []
        t0 = time.perf_counter()
        for r in decodes:
            p = self.kv.seq_len(r.request_id)
            rows.append({"req": r, "kind": "decode", "start": p, "n": 1,
                         "tokens": [r.last_token], "slot": r._slot})
        if self.spec is not None and draft_budget > 0:
            # upgrade decode rows to verify rows in place (proposer +
            # all-or-nothing draft-slot allocation; a row whose slots
            # cannot be covered stays a plain decode row)
            drafts = self.spec.plan_drafts(self.kv, rows, draft_budget)
            # the scheduler planned one token per decode row; the drafts
            # packed on top are decode work too
            self.scheduler.tokens_planned_decode += drafts
        for req in prefills:
            ids_full, target, start, n, recompute = \
                self._begin_prefill_chunk(req, t0)
            rows.append({"req": req, "kind": "chunk", "start": start,
                         "n": n, "tokens": ids_full[start:start + n],
                         "target": target, "recompute": recompute,
                         "ids_full": ids_full})
        R = len(rows)
        T = sum(row["n"] for row in rows)
        Tb = bucket_size(T)
        width = max(len(self.kv.table(row["req"].request_id))
                    for row in rows)
        TWb = bucket_size(width)
        # pad rows: an all-null table, kv_len 1; pad tokens write the null
        # page; the per-TOKEN sampling quartet keeps pad positions at
        # temp=0 (argmax over the null page, discarded)
        a, pack = self._pad_inputs("ragged", (Tb, TWb))
        ids, pos, seg, last_idx = (a["ids"], a["pos"], a["seg_ids"],
                                   a["last_idx"])
        tables, lens = a["tables"], a["lens"]
        slot_blocks, slot_offsets = a["slot_blocks"], a["slot_offsets"]
        # pad tokens route to a pad row; when R == Tb every row is real
        # and no pad token exists
        seg[:] = min(R, Tb - 1)
        cursor = 0
        for i, row in enumerate(rows):
            req = row["req"]
            table = self.kv.table(req.request_id)
            n, start = row["n"], row["start"]
            row["cursor"] = cursor
            ids[0, cursor:cursor + n] = row["tokens"]
            pp = np.arange(start, start + n)
            pos[0, cursor:cursor + n] = pp
            seg[cursor:cursor + n] = i
            tables[i, :len(table)] = table
            lens[i] = start + n           # cache length AFTER this step
            if row["kind"] == "decode":
                slot_blocks[cursor], slot_offsets[cursor] = row["slot"]
            else:
                # chunk and verify rows: every position scatters into its
                # own table-derived slot (plan_drafts allocated a verify
                # row's draft slots)
                slot_blocks[cursor:cursor + n] = [
                    table[x // self.block_size] for x in pp]
                slot_offsets[cursor:cursor + n] = pp % self.block_size
            if row["kind"] == "verify":
                # each position draws at its own output position
                for j in range(n):
                    pack.set_request(cursor + j, req, offset=j)
            else:
                # only a row's last position is ever read
                pack.set_request(cursor + n - 1, req)
            cursor += n
            last_idx[i] = cursor - 1
        self.ragged_buckets.add(("ragged", Tb, TWb))
        self.metrics.count("unified_steps")
        sampled = bool((pack.temps > 0).any())
        inputs = {n: a[n] for n in _PROGRAM_INPUTS["ragged"]}
        pre_pools, inputs = self.audit.snapshot_pools(
            self._k_pools, self._v_pools, inputs)
        with self.tracer.span("unified_step", cat="serving", tokens=T,
                              rows=R, token_bucket=Tb, table_bucket=TWb):
            with StepTimer(self.metrics, "unified_step",
                           self._collective_phase("ragged")) as st:
                out = self._step_call("ragged", (Tb, TWb), sampled, a, pack)
                toks = out[0].cpu().numpy()
        self.ragged_launches += 1
        # scheduled = T real tokens (decode rows count 1 each) vs the Tb
        # token bucket, the scheduler's tokens_planned axis
        self.stepprof.record_program(
            "ragged", (Tb, TWb), scheduled=T, capacity=Tb, wall_s=st.dt,
            rows=R, table_width=width,
            requests=",".join(str(row["req"].request_id) for row in rows))
        if self.audit.enabled:
            self._audit_launch("ragged", out, R, (Tb, TWb), inputs,
                               pre_pools, [row["req"] for row in rows])
        emitted: Dict[object, int] = {}
        for row in rows:
            req = row["req"]
            rid = req.request_id
            c0, n = row["cursor"], row["n"]
            if row["kind"] == "decode":
                self.kv.commit(rid, 1)
                tok = int(toks[c0])
                self._emit_device(req, tok)
                emitted[rid] = tok
                continue
            if row["kind"] == "verify":
                # position j's target T_j is the token the plain decode
                # path would sample at that output position (same logits
                # prefix, same (seed, draw) key), so exact-match
                # acceptance keeps spec on token-identical to spec off
                drafts = row["drafts"]
                accepted = 0
                for j, d in enumerate(drafts):
                    if int(toks[c0 + j]) != int(d):
                        break
                    accepted += 1
                emitted_n = 0
                for j in range(accepted + 1):
                    tok = int(toks[c0 + j])
                    self._emit_device(req, tok)
                    emitted[rid] = tok
                    emitted_n += 1
                    if req.finished:
                        break   # later targets are tokens the plain
                        # path would never have drawn
                # the emitted tokens' consumed inputs (last_token + the
                # accepted drafts) hold valid KV; the newest token's KV is
                # written by the step that consumes it
                self.kv.commit(rid, emitted_n)
                if not req.finished:
                    # roll the rejected draft tail back: its fresh blocks
                    # return to the free list
                    self.kv.truncate(rid, row["start"] + emitted_n)
                self.spec.record(len(drafts), accepted)
                self._lc(rid, "spec_verify", drafted=len(drafts),
                         accepted=accepted, emitted=emitted_n)
                continue
            before = len(req.output_tokens)
            self._finish_prefill_chunk(req, row["ids_full"], row["target"],
                                       row["start"], n, row["recompute"], t0,
                                       int(toks[c0 + n - 1]))
            if len(req.output_tokens) > before:  # prefill completed
                emitted[rid] = req.output_tokens[-1]
        return emitted

    def step(self) -> Dict[object, int]:
        """One engine iteration: schedule → a decode burst, one packed
        step, or the legacy prefill and decode families → retire.  Returns
        {request_id: last token} emitted this step.  With
        ``profile_ops=True`` the step's op-bus dispatches are timed into
        the metrics' "Host operator summary" (a replayed graph dispatches
        nothing and adds no row), the timer released after the step.  At
        mp > 1 only the controller steps; a follower rank runs
        ``serving.tp.follow(engine)``."""
        if self.tp is not None and not self.tp.is_controller:
            raise RuntimeError(
                "this rank follows the controller's steps at mp > 1: call "
                "serving.tp.follow(engine) here and step the engine on the "
                "mp group's first rank")
        if not self.engine_config.profile_ops:
            return self._step()
        remove_timer = self.metrics.install_dispatch_timer()
        try:
            return self._step()
        finally:
            remove_timer()

    def _step(self) -> Dict[object, int]:
        self.step_seq += 1
        self.kv.clock = self.step_seq  # park lifetimes tick in steps
        self.stepprof.begin_step()
        self.audit.begin_step()
        fi = self._fault
        try:
            if fi is not None:
                # the named injection points: slow_step sleeps here
                # (inside the replica's watched section), engine_step_raise
                # raises (the engine thread dies through the real death
                # path), pool_exhaust arms one planning pass of refusal
                fi.begin_step(self.step_seq)
            with self.tracer.span("engine_step", cat="serving") as sp:
                if fi is not None and fi.pool_exhausted:
                    self.kv.refuse_allocations = True
                try:
                    plan = self.scheduler.schedule()
                finally:
                    # refusal applies to planning only: the launches below
                    # still allocate what the (starved) plan holds
                    self.kv.refuse_allocations = False
                self.metrics.count("engine_steps")
                self.metrics.count("preemptions", len(plan.preempted))
                for req in plan.preempted:
                    self.tracer.instant(
                        "preemption", cat="serving",
                        request=str(req.request_id), trace=req.trace_id,
                        generated=len(req.output_tokens))
                    self._lc(req.request_id, _lc.EV_PREEMPTED,
                             generated=len(req.output_tokens))
                for req in plan.aborted:
                    # unservable at admission: the scheduler set
                    # state/reason
                    self._lc(req.request_id, _lc.EV_ADMISSION_REJECTED,
                             reason="abort", error=req.error)
                    self._finish(req, FinishReason.ABORT)
                    self.requests.pop(req.request_id, None)
                for req in plan.admitted:
                    self._admitted(req)
                decodes = [r for r in plan.decodes
                           if r.state is RequestState.RUNNING]
                emitted: Dict[object, int] = {}
                # a decode-only resident cohort with a clamped horizon >= 2
                # runs as ONE burst; pending prefill work falls through to
                # the per-step paths (host decisions stay at burst
                # boundaries)
                burst_n = 0
                if self._burst_steps >= 2 and burst_eligible(
                        self.scheduler, plan, decodes, self.spec):
                    burst_n = clamp_burst(self._burst_steps, decodes,
                                          plan.burst_capacity)
                if burst_n >= 2:
                    emitted = self._burst_exec(decodes, burst_n)
                elif self._unified:
                    if plan.prefills or decodes:
                        # draft tokens compete for the leftover budget
                        emitted = self._unified_exec(plan.prefills, decodes,
                                                     plan.draft_budget)
                else:
                    for req in plan.prefills:
                        before = len(req.output_tokens)
                        self._prefill(req)
                        if len(req.output_tokens) > before:  # prefill done
                            # — a partial chunk emits nothing yet
                            emitted[req.request_id] = req.output_tokens[-1]
                    if decodes:
                        emitted.update(self._decode(decodes))
                for req in list(self.scheduler.running):
                    if req.finished:
                        self._retire(req)
                self._flush_evict_burst()
                self.metrics.set_cached_token_ratio()
                # pool timeline: one sample per engine step, the
                # free + reuse + allocated == num_blocks invariant checked
                # inside
                self.cachestat.sample_pool(
                    self.step_seq, promised=self.scheduler.promised_blocks)
                self.metrics.sample_gauges(self.scheduler.queue_depth,
                                           self.scheduler.num_running,
                                           self.kv.occupancy())
                if self.history is not None:
                    self.history.on_step(self.step_seq)
                sp.set_attribute(
                    "step", int(self.metrics._counter("engine_steps").value))
                sp.set_attribute("emitted", len(emitted))
                sp.set_attribute("kv_occupancy",
                                 round(self.kv.occupancy(), 4))
            return emitted
        finally:
            # runs on the death path too: the partial step record still
            # reaches the last-K ring a flight bundle embeds
            self.stepprof.end_step()

    def _admitted(self, req: Request) -> None:
        """Admission bookkeeping for one request of this step's plan:
        prefix-cache counters, the per-request cache attribution (at the
        same points, so sum(per-request cached) == prefix_cache_hit_tokens
        exactly), the lifecycle event and the prefix-heat hit."""
        cached = req.num_cached_tokens
        total = len(req.prompt_ids) + len(req.output_tokens)
        self.metrics.count("prefix_cache_hit_tokens", cached)
        self.metrics.count("prefix_cache_miss_tokens", total - cached)
        if req.prompt_cached_tokens is None:
            req.prompt_cached_tokens = cached
        self.cachestat.record_admission(
            req.request_id, cached, total - cached, len(req.prompt_ids),
            recompute=bool(req.output_tokens))
        self._lc(req.request_id, _lc.EV_ADMITTED, cached_tokens=cached,
                 computed_tokens=total - cached,
                 recompute=bool(req.output_tokens))
        if cached:
            self.tracer.instant(
                "prefix_cache_hit", cat="serving",
                request=str(req.request_id), trace=req.trace_id,
                cached_tokens=cached)
        if cached and self.cachestat.enabled:
            # prefix heat, keyed by the DEEPEST matched block's chain hash
            # (it commits to the whole cached prefix); guarded so a
            # disabled tracker costs no table copy
            depth = cached // self.block_size
            table = self.kv.table(req.request_id)
            self.cachestat.record_prefix_hit(
                self.kv.block_chain_hash(table[depth - 1])
                if 0 < depth <= len(table) else None,
                depth, cached, self.step_seq)

    def run(self, max_steps: Optional[int] = None) -> None:
        """Drive ``step()`` until every request finishes."""
        steps = 0
        while self.scheduler.has_work():
            self.step()
            steps += 1
            if (max_steps is not None and steps >= max_steps
                    and self.scheduler.has_work()):
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps")

    # --- streaming ----------------------------------------------------------
    def stream(self, request_id) -> Iterator[int]:
        """Per-request token generator: yields tokens as they are
        produced, driving the shared engine loop when it runs dry.  Closing
        the generator early aborts the request and frees its blocks."""
        req = self.requests[request_id]

        def _gen():
            cursor = 0
            try:
                while True:
                    while cursor < len(req.output_tokens):
                        yield req.output_tokens[cursor]
                        cursor += 1
                    if req.finished:
                        return
                    self.step()
            finally:
                if not req.finished:
                    self.abort_request(req.request_id)

        return _gen()

    # --- KV hand-off ----------------------------------------------------------
    def export_kv_run(self, request_id):
        """Serialize ``request_id``'s computed prompt KV (its hashed
        leading blocks) as a hand-off run, every KV head's (at mp > 1 the
        followers send theirs); ``None`` when nothing is transferable.
        Pure read: the request keeps running here until
        :meth:`detach_request`."""
        from . import handoff

        return handoff.export_request_run(self, request_id)

    def export_prefix_chain(self, chain_hash, max_blocks=None):
        """Serialize the cached prefix chain addressed by its deepest
        digest; ``None`` on a broken chain."""
        from . import handoff

        return handoff.export_prefix_run(self, chain_hash,
                                         max_blocks=max_blocks)

    def import_kv_run(self, run):
        """Admit a hand-off run into this engine's pool (verified, atomic,
        written into the pools in place; see
        :func:`~paddle_tpu_torch.serving.handoff.import_run`).  Returns the
        fresh-block count, or ``None`` on a capacity refusal."""
        from . import handoff

        return handoff.import_run(self, run)

    def detach_request(self, request_id) -> bool:
        """Drop a request WITHOUT finishing it — the donor half of a
        hand-off: the request migrates (same id, open timeline) to another
        replica, so no finish event fires here.  Its blocks are freed;
        with the prefix cache on, the hashed prompt blocks park warm in
        the reuse LRU, so a failed migration that re-admits here revives
        them at no recompute."""
        req = self.requests.pop(request_id, None)
        if req is None:
            return False
        self.scheduler.remove(req)
        self.cachestat.close_request(request_id)
        self.kv.free(request_id)
        return True
