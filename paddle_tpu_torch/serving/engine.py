"""EngineCore: request-level continuous-batching serving engine (the port
of ``paddle_tpu/serving/engine.py`` on its unified ragged step).

Above the block pool sits an engine that owns a request queue, admission
control and preemption, and runs every engine step as ONE packed ragged
step:

* All sequences share ONE paged KV pool per layer
  (``[num_blocks, block_size, Hkv, D]``, allocated once on the device and
  written in place); per-step routing arrays (block tables, lengths, slot
  indices, per-token row ids and positions) are data, so joining/leaving
  requests never change the pools.
* The scheduler's plan — decode rows (one token each) and prefill chunks —
  packs into one flat token batch padded to a power-of-two bucket ``Tb``
  (with tables padded to ``TWb`` pages), so a step's shapes come from a
  bounded set (``ragged_buckets``), ready for captured CUDA graphs.
* Pool exhaustion preempts (lowest priority, newest arrival first) and
  recomputes instead of failing the request: the victim's next prefill
  runs over ``prompt + output_tokens`` — token-identical continuation under
  greedy decoding.
* Pad tokens route to a pad row whose table is all null pages (block 0)
  with ``kv_len = 1``, and write their K/V into the null page.

The step runs eagerly on the device of the model's parameters: the Llama
forward, whose ragged attention is the CUDA kernel on the card, then the
sampling epilogue; only the sampled token ids come back to the host.  The
legacy program families, bursts, speculative decoding, disaggregation, AOT
artifacts, the auditor and the lifecycle/step-profile/cache-stat/history
hooks belong to later slices of the port: the :class:`EngineConfig` fields
that ask for them raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..observability.audit import logit_stats
from ..ops.paged_attention import PagedCache, PoolExhausted
from ..ops.sampling import sample_tokens
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


@dataclass
class EngineConfig:
    """Engine-level deployment knobs, with the JAX package's names and
    defaults: ``EngineCore(model, config=EngineConfig(...))``.  (The JAX
    engine's legacy keyword construction builds ``unified_step=False`` and
    comes with the legacy families, ROADMAP A7.)

    This slice serves ``unified_step=True`` at mp=1.  Fields asking for
    what it does not implement raise ``NotImplementedError`` at engine
    build (see :func:`check_supported`); ``lifecycle_events``,
    ``decode_event_sample``, ``step_profile``, ``cache_stats`` and
    ``history`` select telemetry whose hooks do not exist yet in the port
    (ROADMAP A8) and record nothing."""

    num_blocks: int = 256
    block_size: int = 16
    dtype: object = None              # pool dtype; None = torch.float32
    prefix_cache: bool = True
    profile_ops: bool = False
    scheduler: Optional[SchedulerConfig] = None
    # ragged attention routing: None/True = the CUDA kernel on a CUDA
    # device (True raises on the CPU), False = the plain PyTorch version
    use_pallas_paged: Optional[bool] = None
    mp: Optional[int] = None
    lifecycle_events: bool = True
    lifecycle: Optional[object] = None
    decode_event_sample: int = 8
    step_profile: bool = True
    audit: Optional[object] = None
    cache_stats: bool = True
    history: bool = True
    unified_step: bool = False
    aot_path: Optional[str] = None
    aot: Optional[object] = None
    spec: Optional[object] = None
    burst_steps: int = 0
    role: str = "unified"


def check_supported(config: EngineConfig) -> None:
    """Raise for every :class:`EngineConfig` setting this slice does not
    implement — nothing is silently ignored."""
    if config.role not in ("unified", "prefill", "decode"):
        raise ValueError(
            f"EngineConfig.role must be 'unified', 'prefill' or 'decode'; "
            f"got {config.role!r}")
    todo = (
        (not config.unified_step, "unified_step=False",
         "the legacy prefill/chunk/decode program families", "A7"),
        ((config.burst_steps or 0) >= 2,
         f"burst_steps={config.burst_steps}",
         "device-resident decode bursts", "A7"),
        (config.audit is not None, "audit", "the numerics auditor", "A8"),
        (config.profile_ops, "profile_ops=True",
         "the per-op dispatch timer", "A8"),
        (config.lifecycle is not None, "lifecycle",
         "shared lifecycle trackers", "A8"),
        (config.spec is not None, "spec", "speculative decoding", "A9"),
        (config.aot is not None or bool(config.aot_path), "aot/aot_path",
         "AOT serving artifacts", "A9"),
        (config.role != "unified", f"role={config.role!r}",
         "prefill/decode disaggregation", "A9"),
        (config.mp not in (None, 1), f"mp={config.mp}",
         "tensor-parallel serving", "A11"),
    )
    for bad, setting, what, item in todo:
        if bad:
            raise NotImplementedError(
                f"EngineConfig {setting}: {what} are not ported to "
                f"paddle_tpu_torch yet (ROADMAP {item})")


class EngineCore:
    """Continuous-batching engine over one causal-LM model.

    ``add_request`` enqueues; each ``step()`` asks the scheduler for a
    plan (decode-slot reservation with preemption, then admission and
    prefill chunks), runs it as ONE packed ragged step with in-step
    sampling, and retires finished requests.  ``stream()`` exposes a
    per-request generator that drives ``step()`` on demand.

    ``ragged_launches`` counts packed steps run; with the CUDA kernel each
    one launches it once per layer."""

    def __init__(self, model, config: Optional[EngineConfig] = None):
        config = config if config is not None else EngineConfig()
        check_supported(config)
        self.engine_config = config
        num_blocks, block_size = config.num_blocks, config.block_size
        cfg = model.config
        self.model = model
        self.device = next(model.parameters()).device
        self.kv = KVCacheManager(num_blocks, block_size,
                                 enable_prefix_cache=config.prefix_cache)
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.scheduler = ContinuousBatchingScheduler(
            config.scheduler or SchedulerConfig(), self.kv)
        self.metrics = ServingMetrics()
        self.tracer = self.metrics.tracer
        self._sampling_counters = _register_sampling_metrics(
            self.metrics.registry)
        self.kv.on_evict = self._on_pool_evict
        self.requests: Dict[object, Request] = {}
        self.step_seq = 0
        self._use_pallas_ragged = config.use_pallas_paged
        pool_dtype = (config.dtype if config.dtype is not None
                      else torch.float32)
        # allocated once; every step writes its K/V into them in place
        shape = (num_blocks, block_size, cfg.num_key_value_heads,
                 cfg.head_dim)
        self._k_pools = [torch.zeros(shape, dtype=pool_dtype,
                                     device=self.device)
                         for _ in range(cfg.num_hidden_layers)]
        self._v_pools = [torch.zeros(shape, dtype=pool_dtype,
                                     device=self.device)
                         for _ in range(cfg.num_hidden_layers)]
        self.ragged_buckets = set()
        self.ragged_launches = 0
        model.eval()

    # --- the packed step (runs on the device) --------------------------------
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
        and their :func:`logit_stats`, all on the device.

        ``any_sampled`` is False when every position is greedy: the
        sampling reduction then equals its argmax, which is taken directly
        instead of sorting the vocabulary."""
        caches = []
        for k, v in zip(self._k_pools, self._v_pools):
            c = PagedCache(k, v)
            c.route(tables, lens, slot_blocks, slot_offsets,
                    q_start=pos[0], seg_ids=seg_ids)
            c.use_pallas = self._use_pallas_ragged
            caches.append(c)
        with torch.no_grad():
            logits = self.model(ids, caches=caches, pos=pos)[0].float()
            last = logits[last_idx]
            if any_sampled:
                tokens = sample_tokens(logits, temps, top_ks, top_ps, keys)
            else:
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            return tokens, last, logit_stats(last)

    # --- request lifecycle --------------------------------------------------
    def _on_pool_evict(self, block: int, depth: int, lifetime: int,
                       cause: str) -> None:
        """BlockPool eviction hook: a reuse-parked cached block was
        clobbered for an allocation."""
        self.metrics.count("prefix_cache_evictions")

    def add_request(self, prompt_ids, sampling: Optional[SamplingParams] = None,
                    request_id=None, priority: int = 0,
                    trace_id: Optional[str] = None,
                    prefix_hashes: Optional[List[bytes]] = None,
                    slo_ms: Optional[float] = None) -> Request:
        """Enqueue a request (admission happens inside ``step``).
        ``prefix_hashes`` carries leading-block chain hashes already
        computed over this prompt at this engine's block size
        (``ops.paged_attention.prefix_chain_hashes``)."""
        req = Request(prompt_ids=list(np.asarray(prompt_ids).reshape(-1)),
                      sampling=sampling or SamplingParams(),
                      request_id=request_id, priority=priority,
                      trace_id=trace_id, prefix_hashes=prefix_hashes,
                      slo_ms=slo_ms)
        if req.request_id in self.requests:
            raise ValueError(f"request id {req.request_id!r} already exists")
        req.arrival_time = time.perf_counter()
        self.requests[req.request_id] = req
        self.scheduler.add(req)
        self.metrics.count("requests_admitted")
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
        self.metrics.observe_finish(req.finish_time - req.arrival_time,
                                    req.slo_ms)

    def _emit(self, req: Request, tok: int) -> None:
        """Append one sampled token + finish-state bookkeeping."""
        now = time.perf_counter()
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.observe_ttft(now - req.arrival_time)
            if req.prefill_start_time is not None:
                self.metrics.observe_prefill_phase(
                    now - req.prefill_start_time)
        else:
            self.metrics.observe_inter_token(now - req._last_emit)
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
                              start: int, n: int, tok: int) -> None:
        """Post-launch bookkeeping for one prefill chunk: commit, counters,
        prefix-hash registration, and — when the prefill completes — the
        emission of ``tok``, sampled off the chunk's last position."""
        rid = req.request_id
        self.kv.commit(rid, n)
        self.metrics.count("prefill_tokens_computed", n)
        if self.kv.prefix_cache_enabled:
            # index the fully-written blocks NOW, so a same-prefix request
            # admitted next step shares them even mid-prefill
            self.kv.record_block_hashes(rid, ids_full, start + n)
        if start + n >= target:
            self._emit_device(req, tok)

    # --- execution ----------------------------------------------------------
    def _unified_exec(self, prefills: List[Request],
                      decodes: List[Request]) -> Dict[object, int]:
        """Pack this step's whole plan — decode rows + prefill chunks —
        into ONE ragged step.  The token dim buckets on the TOTAL scheduled
        token count and the row/table arrays are padded to the same bucket,
        so the shapes come from (token-bucket × table-bucket) pairs."""
        rows: List[Dict] = []
        t0 = time.perf_counter()
        for r in decodes:
            p = self.kv.seq_len(r.request_id)
            rows.append({"req": r, "kind": "decode", "start": p, "n": 1,
                         "tokens": [r.last_token], "slot": r._slot})
        for req in prefills:
            ids_full, target, start, n, _ = \
                self._begin_prefill_chunk(req, t0)
            rows.append({"req": req, "kind": "chunk", "start": start,
                         "n": n, "tokens": ids_full[start:start + n],
                         "target": target, "ids_full": ids_full})
        R = len(rows)
        T = sum(row["n"] for row in rows)
        Tb = bucket_size(T)
        width = max(len(self.kv.table(row["req"].request_id))
                    for row in rows)
        TWb = bucket_size(width)
        ids = np.zeros((1, Tb), np.int64)
        pos = np.zeros((1, Tb), np.int32)
        # pad tokens route to a pad row (all-null table, kv_len 1); when
        # R == Tb every row is real and no pad token exists
        seg = np.full((Tb,), min(R, Tb - 1), np.int32)
        last_idx = np.zeros((Tb,), np.int64)
        tables = np.zeros((Tb, TWb), np.int32)
        lens = np.ones((Tb,), np.int32)   # pad rows: 1 token of null page
        slot_blocks = np.zeros((Tb,), np.int64)  # pad tokens -> null page
        slot_offsets = np.zeros((Tb,), np.int64)
        # per-TOKEN sampling quartet: pad positions stay temp=0 (argmax
        # over the null page, discarded)
        pack = SamplingPack(Tb)
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
                slot_blocks[cursor:cursor + n] = [
                    table[x // self.block_size] for x in pp]
                slot_offsets[cursor:cursor + n] = pp % self.block_size
            # only a row's last position is ever read
            pack.set_request(cursor + n - 1, req)
            cursor += n
            last_idx[i] = cursor - 1
        self.ragged_buckets.add(("ragged", Tb, TWb))
        self.metrics.count("unified_steps")
        dev = self.device
        args = [torch.from_numpy(a).to(dev) for a in (
            ids, pos, seg, last_idx, tables, lens, slot_blocks,
            slot_offsets, pack.temps, pack.top_ks, pack.top_ps,
            pack.keys.astype(np.int64))]
        with self.tracer.span("unified_step", cat="serving", tokens=T,
                              rows=R, token_bucket=Tb, table_bucket=TWb):
            with StepTimer(self.metrics, "unified_step"):
                toks, _last, _stats = self._unified_fn(
                    *args, any_sampled=bool((pack.temps > 0).any()))
                toks = toks.cpu().numpy()
        self.ragged_launches += 1
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
            before = len(req.output_tokens)
            self._finish_prefill_chunk(req, row["ids_full"], row["target"],
                                       row["start"], n,
                                       int(toks[c0 + n - 1]))
            if len(req.output_tokens) > before:  # prefill completed
                emitted[rid] = req.output_tokens[-1]
        return emitted

    def step(self) -> Dict[object, int]:
        """One engine iteration: schedule → one packed step → retire.
        Returns {request_id: token} emitted this step."""
        self.step_seq += 1
        self.kv.clock = self.step_seq  # park lifetimes tick in steps
        with self.tracer.span("engine_step", cat="serving") as sp:
            plan = self.scheduler.schedule()
            self.metrics.count("engine_steps")
            self.metrics.count("preemptions", len(plan.preempted))
            for req in plan.preempted:
                self.tracer.instant(
                    "preemption", cat="serving",
                    request=str(req.request_id), trace=req.trace_id,
                    generated=len(req.output_tokens))
            for req in plan.aborted:
                # unservable at admission: the scheduler set state/reason
                self._finish(req, FinishReason.ABORT)
                self.requests.pop(req.request_id, None)
            for req in plan.admitted:
                cached = req.num_cached_tokens
                total = len(req.prompt_ids) + len(req.output_tokens)
                self.metrics.count("prefix_cache_hit_tokens", cached)
                self.metrics.count("prefix_cache_miss_tokens",
                                   total - cached)
                if req.prompt_cached_tokens is None:
                    req.prompt_cached_tokens = cached
                if cached:
                    self.tracer.instant(
                        "prefix_cache_hit", cat="serving",
                        request=str(req.request_id), trace=req.trace_id,
                        cached_tokens=cached)
            decodes = [r for r in plan.decodes
                       if r.state is RequestState.RUNNING]
            emitted: Dict[object, int] = {}
            if plan.prefills or decodes:
                emitted = self._unified_exec(plan.prefills, decodes)
            for req in list(self.scheduler.running):
                if req.finished:
                    self._retire(req)
            self.metrics.set_cached_token_ratio()
            self.metrics.sample_gauges(self.scheduler.queue_depth,
                                       self.scheduler.num_running,
                                       self.kv.occupancy())
            sp.set_attribute("step", self.step_seq)
            sp.set_attribute("emitted", len(emitted))
        return emitted

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
