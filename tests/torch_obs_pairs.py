"""Shared drivers of the port's observability tests: one workload through
the JAX engine and the port's engines on the same weights, with every
telemetry hook on, and the views of what each recorded.

The workload is the JAX observability tests' churn run (``LlamaConfig.tiny``
at 2 layers, 15 blocks of 4 tokens, a prefill budget of 8, four sequences
at most, six prompts sharing an 8-token prefix, 10 new tokens each): it
chunks, forks the prefix, preempts and recomputes.  Request ids are given
explicitly, so both engines' timelines and attributions are keyed alike.
"""

import numpy as np

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import AuditConfig as JaxAuditConfig
from paddle_tpu.observability import HistoryStore as JaxHistoryStore
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.observability import AuditConfig, HistoryStore
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
)
from paddle_tpu_torch.serving.graphs import disable_graphs

BS = 4
LAYERS = 2
# family: the EngineConfig fields that select it
FAMILIES = {
    "legacy": {},
    "burst": {"burst_steps": 8},
    "unified": {"unified_step": True},
}
# the step families the port captures as graphs (their compiles)
GRAPHED = ("prefill", "chunk", "decode", "burst", "ragged")


def prompts(n=6, rng_seed=0, prefix_len=8, tail=8):
    rng = np.random.default_rng(rng_seed)
    prefix = rng.integers(0, 256, prefix_len).tolist()
    return [prefix + rng.integers(0, 256, tail).tolist() for _ in range(n)]


def jax_model():
    paddle.seed(0)
    return JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))


def port_model(jm):
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return llama_from_paddle_tpu(
        state, LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")


def _config(cls, sched_cls, family, audit, num_blocks, **fields):
    return cls(num_blocks=num_blocks, block_size=BS, audit=audit,
               scheduler=sched_cls(max_num_seqs=4,
                                   max_prefill_tokens_per_step=8),
               **FAMILIES[family], **fields)


def jax_engine(model, family, audit=True, num_blocks=15, **fields):
    cfg = _config(JaxEngineConfig, JaxSchedulerConfig, family,
                  JaxAuditConfig(enabled=True, sample_every=1)
                  if audit else None, num_blocks, **fields)
    eng = JaxEngineCore(model, config=cfg)
    eng.set_history(JaxHistoryStore(eng.metrics.registry))
    return eng


def port_engine(model, family, audit=True, num_blocks=15, **fields):
    cfg = _config(EngineConfig, SchedulerConfig, family,
                  AuditConfig(enabled=True, sample_every=1)
                  if audit else None, num_blocks, **fields)
    eng = EngineCore(model, config=cfg)
    eng.set_history(HistoryStore(eng.metrics.registry))
    return eng


def run(eng, sp_cls, ps, max_new=10, slo_ms=None):
    reqs = [eng.add_request(p, sp_cls(max_new_tokens=max_new),
                            request_id=f"r{i}", slo_ms=slo_ms)
            for i, p in enumerate(ps)]
    eng.run(max_steps=4000)
    assert all(r.finished for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def pair(family, audit=True, modes=("graphs", "eager"), **fields):
    """The churn workload through the JAX engine and the port's engine
    (with step graphs, and under ``disable_graphs()``); returns
    ``{"jax": engine, "graphs": engine, "eager": engine, "tokens": {...}}``
    with every engine drained."""
    jm = jax_model()
    pm = port_model(jm)
    ps = prompts()
    out = {"tokens": {}}
    out["jax"] = jax_engine(jm, family, audit, **fields)
    out["tokens"]["jax"] = run(out["jax"], JaxSamplingParams, ps)
    for mode in modes:
        eng = out[mode] = port_engine(pm, family, audit, **fields)
        if mode == "eager":
            with disable_graphs():
                out["tokens"][mode] = run(eng, SamplingParams, ps)
        else:
            out["tokens"][mode] = run(eng, SamplingParams, ps)
    out["model"] = pm
    return out


# --- views of what an engine recorded ----------------------------------------

def program_rows(eng):
    """``stepprof.program_table()`` with the timings left out."""
    return [{k: v for k, v in r.items() if k != "wall_s"}
            for r in eng.stepprof.program_table()]


def bucket_sets(eng):
    return {p: eng.stepprof.bucket_set(p)
            for p in ("prefill", "chunk", "decode", "ragged", "burst")}


def compiles(eng, programs=GRAPHED):
    """The (program, bucket) of each recorded compile, in order."""
    return [(r["program"], r["bucket"]) for r in eng.stepprof.compile_table()
            if r["program"] in programs]


def pool_timeline(eng):
    """The cachestat pool timeline with the timestamps left out."""
    return [{k: v for k, v in r.items() if k != "t"}
            for r in eng.cachestat.timeline()]


def heat_order(eng):
    return [(r["prefix"], r["hits"], r["hit_tokens"], r["depth"])
            for r in eng.cachestat.heat_table()]


def attribution(eng):
    """The cachestat attribution: totals and every request's row."""
    a = eng.cachestat.attribution()
    rows = sorted(a["active"] + a["recent"], key=lambda r: r["id"])
    return a["cached_tokens_total"], a["computed_tokens_total"], rows


def event_names(eng, rids):
    """Each request's lifecycle event names, in order."""
    return {rid: [e["name"] for e in
                  eng.lifecycle.get(rid).to_dict()["events"]]
            for rid in rids}


def series(registry):
    """{(name, label names)} of every series on a registry's page."""
    return {(m.name, tuple(k for k, _ in m.labels))
            for m in registry.series()}


# series of a JAX engine's page that the port does not have yet, by the
# ROADMAP item that brings them: the fleet's finish and admission counters
# (A9).  Spec, AOT and wire series appear only when those
# features run, so a single engine's page has none of them.
JAX_ONLY_SERIES = {("serving_requests_finished_replica_failed_total", ()),
                   ("serving_admission_rejected_total", ())}
# the port registers its prefill and decode families' capture counters up
# front, so an engine whose family never ran reads 0 instead of a missing
# key
PORT_ONLY_SERIES = {("serving_prefill_jit_traces_total", ()),
                    ("serving_decode_jit_traces_total", ())}


def assert_telemetry_matches(r, rids=tuple(f"r{i}" for i in range(6))):
    """Every telemetry view of ``pair()``'s port engines equals the JAX
    engine's: the tokens, the step profiler's rows, bucket sets, scheduled
    tokens and (with graphs) compiles, the pool timeline, prefix heat and
    attribution, each request's lifecycle event names, the audited launch
    counts, and the series names and label sets of the Prometheus page."""
    jax = r["jax"]
    want_series = series(jax.metrics.registry) - JAX_ONLY_SERIES
    for mode in (m for m in ("graphs", "eager") if m in r):
        eng = r[mode]
        assert r["tokens"][mode] == r["tokens"]["jax"], mode
        assert program_rows(eng) == program_rows(jax), mode
        assert bucket_sets(eng) == bucket_sets(jax), mode
        assert eng.stepprof.scheduled_tokens() == \
            jax.stepprof.scheduled_tokens() == eng.scheduler.tokens_planned
        assert compiles(eng) == (compiles(jax) if mode == "graphs" else [])
        assert pool_timeline(eng) == pool_timeline(jax), mode
        assert heat_order(eng) == heat_order(jax), mode
        assert attribution(eng) == attribution(jax), mode
        assert event_names(eng, rids) == event_names(jax, rids), mode
        a, b = eng.audit.snapshot(), jax.audit.snapshot()
        for key in ("status", "steps", "audited_launches", "divergences",
                    "oracle_failures"):
            assert a[key] == b[key], (mode, key)
        got = series(eng.metrics.registry)
        assert got - PORT_ONLY_SERIES == want_series - PORT_ONLY_SERIES, mode
