"""The port's compile-once step programs (``serving/graphs.py``), held to
the JAX engine's jit discipline on the same weights (CPU, fp32,
``LlamaConfig.tiny`` at 2 layers, the sizes of
``test_torch_legacy_serving.py``).

* **Token identity.**  The legacy prefill families (one-shot and chunk),
  decode step, decode bursts of 8 and the unified ragged step give the
  same tokens through the step-program cache as under
  ``disable_graphs()`` (eager) and as the JAX engine, on greedy,
  all-sampled and mixed workloads.
* **Trace counters.**  ``prefill_trace_count`` (the one-shot and the chunk
  prefill), ``decode_trace_count``, ``burst_trace_count`` and
  ``ragged_trace_count`` move once per new ``(family, buckets,
  any_sampled)`` key: on greedy and all-sampled workloads each equals the
  JAX engine's and the size of its bucket set; on the mixed one it lies
  between the bucket set and twice it (``any_sampled`` is in the key).
  The ``*_jit_traces`` metrics (and the registry snapshot's
  ``serving_*_jit_traces_total``) equal the attributes; under
  ``disable_graphs()`` nothing is captured and nothing counts.
* **The burst iteration.**  Driven through the cache — iteration 0 at the
  capture, the rest as replays, and a second burst replayed on fresh
  inputs — it equals ``burst_oracle`` over the ``(B, Nb)`` lattice, with
  EOS mid-burst and a draw index past 2**32.
* **Bookkeeping.**  A kernel-counter change recorded at a key's first call
  is added on every later call; outputs alias across calls; a static
  input is refused a misshaped array; and a replay whose static inputs
  were not refreshed gives other tokens, so the identity check bites.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.ops import decode_burst as tburst
from paddle_tpu_torch.ops import paged_decode, ragged_paged
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
)
from paddle_tpu_torch.serving import graphs
from paddle_tpu_torch.serving.graphs import StepGraphs, disable_graphs
from torch_jax_cache import jax_compile_cache  # noqa: F401

_RNG = np.random.default_rng(7)
PREFIX = _RNG.integers(0, 256, 8).tolist()
PROMPTS = [PREFIX + _RNG.integers(0, 256, 8).tolist() for _ in range(5)]
LAYERS = 2
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
WORKLOADS = {
    "greedy": None,
    "sampled": [SAMPLED] * 5,
    "mixed": [{}, SAMPLED, dict(SAMPLED, seed=42), {},
              dict(SAMPLED, top_k=0)],
}
# family: (EngineConfig fields, prompts, new tokens, the graphed families)
FAMILIES = {
    "legacy": (dict(), PROMPTS, 8, ("prefill", "decode")),
    "burst": (dict(burst_steps=8), PROMPTS[:3], 12,
              ("prefill", "decode", "burst")),
    "unified": (dict(unified_step=True), PROMPTS, 8, ("ragged",)),
}
TRACED = ("prefill", "decode", "burst", "ragged")
# the step programs each trace counter counts
PROGRAMS = {"prefill": ("prefill", "chunk"), "decode": ("decode",),
            "burst": ("burst",), "ragged": ("ragged",)}


def _jax_model():
    paddle.seed(0)
    return JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))


def _port_model(jax_model):
    state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    return llama_from_paddle_tpu(
        state, LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")


def _engine_kw(fields):
    return dict(num_blocks=64, block_size=4, **fields)


def _run(eng, sp_cls, prompts, max_new, per_req):
    reqs = []
    for i, p in enumerate(prompts):
        kw = dict(per_req[i]) if per_req else {}
        if kw.get("temperature"):
            kw.setdefault("seed", 100 + i)
        reqs.append(eng.add_request(p, sp_cls(max_new_tokens=max_new, **kw)))
    eng.run(max_steps=4000)
    assert all(r.finished for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _buckets(eng, family):
    return {"prefill": eng.prefill_buckets, "decode": eng.decode_buckets,
            "burst": eng.burst_buckets, "ragged": eng.ragged_buckets}[family]


@pytest.fixture(scope="module")
def port_model():
    """The port's model on the JAX weights, converted once: the engines
    of every case share it (a step writes no module state)."""
    return _port_model(_jax_model())


@pytest.fixture(scope="module")
def jax_runs():
    """Every (family, workload) case through the JAX engine, each engine
    with its own model (tracing a step swaps the model's parameters for
    tracers): ``{case: (engine, tokens)}``."""
    out = {}
    for family, (fields, prompts, max_new, _) in FAMILIES.items():
        for workload, per_req in WORKLOADS.items():
            jax_eng = JaxEngineCore(_jax_model(), config=JaxEngineConfig(
                scheduler=JaxSchedulerConfig(max_num_seqs=4),
                **_engine_kw(fields)))
            out[(family, workload)] = (jax_eng, _run(
                jax_eng, JaxSamplingParams, prompts, max_new, per_req))
    return out


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_graphs_match_eager_and_jax(family, workload, jax_runs,
                                           port_model):
    fields, prompts, max_new, graphed = FAMILIES[family]
    per_req = WORKLOADS[workload]
    model = port_model
    sched = dict(max_num_seqs=4)
    jax_eng, want = jax_runs[(family, workload)]
    engines = [EngineCore(model, config=EngineConfig(
        scheduler=SchedulerConfig(**sched), **_engine_kw(fields)))
        for _ in range(2)]
    eng, eager = engines
    got = _run(eng, SamplingParams, prompts, max_new, per_req)
    with disable_graphs():
        got_eager = _run(eager, SamplingParams, prompts, max_new, per_req)
    assert got == got_eager == want

    assert not eager.graphs.programs
    assert all(getattr(eager, f"{f}_trace_count") == 0 for f in TRACED)
    snap = eng.metrics.registry.snapshot()
    for f in TRACED:
        count = getattr(eng, f"{f}_trace_count")
        n = len(_buckets(eng, f))
        assert _buckets(eng, f) == _buckets(jax_eng, f)
        assert (n > 0) == (f in graphed), f
        if workload == "mixed":
            assert n <= count <= 2 * n, f
        else:
            assert count == n == getattr(jax_eng, f"{f}_trace_count"), f
        assert eng.metrics.counters[f"{f}_jit_traces"] == count
        assert snap[f"serving_{f}_jit_traces_total"]["value"] == count
        keys = [k for k in eng.graphs.programs if k[0] in PROGRAMS[f]]
        assert len(keys) == count
        assert {k[:-1] for k in keys} == _buckets(eng, f)
    assert eng.graphs.captures == len(eng.graphs.programs)
    instants = [s for s in eng.tracer.spans() if s.cat == "jit"]
    assert len(instants) >= eng.graphs.captures
    assert eng.kv.occupancy() == 0.0


# --- the burst iteration through the cache ------------------------------------

_V = 17


def _toy_step(ids, pos, lens, sb, so, kp, vp):
    """``test_torch_legacy_serving._toy_step_torch``, writing its pools in
    place (as the engine's model does) so that it can be replayed."""
    kp[0][sb, so] = ids[:, 0].float() + 0.25 * pos.float()
    vp[0][sb, so] = ids[:, 0].float() * 2.0
    base = (ids[:, 0][:, None].float()
            * torch.arange(_V, dtype=torch.float32)[None, :] * 0.03
            + pos[:, None].float() * 0.011 + lens[:, None].float() * 0.007)
    acc = kp[0][sb, so][:, None] * 0.002
    return torch.sin(base + acc), kp, vp


def _burst_inputs(B, Nb, rng, eos=None, draw0=None):
    ids = rng.integers(1, _V, (B, 1))
    pos = rng.integers(2, 6, B).astype(np.int32)
    if B * Nb < 63:
        blocks = rng.choice(np.arange(1, 64), size=(B, Nb), replace=False)
    else:
        blocks = rng.integers(1, 64, (B, Nb))
    temps = np.zeros(B, np.float32)
    temps[::2] = 0.8
    draws = rng.integers(0, 9, B) if draw0 is None else np.full(B, draw0)
    keys = np.stack([np.full(B, 77, np.uint32), draws.astype(np.uint32)], 1)
    return dict(ids=ids.astype(np.int64), pos=pos, lens=pos + 1,
                active=np.ones(B, bool),
                eos=np.full(B, -1 if eos is None else eos, np.int32),
                blocks=blocks.astype(np.int64),
                offsets=rng.integers(0, 4, (B, Nb)).astype(np.int64),
                temps=temps, top_ks=np.full(B, 5, np.int32),
                top_ps=np.full(B, 0.9, np.float32), keys=keys)


def _oracle(a, n):
    t = graphs.host_tensor
    pools = [torch.zeros(64, 4)], [torch.zeros(64, 4)]
    buf, last, kp, vp = tburst.burst_oracle(
        _toy_step, n, _V, t(a["ids"]), t(a["pos"]), t(a["lens"]),
        t(a["active"]), t(a["eos"]), t(a["blocks"]), t(a["offsets"]),
        t(a["temps"]), t(a["top_ks"]), t(a["top_ps"]), t(a["keys"]), *pools)
    return buf, last, kp[0], vp[0]


def _cached_burst(cache, a, n, last, kp, vp):
    """One burst through the cache as the engine runs it: the state from
    the host, ``n`` calls of the iteration."""
    B, Nb = a["blocks"].shape

    def iteration(ids, pos, lens, act, buf, last_, j, blocks, offsets, eos,
                  temps, top_ks, top_ps, keys):
        tburst.burst_iteration(
            _toy_step, tburst.BurstState(ids, pos, lens, act, buf, last_, j),
            eos, blocks, offsets, temps, top_ks, top_ps, keys, [kp], [vp])
        return (buf,)

    (buf,) = cache.run(
        ("burst", B, Nb, True), iteration,
        [a["ids"], a["pos"], a["lens"], a["active"],
         np.full((B, Nb), -1, np.int32), last, np.zeros((1,), np.int64),
         a["blocks"], a["offsets"], a["eos"], a["temps"], a["top_ks"],
         a["top_ps"], a["keys"]], steps=n)
    return buf.clone()


def _eos_case(rng_seed):
    probe = _oracle(_burst_inputs(2, 8, np.random.default_rng(rng_seed)), 8)
    return dict(eos=int(probe[0][0, 1]))   # row 0's second emission


@pytest.mark.parametrize("B,Nb,extra", [
    (1, 2, {}), (2, 4, {}), (4, 8, {}),
    (2, 8, "eos"), (2, 8, dict(draw0=2**32 - 3)),
])
def test_burst_iteration_through_the_cache_matches_the_oracle(B, Nb, extra):
    seed = 100 * B + Nb
    if extra == "eos":
        extra = _eos_case(seed)
    cache = StepGraphs("cpu")
    last = torch.zeros(B, _V)
    kp, vp = torch.zeros(64, 4), torch.zeros(64, 4)
    for burst in range(2):   # the capture call, then a replayed burst
        a = _burst_inputs(B, Nb, np.random.default_rng(seed + burst),
                          **extra)
        for n in sorted({2, Nb}):
            kp.zero_()
            vp.zero_()
            got = _cached_burst(cache, a, n, last, kp, vp)
            buf, want_last, want_k, want_v = _oracle(a, n)
            np.testing.assert_array_equal(got.numpy(), buf.numpy())
            assert torch.equal(last, want_last)
            assert torch.equal(kp, want_k) and torch.equal(vp, want_v)
            assert (got.numpy()[:, n:] == -1).all()
            if burst == 0 and n == Nb and "eos" in extra:
                # row 0 emits its EOS at iteration 1 at the latest, then
                # stays masked
                row0 = got.numpy()[0]
                stop = int(np.argmax(row0 == extra["eos"]))
                assert row0[stop] == extra["eos"] and stop <= 1
                assert (row0[stop + 1:] == -1).all()
    assert cache.captures == 1 and len(cache.programs) == 1


# --- bookkeeping ----------------------------------------------------------------

def test_replay_adds_the_first_calls_counter_delta(monkeypatch):
    """The counters' change over a key's first run is added on every later
    call of that key, whatever the later run does to them itself (on the
    card a replay runs no Python); another key records its own."""
    for mod, names in graphs.COUNTERS:
        for name in names:
            monkeypatch.setattr(mod, name, 0)
    runs = []

    def fn(x):
        if not runs:        # the first run launches 2 + 1 kernels
            paged_decode.launches += 2
            paged_decode.mma_launches += 2
            ragged_paged.launches += 1
        runs.append(1)
        return (x * 2,)

    cache = StepGraphs("cpu")
    for i in range(4):
        (out,) = cache.run(("decode", 1, 1, False), fn, [np.full(3, i)])
        assert out.tolist() == [2 * i] * 3
    assert (paged_decode.launches, paged_decode.mma_launches,
            paged_decode.simple_launches) == (8, 8, 0)
    assert ragged_paged.launches == 4 and ragged_paged.tma_launches == 0
    assert cache.replays == 3 and cache.captures == 1 and len(runs) == 4
    cache.run(("decode", 2, 1, False), lambda x: (x,), [np.zeros(3)])
    assert paged_decode.launches == 8 and cache.captures == 2


def test_outputs_alias_and_inputs_are_checked():
    seen = []
    cache = StepGraphs("cpu", on_capture=seen.append)
    key = ("ragged", 4, 2, True)
    first = cache.run(key, lambda x: (x + 1,), [np.arange(4)])
    second = cache.run(key, lambda x: (x - 1,), [np.arange(4) * 10])
    # the first call's program serves the key; its output is overwritten
    assert first[0] is second[0] and second[0].tolist() == [1, 11, 21, 31]
    assert seen == [key]
    with pytest.raises(ValueError, match="static buffer"):
        cache.run(key, lambda x: (x,), [np.arange(5)])
    with pytest.raises(ValueError, match="static buffer"):
        cache.run(key, lambda x: (x,), [np.arange(4, dtype=np.int32)])
    with disable_graphs():
        assert graphs.graphs_enabled() is False
        (out,) = cache.run(key, lambda x: (x * 3,), [np.arange(4)])
        assert out.tolist() == [0, 3, 6, 9] and out is not first[0]
    assert graphs.graphs_enabled() and seen == [key]


def test_stale_static_inputs_change_the_tokens(monkeypatch, port_model):
    """The planted fault: replays whose static inputs were never refreshed
    rerun the first step's inputs, so the tokens must differ from the
    eager engine's — the identity check can fail."""
    model = port_model
    kw = dict(num_blocks=64, block_size=4,
              scheduler=SchedulerConfig(max_num_seqs=4))
    with disable_graphs():
        want = _run(EngineCore(model, config=EngineConfig(**kw)),
                    SamplingParams, PROMPTS[:3], 8, None)
    monkeypatch.setattr(StepGraphs, "_fill", lambda *a: None)
    got = _run(EngineCore(model, config=EngineConfig(**kw)), SamplingParams,
               PROMPTS[:3], 8, None)
    assert got != want
