"""The PyTorch port's legacy serving path, held to the JAX package on the
same weights (CPU, fp32, ``LlamaConfig.tiny`` at 2 layers).

* **Model routes.**  The Llama forward on a dense ``(k_buf, v_buf)`` cache
  (prefill, then decode steps at a scalar position), on the paged decode
  route (``[B]`` slots and positions) and on the paged chunk route
  (``[B, S]`` slots, scalar and per-row chunk starts) gives the JAX model's
  logits within 2e-4 and writes the same K/V.  2e-4 is the tolerance of the
  packed-step test in ``test_torch_llama_serving.py``: fp32 everywhere, the
  two frameworks differ only in summation order.
* **generate** gives the JAX ``LlamaForCausalLM.generate`` tokens exactly,
  greedy and seeded sampled (both sample on the host from
  ``np.random.default_rng(seed)``).
* **The legacy engine** (``EngineCore(model, num_blocks=..., ...)``, the
  keyword form, on both sides) gives the JAX legacy engine's greedy and
  seeded-sampled tokens in every scenario — plain, preemption with
  recompute, warm prefix cache, chunked prefill under
  ``max_prefill_tokens_per_step``, ``LLM.generate``, ``stream_generate``,
  seeded sampling — with the same three bucket sets, step counts, round
  trips and planned-token ledger; free + reuse + allocated == num_blocks
  after every step.
* **Bursts.**  ``run_burst`` equals ``burst_oracle`` (and the JAX
  ``run_burst``) over the (rows x burst length) lattice of
  ``test_zzzzzzzzz_burst.py``, EOS included; the draw index wraps past
  2**32 - 1 as the JAX u32 does; the clamp, the eligibility gate and the
  pool headroom match the JAX unit cases; burst-on equals burst-off and
  the JAX burst engine with strictly fewer host round trips; no burst runs
  while prefill work is pending.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops import decode_burst as jburst
from paddle_tpu.ops.paged_attention import PagedCache as JaxPagedCache
from paddle_tpu.serving import LLM as JaxLLM
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu.serving import stream_generate as jax_stream_generate
from paddle_tpu.serving.kv_manager import KVCacheManager as JaxKVCacheManager
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.ops import decode_burst as tburst
from paddle_tpu_torch.ops import sampling as tsampling
from paddle_tpu_torch.ops.paged_attention import PagedCache
from paddle_tpu_torch.serving import (
    LLM,
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
    stream_generate,
)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving.burst import burst_eligible, clamp_burst
from paddle_tpu_torch.serving.kv_manager import KVCacheManager
from torch_jax_cache import jax_compile_cache  # noqa: F401

_RNG = np.random.default_rng(7)
PREFIX = _RNG.integers(0, 256, 8).tolist()
PROMPTS = [PREFIX + _RNG.integers(0, 256, 8).tolist() for _ in range(5)]
LAYERS = 2
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
TOL = 2e-4


def _jax_model():
    paddle.seed(0)
    return JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))


def _port_model(jax_model):
    state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    return llama_from_paddle_tpu(
        state, LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")


def _jax_logits(jm, ids, caches, pos):
    with paddle.no_grad():
        return np.asarray(jm(Tensor(jnp.asarray(ids)), caches=caches,
                             pos=Tensor(jnp.asarray(pos)))._value)


def _port_logits(model, ids, caches, pos):
    with torch.no_grad():
        return model(torch.from_numpy(np.asarray(ids, np.int64)),
                     caches=caches, pos=torch.as_tensor(pos)).numpy()


# --- the model's cached routes -------------------------------------------------

def _dense_steps(cfg):
    rng = np.random.default_rng(3)
    B, T0, M = 2, 6, 9
    steps = [(rng.integers(0, cfg.vocab_size, (B, T0)), 0),
             (rng.integers(0, cfg.vocab_size, (B, 1)), T0),
             (rng.integers(0, cfg.vocab_size, (B, 1)), T0 + 1)]
    return (B, M, cfg.num_key_value_heads, cfg.head_dim), T0, steps


def _jax_dense(jm):
    """The JAX side of the dense-cache test: each step's logits and the
    buffers after the last."""
    shape, _, steps = _dense_steps(jm.config)
    jcaches = [(Tensor(jnp.zeros(shape)), Tensor(jnp.zeros(shape)))
               for _ in range(LAYERS)]
    refs = [_jax_logits(jm, ids, jcaches, np.int32(pos))
            for ids, pos in steps]
    return refs, [(np.asarray(jk._value), np.asarray(jv._value))
                  for jk, jv in jcaches]


def test_dense_cache_prefill_then_decode_matches_jax(jax_runs, port_model):
    """A 6-token prefill then two decode steps at scalar positions over
    static [B, M] buffers: same logits, same buffers (written in place in
    the port, rebound in JAX)."""
    model = port_model
    shape, T0, steps = _dense_steps(model.config)
    refs, jbufs = jax_runs["dense"]
    caches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(LAYERS)]
    for (ids, pos), ref in zip(steps, refs):
        out = _port_logits(model, ids, caches, pos)
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    for (kb, vb), (jk, jv) in zip(caches, jbufs):
        np.testing.assert_allclose(kb.numpy(), jk, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(vb.numpy(), jv, atol=TOL, rtol=TOL)
    # nothing past the last written position was touched
    assert not caches[0][0][:, T0 + 2:].any()


def _pools(cfg, rng, num_blocks=12, bs=4):
    shape = (num_blocks, bs, cfg.num_key_value_heads, cfg.head_dim)
    return [rng.normal(size=shape).astype(np.float32)
            for _ in range(2 * LAYERS)]


def _routed(pools, cache_cls, wrap, route, use_pallas=None):
    caches = []
    for k, v in zip(pools[:LAYERS], pools[LAYERS:]):
        c = cache_cls(wrap(k), wrap(v))
        c.route(*route[:4], **route[4])
        if use_pallas is not None:
            c.use_pallas = use_pallas
        caches.append(c)
    return caches


def _compare_paged_step(ids, pos, route, real, skip_null_page=False):
    """One forward of both models over the same pools and routing: logits
    of the ``real`` rows (or tokens) and every pool agree."""
    jm = _jax_model()
    model = _port_model(jm)
    pools = _pools(model.config, np.random.default_rng(11))
    jcaches = _routed(pools, JaxPagedCache, Tensor, route, use_pallas=False)
    ref = _jax_logits(jm, ids, jcaches, pos)
    tpools = [torch.from_numpy(p.copy()) for p in pools]
    caches = _routed(tpools, PagedCache, lambda t: t, route)
    out = _port_logits(model, ids, caches, pos)
    np.testing.assert_allclose(out[real], ref[real], atol=TOL, rtol=TOL)
    assert np.isfinite(out).all()
    start = 1 if skip_null_page else 0
    for c, jc in zip(caches, jcaches):
        for ours, theirs in ((c.k_pool, jc.k_pool), (c.v_pool, jc.v_pool)):
            np.testing.assert_allclose(ours.numpy()[start:],
                                       np.asarray(theirs._value)[start:],
                                       atol=TOL, rtol=TOL)
    return out


def test_paged_decode_route_matches_jax():
    """Three decode rows at their own positions ([B] rope) plus a pad row
    (kv length 1 over an all-null table, writing the null page)."""
    bs = 4
    tables = np.array([[3, 7, 0], [5, 0, 0], [2, 9, 11], [0, 0, 0]], np.int32)
    pos = np.array([6, 2, 9, 0], np.int32)
    lens = np.array([7, 3, 10, 1], np.int32)
    slot_blocks = np.array([tables[i, p // bs] for i, p in enumerate(pos)],
                           np.int32)
    slot_offsets = (pos % bs).astype(np.int32)
    ids = np.random.default_rng(4).integers(0, 256, (4, 1))
    route = (tables, lens, slot_blocks, slot_offsets, {})
    out = _compare_paged_step(ids, pos, route, real=slice(0, 3))
    assert out.shape == (4, 1, LlamaConfig.tiny().vocab_size)


@pytest.mark.parametrize("per_row_start", [False, True])
def test_paged_chunk_route_matches_jax(per_row_start):
    """A 4-token chunk per row resuming after a cached prefix — with a
    scalar start (the engine's chunk family) or per-row starts — where the
    second row's chunk ends in two pad tokens that write the null page."""
    bs, S = 4, 4
    tables = np.array([[3, 7, 1, 0], [5, 9, 2, 11]], np.int32)
    starts = np.array([5, 3], np.int32) if per_row_start else \
        np.array([5, 5], np.int32)
    real_n = np.array([4, 2])
    slot_blocks = np.zeros((2, S), np.int32)
    slot_offsets = np.zeros((2, S), np.int32)
    for i in range(2):
        for j in range(real_n[i]):
            p = starts[i] + j
            slot_blocks[i, j] = tables[i, p // bs]
            slot_offsets[i, j] = p % bs
    lens = (starts + real_n).astype(np.int32)
    q_start = starts if per_row_start else np.int32(5)
    ids = np.random.default_rng(8).integers(0, 256, (2, S))
    route = (tables, lens, slot_blocks, slot_offsets, {"q_start": q_start})
    real = (np.array([0, 0, 0, 0, 1, 1]), np.array([0, 1, 2, 3, 0, 1]))
    _compare_paged_step(ids, q_start, route, real=real, skip_null_page=True)


@pytest.mark.parametrize("sampling", [
    dict(temperature=0.0),
    dict(temperature=0.8, top_k=20, top_p=0.9, seed=5),
])
def test_generate_matches_jax(sampling):
    jm = _jax_model()
    model = _port_model(jm)
    ids = np.random.default_rng(2).integers(0, 256, (2, 5))
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=6,
                       **sampling).numpy()
    got = model.generate(torch.from_numpy(ids), max_new_tokens=6, **sampling)
    assert got.dtype == torch.int64 and got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_stops_when_every_row_emitted_eos():
    jm = _jax_model()
    model = _port_model(jm)
    ids = np.random.default_rng(2).integers(0, 256, (1, 5))
    greedy = model.generate(torch.from_numpy(ids), max_new_tokens=6,
                            temperature=0.0).numpy()
    eos = int(greedy[0, 7])   # the third new token
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=6,
                       temperature=0.0, eos_token_id=eos).numpy()
    got = model.generate(torch.from_numpy(ids), max_new_tokens=6,
                         temperature=0.0, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (1, 8)


# --- the legacy engine against the JAX legacy engine ---------------------------

def _pool_invariant(kv):
    allocated = 1 + len(kv._ref)   # + the reserved null page
    assert len(kv._free) + len(kv._reuse) + allocated == kv.num_blocks


def _drive(eng, max_steps=4000):
    """Run ``eng`` to the end, checking the pool invariant after every
    step."""
    for _ in range(max_steps):
        if not eng.scheduler.has_work():
            return
        eng.step()
        _pool_invariant(eng.kv)
    raise AssertionError(f"engine did not drain within {max_steps} steps")


def _submit(eng, sp_cls, prompts, max_new, per_req=None, seed0=None):
    reqs = []
    for i, p in enumerate(prompts):
        kw = dict(per_req[i]) if per_req else {}
        if seed0 is not None and kw.get("temperature"):
            kw.setdefault("seed", seed0 + i)
        reqs.append(eng.add_request(p, sp_cls(max_new_tokens=max_new, **kw)))
    return reqs


def _run_jax(jax_eng, prompts, max_new, per_req=None, seed0=100):
    """The requests through the JAX engine: their tokens."""
    reqs = _submit(jax_eng, JaxSamplingParams, prompts, max_new, per_req,
                   seed0)
    jax_eng.run(max_steps=4000)
    assert all(r.finished for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _run_port(eng, prompts, max_new, per_req=None, seed0=100):
    """The same requests through the port's engine, the pool invariant
    checked after every step: their tokens."""
    reqs = _submit(eng, SamplingParams, prompts, max_new, per_req, seed0)
    _drive(eng)
    assert all(r.finished for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _engine(core, config_cls, sched_cls, model, num_blocks=64, block_size=4,
            max_num_seqs=4, prefill_budget=None, burst=0):
    """One package's legacy engine.  Without bursts it is built by
    keyword, the JAX package's default serving form; ``burst_steps``
    exists only on EngineConfig, so a burst engine takes a config."""
    sched = sched_cls(max_num_seqs=max_num_seqs,
                      max_prefill_tokens_per_step=prefill_budget)
    if not burst:
        return core(model, num_blocks=num_blocks, block_size=block_size,
                    scheduler_config=sched)
    return core(model, config=config_cls(
        scheduler=sched, num_blocks=num_blocks, block_size=block_size,
        burst_steps=burst))


def _jax_engine(jm, **kw):
    return _engine(JaxEngineCore, JaxEngineConfig, JaxSchedulerConfig, jm,
                   **kw)


def _port_engine(model, **kw):
    eng = _engine(EngineCore, EngineConfig, SchedulerConfig, model, **kw)
    assert not eng.engine_config.unified_step and not eng._unified
    return eng


def _roundtrips(eng):
    return int(eng._burst_counters["roundtrips"].value)


def _bursts(eng):
    return int(eng._burst_counters["launches"].value)


def _check_legacy(eng, jax_eng):
    assert eng.decode_buckets == jax_eng.decode_buckets
    assert eng.prefill_buckets == jax_eng.prefill_buckets
    assert eng.burst_buckets == jax_eng.burst_buckets
    assert not eng.ragged_buckets and eng.ragged_launches == 0
    for name in ("engine_steps", "chunked_prefill_steps", "preemptions",
                 "prefix_cache_hit_tokens"):
        assert eng.metrics.counters[name] == jax_eng.metrics.counters[name], \
            name
    assert _roundtrips(eng) == _roundtrips(jax_eng)
    assert _bursts(eng) == _bursts(jax_eng)
    assert eng.scheduler.tokens_planned == jax_eng.scheduler.tokens_planned
    assert eng.kv.occupancy() == 0.0
    assert not eng.requests and not eng.kv._ref
    assert list(eng.kv._free) == list(jax_eng.kv._free)
    assert list(eng.kv._reuse) == list(jax_eng.kv._reuse)


MIXED = [{}, SAMPLED, dict(SAMPLED, seed=42), {}, dict(SAMPLED, top_k=0)]
SCENARIOS = {
    # name: (engine keywords, prompts, max_new, per-request sampling)
    "plain": ({}, PROMPTS, 6, None),
    "preemption": (dict(num_blocks=12), PROMPTS, 8, None),
    "chunked": (dict(prefill_budget=8), PROMPTS, 6, None),
    "sampled": (dict(num_blocks=12), PROMPTS, 8, [SAMPLED] * 5),
    "mixed": ({}, PROMPTS, 10, MIXED),
}


BURST_SCENARIOS = {
    # name: (engine keywords, prompts, max_new, per-request sampling)
    "greedy": ({}, PROMPTS[:3], 12, None),
    "sampled": ({}, PROMPTS[:3], 12, [SAMPLED] * 3),
    "mixed": ({}, PROMPTS[:3], 12, MIXED[:3]),
    "preemption": (dict(num_blocks=12), PROMPTS, 8, [SAMPLED] * 5),
    "chunked": (dict(prefill_budget=8), PROMPTS, 10, None),
}


TENSORS_ONLY = [PROMPTS[0][:9], PROMPTS[1][:13], PROMPTS[2][:16]]
WARM_FIRST = [PREFIX + [3, 1, 4, 1]]
WARM_WAVE = [PREFIX + t for t in ([9, 2, 6], [5, 3, 5], [8, 9, 7])]
LLM_KW = dict(num_blocks=32, block_size=4, max_num_seqs=2)


def _legacy_view(eng):
    """What ``_check_legacy`` reads of an engine, frozen now."""
    from types import SimpleNamespace as NS

    return NS(decode_buckets=set(eng.decode_buckets),
              prefill_buckets=set(eng.prefill_buckets),
              burst_buckets=set(eng.burst_buckets),
              metrics=NS(counters=dict(eng.metrics.counters)),
              _burst_counters={k: NS(value=eng._burst_counters[k].value)
                               for k in ("roundtrips", "launches")},
              scheduler=NS(tokens_planned=eng.scheduler.tokens_planned),
              kv=NS(_free=list(eng.kv._free), _reuse=list(eng.kv._reuse)))


def _jax_llm(jm):
    """The LLM test's JAX side: the default form's and the keyword form's
    outputs, the keyword engine as ``_check_legacy`` reads it after its
    generate, and the tokens it then streams."""
    default = [o.token_ids for o in JaxLLM(jm).generate(
        PROMPTS[:3], JaxSamplingParams(max_new_tokens=5))]
    jax_llm = JaxLLM(jm, **LLM_KW)
    outs = [o.token_ids for o in jax_llm.generate(
        PROMPTS, JaxSamplingParams(max_new_tokens=5))]
    view = _legacy_view(jax_llm.engine)
    streamed = list(jax_stream_generate(jax_llm.engine, PROMPTS[1],
                                        JaxSamplingParams(max_new_tokens=5)))
    return default, outs, view, streamed


def _jax_case(jm, case):
    """One case of the JAX side, on a model ``jm`` of its own."""
    kind = case[0]
    if kind == "legacy":
        kw, prompts, max_new, per_req = SCENARIOS[case[1]]
        eng = _jax_engine(jm, **kw)
        return eng, _run_jax(eng, prompts, max_new, per_req)
    if kind == "burst":
        kw, prompts, max_new, per_req = BURST_SCENARIOS[case[1]]
        eng = _jax_engine(jm, burst=8, **kw)
        return eng, _run_jax(eng, prompts, max_new, per_req)
    if kind == "tensors_only":
        eng = _jax_engine(jm)
        return eng, _run_jax(eng, TENSORS_ONLY, 4)
    if kind == "warm_prefix":
        eng = _jax_engine(jm)
        return eng, (_run_jax(eng, WARM_FIRST, 4),
                     _run_jax(eng, WARM_WAVE, 6))
    if kind == "bursts_warm":
        eng = _jax_engine(jm, burst=8)
        first = _submit(eng, JaxSamplingParams, WARM_FIRST, 4)
        eng.run(max_steps=4000)
        second = _submit(eng, JaxSamplingParams, WARM_WAVE, 8)
        eng.run(max_steps=4000)
        return eng, [list(r.output_tokens) for r in first + second]
    if kind == "llm":
        return _jax_llm(jm)
    return _jax_dense(jm)


@pytest.fixture(scope="module")
def port_model():
    """The port's model on the JAX weights, converted once: the engines
    of every case share it (a step writes no module state)."""
    return _port_model(_jax_model())


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX side of every engine case, of the dense-cache route and of
    the LLM forms, each case on a model of its own (tracing a step swaps
    the model's parameters for tracers)."""
    cases = ([("legacy", n) for n in SCENARIOS]
             + [("burst", n) for n in BURST_SCENARIOS]
             + [("tensors_only",), ("warm_prefix",), ("bursts_warm",),
                ("llm",), ("dense",)])
    return {case if len(case) > 1 else case[0]:
            _jax_case(_jax_model(), case) for case in cases}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_legacy_engine_matches_jax(scenario, jax_runs, port_model):
    kw, prompts, max_new, per_req = SCENARIOS[scenario]
    jax_eng, want = jax_runs[("legacy", scenario)]
    eng = _port_engine(port_model, **kw)
    got = _run_port(eng, prompts, max_new, per_req)
    assert got == want
    _check_legacy(eng, jax_eng)
    counters = eng.metrics.counters
    if scenario in ("preemption", "sampled"):
        assert counters["preemptions"] > 0
        assert counters["recompute_prefills"] > 0
    if scenario == "chunked":
        assert counters["chunked_prefill_steps"] > 0
        assert max(b[1] for b in eng.prefill_buckets) <= 8
    if scenario == "plain":
        assert ("prefill", 16) in eng.prefill_buckets
        assert {k for k, *_ in eng.decode_buckets} == {"decode"}
    # the prefill families are step programs: one capture a (bucket,
    # any_sampled) key, where the JAX engine traces once a bucket
    n = len(eng.prefill_buckets)
    if scenario == "mixed":
        assert n <= eng.prefill_trace_count <= 2 * n
    else:
        assert eng.prefill_trace_count == n == jax_eng.prefill_trace_count
    assert eng.metrics.counters["prefill_jit_traces"] == \
        eng.prefill_trace_count


def test_prefill_step_programs_take_tensors_only(jax_runs, port_model):
    """Each prefill key's inputs are tensors (positions 0-d, never Python
    ints read on the host, which a replay would repeat): ``last_pos`` and
    the chunk's ``start`` are device data.  Two prompts of different
    lengths in one one-shot bucket give the JAX engine's tokens."""
    _, want = jax_runs["tensors_only"]
    eng = _port_engine(port_model)
    got = _run_port(eng, TENSORS_ONLY, 4)
    assert got == want
    assert ("prefill", 16) in eng.prefill_buckets
    keys = [k for k in eng.graphs.programs if k[0] in ("prefill", "chunk")]
    assert keys
    for key in keys:
        prog = eng.graphs.programs[key]
        assert all(isinstance(a, torch.Tensor) for a in prog.inputs), key
        names = engine_mod._PROGRAM_INPUTS[key[0]]
        for name in ("start", "last_pos"):
            if name in names:
                t = prog.inputs[names.index(name)]
                assert t.dim() == 0 and t.dtype == torch.int32, (key, name)
    # the families take exactly their inputs, and no Python int
    for fn, program in ((eng._prefill_fn, "prefill"),
                        (eng._chunk_prefill_fn, "chunk")):
        params = [p for p in inspect.signature(fn).parameters
                  if p != "any_sampled"]
        assert len(params) == len(engine_mod._PROGRAM_INPUTS[program]) + 4
        assert all(isinstance(a, np.ndarray)
                   for a in eng.program_inputs(program, (8,) if
                                               program == "prefill"
                                               else (8, 2)))


def test_legacy_engine_warm_prefix_matches_jax(jax_runs, port_model):
    """A second wave forks the first request's cached prefix: the chunk
    family resumes past the hit, with the JAX engine's tokens and hits."""
    jax_eng, (jfirst, jsecond) = jax_runs["warm_prefix"]
    eng = _port_engine(port_model)
    first = _run_port(eng, WARM_FIRST, 4)
    second = _run_port(eng, WARM_WAVE, 6)
    assert first == jfirst and second == jsecond
    assert eng.metrics.counters["prefix_cache_hit_tokens"] > 0
    assert any(b[0] == "chunk" for b in eng.prefill_buckets)
    _check_legacy(eng, jax_eng)


def test_llm_default_form_and_stream_match_jax(jax_runs, port_model):
    """``LLM(model)`` and ``LLM(model, num_blocks=..., ...)`` build the
    legacy engine, as the JAX package's do, and serve the same tokens;
    ``stream_generate`` on the same engine streams them too."""
    model = port_model
    jdefault, jouts, jview, jstreamed = jax_runs["llm"]
    default = LLM(model)
    eng = default.engine
    assert (eng.num_blocks, eng.block_size) == (256, 16)
    assert eng._pool_dtype == torch.float32 and not eng._unified
    assert eng.scheduler.config.max_num_seqs == 8
    assert [o.token_ids for o in default.generate(
        PROMPTS[:3], SamplingParams(max_new_tokens=5))] == jdefault

    llm = LLM(model, **LLM_KW)
    outs = llm.generate(PROMPTS, SamplingParams(max_new_tokens=5))
    assert [o.token_ids for o in outs] == jouts
    assert {o.finish_reason for o in outs} == {"length"}
    _check_legacy(llm.engine, jview)
    streamed = list(stream_generate(llm.engine, PROMPTS[1],
                                    SamplingParams(max_new_tokens=5)))
    assert streamed == jstreamed
    assert "decode_step" in llm.summary()
    names = {sp.name for sp in llm.engine.tracer.spans()}
    assert {"engine_step", "prefill_step", "decode_step"} <= names


def test_llm_keeps_the_config_form(port_model):
    """``LLM(model, config=...)`` goes through ``**engine_kw``; the config
    wins over the keywords, as in the JAX package."""
    llm = LLM(port_model, num_blocks=256, config=EngineConfig(
        num_blocks=24, block_size=4, unified_step=True))
    assert llm.engine.num_blocks == 24 and llm.engine._unified
    outs = llm.generate(PROMPTS[:2], SamplingParams(max_new_tokens=3))
    assert llm.engine.ragged_launches > 0
    assert all(len(o.token_ids) == 3 for o in outs)


# --- bursts: the device loop ---------------------------------------------------

_V = 17


def _toy_step_torch(ids, pos, lens, sb, so, kp, vp):
    """The port of ``test_zzzzzzzzz_burst._toy_model_step``: writes the
    input token's 'KV' into the routed slot and emits logits that depend on
    token, position, length and the written cell."""
    k, v = kp[0].clone(), vp[0].clone()
    k[sb, so] = ids[:, 0].float() + 0.25 * pos.float()
    v[sb, so] = ids[:, 0].float() * 2.0
    base = (ids[:, 0][:, None].float()
            * torch.arange(_V, dtype=torch.float32)[None, :] * 0.03
            + pos[:, None].float() * 0.011 + lens[:, None].float() * 0.007)
    acc = k[sb, so][:, None] * 0.002
    return torch.sin(base + acc), [k], [v]


def _toy_step_jax(ids, pos, lens, sb, so, kp, vp):
    k = kp[0].at[sb, so].set(ids[:, 0].astype(jnp.float32) + 0.25
                             * pos.astype(jnp.float32))
    v = vp[0].at[sb, so].set(ids[:, 0].astype(jnp.float32) * 2.0)
    base = (ids[:, 0][:, None].astype(jnp.float32)
            * jnp.arange(_V, dtype=jnp.float32)[None, :] * 0.03
            + pos[:, None].astype(jnp.float32) * 0.011
            + lens[:, None].astype(jnp.float32) * 0.007)
    acc = k[sb, so][:, None] * 0.002
    return jnp.sin(base + acc).astype(jnp.float32), [k], [v]


def _burst_arrays(B, Nb, rng, sampled_rows=(), eos=None, draw0=None):
    """``test_zzzzzzzzz_burst._burst_args`` as numpy: every row active,
    slots routed into a [64, 4] pool, greedy and sampled rows mixed."""
    ids = rng.integers(1, _V, (B, 1))
    pos = rng.integers(2, 6, B)
    if B * Nb < 63:
        blocks = rng.choice(np.arange(1, 64), size=(B, Nb), replace=False)
    else:
        blocks = rng.integers(1, 64, (B, Nb))
    offsets = rng.integers(0, 4, (B, Nb))
    temps = np.zeros(B, np.float32)
    temps[list(sampled_rows)] = 0.8
    draws = rng.integers(0, 9, B) if draw0 is None else np.full(B, draw0)
    keys = np.stack([np.full(B, 77, np.uint32), draws.astype(np.uint32)], 1)
    return dict(ids=ids, pos=pos, lens=pos + 1, active=np.ones(B, bool),
                eos=np.full(B, -1 if eos is None else eos),
                blocks=blocks, offsets=offsets, temps=temps,
                top_ks=np.full(B, 5), top_ps=np.full(B, 0.9, np.float32),
                keys=keys)


def _torch_args(a):
    t = torch.from_numpy
    return (t(a["ids"]).long(), t(a["pos"]).int(), t(a["lens"]).int(),
            t(a["active"]), t(a["eos"]).int(), t(a["blocks"]).long(),
            t(a["offsets"]).long(), t(a["temps"]), t(a["top_ks"]).int(),
            t(a["top_ps"]), t(a["keys"].astype(np.int64)),
            [torch.zeros(64, 4)], [torch.zeros(64, 4)])


def _jax_args(a):
    i32 = jnp.int32
    return (jnp.asarray(a["ids"], i32), jnp.asarray(a["pos"], i32),
            jnp.asarray(a["lens"], i32), jnp.asarray(a["active"]),
            jnp.asarray(a["eos"], i32), jnp.asarray(a["blocks"], i32),
            jnp.asarray(a["offsets"], i32), jnp.asarray(a["temps"]),
            jnp.asarray(a["top_ks"], i32), jnp.asarray(a["top_ps"]),
            jnp.asarray(a["keys"]), [jnp.zeros((64, 4), jnp.float32)],
            [jnp.zeros((64, 4), jnp.float32)])


def _check_burst(fast, slow, what):
    np.testing.assert_array_equal(fast[0].numpy(), slow[0].numpy(),
                                  err_msg=f"{what}: tokens")
    np.testing.assert_array_equal(fast[2][0].numpy(), slow[2][0].numpy(),
                                  err_msg=f"{what}: k_pool")
    np.testing.assert_array_equal(fast[3][0].numpy(), slow[3][0].numpy(),
                                  err_msg=f"{what}: v_pool")
    np.testing.assert_array_equal(fast[1].numpy(), slow[1].numpy(),
                                  err_msg=f"{what}: last logits")


def _check_against_jax(ours, theirs, what):
    """Tokens exactly; the pools outside the null page (where inactive rows'
    duplicate writes land) exactly; the last logits within 1e-6 (each
    framework's float32 sin)."""
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]),
                                  err_msg=f"{what}: tokens vs JAX")
    for i in (2, 3):
        np.testing.assert_array_equal(ours[i][0].numpy()[1:],
                                      np.asarray(theirs[i][0])[1:],
                                      err_msg=f"{what}: pool vs JAX")
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(theirs[1]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B,Nb", [(1, 2), (2, 4), (4, 8)])
def test_run_burst_matches_oracle_over_the_lattice(B, Nb):
    rng = np.random.default_rng(100 * B + Nb)
    a = _burst_arrays(B, Nb, rng, sampled_rows=range(0, B, 2))
    for n in sorted({2, Nb}):
        fast = tburst.run_burst(_toy_step_torch, n, _V, *_torch_args(a))
        slow = tburst.burst_oracle(_toy_step_torch, n, _V, *_torch_args(a))
        _check_burst(fast, slow, f"B={B} Nb={Nb} n={n}")
        theirs = jburst.burst_oracle(_toy_step_jax, n, _V, *_jax_args(a))
        _check_against_jax(fast, theirs, f"B={B} Nb={Nb} n={n}")
        assert (fast[0].numpy()[:, n:] == -1).all()


def test_run_burst_greedy_shortcut_equals_the_sampler():
    """With every row greedy the engine skips the sampler's sort
    (``any_sampled=False``): the same tokens."""
    a = _burst_arrays(4, 8, np.random.default_rng(5))
    fast = tburst.run_burst(_toy_step_torch, 8, _V, *_torch_args(a),
                            any_sampled=False)
    slow = tburst.burst_oracle(_toy_step_torch, 8, _V, *_torch_args(a))
    _check_burst(fast, slow, "greedy shortcut")


def test_run_burst_eos_emits_then_masks():
    """A row that samples its EOS emits it, then its remaining lanes stay
    -1 and it writes only the null page."""
    probe = tburst.burst_oracle(
        _toy_step_torch, 8, _V,
        *_torch_args(_burst_arrays(2, 8, np.random.default_rng(9))))
    tok1 = int(probe[0][0, 1])   # row 0's second emission
    a = _burst_arrays(2, 8, np.random.default_rng(9), eos=tok1)
    fast = tburst.run_burst(_toy_step_torch, 8, _V, *_torch_args(a))
    slow = tburst.burst_oracle(_toy_step_torch, 8, _V, *_torch_args(a))
    _check_burst(fast, slow, "eos")
    _check_against_jax(fast, jax.jit(
        lambda *x: jburst.run_burst(_toy_step_jax, *x),
        static_argnums=(1,))(jnp.int32(8), _V, *_jax_args(a)), "eos")
    row0 = fast[0].numpy()[0]
    stop = int(np.argmax(row0 == tok1))
    assert stop <= 1 and (row0[stop + 1:] == -1).all()


def test_draw_index_wraps_past_2_32():
    """Sampled rows whose first draw index is 2**32 - 3: iteration j draws
    with key (seed, (draw0 + j) mod 2**32), as the JAX u32 key does — the
    int64 key column runs past 2**32 and the sampler masks it back."""
    draw0 = 2**32 - 3
    a = _burst_arrays(2, 8, np.random.default_rng(13), sampled_rows=(0, 1),
                      draw0=draw0)
    keys = torch.from_numpy(a["keys"].astype(np.int64))
    for j in range(6):
        stepped = tburst._step_keys(keys, j)
        assert torch.equal(stepped[:, 0], keys[:, 0])
        wrapped = torch.tensor([[77, (draw0 + j) % 2**32]] * 2)
        assert torch.equal(tsampling._hash_bits(stepped, _V),
                           tsampling._hash_bits(wrapped, _V))
    fast = tburst.run_burst(_toy_step_torch, 6, _V, *_torch_args(a))
    slow = tburst.burst_oracle(_toy_step_torch, 6, _V, *_torch_args(a))
    _check_burst(fast, slow, "wrapped draws")
    theirs = jburst.burst_oracle(_toy_step_jax, 6, _V, *_jax_args(a))
    _check_against_jax(fast, theirs, "wrapped draws")
    # the noise was used: the greedy twin of the same burst differs
    greedy = tburst.run_burst(
        _toy_step_torch, 6, _V,
        *_torch_args(dict(a, temps=np.zeros(2, np.float32))))
    assert not torch.equal(greedy[0], fast[0])


# --- bursts: the host half -----------------------------------------------------

def test_burst_capacity_matches_jax():
    for ours, theirs in ((KVCacheManager(16, 4), JaxKVCacheManager(16, 4)),):
        for rows in (1, 3, 0, -2):
            assert ours.burst_capacity(rows) == theirs.burst_capacity(rows)
        assert ours.burst_capacity(1) == 15 * 4 + 1
        assert ours.burst_capacity(3) == 5 * 4 + 1


def test_truncate_matches_jax():
    """A burst's pre-allocated tail handed back: the same blocks freed,
    tables, lengths and free lists as the JAX manager's."""
    kvs = [KVCacheManager(16, 4), JaxKVCacheManager(16, 4)]
    for kv in kvs:
        assert kv.allocate("a", 5) and kv.allocate("b", 3)
        kv.commit("a", 5)
        kv.commit("b", 3)
        assert kv.allocate("a", 8)          # a burst's 8 slots
        kv.commit("a", 3)                   # 3 emitted
    freed = [kv.truncate("a", 8) for kv in kvs]
    assert freed[0] == freed[1] == 2
    for kv in kvs:
        with pytest.raises(ValueError, match="extends past"):
            kv.truncate("a", 9)
    ours, theirs = kvs
    assert ours.table("a") == theirs.table("a")
    assert ours.seq_len("a") == theirs.seq_len("a") == 8
    assert list(ours._free) == list(theirs._free)
    _pool_invariant(ours)


class _Req:
    def __init__(self, max_new, emitted):
        from types import SimpleNamespace
        self.sampling = SimpleNamespace(max_new_tokens=max_new)
        self.output_tokens = [0] * emitted


def test_clamp_is_min_of_three():
    rows = [_Req(16, 4), _Req(16, 10)]   # remaining: 12, 6
    assert clamp_burst(8, rows, 100) == 6
    assert clamp_burst(4, rows, 100) == 4
    assert clamp_burst(8, rows, 3) == 3
    assert clamp_burst(8, rows, 1) == 0      # < 2: not worth it
    assert clamp_burst(1, rows, 100) == 0    # config below threshold
    assert clamp_burst(8, [], 100) == 0


def test_eligibility_gates():
    from types import SimpleNamespace
    sched = SimpleNamespace(waiting=[], running=[],
                            _needs_prefill=lambda r: False)
    plan = SimpleNamespace(prefills=[])
    rows = [object()]
    assert burst_eligible(sched, plan, rows, None)
    assert not burst_eligible(sched, plan, rows, object())   # spec on
    assert not burst_eligible(sched, plan, [], None)         # no rows
    assert not burst_eligible(
        sched, SimpleNamespace(prefills=[object()]), rows, None)
    sched.waiting = [object()]
    assert not burst_eligible(sched, plan, rows, None)
    sched.waiting = []
    sched.running = [object()]
    sched._needs_prefill = lambda r: True    # deferred chunk pending
    assert not burst_eligible(sched, plan, rows, None)


def test_scheduler_plan_carries_the_capacity(port_model):
    eng = EngineCore(port_model, num_blocks=16, block_size=4,
                     scheduler_config=SchedulerConfig(max_num_seqs=2))
    eng.add_request(PROMPTS[0][:6], SamplingParams(max_new_tokens=2))
    eng.step()   # prefill
    plan = eng.scheduler.schedule()
    assert plan.decodes
    assert plan.burst_capacity == eng.kv.burst_capacity(len(plan.decodes))
    assert plan.burst_capacity >= 2


# --- bursts: the engine --------------------------------------------------------

@pytest.mark.parametrize("scenario", list(BURST_SCENARIOS))
def test_bursts_match_burst_off_and_jax(scenario, jax_runs, port_model):
    """Burst-on gives the burst-off tokens and the JAX burst engine's, with
    strictly fewer host round trips and the same ledger as JAX."""
    kw, prompts, max_new, per_req = BURST_SCENARIOS[scenario]
    jax_eng, want = jax_runs[("burst", scenario)]
    eng = _port_engine(port_model, burst=8, **kw)
    got = _run_port(eng, prompts, max_new, per_req)
    assert got == want
    _check_legacy(eng, jax_eng)
    off = _port_engine(port_model, **kw)
    reqs = _submit(off, SamplingParams, prompts, max_new, per_req, 100)
    _drive(off)
    assert [list(r.output_tokens) for r in reqs] == got
    assert _bursts(eng) > 0 and not off.burst_buckets
    assert _roundtrips(eng) < _roundtrips(off)
    burst_tokens = int(eng._burst_counters["tokens"].value)
    assert 0 < burst_tokens <= sum(map(len, got))
    if scenario == "preemption":
        assert eng.metrics.counters["preemptions"] > 0


def test_bursts_warm_prefix_match_burst_off_and_jax(jax_runs, port_model):
    jax_eng, want = jax_runs["bursts_warm"]
    eng = _port_engine(port_model, burst=8)
    off = _port_engine(port_model)
    outs = []
    for e in (eng, off):
        first = _submit(e, SamplingParams, WARM_FIRST, 4)
        _drive(e)
        second = _submit(e, SamplingParams, WARM_WAVE, 8)
        _drive(e)
        outs.append([list(r.output_tokens) for r in first + second])
        assert e.metrics.counters["prefix_cache_hit_tokens"] > 0
    assert outs[0] == outs[1] == want
    assert _bursts(eng) > 0
    assert _roundtrips(eng) < _roundtrips(off)
    _check_legacy(eng, jax_eng)


def test_unified_engine_bursts_too(port_model):
    """Bursts work with ``unified_step`` True as well: the same tokens as
    the burst-off unified engine, fewer round trips."""
    outs, trips = [], []
    for burst in (0, 8):
        eng = EngineCore(port_model, config=EngineConfig(
            num_blocks=64, block_size=4, unified_step=True, burst_steps=burst,
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_tokens_per_step=16)))
        reqs = _submit(eng, SamplingParams, PROMPTS[:3], 12, MIXED[:3], 100)
        _drive(eng)
        outs.append([list(r.output_tokens) for r in reqs])
        trips.append(_roundtrips(eng))
        assert (_bursts(eng) > 0) == bool(burst)
    assert outs[0] == outs[1]
    assert trips[1] < trips[0]


def test_never_bursts_with_prefill_pending(port_model):
    """Every burst launches on a step with no prefill work: nothing
    waiting, no deferred chunk, no chunk in the plan."""
    eng = _port_engine(port_model, burst=8, max_num_seqs=4,
                       prefill_budget=8)
    seen = []
    launch = eng._burst_exec

    def checked(reqs, n):
        sched = eng.scheduler
        seen.append((len(sched.waiting),
                     any(sched._needs_prefill(r) for r in sched.running)))
        return launch(reqs, n)

    eng._burst_exec = checked
    r1 = eng.add_request(PROMPTS[0], SamplingParams(max_new_tokens=60))
    for _ in range(6):
        eng.step()
    assert not r1.finished and _bursts(eng) > 0
    before = _bursts(eng)
    # a waiting admission pins the engine to per-step until it is resident
    r2 = eng.add_request(PROMPTS[1], SamplingParams(max_new_tokens=8))
    eng.step()
    assert _bursts(eng) == before
    _drive(eng)
    assert r1.finished and r2.finished
    assert seen and all(w == 0 and not pending for w, pending in seen)
