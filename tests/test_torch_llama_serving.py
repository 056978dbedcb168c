"""The PyTorch port's Llama and unified serving engine, held to the JAX
package on the same weights (CPU, fp32, ``LlamaConfig.tiny`` at 2 layers).

* ``convert.llama_from_paddle_tpu`` maps the JAX ``state_dict()`` onto the
  port exactly, and refuses a missing, extra or misshaped key.
* One packed ragged step (decode rows + a prefill chunk + pad tokens) gives
  the JAX model's logits within 2e-4 and writes the same K/V into the
  pools; the no-cache forward gives them within 1e-4.
* The port's engine gives greedy tokens identical to the JAX unified
  engine in the four scenarios of ``test_unified_ragged.py`` at mp=1 —
  plain stream, preemption recompute, warm prefix cache, chunked prefill —
  with the same bucket set, and ends with an empty pool.  Seeded sampled
  requests give identical streams as well.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.paged_attention import PagedCache as JaxPagedCache
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import LLM as JaxLLM
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.ops.paged_attention import PagedCache
from paddle_tpu_torch.serving import (
    LLM,
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
    stream_generate,
)

_RNG = np.random.default_rng(7)
PREFIX = _RNG.integers(0, 256, 8).tolist()
PROMPTS = [PREFIX + _RNG.integers(0, 256, 8).tolist() for _ in range(5)]
LAYERS = 2


def _jax_model():
    paddle.seed(0)
    return JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))


def _state(jax_model):
    return {k: np.asarray(v) for k, v in jax_model.state_dict().items()}


def _port_model(jax_model):
    return llama_from_paddle_tpu(
        _state(jax_model), LlamaConfig.tiny(num_hidden_layers=LAYERS),
        device="cpu")


# --- weights -----------------------------------------------------------------

def test_convert_round_trips_the_jax_weights():
    jm = _jax_model()
    state = _state(jm)
    model = _port_model(jm)
    params = dict(model.named_parameters())
    assert set(params) == set(state)
    for name, p in params.items():
        back = p.detach().numpy()
        if back.ndim == 2 and "embed_tokens" not in name:
            back = back.T             # linear: [out, in] -> [in, out]
        np.testing.assert_array_equal(back, state[name], err_msg=name)


def test_convert_refuses_mismatched_state():
    jm = _jax_model()
    cfg = LlamaConfig.tiny(num_hidden_layers=LAYERS)
    state = _state(jm)
    missing = dict(state)
    del missing["llama.norm.weight"]
    with pytest.raises(KeyError, match="llama.norm.weight"):
        llama_from_paddle_tpu(missing, cfg, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        llama_from_paddle_tpu({**state, "extra.weight": np.zeros(3)}, cfg,
                              device="cpu")
    bad = dict(state)
    bad["lm_head.weight"] = bad["lm_head.weight"][:, :-1]
    with pytest.raises(ValueError, match="lm_head.weight"):
        llama_from_paddle_tpu(bad, cfg, device="cpu")


# --- one packed ragged step --------------------------------------------------

def _packed_step_inputs(cfg, num_blocks=10, bs=4, seed=11):
    """A step packing two decode rows, one 5-token prefill chunk resuming at
    position 4, and 8 - 7 = 1 pad token, over pools that already hold each
    row's earlier KV."""
    rng = np.random.default_rng(seed)
    shape = (num_blocks, bs, cfg.num_key_value_heads, cfg.head_dim)
    pools = [rng.normal(size=shape).astype(np.float32)
             for _ in range(2 * cfg.num_hidden_layers)]
    Tb, TWb = 8, 4
    rows = [([1, 2, 3], 9, [8]), ([4, 5], 6, [5]),
            ([6, 7, 8], 9, [4, 5, 6, 7, 8])]
    ids = np.zeros((1, Tb), np.int64)
    pos = np.zeros((1, Tb), np.int32)
    seg = np.full((Tb,), len(rows), np.int32)
    tables = np.zeros((Tb, TWb), np.int32)
    lens = np.ones((Tb,), np.int32)
    slot_blocks = np.zeros((Tb,), np.int32)
    slot_offsets = np.zeros((Tb,), np.int32)
    cursor = 0
    for i, (pages, kv_len, positions) in enumerate(rows):
        n = len(positions)
        ids[0, cursor:cursor + n] = rng.integers(0, cfg.vocab_size, n)
        pos[0, cursor:cursor + n] = positions
        seg[cursor:cursor + n] = i
        tables[i, :len(pages)] = pages
        lens[i] = kv_len
        for j, p in enumerate(positions):
            slot_blocks[cursor + j] = pages[p // bs]
            slot_offsets[cursor + j] = p % bs
        cursor += n
    return pools, (ids, pos, seg, tables, lens, slot_blocks, slot_offsets)


def test_packed_ragged_step_matches_jax_logits():
    jm = _jax_model()
    model = _port_model(jm)
    cfg = model.config
    pools, (ids, pos, seg, tables, lens, sb, so) = _packed_step_inputs(cfg)
    L = cfg.num_hidden_layers

    jcaches = []
    for k, v in zip(pools[:L], pools[L:]):
        c = JaxPagedCache(Tensor(k), Tensor(v))
        c.route(tables, lens, sb, so, q_start=pos[0], seg_ids=seg)
        c.use_pallas = False
        jcaches.append(c)
    with paddle.no_grad():
        ref = np.asarray(jm(Tensor(ids), caches=jcaches,
                            pos=Tensor(pos))._value)

    tpools = [torch.from_numpy(p.copy()) for p in pools]
    caches = []
    for k, v in zip(tpools[:L], tpools[L:]):
        c = PagedCache(k, v)
        c.route(tables, lens, sb, so, q_start=pos[0], seg_ids=seg)
        caches.append(c)
    with torch.no_grad():
        out = model(torch.from_numpy(ids), caches=caches,
                    pos=torch.from_numpy(pos)).numpy()

    T_real = 7
    np.testing.assert_allclose(out[0, :T_real], ref[0, :T_real],
                               atol=2e-4, rtol=2e-4)
    assert np.isfinite(out).all()
    # the in-place scatter wrote what the JAX program's new pools hold
    # (block 0, the null page, takes the pad token's write in both)
    for tp, jc in zip(tpools, [c.k_pool for c in jcaches]
                      + [c.v_pool for c in jcaches]):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jc._value),
                                   atol=2e-4, rtol=2e-4)


def test_no_cache_forward_waits_for_the_training_slice():
    """The training slice has come: the no-cache forward (rope at 0..S-1,
    then ring_flash_attention) gives the JAX model's logits within 1e-4,
    in eval and in train mode."""
    jm = _jax_model()
    model = _port_model(jm)
    ids = np.random.default_rng(3).integers(0, 256, (2, 12))
    with paddle.no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids, dtype="int64")).numpy())
    for training in (False, True):
        model.train(training)
        with torch.no_grad():
            got = model(torch.from_numpy(ids)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# --- engine token identity ---------------------------------------------------

def _engines(num_blocks=64, block_size=4, max_num_seqs=4,
             prefill_budget=None, token_budget=None):
    sched = dict(max_num_seqs=max_num_seqs,
                 max_prefill_tokens_per_step=prefill_budget,
                 max_tokens_per_step=token_budget)
    jm = _jax_model()
    jax_eng = JaxEngineCore(jm, config=JaxEngineConfig(
        num_blocks=num_blocks, block_size=block_size,
        scheduler=JaxSchedulerConfig(**sched), unified_step=True))
    eng = EngineCore(_port_model(jm), config=EngineConfig(
        num_blocks=num_blocks, block_size=block_size,
        scheduler=SchedulerConfig(**sched), unified_step=True))
    return jax_eng, eng


def _run(eng, sampling_cls, prompts, max_new):
    reqs = [eng.add_request(p, sampling_cls(max_new_tokens=max_new))
            for p in prompts]
    eng.run(max_steps=4000)
    assert all(r.finished for r in reqs)
    return [list(r.output_tokens) for r in reqs]


def _check_engine(eng, jax_eng):
    assert eng.ragged_buckets == jax_eng.ragged_buckets
    assert eng.ragged_launches == eng.metrics.counters["unified_steps"] > 0
    assert eng.kv.occupancy() == 0.0
    assert not eng.requests and not eng.kv._ref
    assert eng.metrics.counters["engine_steps"] == \
        jax_eng.metrics.counters["engine_steps"]


def test_plain_stream_identical():
    jax_eng, eng = _engines()
    want = _run(jax_eng, JaxSamplingParams, PROMPTS, 6)
    assert _run(eng, SamplingParams, PROMPTS, 6) == want
    _check_engine(eng, jax_eng)


def test_preemption_recompute_identical():
    jax_eng, eng = _engines(num_blocks=12)
    want = _run(jax_eng, JaxSamplingParams, PROMPTS, 8)
    assert _run(eng, SamplingParams, PROMPTS, 8) == want
    assert eng.metrics.counters["preemptions"] > 0
    assert eng.metrics.counters["preemptions"] == \
        jax_eng.metrics.counters["preemptions"]
    _check_engine(eng, jax_eng)


def test_warm_prefix_cache_identical():
    jax_eng, eng = _engines()
    wave = [PREFIX + t for t in ([9, 2, 6], [5, 3, 5], [8, 9, 7])]
    outs = []
    for e, sp in ((jax_eng, JaxSamplingParams), (eng, SamplingParams)):
        outs.append(_run(e, sp, [PREFIX + [3, 1, 4, 1]], 4)
                    + _run(e, sp, wave, 6))
    assert outs[0] == outs[1]
    hits = eng.metrics.counters["prefix_cache_hit_tokens"]
    assert hits > 0
    assert hits == jax_eng.metrics.counters["prefix_cache_hit_tokens"]
    _check_engine(eng, jax_eng)


def test_chunked_prefill_identical():
    jax_eng, eng = _engines(prefill_budget=8, token_budget=8)
    want = _run(jax_eng, JaxSamplingParams, PROMPTS, 6)
    assert _run(eng, SamplingParams, PROMPTS, 6) == want
    assert max(tb for _, tb, _ in eng.ragged_buckets) <= 8
    _check_engine(eng, jax_eng)


def test_llm_generate_and_stream_match_jax():
    jm = _jax_model()
    cfg = dict(num_blocks=64, block_size=4, unified_step=True)
    want = [o.token_ids for o in JaxLLM(
        jm, config=JaxEngineConfig(**cfg)).generate(
            PROMPTS[:3], JaxSamplingParams(max_new_tokens=5))]
    llm = LLM(_port_model(jm), config=EngineConfig(**cfg))
    outs = llm.generate(PROMPTS[:3], SamplingParams(max_new_tokens=5))
    assert [o.token_ids for o in outs] == want
    assert {o.finish_reason for o in outs} == {"length"}
    streamed = list(stream_generate(llm.engine, PROMPTS[0],
                                    SamplingParams(max_new_tokens=5)))
    assert streamed == want[0]
    assert "unified_step" in llm.summary()
    names = {sp.name for sp in llm.engine.tracer.spans()}
    assert {"engine_step", "unified_step"} <= names


def test_seeded_sampling_identical():
    """Sampled rows draw from the (seed, output position) keyed noise in
    both packages, so seeded streams match too, including across a
    preemption recompute."""
    jax_eng, eng = _engines(num_blocks=12)
    params = dict(max_new_tokens=8, temperature=0.8, top_k=20, top_p=0.9)
    outs = []
    for e, sp in ((jax_eng, JaxSamplingParams), (eng, SamplingParams)):
        reqs = [e.add_request(p, sp(seed=100 + i, **params))
                for i, p in enumerate(PROMPTS)]
        e.run(max_steps=4000)
        outs.append([list(r.output_tokens) for r in reqs])
    assert outs[0] == outs[1]
    assert eng.metrics.counters["preemptions"] > 0
    counters = eng._sampling_counters
    assert counters["sampled"].value == 8 * len(PROMPTS)
    assert counters["greedy"].value == 0
