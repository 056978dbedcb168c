"""The port's KV hand-off (``serving/handoff.py``, the block-transfer
methods of ``BlockPool``, ``EngineCore.export_kv_run`` /
``import_kv_run``), held to the JAX package (CPU, ``LlamaConfig.tiny`` at
2 layers, weights through ``convert.llama_from_paddle_tpu``).

* ``export_blocks`` / ``export_chain`` / ``import_blocks`` give the JAX
  pool's records and placements on the same operations; ``truncate``
  drops the chain hash of a block it frees.
* ``pool_meta`` equals the JAX engine's for the same config (fp32 and
  bf16), and a port run's header, block records and pages equal the JAX
  run's.
* A run exported by the JAX engine imports into a port engine whose step
  graphs are already captured, and its continuation equals the JAX decode
  replica's; the pools keep their storages (written in place), and a run
  whose pages were zeroed changes the continuation, so the captured step
  reads the imported pages.
* A corrupt digest or a mismatched header raises ``HandoffError`` and
  leaves the pool untouched; the wire frames equal the JAX ones and fail
  with the same typed errors.
* bf16 pages travel as raw 16-bit words and land bit for bit.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.paged_attention import BlockPool as JaxBlockPool
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu.serving import handoff as jax_handoff
from paddle_tpu.serving.kv_manager import KVCacheManager as JaxKVCacheManager
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.ops.paged_attention import BlockPool
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    HandoffError,
    KVCacheManager,
    SamplingParams,
    SchedulerConfig,
    handoff,
    wire,
)

BS = 4
LAYERS = 2
_RNG = np.random.default_rng(5)
PREFIX = _RNG.integers(0, 256, 8).tolist()
PROMPTS = [PREFIX + _RNG.integers(0, 256, 6).tolist() for _ in range(3)]
MAX_NEW = 8


def _greedy(cls):
    return cls(max_new_tokens=MAX_NEW, temperature=0.0)


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    return JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))


@pytest.fixture(scope="module")
def port_model(jax_model):
    state = {k: np.asarray(v) for k, v in jax_model.state_dict().items()}
    return llama_from_paddle_tpu(
        state, LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")


def _jax_engine(model, **kw):
    return JaxEngineCore(model, config=JaxEngineConfig(
        num_blocks=32, block_size=BS,
        scheduler=JaxSchedulerConfig(max_num_seqs=4), **kw))


def _port_engine(model, unified=True, dtype=None):
    return EngineCore(model, config=EngineConfig(
        num_blocks=32, block_size=BS, unified_step=unified, dtype=dtype,
        scheduler=SchedulerConfig(max_num_seqs=4, max_tokens_per_step=32)))


def _first_token(eng, cls, rid, prompt=PROMPTS[0]):
    req = eng.add_request(prompt, _greedy(cls), request_id=rid)
    while not req.output_tokens:
        eng.step()
    return req


@pytest.fixture(scope="module")
def jax_handoff_ref(jax_model):
    """The JAX package's hand-off: a donor's run at the first token, the
    decode replica's continuation after importing it, and the run's
    frames."""
    donor = _jax_engine(jax_model)
    req = _first_token(donor, JaxSamplingParams, "d0")
    run = donor.export_kv_run("d0")
    resume = [int(t) for t in req.output_tokens]
    recipient = _jax_engine(jax_model)
    assert recipient.import_kv_run(run) == len(run["blocks"])
    res = recipient.add_request(PROMPTS[0], _greedy(JaxSamplingParams),
                                request_id="res", resume_tokens=resume)
    recipient.run(max_steps=2000)
    return {"run": run, "resume": resume,
            "tokens": list(res.output_tokens),
            "frames": jax_handoff.run_to_frames(run)}


def _pool_state(kv):
    return (list(kv._free), dict(kv._reuse), dict(kv._ref),
            dict(kv._hash_index))


def _check_invariant(eng):
    kv = eng.kv
    assert len(kv._free) + len(kv._reuse) + len(kv._ref) + 1 \
        == kv.num_blocks


# --- BlockPool transfer methods ----------------------------------------------

def _pools_after(cls, ops):
    pool = cls(24, BS, enable_prefix_cache=True)
    for seq, toks in ops:
        pool.allocate(seq, len(toks))
        pool.record_block_hashes(seq, toks)
    return pool


OPS = [("a", PROMPTS[0]), ("b", PROMPTS[1]), ("c", list(range(20)))]


@pytest.mark.parametrize("seq", ["a", "b", "c"])
def test_export_blocks_and_chain_match_jax(seq):
    mine, ref = _pools_after(BlockPool, OPS), _pools_after(JaxBlockPool, OPS)
    hashes = [ref.block_chain_hash(b) for b in ref._tables[seq]
              if ref.block_chain_hash(b) is not None]
    assert hashes
    assert mine.export_blocks(hashes) == ref.export_blocks(hashes)
    assert mine.export_chain(hashes[-1]) == ref.export_chain(hashes[-1])
    assert mine.export_blocks(hashes + [b"\0" * 32]) is None
    assert mine.export_chain(b"\1" * 32) is None


@pytest.mark.parametrize("num_blocks", [24, 4])
def test_import_blocks_matches_jax(num_blocks):
    donor = _pools_after(JaxBlockPool, OPS)
    records = donor.export_chain(donor.block_chain_hash(donor._tables["c"][-1]))
    mine = BlockPool(num_blocks, BS, enable_prefix_cache=True)
    ref = JaxBlockPool(num_blocks, BS, enable_prefix_cache=True)
    placed_m, placed_r = mine.import_blocks(records), ref.import_blocks(records)
    assert placed_m == placed_r
    if placed_m is None:     # capacity refusal: nothing moved
        assert len(mine._free) == num_blocks - 1 and not mine._hash_index
        return
    assert mine.import_blocks(records) == ref.import_blocks(records) == {}
    assert mine.match_prefix(list(range(20)) + [1]) == \
        ref.match_prefix(list(range(20)) + [1])
    assert len(mine._free) + len(mine._reuse) == num_blocks - 1
    bad = copy.deepcopy(records)
    bad[1] = dict(bad[1], tokens=tuple(t + 1 for t in bad[1]["tokens"]))
    state = _pool_state(mine)
    with pytest.raises(ValueError, match="chain-hash"):
        mine.import_blocks(bad)
    assert _pool_state(mine) == state


def test_truncate_drops_the_hash_of_a_freed_block():
    states = []
    for cls in (KVCacheManager, JaxKVCacheManager):
        kv = cls(16, BS, enable_prefix_cache=True)
        toks = list(range(12))
        kv.allocate("s", 12)
        kv.commit("s", 12)
        kv.record_block_hashes("s", toks)
        tail = kv.table("s")[-1]
        assert kv.block_chain_hash(tail) is not None
        assert kv.truncate("s", 5) == 1
        assert kv.block_chain_hash(tail) is None
        assert tail not in kv._hash_index.values()
        states.append((kv.table("s"), kv.seq_len("s"), sorted(kv._free)))
    assert states[0] == states[1]


# --- runs against the JAX engine's ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_meta_matches_jax(jax_model, port_model, dtype):
    mine = _port_engine(port_model, dtype=getattr(torch, dtype))
    ref = _jax_engine(jax_model, dtype=getattr(jnp, dtype))
    assert handoff.pool_meta(mine) == jax_handoff.pool_meta(ref)
    assert handoff.pool_meta(mine)["dtype"] == dtype


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_port_run_matches_jax_run(port_model, jax_handoff_ref, unified):
    ref = jax_handoff_ref["run"]
    eng = _port_engine(port_model, unified=unified)
    req = _first_token(eng, SamplingParams, "d0")
    assert [int(t) for t in req.output_tokens] == jax_handoff_ref["resume"]
    run = eng.export_kv_run("d0")
    assert eng.kv.has("d0")                  # a pure read
    _check_invariant(eng)
    for key in ("version", "block_size", "layers", "kv_heads", "head_dim",
                "dtype", "tokens_total", "blocks"):
        assert run[key] == ref[key], key
    assert run["payload"].dtype == np.float32
    np.testing.assert_allclose(run["payload"], np.asarray(ref["payload"]),
                               rtol=1e-5, atol=1e-5)
    assert run["digest"] == handoff.payload_digest(run["payload"])


def test_prefix_chain_export_matches_jax(jax_model, port_model):
    """A hot prefix addressed by its deepest digest (the hot-prefix
    migration's entry point), cut to its leading blocks."""
    ref_eng = _jax_engine(jax_model)
    _first_token(ref_eng, JaxSamplingParams, "d0")
    eng = _port_engine(port_model)
    _first_token(eng, SamplingParams, "d0")
    deepest = eng.kv.block_chain_hash(eng.kv.table("d0")[2])
    assert deepest == ref_eng.kv.block_chain_hash(
        ref_eng.kv.table("d0")[2])
    for cap in (None, 2):
        run = eng.export_prefix_chain(deepest, max_blocks=cap)
        ref = ref_eng.export_prefix_chain(deepest, max_blocks=cap)
        assert run["blocks"] == ref["blocks"]
        assert len(run["blocks"]) == (cap or 3)
        np.testing.assert_allclose(run["payload"], np.asarray(ref["payload"]),
                                   rtol=1e-5, atol=1e-5)
    assert eng.export_prefix_chain(b"\1" * 32) is None


def _warm_engine(port_model, unified):
    eng = _port_engine(port_model, unified=unified)
    # a prompt sharing no block with PROMPTS[0]: every imported block is
    # fresh, so the continuation reads imported pages only
    eng.add_request(list(range(100, 114)), _greedy(SamplingParams),
                    request_id="warm")
    eng.run(max_steps=2000)
    assert eng.graphs.captures > 0
    return eng


def _continue(eng, resume, run):
    ptrs = [p.data_ptr() for p in eng._k_pools + eng._v_pools]
    placed = eng.import_kv_run(run)
    assert [p.data_ptr() for p in eng._k_pools + eng._v_pools] == ptrs
    _check_invariant(eng)
    res = eng.add_request(PROMPTS[0], _greedy(SamplingParams),
                          request_id="res", resume_tokens=resume)
    eng.run(max_steps=2000)
    return placed, list(res.output_tokens)


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_jax_run_continues_in_a_warm_port_engine(port_model, jax_handoff_ref,
                                                 unified):
    ref = jax_handoff_ref
    eng = _warm_engine(port_model, unified)
    placed, tokens = _continue(eng, ref["resume"], ref["run"])
    assert placed == len(ref["run"]["blocks"])
    assert tokens == ref["tokens"]
    # the imported prefix served from the cache
    rows = eng.cachestat.attribution()
    row = [r for r in rows["recent"] + rows["active"] if r["id"] == "res"]
    assert row and row[0]["cached_tokens"] >= len(ref["run"]["blocks"]) * BS
    assert eng.kv.occupancy() == 0.0


def test_the_captured_step_reads_the_imported_pages(port_model,
                                                    jax_handoff_ref):
    ref = jax_handoff_ref
    zeroed = copy.deepcopy(ref["run"])
    zeroed["payload"] = np.zeros_like(np.asarray(zeroed["payload"]))
    zeroed["digest"] = handoff.payload_digest(zeroed["payload"])
    _, tokens = _continue(_warm_engine(port_model, True), ref["resume"],
                          zeroed)
    assert tokens[:len(ref["resume"])] == ref["resume"]
    assert tokens != ref["tokens"]


def test_corrupt_or_mismatched_runs_are_refused(port_model, jax_handoff_ref):
    run = jax_handoff_ref["run"]
    eng = _port_engine(port_model)
    state = _pool_state(eng.kv)
    bad = copy.deepcopy(run)
    bad["payload"] = np.array(bad["payload"], copy=True)
    bad["payload"].reshape(-1)[0] += 1
    with pytest.raises(HandoffError, match="digest"):
        eng.import_kv_run(bad)
    for key, val in (("block_size", 8), ("layers", 99), ("kv_heads", 1),
                     ("head_dim", 3), ("dtype", "bfloat16"),
                     ("dtype", "float64"), ("version", 0)):
        bad = dict(run, **{key: val})
        with pytest.raises(HandoffError):
            eng.import_kv_run(bad)
    short = dict(run, payload=np.asarray(run["payload"])[:, :, :1])
    short["digest"] = handoff.payload_digest(short["payload"])
    with pytest.raises(HandoffError, match="shape"):
        eng.import_kv_run(short)
    lying = copy.deepcopy(run)
    lying["blocks"][0]["tokens"] = tuple(
        t + 1 for t in lying["blocks"][0]["tokens"])
    with pytest.raises(HandoffError, match="rejected by the pool"):
        eng.import_kv_run(lying)
    assert _pool_state(eng.kv) == state


def test_wire_frames_match_jax(jax_handoff_ref):
    run, ref_frames = jax_handoff_ref["run"], jax_handoff_ref["frames"]
    frames = handoff.run_to_frames(run)
    assert frames == ref_frames
    back = handoff.run_from_frames(frames[0], frames[1:])
    assert back["digest"] == run["digest"] and back["blocks"] == run["blocks"]
    np.testing.assert_array_equal(back["payload"], np.asarray(run["payload"]))
    with pytest.raises(wire.FrameError) as e:
        handoff.run_from_frames(frames[0], frames[1:-1])
    assert e.value.kind == "truncated"
    lying = copy.deepcopy(frames)
    lying[0]["meta"]["shape"] = [1, 2, 3]
    with pytest.raises(HandoffError):
        handoff.run_from_frames(lying[0], lying[1:])


def test_bf16_pages_travel_bit_exact(port_model):
    donor = _port_engine(port_model, dtype=torch.bfloat16)
    _first_token(donor, SamplingParams, "d0")
    run = donor.export_kv_run("d0")
    assert run["dtype"] == "bfloat16" and run["payload"].dtype == np.uint16
    frames = handoff.run_to_frames(run)
    back = handoff.run_from_frames(frames[0], frames[1:])
    recipient = _port_engine(port_model, dtype=torch.bfloat16)
    placed = recipient.import_kv_run(back)
    assert placed == len(run["blocks"])
    src = donor.kv.table("d0")[:len(run["blocks"])]
    dst = [recipient.kv._hash_index[r["hash"]] for r in run["blocks"]]
    for a, b in zip(donor._k_pools + donor._v_pools,
                    recipient._k_pools + recipient._v_pools):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a[src], b[dst])
