"""The port's KV-cache observability (``observability/cachestat.py`` and
the pool's ``on_evict`` / ``on_revive`` hooks) held to the JAX package's
(``tests/test_zzz_cachestat.py``'s engine-level classes), on the CPU.

* **The pool contract** (``TestBlockPoolContract``): the port's
  ``BlockPool`` and the JAX one, driven by the same calls, clobber the
  deepest chain blocks first, report the same revive depths, LRU
  positions and lifetimes through ``on_revive``, and keep the exact
  ``free + reuse + allocated == num_blocks`` invariant under the same
  churn, with the same hook streams.
* **Unit** (``TestCacheStatUnit``): the timeline ring is bounded and a
  torn pool fails the sample, the heat table is bounded by decayed
  eviction, the attribution rows and the recent ring, a disabled tracker
  registers nothing — each against the JAX tracker on the same calls.
* **Engine** (``TestEngineIntegration``): on the unified churn run the
  port's engine with step graphs and under ``disable_graphs()`` records
  every telemetry view the JAX engine records (the pool timeline and the
  prefix-heat order among them); cache stats on vs off gives the same
  tokens and captures and gates the series; one pool sample per step with
  the invariant; attribution equal to the hit/miss counters; evictions
  event-driven with cause and depth; the per-step eviction-event budget.
"""

import numpy as np
import pytest

from paddle_tpu.observability import CacheStatTracker as JaxTracker
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.ops.paged_attention import BlockPool as JaxBlockPool
from paddle_tpu_torch.observability import CacheStatTracker, MetricsRegistry
from paddle_tpu_torch.ops.paged_attention import BlockPool
from paddle_tpu_torch.serving import SamplingParams
from paddle_tpu_torch.serving.engine import _EVICT_EVENTS_PER_STEP

import torch_obs_pairs as tp

POOLS = {"port": BlockPool, "jax": JaxBlockPool}


def _parked_chain(cls, num_blocks=8, bs=2, chain_blocks=3):
    """A pool whose reuse LRU holds one hashed chain of ``chain_blocks``
    blocks (depths 1..chain_blocks)."""
    pool = cls(num_blocks, bs, enable_prefix_cache=True)
    tokens = list(range(chain_blocks * bs))
    assert pool.allocate("a", len(tokens))
    pool._lens["a"] = len(tokens)
    pool.record_block_hashes("a", tokens)
    pool.free("a")
    assert len(pool._reuse) == chain_blocks
    return pool, tokens


def _churn(cls):
    """The JAX test's 300-step pool churn; returns the hook streams and
    the per-step (free, reuse, allocated) triples."""
    rng = np.random.default_rng(7)
    pool = cls(12, 2, enable_prefix_cache=True)
    evicted, revived, counts = [], [], []
    pool.on_evict = lambda *a: evicted.append(a)
    pool.on_revive = lambda *a: revived.append(a)
    prompts = [list(rng.integers(0, 64, 8)) for _ in range(4)]
    live = {}
    for step in range(300):
        pool.clock = step
        op = rng.integers(0, 4)
        sid = f"s{step}"
        if op == 0 and len(live) < 4:
            p = prompts[rng.integers(0, len(prompts))]
            cached = pool.fork_prefix(sid, p)
            need = len(p) - cached
            if need and not pool.allocate(sid, need, cause="prefill_chunk"):
                pool.free(sid)
            else:
                pool._lens[sid] = len(p)
                pool.record_block_hashes(sid, p)
                live[sid] = p
        elif op == 1 and live:
            victim = list(live)[rng.integers(0, len(live))]
            pool.free(victim)
            live.pop(victim)
        elif op == 2 and live:
            owner = list(live)[rng.integers(0, len(live))]
            if pool.allocate(owner, 1, cause="decode_slot"):
                pool._lens[owner] += 1
        elif op == 3 and live:
            victim = list(live)[rng.integers(0, len(live))]
            pool.free(victim)
            live.pop(victim)
        free, reuse = pool.num_free, len(pool._reuse)
        allocated = 1 + len(pool._ref)
        assert free + reuse + allocated == pool.num_blocks
        assert pool.num_available == free + reuse
        counts.append((free, reuse, allocated))
    assert pool.reuse_evictions > 0 and pool.reuse_hits > 0
    return evicted, revived, counts


class TestBlockPoolContract:
    @pytest.mark.parametrize("side", list(POOLS))
    def test_eviction_order_keeps_shortest_prefixes_longest(self, side):
        pool, _ = _parked_chain(POOLS[side])
        evicted = []
        pool.on_evict = lambda b, d, life, cause: evicted.append((d, cause))
        assert pool.allocate("b", 4 * pool.block_size)
        assert pool.num_free == 0
        assert pool.allocate("c", 3 * pool.block_size, cause="other")
        assert [d for d, _ in evicted] == [3, 2, 1]
        assert pool.reuse_evictions == 3

    @pytest.mark.parametrize("side", list(POOLS))
    def test_revive_depth_matches_hit_depth_report(self, side):
        pool, tokens = _parked_chain(POOLS[side])
        pool.clock = 5
        revives = []
        pool.on_revive = lambda b, d, lru, life: revives.append(
            (d, lru, life))
        assert pool.fork_prefix("w", tokens + [99]) == len(tokens)
        assert [(d, lru) for d, lru, _ in revives] == [
            (1, 2), (2, 1), (3, 0)]
        assert all(life == 5 for _, _, life in revives)
        assert pool.reuse_hits == 3 and not pool._reuse
        table = pool._tables["w"]
        assert [pool.block_chain_depth(b) for b in table] == [1, 2, 3]
        assert pool.block_chain_hash(table[-1]) is not None

    def test_pool_invariant_under_churn_same_hook_streams(self):
        port, jax = _churn(BlockPool), _churn(JaxBlockPool)
        assert port == jax
        assert port[0] and port[1]


def _unit_calls(cs):
    for i in range(10):
        cs.sample_pool(i + 1, promised=i)
    hot = b"H" * 32
    for step in range(6):
        cs.record_prefix_hit(hot, 2, 100, step)
    for i in range(5):
        cs.record_prefix_hit(bytes([i]) * 32, 1, 2, i)
    cs.record_admission("a", 8, 4, 12)
    cs.record_admission("a", 8, 10, 12, recompute=True)
    for rid in ("b", "c", "d"):
        cs.record_admission(rid, 0, 6, 6)
        cs.close_request(rid)
    cs.record_revive(0, 3)
    cs.record_revive(2, 1)
    cs.record_eviction(1, 4, "decode_slot")
    cs.record_eviction(2, 1, "burst")    # unknown cause -> "other"


class TestCacheStatUnit:
    def test_timeline_ring_bounded_and_invariant_checked(self):
        pool = BlockPool(8, 2, enable_prefix_cache=True)
        cs = CacheStatTracker(pool, registry=MetricsRegistry(),
                              timeline_len=4)
        for i in range(10):
            cs.sample_pool(i + 1, promised=i)
        tl = cs.timeline()
        assert [s["step"] for s in tl] == [7, 8, 9, 10]
        assert tl[-1]["free"] + tl[-1]["reuse"] + tl[-1]["allocated"] \
            == pool.num_blocks
        pool._ref[3] = 1  # block 3 is ALSO on the free list
        with pytest.raises(AssertionError, match="pool invariant"):
            cs.sample_pool(11)

    def test_heat_table_bounded_with_decayed_eviction(self):
        pool = BlockPool(8, 2, enable_prefix_cache=True)
        cs = CacheStatTracker(pool, heat_entries=3, heat_decay=0.5)
        hot = b"H" * 32
        for step in range(6):
            cs.record_prefix_hit(hot, 2, 100, step)
        for i in range(5):
            cs.record_prefix_hit(bytes([i]) * 32, 1, 2, i)
        assert len(cs._heat) <= 3
        table = cs.heat_table(step=10)
        assert table[0]["prefix"] == hot.hex()[:16]
        assert table[0]["hit_tokens"] == 600 and table[0]["hits"] == 6

    def test_attribution_rows_and_recent_ring(self):
        pool = BlockPool(8, 2, enable_prefix_cache=True)
        cs = CacheStatTracker(pool, recent_requests=2)
        cs.record_admission("a", 8, 4, 12)
        cs.record_admission("a", 8, 10, 12, recompute=True)
        for rid in ("b", "c", "d"):
            cs.record_admission(rid, 0, 6, 6)
            cs.close_request(rid)
        attr = cs.attribution()
        assert attr["cached_tokens_total"] == 16
        assert attr["computed_tokens_total"] == 32
        assert [r["id"] for r in attr["active"]] == ["a"]
        assert attr["active"][0]["recomputes"] == 1
        assert [r["id"] for r in attr["recent"]] == ["c", "d"]

    def test_disabled_registers_nothing(self):
        pool = BlockPool(8, 2, enable_prefix_cache=True)
        reg = MetricsRegistry()
        cs = CacheStatTracker(pool, registry=reg, enabled=False)
        _unit_calls(cs)
        assert reg.prometheus_text() == ""
        assert cs.timeline() == [] and cs.heat_table() == []

    def test_same_calls_same_snapshot_and_page_as_jax(self):
        regs = MetricsRegistry(), JaxRegistry()
        trackers = (
            CacheStatTracker(BlockPool(8, 2, enable_prefix_cache=True),
                             registry=regs[0], labels={"replica": "0"}),
            JaxTracker(JaxBlockPool(8, 2, enable_prefix_cache=True),
                       registry=regs[1], labels={"replica": "0"}))
        for cs in trackers:
            _unit_calls(cs)
        snaps = []
        for cs in trackers:
            s = cs.snapshot()
            s["timeline"] = [{k: v for k, v in r.items() if k != "t"}
                             for r in s["timeline"]]
            s.pop("pool")
            snaps.append(s)
        assert snaps[0] == snaps[1]
        assert regs[0].prometheus_text() == regs[1].prometheus_text()


@pytest.fixture(scope="module")
def unified():
    return tp.pair("unified")


class TestEngineIntegration:
    def test_telemetry_matches_jax_engine(self, unified):
        tp.assert_telemetry_matches(unified)
        jax = unified["jax"]
        assert jax.metrics.counters["preemptions"] > 0
        assert jax.kv.reuse_evictions > 0 and jax.cachestat.revives > 0
        for mode in ("graphs", "eager"):
            eng = unified[mode]
            assert eng.cachestat.eviction_report() == \
                jax.cachestat.eviction_report()
            assert eng.cachestat.hit_depth_distribution() == \
                jax.cachestat.hit_depth_distribution()

    def test_on_off_token_identical_equal_captures_and_series(self,
                                                              unified):
        on = unified["graphs"]
        off = tp.port_engine(unified["model"], "unified", cache_stats=False)
        assert tp.run(off, SamplingParams, tp.prompts()) == \
            unified["tokens"]["graphs"]
        assert off.ragged_trace_count == on.ragged_trace_count
        assert off.graphs.captures == on.graphs.captures
        text_on = on.metrics.prometheus_text()
        text_off = off.metrics.prometheus_text()
        for name in ("serving_pool_free_blocks", "serving_pool_reuse_blocks",
                     "serving_pool_allocated_blocks",
                     "serving_reuse_hit_depth",
                     "serving_block_lifetime_steps",
                     "serving_pool_evictions_total"):
            assert name in text_on and name not in text_off, name

    @pytest.mark.parametrize("mode", ["graphs", "eager"])
    def test_pool_sampled_every_step_with_invariant(self, unified, mode):
        eng = unified[mode]
        tl = eng.cachestat.timeline()
        assert len(tl) == min(eng.step_seq, 256)
        assert [s["step"] for s in tl] == \
            list(range(eng.step_seq - len(tl) + 1, eng.step_seq + 1))
        for s in tl:
            assert s["free"] + s["reuse"] + s["allocated"] == eng.num_blocks

    @pytest.mark.parametrize("mode", ["graphs", "eager"])
    def test_attribution_invariant_and_prefix_heat(self, unified, mode):
        eng = unified[mode]
        c = eng.metrics.counters
        attr = eng.cachestat.attribution()
        assert attr["cached_tokens_total"] == c["prefix_cache_hit_tokens"]
        assert attr["computed_tokens_total"] == c["prefix_cache_miss_tokens"]
        assert not attr["active"] and attr["recent"]
        top = eng.cachestat.heat_table()[0]
        assert top["depth"] == 2 and top["hit_tokens"] == top["hits"] * 8

    def test_evictions_event_driven_with_cause_and_depth(self, unified):
        eng = unified["graphs"]
        c = eng.metrics.counters
        assert c["prefix_cache_evictions"] == eng.kv.reuse_evictions > 0
        rep = eng.cachestat.eviction_report()
        assert rep["total"] == eng.kv.reuse_evictions
        assert set(rep["causes"]) == {"decode_slot", "prefill_chunk",
                                      "other"}
        assert eng.cachestat._hit_depth_h.count == eng.cachestat.revives > 0
        assert sum(eng.cachestat.hit_depth_distribution().values()) == \
            eng.cachestat.revives
        assert eng.hot_prefixes() == unified["jax"].hot_prefixes()

    def test_eviction_lifecycle_event_carries_cause_and_depth(self,
                                                              unified):
        seen = []
        eng = tp.port_engine(unified["model"], "legacy", audit=False)
        eng.lifecycle.add_listener(
            lambda rid, name, ts, tid, attrs:
            seen.append(dict(attrs, name=name))
            if name == "prefix_cache_eviction" else None)
        tp.run(eng, SamplingParams, tp.prompts(), max_new=6)
        assert len(seen) == eng.kv.reuse_evictions > 0
        for ev in seen:
            assert ev["cause"] in ("decode_slot", "prefill_chunk")
            assert ev["depth"] >= 1 and "lifetime_steps" in ev

    def test_eviction_event_burst_capped_per_step(self, unified):
        eng = tp.port_engine(unified["model"], "unified", audit=False,
                             num_blocks=16)
        seen = []
        eng.lifecycle.add_listener(
            lambda rid, name, ts, tid, attrs:
            seen.append(dict(attrs, name=name))
            if name.startswith("prefix_cache_eviction") else None)
        before = eng.metrics.counters["prefix_cache_evictions"]
        for _ in range(_EVICT_EVENTS_PER_STEP + 4):
            eng._on_pool_evict(3, depth=1, lifetime=2, cause="decode_slot")
        eng._flush_evict_burst()
        events = [e for e in seen if e["name"] == "prefix_cache_eviction"]
        bursts = [e for e in seen
                  if e["name"] == "prefix_cache_eviction_burst"]
        assert len(events) == _EVICT_EVENTS_PER_STEP
        assert len(bursts) == 1 and bursts[0]["suppressed"] == 4
        assert eng.metrics.counters["prefix_cache_evictions"] == \
            before + _EVICT_EVENTS_PER_STEP + 4
        assert eng._evict_events_step == 0
