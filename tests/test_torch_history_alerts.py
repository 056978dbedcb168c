"""The port's metrics history and alerting (``observability/history.py``,
``alerts.py``, the registry's collect hooks and the SLO pair) held to the
JAX package's (``tests/test_zzzz_history_alerts.py``'s engine-level
classes), on the CPU.

* ``TestHistoryStore``, ``TestCollectHooks``, ``TestSloPairAtomicity`` and
  ``TestAlertEngine``: the JAX classes' cases, run on the port's modules
  (bounded rings, the series cap, counter resets clamped, histogram-derived
  series, cadence, listeners, collect hooks, the SLO pair read and sampled
  consistently, threshold / rate / burn-rate rules with pending, firing,
  resolved, cooldown, warm-up and no-data, deterministic replay, the rule
  set's JSON round trip and the default rules) — plus the same value
  script through the JAX store and engine giving the same transitions and
  the same sampled windows.
* ``TestHistoryOnOffIdentity``: history and alerting on vs off gives the
  same tokens and the same captures on the port's engines (legacy, bursts,
  unified; with graphs and under ``disable_graphs()``), each step samples
  once, the off registry has no ``serving_history_*`` /
  ``serving_alerts_*`` series, and a gated-off engine ignores
  ``set_history``.
"""

import threading

import pytest

from paddle_tpu.observability import AlertEngine as JaxAlertEngine
from paddle_tpu.observability import AlertRule as JaxAlertRule
from paddle_tpu.observability import AlertRuleSet as JaxAlertRuleSet
from paddle_tpu.observability import HistoryConfig as JaxHistoryConfig
from paddle_tpu.observability import HistoryStore as JaxHistoryStore
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.observability import (
    AlertEngine,
    AlertRule,
    AlertRuleSet,
    HistoryConfig,
    HistoryStore,
    MetricsRegistry,
    default_rule_set,
)
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
)
from paddle_tpu_torch.serving.graphs import disable_graphs
from paddle_tpu_torch.serving.metrics import ServingMetrics

import torch_obs_pairs as tp


class TestHistoryStore:
    def test_ring_boundedness_under_churn(self):
        reg = MetricsRegistry()
        c = reg.counter("serving_churn_total", "t")
        g = reg.gauge("serving_churn_gauge", "t")
        hist = HistoryStore(reg, HistoryConfig(ring_len=8, max_series=64))
        for i in range(100):
            c.inc()
            g.set(i)
            hist.sample(step=i)
        for key in hist.keys():
            assert len(hist.window(key)) <= 8, key
        assert hist.stats()["samples"] == 100
        # the ring holds the LAST 8: the newest value is the live one
        assert hist.latest("serving_churn_gauge") == 99.0

    def test_max_series_cap_drops_and_counts(self):
        reg = MetricsRegistry()
        hist = HistoryStore(reg, HistoryConfig(ring_len=4, max_series=5))
        for i in range(12):
            reg.gauge("serving_cap_gauge", "t", idx=str(i)).set(i)
        hist.sample()
        st = hist.stats()
        assert st["series"] == 5                       # hard cap held
        assert st["dropped_series"] >= 7               # rest counted
        dropped = reg.counter("serving_history_series_dropped_total",
                              "x").value
        assert dropped == st["dropped_series"]
        # re-sampling the same dropped keys does not re-count them
        hist.sample()
        assert reg.counter("serving_history_series_dropped_total",
                           "x").value == dropped

    def test_counter_reset_clamps_to_zero(self):
        """A replica rebuild restarts an engine-local counter at zero
        : the windowed increase must clamp the
        negative delta, never report a negative rate."""
        reg = MetricsRegistry()
        c = reg.counter("serving_reset_total", "t")
        hist = HistoryStore(reg, HistoryConfig(ring_len=16))
        for _ in range(4):
            c.inc(5)
            hist.sample()
        assert hist.increase("serving_reset_total", 3) == 15.0
        c._value = 0.0          # the rebuild: counter restarts at zero
        hist.sample()
        # 3 deltas in window: +5, +5, clamp(-15 -> 0)
        assert hist.increase("serving_reset_total", 3) == 10.0
        c.inc(2)
        hist.sample()
        # +5, clamp(0), +2 — accumulation resumes after the reset
        assert hist.increase("serving_reset_total", 3) == 7.0
        # full window: 3 pre-reset deltas (the first sample is the
        # baseline, not a delta) + clamped reset + the post-reset +2
        assert hist.increase("serving_reset_total", 100) == 17.0

    def test_histogram_derives_count_and_sum_series(self):
        reg = MetricsRegistry()
        h = reg.histogram("serving_lat_seconds", "t")
        hist = HistoryStore(reg, HistoryConfig())
        h.observe(0.5)
        h.observe(1.5)
        hist.sample()
        assert hist.latest("serving_lat_seconds:count") == 2.0
        assert hist.latest("serving_lat_seconds:sum") == 2.0
        assert hist.match("serving_lat_seconds_count") == \
            ["serving_lat_seconds:count"]
        assert hist.kind("serving_lat_seconds:count") == "counter"

    def test_name_aggregation_across_label_sets(self):
        reg = MetricsRegistry()
        a = reg.counter("serving_multi_total", "t", replica="0")
        b = reg.counter("serving_multi_total", "t", replica="1")
        hist = HistoryStore(reg, HistoryConfig())
        hist.sample()
        a.inc(3)
        b.inc(4)
        hist.sample()
        assert sorted(hist.match("serving_multi_total")) == [
            'serving_multi_total{replica="0"}',
            'serving_multi_total{replica="1"}']
        assert hist.name_increase("serving_multi_total", 1) == 7.0
        assert hist.name_latest_sum("serving_multi_total") == 7.0

    def test_on_step_cadence(self):
        reg = MetricsRegistry()
        reg.gauge("serving_cad_gauge", "t").set(1)
        hist = HistoryStore(reg, HistoryConfig(sample_every_steps=4))
        taken = [hist.on_step(s) for s in range(1, 13)]
        assert sum(1 for t in taken if t is not None) == 3
        assert hist.stats()["ticks"] == 12

    def test_listener_cap_and_removal(self):
        reg = MetricsRegistry()
        hist = HistoryStore(reg, HistoryConfig())
        seen = []
        remove = hist.add_listener(lambda i, s: seen.append((i, s)))
        hist.sample(step=7)
        assert seen == [(1, 7)]
        remove()
        remove()                      # idempotent
        hist.sample(step=8)
        assert len(seen) == 1
        removers = [hist.add_listener(lambda i, s: None)
                    for _ in range(8 - len(hist._listeners))]
        with pytest.raises(RuntimeError, match="listeners"):
            hist.add_listener(lambda i, s: None)
        for r in removers:
            r()

    def test_broken_listener_is_swallowed_with_report(self, capsys):
        # listeners run on the sampling ENGINE thread — a broken
        # evaluator must be reported, never kill the replica
        reg = MetricsRegistry()
        hist = HistoryStore(reg, HistoryConfig())
        seen = []

        def boom(i, s):
            raise RuntimeError("evaluator bug")

        hist.add_listener(boom)
        hist.add_listener(lambda i, s: seen.append(i))
        idx = hist.sample(step=1)     # must not raise
        assert idx == 1 and seen == [1]
        assert "sample listener failed" in capsys.readouterr().err

    def test_collect_hooks_run_before_sampling(self):
        reg = MetricsRegistry()
        g = reg.gauge("serving_derived_gauge", "t")
        state = {"v": 0}
        reg.add_collect_hook(lambda: g.set(state["v"]))
        hist = HistoryStore(reg, HistoryConfig())
        state["v"] = 42
        hist.sample()
        assert hist.latest("serving_derived_gauge") == 42.0

    def test_config_validation(self):
        with pytest.raises(ValueError):
            HistoryConfig(sample_every_steps=0)
        with pytest.raises(ValueError):
            HistoryConfig(ring_len=1)
        with pytest.raises(ValueError):
            HistoryConfig(max_series=0)


# --------------------------------------------------------------------------
# Collect hooks + SLO pair atomicity
# --------------------------------------------------------------------------
class TestCollectHooks:
    def test_hooks_run_on_render_and_snapshot(self):
        reg = MetricsRegistry()
        calls = []
        remove = reg.add_collect_hook(lambda: calls.append(1))
        reg.prometheus_text()
        reg.snapshot()
        assert len(calls) == 2
        remove()
        reg.prometheus_text()
        assert len(calls) == 2

    def test_broken_hook_is_swallowed_with_report(self, capsys):
        reg = MetricsRegistry()
        g = reg.gauge("serving_hooked_gauge", "t")

        def boom():
            raise RuntimeError("collector exploded")

        reg.add_collect_hook(boom)
        reg.add_collect_hook(lambda: g.set(5))
        text = reg.prometheus_text()          # must not raise
        assert "serving_hooked_gauge 5" in text
        assert "collect hook failed" in capsys.readouterr().err

    def test_hook_cap_refuses_leak(self):
        reg = MetricsRegistry()
        for _ in range(16):
            reg.add_collect_hook(lambda: None)
        with pytest.raises(RuntimeError, match="collect"):
            reg.add_collect_hook(lambda: None)

    def test_hook_may_render_without_recursion(self):
        reg = MetricsRegistry()
        depth = []

        def hook():
            depth.append(1)
            reg.snapshot()                    # re-entrant render

        reg.add_collect_hook(hook)
        reg.prometheus_text()
        assert len(depth) == 1                # guard stopped recursion


class TestSloPairAtomicity:
    def test_sampler_never_sees_good_above_total(self):
        """Writers hammer observe_finish (all meeting their SLO — the
        worst case: every total inc is immediately followed by a good
        inc) while a reader snapshots; good > total in any snapshot is
        the bug the atomic pair prevents."""
        reg = MetricsRegistry()
        sm = ServingMetrics(registry=reg)
        stop = threading.Event()

        def writer():
            while not stop.is_set():
                sm.observe_finish(0.001, slo_ms=60_000.0)

        threads = [threading.Thread(target=writer) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            for _ in range(3000):
                good, total = sm.slo_counts()
                assert good <= total, (good, total)
        finally:
            stop.set()
            for t in threads:
                t.join()

    def test_history_samples_keep_pair_consistent(self):
        reg = MetricsRegistry()
        sm = ServingMetrics(registry=reg)
        hist = HistoryStore(reg, HistoryConfig(ring_len=512))
        stop = threading.Event()

        def writer():
            while not stop.is_set():
                sm.observe_finish(0.001, slo_ms=60_000.0)

        threads = [threading.Thread(target=writer) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            for _ in range(300):
                hist.sample()
        finally:
            stop.set()
            for t in threads:
                t.join()
        goods = hist.window("serving_slo_good_total")
        totals = hist.window("serving_slo_total")
        assert len(goods) == len(totals)
        for g, t in zip(goods, totals):
            assert g["i"] == t["i"]
            assert g["v"] <= t["v"], (g, t)


# --------------------------------------------------------------------------
# AlertEngine semantics (no engines — driven registries)
# --------------------------------------------------------------------------
def _threshold_rules(**kw):
    defaults = dict(name="pool", kind="threshold",
                    series="serving_pool_free_blocks", op="lt",
                    threshold=2.0, for_samples=2, cooldown=4)
    defaults.update(kw)
    return AlertRuleSet(rules=(AlertRule(**defaults),))


class TestAlertEngine:
    def test_threshold_pending_firing_resolved(self):
        reg = MetricsRegistry()
        free = reg.gauge("serving_pool_free_blocks", "t")
        hist = HistoryStore(reg, HistoryConfig())
        eng = AlertEngine(hist, rules=_threshold_rules(), registry=reg)
        free.set(10)
        hist.sample()
        assert eng.state("pool")["state"] == "inactive"
        free.set(0)
        hist.sample()                         # breach 1 -> pending
        assert eng.state("pool")["state"] == "pending"
        hist.sample()                         # breach 2 -> firing
        st = eng.state("pool")
        assert st["state"] == "firing"
        assert reg.gauge("serving_alerts_firing", "x",
                         rule="pool").value == 1
        free.set(10)
        hist.sample()                         # clean -> resolved
        st = eng.state("pool")
        assert st["state"] == "inactive"
        assert [t["state"] for t in st["transitions"]] == \
            ["pending", "firing", "resolved"]
        assert reg.gauge("serving_alerts_firing", "x",
                         rule="pool").value == 0
        snap = reg.snapshot()
        assert snap[
            'serving_alert_transitions_total{rule="pool",'
            'state="firing"}']["value"] == 1

    def test_pending_that_clears_is_not_an_incident(self):
        reg = MetricsRegistry()
        free = reg.gauge("serving_pool_free_blocks", "t")
        hist = HistoryStore(reg, HistoryConfig())
        eng = AlertEngine(hist, rules=_threshold_rules(), registry=reg)
        free.set(0)
        hist.sample()                         # pending
        free.set(10)
        hist.sample()                         # clears silently
        st = eng.state("pool")
        assert st["state"] == "inactive"
        # pending counted; firing/resolved never happened
        states = [t["state"] for t in st["transitions"]]
        assert states == ["pending"]

    def test_cooldown_gates_repending(self):
        reg = MetricsRegistry()
        free = reg.gauge("serving_pool_free_blocks", "t")
        hist = HistoryStore(reg, HistoryConfig())
        eng = AlertEngine(hist,
                          rules=_threshold_rules(for_samples=1,
                                                 cooldown=5),
                          registry=reg)
        free.set(0)
        hist.sample()                         # pending+firing
        free.set(10)
        hist.sample()                         # resolved, cooldown starts
        free.set(0)
        for _ in range(4):
            hist.sample()                     # inside cooldown: quiet
        assert eng.state("pool")["state"] == "inactive"
        for _ in range(3):
            hist.sample()                     # past cooldown: refires
        assert eng.state("pool")["state"] == "firing"

    def test_rate_rule_window_delta(self):
        reg = MetricsRegistry()
        c = reg.counter("serving_replica_restarts_total", "t",
                        cause="engine_death")
        hist = HistoryStore(reg, HistoryConfig())
        rules = AlertRuleSet(rules=(AlertRule(
            name="churn", kind="rate",
            series="serving_replica_restarts_total",
            window=4, threshold=1.0, for_samples=1, cooldown=0),))
        eng = AlertEngine(hist, rules=rules, registry=reg)
        for _ in range(3):
            hist.sample()
        assert eng.state("churn")["state"] == "inactive"
        c.inc()                               # the restart
        hist.sample()
        assert eng.state("churn")["state"] == "firing"
        for _ in range(5):                    # window slides past it
            hist.sample()
        st = eng.state("churn")
        assert st["state"] == "inactive"
        assert [t["state"] for t in st["transitions"]] == \
            ["pending", "firing", "resolved"]

    def test_burn_rate_requires_both_windows(self):
        reg = MetricsRegistry()
        good = reg.counter("serving_slo_good_total", "t")
        total = reg.counter("serving_slo_total", "t")
        hist = HistoryStore(reg, HistoryConfig())
        rules = AlertRuleSet(rules=(AlertRule(
            name="burn", kind="burn_rate", objective=0.9,
            threshold=2.0, fast_window=3, slow_window=9,
            for_samples=1, cooldown=0),))
        eng = AlertEngine(hist, rules=rules, registry=reg)
        # a long healthy run fills the slow window with good traffic
        for _ in range(10):
            good.inc()
            total.inc()
            hist.sample()
        # bad traffic starts: the FAST window burns immediately, but
        # the slow window still remembers the good era -> no fire yet
        total.inc()
        hist.sample()
        assert eng.state("burn")["state"] == "inactive", \
            "fast-only burn must not fire (page-vs-ticket split)"
        for _ in range(8):                    # sustained badness
            total.inc()
            hist.sample()
        assert eng.state("burn")["state"] == "firing"
        # recovery: good traffic drains the fast window first
        for _ in range(5):
            good.inc()
            total.inc()
            hist.sample()
        st = eng.state("burn")
        assert st["state"] == "inactive"
        assert [t["state"] for t in st["transitions"]] == \
            ["pending", "firing", "resolved"]

    def test_burn_rate_cold_start_cannot_page(self):
        # two samples after a restart, a "slow" window computed over
        # the only deltas available is the fast window relabeled — the
        # first SLO misses of a warmup must NOT page
        reg = MetricsRegistry()
        good = reg.counter("serving_slo_good_total", "t")
        total = reg.counter("serving_slo_total", "t")
        hist = HistoryStore(reg, HistoryConfig())
        rules = AlertRuleSet(rules=(AlertRule(
            name="burn", kind="burn_rate", objective=0.9,
            threshold=2.0, fast_window=3, slow_window=9,
            for_samples=1, cooldown=0),))
        eng = AlertEngine(hist, rules=rules, registry=reg)
        for _ in range(4):                    # all misses, short history
            total.inc()
            hist.sample()
        assert eng.state("burn")["state"] == "inactive", \
            "burn fired before the slow window was covered"
        for _ in range(6):                    # sustained misses fill it
            total.inc()
            hist.sample()
        assert eng.state("burn")["state"] == "firing"
        assert good.value == 0                # pure-miss stream

    def test_warmup_samples_grace(self):
        reg = MetricsRegistry()
        c = reg.counter("serving_compiles_total", "t")
        hist = HistoryStore(reg, HistoryConfig())
        rules = AlertRuleSet(rules=(AlertRule(
            name="storm", kind="rate", series="serving_compiles_total",
            window=4, threshold=2.0, for_samples=1, cooldown=0,
            warmup_samples=4),))
        eng = AlertEngine(hist, rules=rules, registry=reg)
        hist.sample()                         # boot sample inside grace
        c.inc(10)                             # warmup trace burst —
        # RECORDED in the history, not just pre-dating it
        for _ in range(4):                    # samples 2-5: grace ends
            hist.sample()
        # first post-grace evaluation: the rate window is clamped to
        # the post-warmup era, so the recorded boot burst (a 10-delta
        # inside the unclamped window) cannot fire it
        assert eng.state("storm")["state"] == "inactive", \
            eng.state("storm")
        for _ in range(4):                    # window expands quietly
            hist.sample()
        assert eng.state("storm")["state"] == "inactive"
        c.inc(3)                              # a REAL post-warmup storm
        hist.sample()
        assert eng.state("storm")["state"] == "firing"
        assert default_rule_set() == AlertRuleSet.from_obj(
            default_rule_set().to_obj())      # warmup round-trips

    def test_unrecorded_series_is_no_data_not_inactive(self):
        # a rule whose series is never recorded (source gate off) can
        # never breach — it must say so, not pose as healthy
        reg = MetricsRegistry()
        reg.counter("serving_slo_total", "t")
        hist = HistoryStore(reg, HistoryConfig())
        eng = AlertEngine(hist, rules=_threshold_rules(
            series="serving_pool_available_blocks"), registry=reg)
        hist.sample()
        st = eng.state("pool")
        assert st["has_data"] is False
        assert "no recorded data" in st["last_detail"]
        assert "pool" in eng.snapshot()["no_data"]

    def test_deterministic_replay_same_window_same_transitions(self):
        """The AuditConfig/FaultPlan discipline, proven: running the
        SAME recorded value script through two fresh store+engine pairs
        produces identical transition sequences (samples, states,
        values) — no wall-clock leaks into evaluation."""
        script = ([("free", 10.0, 0)] * 3 + [("free", 0.0, 0)] * 4
                  + [("free", 10.0, 2)] * 6 + [("free", 1.0, 3)] * 3
                  + [("free", 10.0, 5)] * 4)

        def run_once():
            reg = MetricsRegistry()
            free = reg.gauge("serving_pool_free_blocks", "t")
            restarts = reg.counter("serving_replica_restarts_total", "t")
            hist = HistoryStore(reg, HistoryConfig())
            rules = AlertRuleSet(rules=(
                AlertRule(name="pool", kind="threshold",
                          series="serving_pool_free_blocks", op="lt",
                          threshold=2.0, for_samples=2, cooldown=3),
                AlertRule(name="churn", kind="rate",
                          series="serving_replica_restarts_total",
                          window=5, threshold=2.0, for_samples=1,
                          cooldown=2),))
            eng = AlertEngine(hist, rules=rules, registry=reg)
            for _, v, restart_total in script:
                free.set(v)
                if restarts.value < restart_total:
                    restarts.inc(restart_total - restarts.value)
                hist.sample()
            return {name: [(t["state"], t["sample"], t["value"])
                           for t in trs]
                    for name, trs in eng.transitions_report().items()}

        first, second = run_once(), run_once()
        assert first == second
        assert any(first.values()), "script produced no transitions"

    def test_rule_set_json_round_trip_and_validation(self):
        rs = default_rule_set()
        again = AlertRuleSet.from_obj(rs.to_obj())
        assert again == rs                    # frozen value equality
        with pytest.raises(ValueError, match="not valid for a"):
            AlertRuleSet.from_obj([{"name": "x", "kind": "rate",
                                    "series": "s", "windw": 3}])
        # a knob from ANOTHER kind must also raise, not silently
        # evaluate with this kind's defaults
        with pytest.raises(ValueError, match="not valid for a"):
            AlertRuleSet.from_obj([{"name": "x", "kind": "rate",
                                    "series": "s", "fast_window": 4}])
        with pytest.raises(ValueError, match="duplicate"):
            AlertRuleSet(rules=(
                AlertRule(name="a", kind="rate", series="s"),
                AlertRule(name="a", kind="rate", series="s")))
        with pytest.raises(ValueError, match="kind"):
            AlertRule(name="x", kind="nope")
        with pytest.raises(ValueError, match="fast_window"):
            AlertRule(name="x", kind="burn_rate", fast_window=9,
                      slow_window=3)
        with pytest.raises(ValueError, match="op"):
            AlertRule(name="x", kind="threshold", series="s", op="eq")
        # a typo'd/missing top-level 'rules' key must raise, never
        # silently disable every alert
        with pytest.raises(ValueError, match="unknown top-level"):
            AlertRuleSet.from_obj({"Rules": []})
        with pytest.raises(ValueError, match="no 'rules' array"):
            AlertRuleSet.from_obj({})
        assert AlertRuleSet.from_obj({"rules": []}).rules == ()

    def test_default_rules_cover_the_stated_surface(self):
        names = {r.name for r in default_rule_set().rules}
        assert {"pool_exhaustion", "goodput_burn", "rejection_burst",
                "compile_storm", "restart_churn", "quarantine_churn",
                "audit_divergence", "cache_imbalance_high"} <= names
        # the pool floor is on free + reuse, NOT the free list proper: a
        # warm prefix cache parks every refcount-0 block in the reuse
        # LRU, so a free-list floor would page forever on a healthy fleet
        pool = next(r for r in default_rule_set().rules
                    if r.name == "pool_exhaustion")
        assert pool.series == "serving_pool_available_blocks"


# --------------------------------------------------------------------------
# Fleet-gauge freshness: /metrics + push gateway via collect hook (dp=2)
# --------------------------------------------------------------------------


# the deterministic-replay script of TestAlertEngine: (free blocks,
# restarts so far) per sample
SCRIPT = ([(10.0, 0)] * 3 + [(0.0, 0)] * 4 + [(10.0, 2)] * 6
          + [(1.0, 3)] * 3 + [(10.0, 5)] * 4)


def _replay(reg_cls, store_cls, cfg_cls, engine_cls, rule_cls, set_cls):
    reg = reg_cls()
    free = reg.gauge("serving_pool_free_blocks", "t")
    restarts = reg.counter("serving_replica_restarts_total", "t")
    good = reg.counter("serving_slo_good_total", "t")
    total = reg.counter("serving_slo_total", "t")
    hist = store_cls(reg, cfg_cls(ring_len=16))
    rules = set_cls(rules=(
        rule_cls(name="pool", kind="threshold",
                 series="serving_pool_free_blocks", op="lt",
                 threshold=2.0, for_samples=2, cooldown=3),
        rule_cls(name="churn", kind="rate",
                 series="serving_replica_restarts_total",
                 window=5, threshold=2.0, for_samples=1, cooldown=2),
        rule_cls(name="burn", kind="burn_rate", objective=0.9,
                 threshold=2.0, fast_window=3, slow_window=6,
                 for_samples=1, cooldown=2)))
    eng = engine_cls(hist, rules=rules, registry=reg)
    for i, (v, restart_total) in enumerate(SCRIPT):
        free.set(v)
        if restarts.value < restart_total:
            restarts.inc(restart_total - restarts.value)
        total.inc(2)
        good.inc(2 if v > 2 else 0)
        hist.sample(step=i)
    transitions = {name: [(t["state"], t["sample"], t["value"])
                          for t in trs]
                   for name, trs in eng.transitions_report().items()}
    windows = {k: hist.window(k) for k in hist.keys()}
    return transitions, windows, reg.prometheus_text()


class TestAgainstJax:
    def test_same_script_same_transitions_windows_and_page(self):
        port = _replay(MetricsRegistry, HistoryStore, HistoryConfig,
                       AlertEngine, AlertRule, AlertRuleSet)
        jax = _replay(JaxRegistry, JaxHistoryStore, JaxHistoryConfig,
                      JaxAlertEngine, JaxAlertRule, JaxAlertRuleSet)
        assert port[0] == jax[0]
        assert any(port[0].values())
        assert port[1] == jax[1]
        assert port[2] == jax[2]


class TestHistoryOnOffIdentity:
    @pytest.mark.parametrize("eager", [False, True])
    @pytest.mark.parametrize("family", list(tp.FAMILIES))
    def test_token_identical_with_equal_captures(self, family, eager):
        model = _port_model()
        outs, captures, regs, engines = [], [], [], []
        for on in (True, False):
            eng = EngineCore(model, config=EngineConfig(
                num_blocks=15, block_size=tp.BS, history=on,
                scheduler=SchedulerConfig(max_num_seqs=4,
                                          max_prefill_tokens_per_step=8),
                **tp.FAMILIES[family]))
            if on:
                hist = HistoryStore(eng.metrics.registry)
                AlertEngine(hist, registry=eng.metrics.registry)
                eng.set_history(hist)
            if eager:
                with disable_graphs():
                    outs.append(tp.run(eng, SamplingParams, tp.prompts()))
            else:
                outs.append(tp.run(eng, SamplingParams, tp.prompts()))
            captures.append((eng.graphs.captures, eng.decode_trace_count,
                             eng.burst_trace_count, eng.ragged_trace_count))
            regs.append(eng.metrics.registry)
            engines.append(eng)
        assert outs[0] == outs[1]
        assert captures[0] == captures[1]
        assert engines[0].history.stats()["samples"] == \
            engines[0].step_seq
        on_text, off_text = (r.prometheus_text() for r in regs)
        assert "serving_history_samples_total" in on_text
        assert "serving_alerts_firing" in on_text
        assert "serving_history" not in off_text
        assert "serving_alerts" not in off_text

    def test_gated_off_engine_ignores_set_history(self):
        eng = EngineCore(_port_model(), config=EngineConfig(
            num_blocks=64, block_size=4, history=False))
        eng.set_history(HistoryStore(MetricsRegistry()))
        assert eng.history is None


_MODEL = []


def _port_model():
    if not _MODEL:
        _MODEL.append(tp.port_model(tp.jax_model()))
    return _MODEL[0]
