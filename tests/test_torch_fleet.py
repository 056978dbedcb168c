"""The port's in-process fleet (``serving/fleet.py``), its supervisor
(``serving/resilience.py``, ``distributed/watchdog.py``) and fault
injection (``serving/faultinject.py``), held to the JAX package (CPU,
``LlamaConfig.tiny`` at 2 layers, weights through
``convert.llama_from_paddle_tpu``).

* Routing previews, role parsing, fault plans and the metric names equal
  the JAX modules'.
* A dp=2 prefix-affinity fleet, the same fleet on ONE shared model module,
  and a role-aware prefill/decode fleet with the KV hand-off give the
  tokens of one JAX engine (greedy, and seeded sampled for dp=2); the
  role-aware fleet hands each request off once, finishes it on the decode
  replica, keeps both pools' invariant and captures only the buckets
  each replica uses.
* The supervisor restarts a replica killed by an injected fault mid-stream
  and the retryable requests finish token-identically; the flight recorder
  writes one ``engine_death`` bundle naming the fault.
* ``pool_exhaust`` preempts and recomputes token-identically.

Every wait has a deadline; every fleet is shut down and its threads
joined.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu.serving import faultinject as jax_faultinject
from paddle_tpu.serving import fleet as jax_fleet
from paddle_tpu.serving import handoff as jax_handoff
from paddle_tpu.serving import resilience as jax_resilience
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.distributed import StepWatchdog
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    FleetConfig,
    FleetRouter,
    FleetSupervisor,
    InjectedFault,
    SamplingParams,
    SchedulerConfig,
    SupervisorConfig,
    faultinject,
    fleet as port_fleet,
    handoff,
    parse_roles,
    resilience,
)

BS = 4
LAYERS = 2
_RNG = np.random.default_rng(0)
PREFIX = _RNG.integers(0, 256, 8).tolist()
PROMPTS = [PREFIX + _RNG.integers(0, 256, 8).tolist() for _ in range(4)] + [
    _RNG.integers(0, 256, 12).tolist() for _ in range(2)]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=1234)
MAX_NEW = 8
FAST_SUP = dict(backoff_initial_s=0.01, backoff_max_s=0.2,
                poll_interval_s=0.01)


@pytest.fixture(scope="module")
def weights():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))
    return jm, {k: np.asarray(v) for k, v in jm.state_dict().items()}


def _port_model(weights):
    return llama_from_paddle_tpu(
        weights[1], LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")


@pytest.fixture(scope="module")
def port_model(weights):
    return _port_model(weights)


@pytest.fixture(scope="module")
def expected(weights):
    """One JAX unified engine's greedy and seeded sampled tokens for
    every prompt (batch-composition independence makes these the
    reference of any fleet placement)."""
    eng = JaxEngineCore(weights[0], config=JaxEngineConfig(
        num_blocks=64, block_size=BS, unified_step=True,
        scheduler=JaxSchedulerConfig(max_num_seqs=8,
                                     max_tokens_per_step=64)))
    out = {}
    for name, sp in (("greedy", {}), ("sampled", SAMPLED)):
        reqs = [eng.add_request(p, JaxSamplingParams(max_new_tokens=MAX_NEW,
                                                     **sp),
                                request_id=f"{name}{i}")
                for i, p in enumerate(PROMPTS)]
        eng.run(max_steps=4000)
        out[name] = [list(r.output_tokens) for r in reqs]
    return out


def _factory(model_for, roles=None, unified=True, **engine_kw):
    def make(i, registry):
        return EngineCore(model_for(i), config=EngineConfig(
            num_blocks=64, block_size=BS, unified_step=unified,
            role=roles[i] if roles else "unified",
            scheduler=SchedulerConfig(max_num_seqs=8,
                                      max_tokens_per_step=64), **engine_kw),
            registry=registry, metrics_labels={"replica": str(i)})
    return make


def _serve(fleet, sampling=None, timeout=120):
    hs = [fleet.submit_request(
        p, SamplingParams(max_new_tokens=MAX_NEW, **(sampling or {})),
        request_id=f"r{i}", retryable=True) for i, p in enumerate(PROMPTS)]
    fleet.wait(hs, timeout=timeout)
    return hs


def _check_invariant(eng):
    kv = eng.kv
    assert len(kv._free) + len(kv._reuse) + len(kv._ref) + 1 \
        == kv.num_blocks


def _wait(predicate, timeout=60.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.01)


# --- host-side pieces ---------------------------------------------------------

@pytest.mark.parametrize("dp", [1, 2, 3, 5])
def test_affinity_preview_matches_jax(dp):
    for p in PROMPTS + [[1, 2, 3], list(range(40))]:
        for blocks in (1, 2, 4):
            assert port_fleet.affinity_replica_index(
                p, dp, BS, affinity_blocks=blocks) == \
                jax_fleet.affinity_replica_index(p, dp, BS,
                                                 affinity_blocks=blocks)


@pytest.mark.parametrize("spec", ["prefill:1,decode:2", "unified:2", "decode",
                                  "draft:2", "prefill:x", "", "prefill:-1"])
def test_parse_roles_matches_jax(spec):
    try:
        ref = jax_fleet.parse_roles(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_roles(spec)
    else:
        assert parse_roles(spec) == ref


def test_fault_plan_round_trip_matches_jax(tmp_path):
    kw = dict(seed=7, faults=[dict(point="engine_step_raise", step=6,
                                   replica=1),
                              dict(point="slow_step", step=3, replica="0",
                                   duration_s=0.5)])
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(kw))
    mine = FaultPlan.from_json(str(path))
    ref = jax_faultinject.FaultPlan.from_json(str(path))
    assert mine.to_obj() == ref.to_obj()
    assert mine.for_replica("1") == [(0, FaultSpec("engine_step_raise", 6,
                                                   "1"))]
    with pytest.raises(ValueError):
        FaultSpec(point="meteor_strike", step=1)


def test_injector_fires_each_entry_once():
    fi = FaultInjector(FaultPlan(faults=(
        FaultSpec(point="pool_exhaust", step=3, replica="0"),
        FaultSpec(point="engine_step_raise", step=5, replica="0"),
        FaultSpec(point="pool_exhaust", step=1, replica="1"))), replica="0")
    fired = []
    for step in range(1, 5):
        fi.begin_step(step)
        fired.append(fi.pool_exhausted)
    assert fired == [False, False, True, False]
    with pytest.raises(InjectedFault):
        fi.begin_step(6)
    fi.begin_step(7)
    assert fi.remaining == 0 and fi.fired_count == 2
    # a respawned incarnation inherits the fired set: nothing fires again
    again = FaultInjector(fi.plan, replica="0")
    again.mark_fired(fi.snapshot()["fired_plan_indexes"])
    again.begin_step(9)
    assert not again.pool_exhausted and again.remaining == 0


def test_metric_names_match_jax():
    assert port_fleet.METRIC_NAMES == jax_fleet.METRIC_NAMES
    assert resilience.METRIC_NAMES == jax_resilience.METRIC_NAMES
    assert handoff.METRIC_NAMES == jax_handoff.METRIC_NAMES
    assert faultinject.INJECTION_POINTS == jax_faultinject.INJECTION_POINTS


def test_watchdog_fires_on_a_stalled_section():
    fired = threading.Event()
    seen = []

    def on_timeout(label, timeout_s):
        seen.append((label, timeout_s))
        fired.set()

    wd = StepWatchdog(timeout=0.05, on_timeout=on_timeout)
    release = threading.Event()
    try:
        with wd.watch("stalled-step"):
            assert fired.wait(30), "watchdog never fired"
            release.set()
        with wd.watch("quick-step"):
            pass
    finally:
        wd.shutdown()
    assert seen[0] == ("stalled-step", 0.05)
    assert wd.fired == ["stalled-step"]


# --- fleets against one JAX engine ---------------------------------------------

@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_dp2_affinity_fleet_matches_one_engine(weights, port_model, expected,
                                               shared, sampling):
    models = {}

    def model_for(i):
        if shared:
            return port_model
        return models.setdefault(i, _port_model(weights))

    fleet = FleetRouter.build(_factory(model_for), dp=2).start()
    try:
        hs = _serve(fleet, SAMPLED if sampling == "sampled" else None)
        assert [h.output_tokens for h in hs] == expected[sampling]
        assert all(h.finish_reason == "length" for h in hs)
        # the four prompts sharing a prefix landed on one replica, at the
        # JAX package's ring position
        target = jax_fleet.affinity_replica_index(PROMPTS[0], 2, BS)
        assert {h.replica.index for h in hs[:4]} == {target}
        assert fleet.routing_counts["affinity_hit"] == len(PROMPTS)
        page = fleet.registry.prometheus_text()
        for name in port_fleet.METRIC_NAMES:
            assert name in page
    finally:
        fleet.shutdown(drain_timeout=5.0)
    for r in fleet.replicas:
        assert not r.thread.is_alive()
        assert r.engine.kv.occupancy() == 0.0
        _check_invariant(r.engine)


@pytest.mark.parametrize("unified", [True, False], ids=["unified", "legacy"])
def test_role_aware_fleet_hands_off_token_identically(port_model, expected,
                                                      unified):
    roles = ["prefill", "decode"]
    fleet = FleetRouter.build(_factory(lambda i: port_model, roles=roles,
                                       unified=unified),
                              dp=2, config=FleetConfig(roles=roles)).start()
    try:
        hs = _serve(fleet)
        assert [h.output_tokens for h in hs] == expected["greedy"]
        assert all(h.replica.index == 1 for h in hs)
        snap = fleet.registry.snapshot()
        assert snap["serving_handoff_total"]["value"] == len(PROMPTS)
        lc = fleet.lifecycle
        for h in hs:
            names = [e["name"] for e in lc.get(h.rid).to_dict()["events"]]
            i = names.index("kv_handoff")
            assert names.index("first_token") < i
            assert "decode_token" not in names[:i]
        decode = fleet.replicas[1].engine
        # the decode replica served every prompt block from the imported
        # pages: only the tail past the last full block recomputed
        rows = decode.cachestat.attribution()["recent"]
        assert all(r["cached_tokens"] >= 12 for r in rows)
        for r in fleet.replicas:
            eng = r.engine
            _check_invariant(eng)
            traces = eng.ragged_trace_count + eng.decode_trace_count
            buckets = len(eng.ragged_buckets) + len(eng.decode_buckets)
            assert traces == buckets
    finally:
        fleet.shutdown(drain_timeout=5.0)
    assert all(not r.thread.is_alive() for r in fleet.replicas)


@pytest.mark.parametrize("layout", ["roles_unified", "dp2_legacy_burst"])
def test_fleet_kernel_calls_run_inside_step_programs(port_model, expected,
                                                     monkeypatch, layout):
    """Every call of a counted kernel wrapper (ragged and decode attention)
    from either replica's thread runs inside a step program, under the
    process-wide lock that captures hold; the eager families (prefill,
    chunked prefill, the hand-off) make none.  With the wrappers counting
    as they do on the card, the fleet's launches equal its replicas'
    unified steps, decode steps and burst iterations times the layers."""
    from paddle_tpu_torch.ops import paged_decode, ragged_paged
    from paddle_tpu_torch.serving import graphs

    held = []
    for mod, fname in ((ragged_paged, "ragged_paged_attention"),
                       (paged_decode, "paged_attention_decode")):
        monkeypatch.setattr(mod, "launches", 0)

        def counted(*a, _mod=mod, _orig=getattr(mod, fname), **kw):
            held.append(graphs._RUN_LOCK._is_owned())
            _mod.launches += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fname, counted)
    if layout == "roles_unified":
        roles = ["prefill", "decode"]
        make = _factory(lambda i: port_model, roles=roles)
        config = FleetConfig(roles=roles)
    else:
        make = _factory(lambda i: port_model, unified=False, burst_steps=4)
        config = None
    fleet = FleetRouter.build(make, dp=2, config=config).start()
    try:
        hs = _serve(fleet)
        assert [h.output_tokens for h in hs] == expected["greedy"]
    finally:
        fleet.shutdown(drain_timeout=5.0)
    assert all(not r.thread.is_alive() for r in fleet.replicas)
    engines = [r.engine for r in fleet.replicas]
    assert held and all(held)
    assert ragged_paged.launches == LAYERS * sum(
        e.ragged_launches for e in engines)
    assert paged_decode.launches == LAYERS * sum(
        e.metrics.histogram("decode_step").count
        + int(e._burst_counters["length"].sum) for e in engines)
    assert ragged_paged.launches + paged_decode.launches == len(held)


def test_router_preview_reweighting_and_engine_thread_tasks(port_model):
    fleet = FleetRouter.build(_factory(lambda i: port_model), dp=2)
    try:
        for p in PROMPTS:
            assert fleet.predict_replica(p) == \
                jax_fleet.affinity_replica_index(p, 2, BS)
        # a replica weighted 4x takes more of the key space, and a
        # reweighting moves no surviving vnode of the other
        before = {k for k, i in fleet._ring if i == 1}
        fleet.reweight_ring({0: 4.0})
        assert sum(1 for _, i in fleet._ring if i == 0) == 64
        assert {k for k, i in fleet._ring if i == 1} == before
        assert fleet._ring == jax_fleet._build_ring(2, 16, {0: 4.0})
        fleet.start()
        ran = threading.Event()
        seen = []
        assert fleet.replicas[1].post(
            lambda: seen.append(threading.current_thread().name) or ran.set())
        assert ran.wait(30)
        assert seen == ["serving-engine-1"]
    finally:
        fleet.shutdown(drain_timeout=5.0)
    assert all(not r.thread.is_alive() for r in fleet.replicas)


def test_role_aware_fleet_refuses_bad_specs(port_model):
    with pytest.raises(ValueError, match="does not match"):
        FleetRouter.build(_factory(lambda i: port_model,
                                   roles=["prefill", "decode"]),
                          dp=2, config=FleetConfig(roles=["decode",
                                                          "prefill"]))
    with pytest.raises(ValueError, match="only decode"):
        FleetRouter.build(_factory(lambda i: port_model,
                                   roles=["decode", "decode"]), dp=2)


# --- the supervisor ------------------------------------------------------------

def test_supervisor_restarts_a_killed_replica_token_identically(
        port_model, expected, tmp_path):
    target = jax_fleet.affinity_replica_index(PROMPTS[0], 2, BS)
    plan = FaultPlan(faults=(FaultSpec(point="engine_step_raise", step=4,
                                       replica=str(target)),))
    fleet = FleetRouter.build(
        _factory(lambda i: port_model), dp=2,
        config=FleetConfig(fault_plan=plan, flight_dir=str(tmp_path)))
    sup = FleetSupervisor(fleet, config=SupervisorConfig(**FAST_SUP))
    sup.start()
    fleet.start()
    try:
        hs = _serve(fleet)
        assert all(h.finish_reason == "length" for h in hs)
        assert [h.output_tokens for h in hs] == expected["greedy"]
        assert fleet.fault_injectors[target].snapshot()["fired"] == 1
        _wait(lambda: fleet.replicas[target].alive, msg="replica restart")
        assert int(sup._restarts["engine_death"].value) == 1
        assert int(sup._redis_c.value) >= 1
        assert int(sup._failed_c.value) == 0
        deaths = [f for f in os.listdir(tmp_path)
                  if f.startswith("flight_engine_death")]
        assert len(deaths) == 1
        with open(tmp_path / deaths[0]) as f:
            bundle = json.load(f)
        assert any(ev["name"] == "fault_injected" for ev in bundle["events"])
        # the rebuilt replica serves again
        h = fleet.submit_request(PROMPTS[0],
                                 SamplingParams(max_new_tokens=4),
                                 request_id="again")
        fleet.wait([h], timeout=120)
        assert h.output_tokens == expected["greedy"][0][:4]
    finally:
        fleet.shutdown(drain_timeout=5.0)
    assert all(not r.thread.is_alive() for r in fleet.replicas)


def test_pool_exhaust_preempts_token_identically(port_model, expected):
    plan = FaultPlan(faults=(FaultSpec(point="pool_exhaust", step=5,
                                       replica="0"),))
    fleet = FleetRouter.build(_factory(lambda i: port_model), dp=1,
                              config=FleetConfig(fault_plan=plan)).start()
    try:
        hs = _serve(fleet)
        assert [h.output_tokens for h in hs] == expected["greedy"]
        eng = fleet.replicas[0].engine
        assert eng.metrics.counters["preemptions"] > 0
        assert fleet.fault_injectors[0].remaining == 0
    finally:
        fleet.shutdown(drain_timeout=5.0)
