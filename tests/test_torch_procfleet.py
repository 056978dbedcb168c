"""The port's cross-process fleet (``paddle_tpu_torch/serving/procfleet.py``
over ``python -m paddle_tpu_torch.serving.worker`` processes), held to the
JAX package (CPU workers, ``LlamaConfig.tiny`` at 2 layers).

* A ``ProcessFleet`` of CPU workers on the JAX model's weights (the
  worker spec's ``weights`` key) gives the greedy tokens of the JAX
  package's in-process ``EngineCore`` on the same prompts and pool,
  exactly; after a ``kill -9`` of the worker holding the stream it loses
  no request, gives the same tokens, respawns the worker under a new pid
  and writes one ``engine_death`` bundle embedding the dead worker's
  mirrored events.
* The cases of ``tests/test_zzzzzz_procfleet.py``: a fault plan fires
  exactly once across a respawn, an idle ``kill -9`` is caught by the
  heartbeat, debug endpoints answer ``restarting`` rows mid-respawn, the
  wire's refusals are connection-scoped and counted, ``--workers`` and
  ``--dp`` exclude each other.
* ``ScaleDecider``, the weighted ring and ``CacheRebalancer``'s weights
  equal the JAX classes' on the same inputs.  The autoscaler is driven by
  a synthetic alert firing (a threshold rule over a gauge the test sets),
  sample by sample, not by wall-clock goodput.
* ``--compile-cache``: the worker's boot line and the build directory's
  cross-process lock (two processes, one fake ``nvcc`` run).

Every fleet is stopped in ``finally``, and no worker process, replica
thread or heartbeat thread outlives it.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serving import EngineConfig as JaxEngineConfig
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu.serving import fleet as jax_fleet
from paddle_tpu.serving import procfleet as jax_procfleet
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.observability.alerts import AlertRule, AlertRuleSet
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import (
    AotArtifact,
    AutoscalerConfig,
    CacheRebalancer,
    EngineConfig,
    EngineCore,
    FaultPlan,
    FaultSpec,
    FleetConfig,
    FleetDown,
    FleetRouter,
    ProcessFleet,
    ProcessFleetConfig,
    RebalancerConfig,
    SamplingParams,
    ScaleDecider,
    SchedulerConfig,
    SupervisorConfig,
    wire,
)
from paddle_tpu_torch.serving import procfleet
from paddle_tpu_torch.serving.fleet import _build_ring
from paddle_tpu_torch.serving.procfleet import WorkerHandle

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_PY = os.path.join(_REPO, "paddle_tpu_torch", "ops", "_build.py")
LAYERS = 2
POOL = dict(num_blocks=32, block_size=4)
SCHED = dict(max_num_seqs=4, max_prefill_tokens_per_step=8)
_RNG = np.random.default_rng(0)
PREFIX = _RNG.integers(0, 256, 8).tolist()   # 2 full blocks shared
PROMPTS = [PREFIX + _RNG.integers(0, 256, 4).tolist() for _ in range(6)]
MAX_NEW = 12
SUP = dict(backoff_initial_s=0.02, backoff_max_s=0.5, poll_interval_s=0.01)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_workers():
    """CPU worker processes run one intra-op thread each (their tiny
    model needs no more), so a parallel test run keeps its cores."""
    keys = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """The JAX worker's model (``paddle.seed(0)``, tiny, 2 layers): its
    numpy parameters in an ``.npz`` and its greedy tokens for PROMPTS
    from one in-process JAX engine on the workers' pool."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    path = str(tmp_path_factory.mktemp("procfleet") / "weights.npz")
    np.savez(path, **state)
    eng = JaxEngineCore(jm, config=JaxEngineConfig(
        **POOL, scheduler=JaxSchedulerConfig(**SCHED)))
    reqs = [eng.add_request(p, JaxSamplingParams(max_new_tokens=MAX_NEW),
                            request_id=f"r{i}")
            for i, p in enumerate(PROMPTS)]
    eng.run(max_steps=4000)
    return path, state, {f"r{i}": list(r.output_tokens)
                         for i, r in enumerate(reqs)}


def _cfg(weights=None, dp=2, **kw):
    kw.setdefault("heartbeat_interval_s", 0.1)
    kw.setdefault("heartbeat_timeout_s", 5.0)
    return ProcessFleetConfig(
        dp=dp, layers=LAYERS, device="cpu", weights=weights,
        max_num_seqs=SCHED["max_num_seqs"],
        max_prefill_tokens_per_step=SCHED["max_prefill_tokens_per_step"],
        **POOL, **kw)


def _csum(registry, name, **match) -> float:
    total = 0.0
    for row in wire.dump_registry(registry):
        if row["name"] != name:
            continue
        lbls = dict(row["labels"])
        if all(lbls.get(k) == v for k, v in match.items()):
            total += row.get("value", 0.0)
    return total


def _stream(router, prompts, max_new=MAX_NEW, prefix="r", **kw):
    return [router.submit_request(
        p, SamplingParams(max_new_tokens=max_new),
        request_id=f"{prefix}{i}", retryable=True, **kw)
        for i, p in enumerate(prompts)]


def _gone(pid) -> bool:
    """True once ``pid`` (a child of this process) has exited and been
    reaped."""
    try:
        done, _ = os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        return True
    return done == pid


def _stop(pf, pids=()):
    """Stop ``pf`` and assert nothing of it survives: no worker process
    (the current ones and ``pids``), no replica, heartbeat or actuator
    thread."""
    proxies = list(pf.shared.active.values())
    pids = {p.pid for p in proxies if p.pid} | set(pids)
    pf.stop()
    hb = [p._hb_thread for p in proxies if p._hb_thread is not None]
    for t in hb:
        t.join(10)
    deadline = time.monotonic() + 10
    while not all(_gone(pid) for pid in pids) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert all(_gone(pid) for pid in pids), "a worker outlived stop()"
    assert not any(r.thread is not None and r.thread.is_alive()
                   for r in pf.router.replicas)
    assert not any(t.is_alive() for t in hb)


# --- pure actuator cores, against the JAX classes ---------------------------

class TestScaleDecider:
    def test_decision_sequence_bounds_and_replay(self):
        inputs = [(0, ()), (1, ("goodput_burn",)),
                  (2, ("goodput_burn",)), (3, ("goodput_burn",)),
                  (4, ()), (5, ()), (6, ()), (7, ())]
        runs = {}
        for name, mod in (("jax", jax_procfleet), ("port", procfleet)):
            cfg = mod.AutoscalerConfig(min_replicas=1, max_replicas=2,
                                       cooldown_samples=2, calm_samples=3)
            d = mod.ScaleDecider(cfg, start_replicas=1, min_replicas=1,
                                 max_replicas=2)
            live = [d.decide(i, f) for i, f in inputs]
            replay = mod.ScaleDecider(cfg, 1, 1, 2)
            runs[name] = (live, list(d.decisions),
                          [replay.decide(i, f) for i, f in inputs])
        assert runs["port"] == runs["jax"]
        live, decisions, replayed = runs["port"]
        assert live == [None, "up", None, None, None, None, "down", None]
        assert [x["direction"] for x in decisions] == ["up", "down"]
        assert replayed == live

    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_firing_streams_decide_as_the_jax_decider(self, seed):
        rng = np.random.default_rng(seed)
        rules = ("goodput_burn", "pool_exhaustion", "compile_storm")
        inputs = [(i, tuple(r for r in rules if rng.random() < 0.15))
                  for i in range(400)]
        out = {}
        for name, mod in (("jax", jax_procfleet), ("port", procfleet)):
            cfg = mod.AutoscalerConfig(min_replicas=1, max_replicas=4,
                                       cooldown_samples=5, calm_samples=12)
            d = mod.ScaleDecider(cfg, 2, 1, 4)
            out[name] = ([d.decide(i, f) for i, f in inputs],
                         list(d.decisions))
        assert out["port"] == out["jax"]
        assert {"up", "down"} <= set(out["port"][0])

    def test_never_scales_past_bounds(self):
        cfg = AutoscalerConfig(min_replicas=1, max_replicas=2,
                               cooldown_samples=1, calm_samples=1)
        d = ScaleDecider(cfg, start_replicas=2, min_replicas=1,
                         max_replicas=2)
        assert d.decide(0, ("pool_exhaustion",)) is None  # at max
        assert d.decide(5, ()) == "down"
        assert d.decide(9, ()) is None                    # at min
        assert d.decide(12, ("compile_storm",)) is None


class TestRingReweight:
    @pytest.mark.parametrize("weights", [
        None, {0: 2.0, 1: 0.5}, {1: 0.001}, {0: 0.25, 1: 4.0, 2: 1.3}])
    def test_weighted_ring_equals_the_jax_ring(self, weights):
        n = 3 if weights and 2 in weights else 2
        assert _build_ring(n, 16, weights=weights) == \
            jax_fleet._build_ring(n, 16, weights=weights)

    def test_weighted_ring_moves_vnode_share_only(self):
        base = _build_ring(2, 16)

        def count(ring, i):
            return sum(1 for _, r in ring if r == i)

        assert count(base, 0) == 16 and count(base, 1) == 16
        skew = _build_ring(2, 16, weights={0: 2.0, 1: 0.5})
        assert count(skew, 0) == 32 and count(skew, 1) == 8
        assert {p for p in skew if p[1] == 1} <= {p for p in base
                                                 if p[1] == 1}
        assert {p for p in base if p[1] == 0} <= {p for p in skew
                                                  if p[1] == 0}
        assert count(_build_ring(2, 16, weights={1: 0.001}), 1) == 1


class _StubRouter:
    """The surface ``CacheRebalancer`` reads, fed fixed ratios."""

    class _History:
        def __init__(self):
            self.listeners = []

        def add_listener(self, fn):
            self.listeners.append(fn)
            return lambda: self.listeners.remove(fn)

    class _Lifecycle:
        def __init__(self):
            self.events = []

        def event(self, rid, name, **attrs):
            self.events.append((name, attrs))

    def __init__(self, ratios):
        self.history = self._History()
        self.lifecycle = self._Lifecycle()
        self.ratios = ratios
        self.weights = []
        self.replicas = []

    def cached_token_ratios(self):
        return dict(self.ratios)

    def cache_imbalance(self):
        vals = [v for v in self.ratios.values() if v is not None]
        return max(vals) - min(vals) if len(vals) > 1 else None

    def reweight_ring(self, weights):
        self.weights.append(dict(weights))


class TestCacheRebalancer:
    @pytest.mark.parametrize("ratios", [
        {"0": 0.9, "1": 0.1}, {"0": 0.2, "1": 0.25, "2": None},
        {"0": 0.0, "1": 0.95, "2": 0.5, "3": 0.3}, {"0": 0.5, "1": 0.52}])
    def test_weights_equal_the_jax_rebalancer(self, ratios):
        out = {}
        for name, mod, registry in (
                ("jax", jax_procfleet, JaxRegistry()),
                ("port", procfleet, MetricsRegistry())):
            router = _StubRouter(ratios)
            reb = mod.CacheRebalancer(router, mod.RebalancerConfig(
                threshold=0.15, min_interval_samples=3,
                migrate_prefixes=False), registry=registry)
            for i in range(1, 8):
                for fn in list(router.history.listeners):
                    fn(i, i)
            reb.close()
            out[name] = (router.weights, reb.last_weights,
                         router.lifecycle.events,
                         registry.prometheus_text())
        assert out["port"] == out["jax"]

    def test_reweights_cold_replica_heavier(self, jax_weights):
        """Over the stock in-process port router: past the imbalance
        threshold the COLD replica gets the heavier vnode weight."""
        _, state, _ = jax_weights

        def make(i, registry):
            model = llama_from_paddle_tpu(
                state, LlamaConfig.tiny(num_hidden_layers=LAYERS),
                device="cpu")
            return EngineCore(model, config=EngineConfig(
                **POOL, scheduler=SchedulerConfig(**SCHED)),
                registry=registry, metrics_labels={"replica": str(i)})

        router = FleetRouter.build(make, dp=2)
        try:
            router.start()
            rng = np.random.default_rng(1)
            wave = [rng.integers(0, 256, 12).tolist() for _ in range(12)]
            router.wait(_stream(router, wave, max_new=2, prefix="w"),
                        timeout=120)
            ratios = router.cached_token_ratios()
            assert all(v is not None for v in ratios.values()), ratios
            router.wait(_stream(router, [wave[0]] * 4, max_new=2,
                                prefix="h"), timeout=120)
            imb = router.cache_imbalance()
            assert imb is not None and imb > 0.01
            reb = CacheRebalancer(router, RebalancerConfig(
                threshold=0.01, min_interval_samples=50))
            try:
                router.history.sample()
                assert reb.last_weights is not None
                ratios = router.cached_token_ratios()
                warm = max(ratios, key=lambda k: ratios[k])
                cold = min(ratios, key=lambda k: ratios[k])
                assert reb.last_weights[int(cold)] \
                    > reb.last_weights[int(warm)]
                assert _csum(router.registry,
                             "serving_fleet_ring_reweights_total") == 1
                router.history.sample()
                assert _csum(router.registry,
                             "serving_fleet_ring_reweights_total") == 1
                h = router.submit_request(wave[1], SamplingParams(
                    max_new_tokens=2), request_id="post")
                router.wait([h], timeout=120)
                assert h.finish_reason == "length"
            finally:
                reb.close()
        finally:
            router.stop()
        assert not any(r.thread.is_alive() for r in router.replicas)


# --- wire-protocol robustness ------------------------------------------------

_SPEC_SMALL = {
    "layers": 2, "num_blocks": 16, "block_size": 4, "max_num_seqs": 2,
    "max_prefill_tokens_per_step": 4, "unified_step": False, "seed": 0,
    "audit_enabled": False, "audit_sample_every": 1,
    "lifecycle_events": False, "history": False, "device": "cpu",
}
_DEPLOY_SMALL = {"mp": 1, "spec": None, "role": "unified",
                 "model": wire.model_identity(_SPEC_SMALL)}


class TestWireRobustness:
    @pytest.fixture(scope="class")
    def worker(self):
        wh = WorkerHandle.spawn(ProcessFleetConfig(dp=1, device="cpu"), 0,
                                _SPEC_SMALL)
        try:
            yield wh
        finally:
            wh.stop()
        assert not wh.alive

    def _raw(self, worker):
        sock = socket.create_connection(("127.0.0.1", worker.port),
                                        timeout=10)
        conn = wire.Connection(sock, side="router")
        conn.settimeout(10)
        return conn

    def _alive_and_serving(self, worker):
        assert worker.alive, "worker process died on a bad connection"
        conn = wire.connect("127.0.0.1", worker.port, role="control",
                            aot_hash=None, deploy=_DEPLOY_SMALL)
        try:
            assert conn.request({"type": "health"})["type"] == "health_ok"
        finally:
            conn.close()

    def test_version_mismatch_is_connection_scoped(self, worker):
        conn = self._raw(worker)
        try:
            conn.send({"type": "hello", "version": 99, "role": "control",
                       "aot_hash": None})
            reply = conn.recv()
            assert (reply["type"], reply["code"]) == ("error",
                                                      "version_mismatch")
        finally:
            conn.close()
        self._alive_and_serving(worker)

    def test_aot_hash_mismatch_refused_both_sides(self, worker):
        conn = self._raw(worker)
        try:
            conn.send(wire.hello_frame("control", "deadbeef",
                                       deploy=_DEPLOY_SMALL))
            reply = conn.recv()
            assert (reply["type"], reply["code"]) == ("error",
                                                      "aot_mismatch")
        finally:
            conn.close()
        with pytest.raises(wire.HandshakeMismatch) as ei:
            wire.connect("127.0.0.1", worker.port, role="engine",
                         aot_hash="deadbeef", deploy=_DEPLOY_SMALL)
        assert ei.value.code == "aot_mismatch"
        self._alive_and_serving(worker)

    def test_model_drift_is_a_deploy_mismatch(self, worker):
        """A router expecting another model (the defaults: tiny on the
        card) than the worker built is refused at the handshake."""
        with pytest.raises(wire.HandshakeMismatch) as ei:
            wire.connect("127.0.0.1", worker.port, role="engine",
                         aot_hash=None)
        assert ei.value.code == "deploy_mismatch"
        self._alive_and_serving(worker)

    def test_unknown_role_is_protocol_error(self, worker):
        conn = self._raw(worker)
        try:
            conn.send({"type": "hello", "version": wire.WIRE_VERSION,
                       "role": "root", "aot_hash": None,
                       "deploy": _DEPLOY_SMALL})
            reply = conn.recv()
            assert (reply["type"], reply["code"]) == ("error", "protocol")
        finally:
            conn.close()
        self._alive_and_serving(worker)

    def test_malformed_frames_answered_and_isolated(self, worker):
        for payload in (b"this is not json!", b"[1, 2, 3]"):
            conn = self._raw(worker)
            try:
                conn._sock.sendall(
                    wire._HEADER.pack(len(payload)) + payload)
                reply = conn.recv()
                assert (reply["type"], reply["code"]) == ("error",
                                                          "malformed")
            finally:
                conn.close()
            self._alive_and_serving(worker)

    def test_oversized_frame_refused(self, worker):
        conn = self._raw(worker)
        try:
            conn._sock.sendall(wire._HEADER.pack(wire.MAX_FRAME_BYTES + 1))
            reply = conn.recv()
            assert (reply["type"], reply["code"]) == ("error", "oversized")
        finally:
            conn.close()
        self._alive_and_serving(worker)

    def test_truncated_frame_never_kills_the_process(self, worker):
        conn = self._raw(worker)
        conn._sock.sendall(wire._HEADER.pack(64) + b"only ten b")
        conn.close()  # EOF mid-frame: the kill -9 signature
        time.sleep(0.1)
        self._alive_and_serving(worker)

    def test_wire_errors_are_counted_worker_side(self, worker):
        conn = wire.connect("127.0.0.1", worker.port, role="control",
                            aot_hash=None, deploy=_DEPLOY_SMALL)
        try:
            reply = conn.request({"type": "debug", "what": "metrics"})
            assert reply["type"] == "debug_ok"
            kinds = {dict(r["labels"]).get("kind")
                     for r in reply["data"]
                     if r["name"] == "serving_wire_errors_total"
                     and r.get("value", 0) > 0}
        finally:
            conn.close()
        assert {"version_mismatch", "aot_mismatch", "deploy_mismatch",
                "malformed", "oversized", "truncated"} <= kinds, kinds


# --- the cross-process chaos contract ---------------------------------------

class TestProcessChaos:
    def test_kill9_midstream_zero_loss_token_identity(self, jax_weights,
                                                      tmp_path):
        """dp=2 CPU workers on the JAX weights: the fault-free run and a
        run with the stream's worker ``kill -9``'d mid-stream both give
        the JAX engine's greedy tokens; the chaos run loses nothing,
        respawns the worker under a new pid and writes ONE engine_death
        bundle holding the dead worker's mirrored events."""
        path, _, want = jax_weights

        def run(kill):
            fdir = str(tmp_path / f"flight-{kill}")
            pf = ProcessFleet(_cfg(path, fleet=FleetConfig(
                flight_dir=fdir)))
            pf.supervise(SupervisorConfig(**SUP))
            pf.start()
            router = pf.router
            victim = victim_pid = None
            try:
                hs = _stream(router, PROMPTS)
                if kill:
                    deadline = time.monotonic() + 60
                    while not any(h.output_tokens for h in hs) \
                            and time.monotonic() < deadline:
                        time.sleep(0.005)
                    # the shared prefix is ONE affinity key: one replica
                    # owns the whole stream — kill that one
                    victim = next(r.index for r in router.replicas
                                  if r.in_flight)
                    victim_pid = pf.worker_pid(victim)
                    os.kill(victim_pid, signal.SIGKILL)
                router.wait(hs, timeout=300)
                lost = [h.rid for h in hs if h.finish_reason != "length"]
                assert not lost, f"requests lost under chaos: {lost}"
                bundles = [p for p in router.flight.bundles
                           if "engine_death" in p]
                if kill:
                    deadline = time.monotonic() + 120
                    while time.monotonic() < deadline:
                        if (all(r.healthy for r in router.replicas)
                                and pf.worker_pid(victim) != victim_pid):
                            break
                        time.sleep(0.02)
                    assert all(r.healthy for r in router.replicas)
                    assert pf.worker_pid(victim) != victim_pid
                    desc = pf.proxy(victim).debug_fetch("describe")
                    assert desc is not None and desc["pid"] != victim_pid
                    assert len(bundles) == 1
                    with open(bundles[0]) as f:
                        dead = json.load(f)["distrib"][str(victim)]
                    assert dead["pid"] == victim_pid
                    assert dead["mirror"]["events"], \
                        "engine_death bundle embeds no worker events"
                    assert isinstance(dead["stderr_tail"], list)
                else:
                    assert not bundles
                deaths = int(_csum(router.registry,
                                   "serving_flight_dumps_total",
                                   trigger="engine_death"))
                respawns = int(_csum(router.registry,
                                     "serving_fleet_worker_respawns_total"))
                return ({h.rid: list(h.output_tokens) for h in hs},
                        deaths, respawns)
            finally:
                _stop(pf, [victim_pid] if victim_pid else ())

        clean, clean_deaths, clean_respawns = run(kill=False)
        assert (clean_deaths, clean_respawns) == (0, 0)
        assert clean == want, "the fleet's tokens differ from JAX's"
        chaos, deaths, respawns = run(kill=True)
        assert (deaths, respawns) == (1, 1)
        assert chaos == want, "token identity broken after kill -9"

    def test_fault_plan_fires_exactly_once_across_respawn(self,
                                                          jax_weights):
        """An injected engine_step_raise crosses the wire: the worker
        reports step_error and exits, the supervisor respawns it, and
        the fired-index transfer keeps the plan entry exactly-once."""
        owner = 1   # the stream's affinity replica on the dp=2 ring
        plan = FaultPlan(faults=(FaultSpec(point="engine_step_raise",
                                           step=6, replica=str(owner)),))
        pf = ProcessFleet(_cfg(jax_weights[0], fleet=FleetConfig(
            fault_plan=plan)))
        pf.supervise(SupervisorConfig(**SUP))
        pf.start()
        router = pf.router
        first_pid = pf.worker_pid(owner)
        try:
            hs = _stream(router, PROMPTS)
            router.wait(hs, timeout=300)
            assert all(h.finish_reason == "length" for h in hs)
            assert {h.rid: list(h.output_tokens) for h in hs} == \
                jax_weights[2]
            deadline = time.monotonic() + 120
            while (not all(r.healthy for r in router.replicas)
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert all(r.healthy for r in router.replicas)
            assert pf.worker_pid(owner) != first_pid
            snap = router.fault_injectors[owner].snapshot()
            assert snap["fired"] == 1
            assert snap["fired_plan_indexes"] == [0]
            assert int(_csum(router.registry,
                             "serving_flight_dumps_total",
                             trigger="engine_death")) == 1
            hs2 = _stream(router, PROMPTS[:4], prefix="again")
            router.wait(hs2, timeout=300)
            assert all(h.finish_reason == "length" for h in hs2)
            assert router.fault_injectors[owner].snapshot()["fired"] == 1
            assert int(_csum(router.registry,
                             "serving_flight_dumps_total",
                             trigger="engine_death")) == 1
        finally:
            _stop(pf, [first_pid])

    def test_idle_kill9_detected_by_heartbeat(self, tmp_path):
        """An IDLE worker's death has no step to fail on: the heartbeat
        marks it dead, the replica loop's has_work poll raises
        WorkerDied through the standard death path, and an unsupervised
        one-replica fleet then refuses submits."""
        cache = str(tmp_path / "kernels")
        pf = ProcessFleet(_cfg(dp=1, compile_cache=cache))
        pf.start()
        router = pf.router
        pid = pf.worker_pid(0)
        try:
            # --compile-cache names the worker's kernel build directory;
            # on the CPU no kernel is built, so both counts are 0
            wh = pf.proxy(0).worker
            assert wh.compile_cache == {"dir": cache, "entries_before": 0,
                                        "entries_after": 0}
            assert os.path.isdir(cache)
            assert wh.boot_s > 0 and wh.ready_s >= wh.boot_s
            assert router.replicas[0].healthy
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 15
            while (router.replicas[0].healthy
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert not router.replicas[0].healthy, \
                "idle worker death not detected"
            assert _csum(router.registry,
                         "serving_fleet_heartbeat_timeouts_total") >= 1
            with pytest.raises(FleetDown):
                router.submit_request(PROMPTS[0], SamplingParams(
                    max_new_tokens=2))
        finally:
            _stop(pf, [pid])


# --- mid-respawn debug rows over HTTP ---------------------------------------

def _http(port, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = None if body is None else json.dumps(body)
    conn.request(method, path, payload,
                 {"Content-Type": "application/json"} if payload else {})
    resp = conn.getresponse()
    data = resp.read()
    status = resp.status
    conn.close()
    return status, data


class TestRestartingDebugRows:
    def test_debug_endpoints_degrade_to_restarting_rows(self):
        import asyncio

        from paddle_tpu_torch.serving.server import (CompletionServer,
                                                     ServerConfig)

        pf = ProcessFleet(_cfg())
        loop = asyncio.new_event_loop()
        thread = threading.Thread(target=loop.run_forever, daemon=True)
        thread.start()

        def run(coro, timeout=120):
            return asyncio.run_coroutine_threadsafe(
                coro, loop).result(timeout)

        server = CompletionServer(pf.router, ServerConfig())
        pid = pf.worker_pid(1)
        run(server.start())
        try:
            status, body = _http(server.port, "GET", "/readyz")
            assert status == 200 and body.startswith(b"ok dp=2")
            status, data = _http(server.port, "GET", "/v1/debug/wire")
            assert status == 200 and json.loads(data)["enabled"] is True
            os.kill(pid, signal.SIGKILL)
            deadline = time.monotonic() + 15
            while (pf.router.replicas[1].healthy
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert not pf.router.replicas[1].healthy

            status, data = _http(server.port, "GET", "/v1/debug/audit")
            assert status == 200
            assert {"replica": "1", "enabled": False,
                    "status": "restarting"} in json.loads(data)["data"]
            status, data = _http(server.port, "GET",
                                 "/v1/debug/audit?replica=1")
            assert status == 200
            assert json.loads(data)["data"][0]["status"] == "restarting"
            status, data = _http(server.port, "GET", "/v1/debug/cache")
            assert status == 200
            rows = {d["replica"]: d for d in json.loads(data)["data"]}
            assert rows["1"]["status"] == "restarting"
            assert rows["0"].get("status") != "restarting"
            status, data = _http(server.port, "GET", "/v1/debug/compiles")
            assert status == 200
            assert json.loads(data)["aot"]["1"] == {"status": "restarting"}
            status, data = _http(server.port, "POST", "/v1/completions",
                                 {"prompt": PROMPTS[0], "max_tokens": 2})
            assert status == 200
            assert len(json.loads(data)["choices"][0]["token_ids"]) == 2
            status, data = _http(server.port, "GET",
                                 "/v1/requests?state=recent")
            listing = json.loads(data)
            assert (listing["source"], listing["complete"]) == \
                ("router+workers", True)
        finally:
            try:
                run(server.shutdown(drain_timeout=1.0), timeout=60)
            finally:
                loop.call_soon_threadsafe(loop.stop)
                thread.join(10)
                loop.close()
                _stop(pf, [pid])
        assert not thread.is_alive()


# --- the autoscaler, driven by a synthetic firing ---------------------------

class TestAutoscaler:
    def test_synthetic_firing_scales_up_then_drains_and_replays(self):
        """A threshold rule over a gauge the test sets stands in for a
        goodput burn: each manual history sample re-evaluates it.  Its
        firing provisions the parked replica (bounded at max); once it
        resolves, calm_samples later the actuator drains an idle replica;
        the recorded (sample, firing) log replays to the same decisions.
        Nothing here reads a wall clock."""
        rules = AlertRuleSet(rules=(AlertRule(
            name="synthetic_pressure", kind="threshold",
            series="test_synthetic_pressure", op="gt", threshold=0.5,
            for_samples=1, cooldown=0),))
        pf = ProcessFleet(_cfg(fleet=FleetConfig(alert_rules=rules)),
                          initial_replicas=1)
        pressure = pf.registry.gauge("test_synthetic_pressure",
                                     "a test's stand-in alert signal")
        pf.start()
        router = pf.router
        pids = {pf.worker_pid(0)}
        try:
            assert pf.live_replica_count() == 1
            scaler = pf.enable_autoscaler(AutoscalerConfig(
                min_replicas=1, max_replicas=2, cooldown_samples=2,
                calm_samples=4, scale_up_rules=("synthetic_pressure",)))
            pressure.set(1.0)
            for _ in range(3):
                router.history.sample()
            assert [d["direction"] for d in scaler.decider.decisions] \
                == ["up"]
            assert "synthetic_pressure" in \
                scaler.decider.decisions[0]["firing"]
            deadline = time.monotonic() + 90
            while (_csum(pf.registry, "serving_fleet_scale_events_total",
                         direction="up") < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert pf.live_replica_count() == 2
            pids.add(pf.worker_pid(1))
            assert _csum(pf.registry, "serving_fleet_scale_events_total",
                         direction="up") == 1
            hs = _stream(router, PROMPTS[:2], max_new=4, prefix="up")
            router.wait(hs, timeout=300)
            assert all(h.finish_reason == "length" for h in hs)
            pressure.set(0.0)
            for _ in range(8):
                router.history.sample()
            assert [d["direction"] for d in scaler.decider.decisions] \
                == ["up", "down"]
            # the actuator parks the replica, then counts the action
            deadline = time.monotonic() + 90
            while (_csum(pf.registry, "serving_fleet_scale_events_total",
                         direction="down") < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert pf.live_replica_count() == 1
            assert _csum(pf.registry, "serving_fleet_scale_events_total",
                         direction="down") == 1
            assert [x for x in scaler.replay() if x is not None] == \
                ["up", "down"]
        finally:
            _stop(pf, pids)


# --- the kernels' build directory across processes --------------------------

class TestCompileCache:
    def test_sibling_processes_run_nvcc_once(self, tmp_path):
        """Two processes build one kernel into one directory at once: the
        directory lock lets one run nvcc (a fake that logs each run and
        takes half a second) and the other find the library built."""
        bin_dir = tmp_path / "bin"
        bin_dir.mkdir()
        log = tmp_path / "nvcc.log"
        nvcc = bin_dir / "nvcc"
        nvcc.write_text(
            "#!/bin/sh\n"
            f"echo run >> {log}\n"
            "sleep 0.5\n"
            'while [ "$1" != "-o" ]; do shift; done\n'
            'echo lib > "$2"\n')
        nvcc.chmod(0o755)
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        (csrc / "kern.cu").write_text("int x;\n")
        cache = tmp_path / "cache"
        # _build.py alone (no torch import): the two processes start fast
        # enough to overlap in the fake nvcc's half second
        code = (
            "import importlib.util\n"
            "from pathlib import Path\n"
            "spec = importlib.util.spec_from_file_location(\n"
            f"    '_build', {str(BUILD_PY)!r})\n"
            "_build = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(_build)\n"
            f"_build.CSRC_DIR = Path({str(csrc)!r})\n"
            f"_build.set_build_dir({str(cache)!r})\n"
            "_build.build(['kern'])\n"
            "print(_build.count_libraries(str(_build.BUILD_DIR)))\n")
        env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}"
                   f"{os.environ.get('PATH', '')}")
        procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(2)]
        outs = [p.communicate(timeout=120)[0].strip() for p in procs]
        assert [p.returncode for p in procs] == [0, 0]
        assert outs == ["1", "1"]
        assert log.read_text().count("run") == 1


# --- CLI mode selection ------------------------------------------------------

class TestServerCli:
    def test_workers_and_dp_are_mutually_exclusive(self, capsys):
        from paddle_tpu_torch.serving.server import main as server_main

        with pytest.raises(SystemExit) as e:
            server_main(["--workers", "2", "--dp", "2"])
        assert e.value.code == 2
        assert "two fleet modes" in capsys.readouterr().err


# --- AOT artifacts across processes ------------------------------------------

class TestProcessFleetAot:
    @pytest.fixture(scope="class")
    def artifact(self, jax_weights, tmp_path_factory):
        """A port artifact saved from an in-process engine of the workers'
        own configuration (the JAX weights, the fleet's pool and caps)."""
        _, state, _ = jax_weights
        model = llama_from_paddle_tpu(
            state, LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")
        path = str(tmp_path_factory.mktemp("aot") / "art")
        art = AotArtifact.save(EngineCore(model, config=EngineConfig(
            **POOL, scheduler=SchedulerConfig(**SCHED))), path)
        return path, art

    def test_warm_booted_workers_serve_the_jax_tokens(self, jax_weights,
                                                      artifact):
        """CPU workers booted with ``--aot-path --warm``: the JAX engine's
        greedy tokens, the artifact's hash in every ready line, every
        trace counter 0, the warm's captures (2 a saved bucket) and none
        while serving, the ``aot`` debug block loaded with hits."""
        path, _, want = jax_weights
        art_path, art = artifact
        pf = ProcessFleet(_cfg(path, aot_path=art_path, warm_boot=True))
        pf.start()
        try:
            assert pf.router.aot_artifact is pf.shared.aot_handle
            for i in range(2):
                assert pf.proxy(i).worker.aot_hash == \
                    art.manifest["model_hash"]
            hs = _stream(pf.router, PROMPTS)
            pf.router.wait(hs, timeout=300)
            assert {h.rid: list(h.output_tokens) for h in hs} == want
            for i in range(2):
                desc = pf.proxy(i).debug_fetch("describe")
                assert not any(desc["traces"].values()), desc["traces"]
                assert desc["captures"] == 2 * art.program_count
                assert desc["aot_hash"] == art.manifest["model_hash"]
                snap = pf.proxy(i).stepprof.aot_snapshot()
                assert snap["loaded"] and snap["programs"] == \
                    art.program_count
            assert sum(sum(pf.proxy(i).stepprof.aot_snapshot()["hits"]
                           .values()) for i in range(2)) > 0
        finally:
            _stop(pf)

    def test_a_different_model_hash_is_an_aot_mismatch(self, jax_weights,
                                                       artifact,
                                                       monkeypatch):
        """A router holding another model's hash is refused by a worker
        booted off this artifact (``aot_mismatch``, connection-scoped),
        and a fleet whose manifest handle names another model than the
        artifact its workers boot off does not start."""
        path, _, _ = jax_weights
        art_path, _ = artifact
        pf = ProcessFleet(_cfg(path, dp=1, aot_path=art_path))
        try:
            with pytest.raises(wire.HandshakeMismatch) as ei:
                wire.connect("127.0.0.1", pf.proxy(0).worker.port,
                             role="control", aot_hash="0" * 64,
                             deploy=pf.shared.deploy(0))
            assert ei.value.code == "aot_mismatch"
            assert pf.proxy(0).worker.alive
        finally:
            _stop(pf)
        load = procfleet.AotManifestHandle.load

        def drifted(p):
            h = load(p)
            h.manifest = dict(h.manifest, model_hash="0" * 64)
            return h

        monkeypatch.setattr(procfleet.AotManifestHandle, "load",
                            staticmethod(drifted))
        with pytest.raises(procfleet.WorkerDied, match="artifact drift"):
            ProcessFleet(_cfg(path, dp=1, aot_path=art_path))
