"""The port's request lifecycle, flight recorder, histogram quantiles and
push gateway (``observability/lifecycle.py``, ``flight.py``,
``metrics.py``, ``push.py``) held to the JAX package's
(``tests/test_lifecycle_flight.py``'s engine-level classes), on the CPU.

* ``TestTrackerBounds``: bounded per-request rings with a dropped
  counter, sampled decode-token events with exact aggregates (and the
  listener fan-out sampled alike), the bounded recent ring, engine-level
  events to listeners only, race-free snapshots, a disabled tracker, a
  reused id starting afresh.
* ``TestHistogramQuantiles``: bucket quantiles, clamped to the observed
  range, the overflow bucket's exact max — equal to the JAX registry's on
  the same observations.
* ``TestFlightRecorderUnit``: one bundle per preemption storm, rejection
  bursts and the bounded ring, router-ring filing, engine death once per
  replica, a chained watchdog hook, counting without a dump directory.
* ``TestPushGateway``: the daemon loop POSTs the exposition (first push
  at once, final push on close), failures counted with capped backoff.
* ``TestEngineTimeline``: the JAX test's chunked, preempting run with an
  SLO through both engines on the same weights — the same event names
  for each request, the same summaries and SLO counters; the gate off
  records nothing; and on the burst churn run every telemetry view equals
  the JAX engine's, with graphs and under ``disable_graphs()``.
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.observability import (
    FlightConfig,
    FlightRecorder,
    LifecycleTracker,
    MetricsRegistry,
    PushGateway,
)
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
)

import torch_obs_pairs as tp


class TestTrackerBounds:
    def test_per_request_ring_bounded_with_dropped_counter(self):
        reg = MetricsRegistry()
        lc = LifecycleTracker(registry=reg, max_events_per_request=8)
        for i in range(20):
            lc.event("r1", "custom", i=i)
        tl = lc.get("r1")
        assert len(tl.events) == 8 and tl.dropped == 12
        assert reg.counter(
            "serving_lifecycle_events_dropped_total").value == 12
        assert reg.counter("serving_lifecycle_events_total").value == 20

    def test_decode_token_sampling_keeps_exact_aggregates(self):
        lc = LifecycleTracker(decode_sample=4)
        fanned = []
        lc.add_listener(lambda rid, name, ts, tid, attrs:
                        fanned.append(name))
        for i in range(10):
            lc.event("r", "decode_token", itl_s=0.01 * (i + 1))
        tl = lc.get("r")
        assert tl.decode_tokens == 10
        assert tl.itl_max == pytest.approx(0.10)
        assert sum(1 for e in tl.events if e.name == "decode_token") == 3
        assert fanned.count("decode_token") == 3

    def test_finished_timelines_move_to_bounded_recent_ring(self):
        lc = LifecycleTracker(recent=2)
        for i in range(4):
            lc.event(f"r{i}", "finish", reason="eos")
        assert lc.active() == []
        assert [t.request_id for t in lc.recent()] == ["r2", "r3"]
        assert lc.get("r3") is not None and lc.get("r0") is None

    def test_rid_none_fans_out_to_listeners_only(self):
        lc = LifecycleTracker()
        seen = []
        lc.add_listener(lambda rid, name, ts, tid, attrs:
                        seen.append((rid, name)))
        lc.event(None, "prefix_cache_eviction", evicted=3)
        assert seen == [(None, "prefix_cache_eviction")]
        assert lc.active() == []

    def test_snapshot_reads_race_free_with_concurrent_appends(self):
        lc = LifecycleTracker(max_events_per_request=64)
        stop = threading.Event()

        def writer():
            while not stop.is_set():
                lc.event("r", "decode_token", itl_s=0.001)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            deadline = time.monotonic() + 0.5
            while time.monotonic() < deadline:
                tl = lc.get("r")
                if tl is not None:
                    tl.to_dict(lc.epoch_offset)
                    tl.chrome_spans()
        finally:
            stop.set()
            t.join(5)

    def test_disabled_tracker_records_nothing(self):
        lc = LifecycleTracker(enabled=False)
        lc.event("r", "finish", reason="eos")
        assert lc.get("r") is None

    def test_reused_id_starts_a_fresh_timeline(self):
        lc = LifecycleTracker()
        lc.event("r1", "enqueued")
        lc.event("r1", "finish", reason="eos")
        old = lc.get("r1")
        lc.event("r1", "submitted", prompt_tokens=3)
        fresh = lc.get("r1")
        assert fresh is not old and fresh.state == "active"
        lc.event("r1", "finish", reason="eos")
        assert lc.get("r1").state == "finished"


class TestHistogramQuantiles:
    @staticmethod
    def _both(name, buckets, values):
        out = []
        for reg in (MetricsRegistry(), JaxRegistry()):
            h = reg.histogram(name, buckets=buckets)
            for v in values:
                h.observe(v)
            out.append((h, reg))
        return out

    def test_uniform_distribution_quantiles(self):
        (h, _), (j, _) = self._both(
            "q_test_seconds", tuple(float(b) for b in range(10, 101, 10)),
            [float(v) for v in range(1, 101)])
        assert 40 <= h.quantile(0.50) <= 60
        assert 85 <= h.quantile(0.95) <= 100
        assert 90 <= h.quantile(0.99) <= 100
        for q in (0.01, 0.5, 0.95, 0.99):
            assert h.quantile(q) == j.quantile(q)

    def test_quantiles_clamped_to_observed_range_and_empty_none(self):
        reg = MetricsRegistry()
        h = reg.histogram("q_single_seconds", buckets=(1.0, 10.0))
        assert h.quantile(0.5) is None
        h.observe(3.0)
        assert h.quantile(0.01) == pytest.approx(3.0)
        assert h.quantile(0.99) == pytest.approx(3.0)
        with pytest.raises(ValueError):
            h.quantile(1.5)

    def test_overflow_bucket_falls_back_to_exact_max(self):
        (h, _), (j, _) = self._both("q_over_seconds", (1.0,),
                                    (5.0, 7.0, 9.0))
        assert h.quantile(0.99) == pytest.approx(9.0) == j.quantile(0.99)

    def test_snapshot_carries_quantiles_prometheus_text_unchanged(self):
        (h, reg), (j, jreg) = self._both("q_snap_seconds", (1.0, 2.0),
                                         (0.5,))
        assert {"p50", "p95", "p99"} <= set(h.snap())
        assert h.snap() == j.snap()
        assert "p50" not in reg.prometheus_text()
        assert reg.prometheus_text() == jreg.prometheus_text()


def _bundles(tmp_path, trigger=None):
    names = sorted(f for f in os.listdir(tmp_path)
                   if f.startswith("flight_") and f.endswith(".json"))
    if trigger is not None:
        names = [f for f in names if f.startswith(f"flight_{trigger}_")]
    return [os.path.join(tmp_path, f) for f in names]


class TestFlightRecorderUnit:
    def _recorder(self, tmp_path, **cfg):
        reg = MetricsRegistry()
        lc = LifecycleTracker(registry=reg)
        fr = FlightRecorder(registry=reg, lifecycle=lc,
                            config=FlightConfig(dump_dir=str(tmp_path),
                                                **cfg))
        return reg, lc, fr

    def test_preemption_storm_triggers_exactly_one_bundle(self, tmp_path):
        reg, lc, fr = self._recorder(tmp_path, storm_threshold=3,
                                     storm_window_s=10.0, cooldown_s=60.0)
        lc.event("r1", "enqueued", replica="0")
        for _ in range(6):
            lc.event("r1", "preempted", replica="0")
        paths = _bundles(tmp_path, "preemption_storm")
        assert len(paths) == 1
        bundle = json.load(open(paths[0]))
        assert bundle["trigger"] == "preemption_storm"
        assert bundle["replica"] == "0"
        assert any(ev["name"] == "preempted" for ev in bundle["events"])
        assert "r1" in bundle["in_flight_requests"]
        assert bundle["threads"]
        assert reg.counter("serving_flight_dumps_total",
                           trigger="preemption_storm").value == 1

    def test_rejection_burst_and_ring_bound(self, tmp_path):
        reg, lc, fr = self._recorder(tmp_path, burst_threshold=4,
                                     burst_window_s=10.0, ring_events=8)
        for _ in range(10):
            fr.note_rejection()
        assert len(_bundles(tmp_path, "rejection_burst")) == 1
        assert len(fr._rings["router"]) == 8

    def test_replica_less_events_file_under_router_ring(self, tmp_path):
        reg, lc, fr = self._recorder(tmp_path)
        lc.event("r1", "submitted", prompt_tokens=4)
        lc.event("r1", "enqueued", replica="1")
        assert [e["name"] for e in fr._rings["router"]] == ["submitted"]
        assert [e["name"] for e in fr._rings["1"]] == ["enqueued"]
        assert "0" not in fr._rings

    def test_engine_death_fires_once_per_replica(self, tmp_path):
        reg, lc, fr = self._recorder(tmp_path)
        assert fr.trigger("engine_death", replica="1", detail="boom")
        assert fr.trigger("engine_death", replica="1") is None
        assert fr.trigger("engine_death", replica="0")
        assert len(_bundles(tmp_path, "engine_death")) == 2

    def test_watchdog_attach_chains_and_dumps(self, tmp_path):
        class Watchdog:   # any object with an on_timeout hook
            def __init__(self, hook):
                self.on_timeout = hook

        reg, lc, fr = self._recorder(tmp_path)
        called = []
        wd = Watchdog(lambda lab, t: called.append(lab))
        fr.attach_watchdog(wd)
        wd.on_timeout("decode_step", 600.0)
        assert called == ["decode_step"]
        assert len(_bundles(tmp_path, "watchdog")) == 1

    def test_no_dump_dir_counts_but_writes_nothing(self):
        reg = MetricsRegistry()
        fr = FlightRecorder(registry=reg, config=FlightConfig())
        assert fr.trigger("drain_overrun", detail="x") is None
        assert reg.counter("serving_flight_dumps_total",
                           trigger="drain_overrun").value == 1

    def test_engine_bundle_embeds_its_telemetry(self, tmp_path, burst):
        eng = burst["graphs"]
        fr = FlightRecorder(registry=MetricsRegistry(),
                            lifecycle=eng.lifecycle,
                            config=FlightConfig(dump_dir=str(tmp_path)))
        fr.bind_step_profilers({"0": eng.stepprof})
        fr.bind_cache_trackers({"0": eng.cachestat})
        path = fr.trigger("divergence", replica="0", detail="x")
        bundle = json.load(open(path))
        assert bundle["step_profile"]["0"] == eng.stepprof.records()
        assert bundle["cache_stats"]["0"] == eng.cachestat.timeline()[
            -len(bundle["cache_stats"]["0"]):]


class _CapturingGateway:
    def __init__(self):
        outer = self
        self.bodies = []
        self.types = []

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                outer.bodies.append(self.rfile.read(n))
                outer.types.append(self.headers.get("Content-Type"))
                self.send_response(200)
                self.end_headers()

            def log_message(self, fmt, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class TestPushGateway:
    def test_daemon_loop_posts_exposition(self):
        gw = _CapturingGateway()
        reg = MetricsRegistry()
        reg.counter("push_demo_total", "x").inc(3)
        p = PushGateway(f"http://127.0.0.1:{gw.port}/metrics/job/t",
                        registry=reg, interval_s=60.0).start()
        try:
            deadline = time.monotonic() + 30
            while len(gw.bodies) < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(gw.bodies) >= 1, "no immediate first push"
            reg.counter("push_demo_total", "x").inc(1)
        finally:
            p.close()
            gw.close()
        assert len(gw.bodies) >= 2, "close() skipped the final push"
        text = gw.bodies[-1].decode()
        assert "push_demo_total 4" in text and "push_total" in text
        assert "0.0.4" in gw.types[-1]
        assert reg.counter("push_failures_total").value == 0

    def test_failure_counter_and_capped_backoff(self):
        gw = _CapturingGateway()
        gw.close()
        reg = MetricsRegistry()
        p = PushGateway(f"http://127.0.0.1:{gw.port}/x", registry=reg,
                        interval_s=0.5, timeout_s=0.5, max_backoff_s=2.0)
        for _ in range(5):
            assert p.push_now() is False
        assert reg.counter("push_failures_total").value == 5
        assert p.next_delay_s == 2.0
        assert p.push_now() is False
        with pytest.raises(ValueError):
            PushGateway("ftp://nope", registry=reg)


@pytest.fixture(scope="module")
def burst():
    return tp.pair("burst")


TIMELINE_PROMPTS = ([5, 9, 23, 7, 3, 2, 8, 1], [40, 2, 11, 9])


def _timeline_run(eng, sp_cls):
    reqs = [eng.add_request(p, sp_cls(max_new_tokens=8), request_id=f"t{i}",
                            slo_ms=60_000.0)
            for i, p in enumerate(TIMELINE_PROMPTS)]
    eng.run(max_steps=500)
    assert all(r.finished for r in reqs)
    return reqs


def _summary(tl):
    s = tl.summary()
    return {k: v for k, v in s.items()
            if not k.endswith(("_s", "_unix"))}


class TestEngineTimeline:
    def test_full_lifecycle_with_chunks_preemption_and_slo(self):
        paddle.seed(0)
        jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=1))
        pm = llama_from_paddle_tpu(
            {k: v for k, v in jm.state_dict().items()},
            LlamaConfig.tiny(num_hidden_layers=1), device="cpu")
        jax = JaxEngineCore(jm, num_blocks=10, block_size=2,
                            scheduler_config=JaxSchedulerConfig(
                                max_num_seqs=4,
                                max_prefill_tokens_per_step=6))
        eng = EngineCore(pm, num_blocks=10, block_size=2,
                         scheduler_config=SchedulerConfig(
                             max_num_seqs=4, max_prefill_tokens_per_step=6))
        jreqs = _timeline_run(jax, JaxSamplingParams)
        reqs = _timeline_run(eng, SamplingParams)
        assert [r.output_tokens for r in reqs] == \
            [r.output_tokens for r in jreqs]
        assert eng.metrics.counters["preemptions"] >= 1
        for r in reqs:
            tl, jtl = eng.lifecycle.get(r.request_id), \
                jax.lifecycle.get(r.request_id)
            assert [e.name for e in tl.events] == \
                [e.name for e in jtl.events]
            assert _summary(tl) == _summary(jtl)
            assert [e.ts for e in tl.events] == sorted(e.ts
                                                       for e in tl.events)
        preempted = next(r for r in reqs if r.num_preemptions > 0)
        tl = eng.lifecycle.get(preempted.request_id)
        names = [e.name for e in tl.events]
        for needed in ("enqueued", "admitted", "prefill_chunk",
                       "first_token", "preempted", "finish"):
            assert needed in names, (needed, names)
        assert tl.preemptions == preempted.num_preemptions
        assert tl.state == "finished" and tl.finish_reason == "length"
        s = tl.summary()
        assert s["generated_tokens"] == 8 and s["slo_met"] is True
        c = eng.metrics.counters
        assert c["slo"] == 2 and c["slo_good"] == 2
        bd = eng.metrics.slo_breakdown()
        jbd = jax.metrics.slo_breakdown()
        for phase in ("queue_wait", "prefill", "decode_itl", "e2e"):
            assert bd[phase]["count"] == jbd[phase]["count"], phase
        assert bd["goodput"] == jbd["goodput"]
        assert bd["goodput"]["ratio"] == 1.0
        text = eng.metrics.prometheus_text()
        for series in ("serving_queue_wait_seconds_bucket",
                       "serving_prefill_seconds_bucket",
                       "serving_decode_itl_seconds_bucket",
                       "serving_e2e_seconds_bucket",
                       "serving_slo_good_total", "serving_slo_total",
                       "serving_lifecycle_events_total"):
            assert series in text, series
        assert eng.lifecycle.chrome_trace(reqs[0].request_id)["traceEvents"]

    def test_lifecycle_events_gate_off(self, burst):
        eng = EngineCore(burst["model"], config=EngineConfig(
            num_blocks=32, block_size=4, lifecycle_events=False))
        r = eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=2))
        eng.run(max_steps=50)
        assert r.finished
        assert eng.lifecycle.get(r.request_id) is None
        assert eng.metrics.slo_breakdown()["e2e"]["count"] == 1

    def test_shared_tracker_and_rebind(self, burst):
        shared = LifecycleTracker()
        eng = EngineCore(burst["model"], config=EngineConfig(
            num_blocks=32, block_size=4, lifecycle=shared))
        assert eng.lifecycle is shared
        other = LifecycleTracker()
        eng.set_lifecycle(other, replica=3)
        r = eng.add_request([1, 2, 3], SamplingParams(max_new_tokens=2))
        eng.run(max_steps=50)
        assert r.finished and shared.get(r.request_id) is None
        assert {e.attrs["replica"] for e in
                other.get(r.request_id).events} == {"3"}

    def test_burst_run_telemetry_matches_jax_engine(self, burst):
        tp.assert_telemetry_matches(burst)
        assert burst["graphs"].burst_trace_count > 0
        assert burst["graphs"].stepprof.bucket_set("burst")
