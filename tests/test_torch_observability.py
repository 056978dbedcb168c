"""The port's telemetry substrate (``paddle_tpu_torch/observability``:
tracer, chrome export, metrics registry, scrape endpoint) and the serving
engine's registry surface, held to the JAX package's
(``tests/test_observability.py``'s engine-level classes), on the CPU.

* ``TestSpanTracer``: the bounded ring under many threads, per-thread
  nesting, an exception marking its span, the capacity check.
* ``TestChromeRoundTrip``: export and load round-trip names, nesting and
  attributes; the output directory is created; containment nesting
  without ids; and a trace either package writes, the other loads alike.
* ``TestMetricsRegistry``: counters, gauges (``dec`` included),
  histograms, escaping, labels, snapshots, the cardinality cap, names,
  collect hooks and the process-wide registry — and the Prometheus text
  of a registry driven by one deterministic sequence is byte for byte
  the JAX registry's, as is its JSON snapshot.
* ``TestServingObservability``: a serving run's tracer export nests
  prefill and decode steps under engine steps with the capture instants;
  the page carries the latency, occupancy and capture-count series;
  engines built on one registry with ``metrics_labels`` publish
  per-replica series, with the same series names and label sets as the
  JAX engines on the same registry setup; the ``ServingMetrics`` views
  (``counters``, ``latency``, ``slo_breakdown``, ``snapshot``,
  ``summary``); ``profile_ops=True``'s host operator table.
* ``TestMetricsServer``: ``start_metrics_server(port=0)`` serves an
  engine's page byte-identical to ``metrics_page``, with the
  ``serving_step_*``, cache (``serving_pool_*``,
  ``serving_prefix_cache_*``) and ``serving_lifecycle_events_total``
  series; close is idempotent and a never-started server closes.
"""

import http.client
import json
import os
import threading
import time

import pytest

from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import SpanTracer as JaxSpanTracer
from paddle_tpu.observability import (
    load_profiler_result as jax_load_profiler_result,
)
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import (
    MetricsRegistry,
    MetricsServer,
    SpanTracer,
    load_profiler_result,
    metrics_page,
    start_metrics_server,
)
from paddle_tpu_torch.observability import httpd as _httpd
from paddle_tpu_torch.serving import (
    EngineConfig,
    EngineCore,
    SamplingParams,
    SchedulerConfig,
)
from paddle_tpu_torch.serving.metrics import ServingMetrics

import torch_obs_pairs as tp


class TestSpanTracer:
    def test_ring_bounded_and_counts_dropped(self):
        tr = SpanTracer(capacity=8)
        for i in range(20):
            tr.add_span(f"s{i}", float(i), 0.001)
        assert len(tr) == 8 and tr.dropped == 12
        assert [s.name for s in tr.spans()] == [f"s{i}"
                                                for i in range(12, 20)]
        tr.clear()
        assert len(tr) == 0 and tr.dropped == 0

    def test_ring_bounded_under_many_threads(self):
        tr = SpanTracer(capacity=100)
        n_threads, per = 8, 200

        def work():
            for i in range(per):
                with tr.span("t", i=i):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(tr) == 100
        assert tr.dropped == n_threads * per - 100

    def test_nesting_parent_ids_per_thread(self):
        tr = SpanTracer()
        with tr.span("outer") as outer:
            with tr.span("inner") as inner:
                assert tr.current_span() is inner
            assert tr.current_span() is outer
        spans = {s.name: s for s in tr.spans()}
        assert spans["inner"].parent_id == spans["outer"].span_id
        assert spans["outer"].parent_id is None
        assert spans["outer"].duration >= spans["inner"].duration

    def test_exception_marks_span_and_unwinds(self):
        tr = SpanTracer()
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                raise RuntimeError("x")
        (sp,) = tr.spans()
        assert sp.attrs["error"] == "RuntimeError"
        assert tr.current_span() is None

    def test_capacity_must_be_positive(self):
        with pytest.raises(ValueError):
            SpanTracer(capacity=0)

    def test_process_tracer_swap(self):
        mine = SpanTracer(capacity=4)
        prev = obs.set_tracer(mine)
        try:
            assert obs.get_tracer() is mine
        finally:
            obs.set_tracer(prev)


def _traced(cls):
    tr = cls()
    with tr.span("outer", cat="phase", step=3):
        with tr.span("inner", cat="op"):
            time.sleep(0.001)
        tr.instant("mark", note="x")
    return tr


def _shape(res):
    return (sorted(res.span_names()), [r.name for r in res.roots],
            sorted((s.name, tuple(sorted(c.name for c in s.children)))
                   for n in set(res.span_names()) for s in res.find(n)))


class TestChromeRoundTrip:
    def test_export_load_round_trips_names_nesting_attrs(self, tmp_path):
        path = _traced(SpanTracer).export_chrome(str(tmp_path / "t.json"))
        res = load_profiler_result(path)
        assert sorted(res.span_names()) == ["inner", "mark", "outer"]
        (outer,) = res.find("outer")
        assert {c.name for c in outer.children} == {"inner", "mark"}
        assert [r.name for r in res.roots] == ["outer"]
        assert outer.attrs["step"] == 3
        assert res.find("mark")[0].attrs["note"] == "x"
        assert res.find("inner")[0].dur > 0
        assert res.find("mark")[0].dur == 0

    def test_output_dir_created(self, tmp_path):
        tr = SpanTracer()
        tr.instant("e")
        path = str(tmp_path / "deep" / "nested" / "t.json")
        tr.export_chrome(path)
        assert os.path.exists(path)

    def test_containment_fallback_without_id_args(self, tmp_path):
        events = [
            {"ph": "X", "name": "a", "ts": 0, "dur": 100, "tid": 1,
             "pid": 0},
            {"ph": "X", "name": "b", "ts": 10, "dur": 20, "tid": 1,
             "pid": 0},
        ]
        p = tmp_path / "foreign.json"
        p.write_text(json.dumps({"traceEvents": events}))
        (a,) = load_profiler_result(str(p)).find("a")
        assert [c.name for c in a.children] == ["b"]

    def test_traces_cross_load_between_packages(self, tmp_path):
        port = _traced(SpanTracer).export_chrome(str(tmp_path / "p.json"))
        jax = _traced(JaxSpanTracer).export_chrome(str(tmp_path / "j.json"))
        assert _shape(load_profiler_result(jax)) == \
            _shape(jax_load_profiler_result(port)) == \
            _shape(load_profiler_result(port))


def _drive(reg):
    """One deterministic sequence of registry operations."""
    reg.counter("req_total", 'help with \\ and\nnewline',
                path='a"b\\c\nd').inc(2)
    reg.counter("hits_total", "hits", kind="b").inc(3)
    reg.counter("hits_total", "hits", kind="a").inc()
    g = reg.gauge("depth", "queue depth", replica="0")
    for v in (5, 1, 9, 3.25):
        g.set(v)
    g.inc(2)
    g.dec(0.5)
    reg.gauge("idle")
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0),
                      program="decode")
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    reg.histogram("empty_seconds", buckets=(1.0,))
    reg.counter("big_total").inc(1e16)
    reg.counter("frac_total").inc(0.1)
    reg.gauge("neg").set(-float("inf"))


class TestMetricsRegistry:
    def test_counter_monotonic(self):
        c = MetricsRegistry().counter("ops_total", "ops")
        c.inc()
        c.inc(2)
        with pytest.raises(ValueError):
            c.inc(-1)
        assert c.value == 3

    def test_gauge_exact_streaming_aggregates(self):
        g = MetricsRegistry().gauge("depth")
        for v in (5, 1, 9, 3):
            g.set(v)
        assert g.value == 3 and g.samples == 4
        assert g.avg == 4.5 and g.max == 9 and g.min == 1
        g.dec(2)
        assert g.value == 1 and g.samples == 5

    def test_histogram_cumulative_buckets(self):
        h = MetricsRegistry().histogram("lat", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        assert h.bucket_counts() == {"0.01": 1, "0.1": 2, "1": 3, "+Inf": 4}
        assert h.count == 4 and h.sum == pytest.approx(5.555)
        lines = h.expose()
        assert 'lat_bucket{le="+Inf"} 4' in lines and "lat_count 4" in lines

    def test_prometheus_exposition_format_and_escaping(self):
        reg = MetricsRegistry()
        reg.counter("req_total", 'help with \\ and\nnewline',
                    path='a"b\\c\nd').inc(2)
        text = reg.prometheus_text()
        assert "# HELP req_total help with \\\\ and\\nnewline" in text
        assert "# TYPE req_total counter" in text
        assert 'req_total{path="a\\"b\\\\c\\nd"} 2' in text
        assert text.endswith("\n")

    def test_label_series_and_snapshot(self):
        reg = MetricsRegistry()
        reg.counter("hits_total", kind="a").inc()
        reg.counter("hits_total", kind="b").inc(3)
        snap = reg.snapshot()
        assert snap['hits_total{kind="a"}']["value"] == 1
        assert snap['hits_total{kind="b"}']["value"] == 3
        only = reg.snapshot(kinds=("counter",))
        assert all(v["type"] == "counter" for v in only.values())
        assert sorted(reg.families()) == ["hits_total"]
        assert len(reg.series()) == 2

    def test_get_or_create_is_idempotent_but_kind_conflict_raises(self):
        reg = MetricsRegistry()
        assert reg.counter("x_total") is reg.counter("x_total")
        with pytest.raises(ValueError):
            reg.gauge("x_total")

    def test_series_cardinality_capped(self):
        reg = MetricsRegistry(max_series=2)
        reg.counter("a_total")
        reg.counter("b_total")
        with pytest.raises(RuntimeError):
            reg.counter("c_total")

    def test_invalid_names_rejected(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("bad name")
        with pytest.raises(ValueError):
            reg.counter("1starts_with_digit")

    def test_text_and_snapshot_byte_identical_to_jax(self):
        port, jax = MetricsRegistry(), JaxRegistry()
        _drive(port)
        _drive(jax)
        assert port.prometheus_text().encode() == \
            jax.prometheus_text().encode()
        assert json.dumps(port.snapshot(), sort_keys=True) == \
            json.dumps(jax.snapshot(), sort_keys=True)
        assert metrics_page(port) == jax.prometheus_text().encode()

    def test_collect_hooks_run_before_render(self):
        reg = MetricsRegistry()
        calls = []
        remove = reg.add_collect_hook(
            lambda: (calls.append(1), reg.gauge("fresh").set(len(calls))))
        assert "fresh 1" in reg.prometheus_text()
        assert reg.snapshot()["fresh"]["value"] == 2
        remove()
        remove()   # idempotent
        reg.run_collect_hooks()
        assert len(calls) == 2

    def test_process_registry_swap(self):
        mine = MetricsRegistry()
        prev = obs.set_registry(mine)
        try:
            assert obs.get_registry() is mine
        finally:
            obs.set_registry(prev)


def _serve(eng, sp_cls):
    eng.add_request([5, 9, 23, 7], sp_cls(max_new_tokens=4))
    eng.add_request([40, 2, 11], sp_cls(max_new_tokens=3))
    eng.run(max_steps=100)


@pytest.fixture(scope="module")
def models():
    jm = tp.jax_model()
    return jm, tp.port_model(jm)


class TestServingObservability:
    def test_serving_run_exports_trace_and_prometheus(self, models,
                                                      tmp_path):
        reg = MetricsRegistry()
        tracer = SpanTracer()
        prev = obs.set_tracer(tracer)
        try:
            eng = EngineCore(models[1], num_blocks=64, block_size=4,
                             scheduler_config=SchedulerConfig(
                                 max_num_seqs=2), registry=reg)
            _serve(eng, SamplingParams)
        finally:
            obs.set_tracer(prev)
        res = load_profiler_result(
            tracer.export_chrome(str(tmp_path / "serving_trace.json")))
        names = set(res.span_names())
        assert {"engine_step", "prefill_step", "decode_step",
                "decode_jit_trace"} <= names
        child_names = {c.name for s in res.find("engine_step")
                       for c in s.children}
        assert {"prefill_step", "decode_step"} <= child_names
        text = reg.prometheus_text()
        for name in ("serving_time_to_first_token_seconds_bucket",
                     "serving_inter_token_latency_seconds_count",
                     "serving_kv_pool_occupancy",
                     "serving_decode_jit_traces_total"):
            assert name in text, name
        snap = reg.snapshot()
        assert snap["serving_decode_jit_traces_total"]["value"] == \
            eng.decode_trace_count > 0

    def test_labelled_replicas_on_one_registry_match_jax(self, models):
        regs = MetricsRegistry(), JaxRegistry()
        for i in range(2):
            _serve(EngineCore(models[1], num_blocks=64, block_size=4,
                              scheduler_config=SchedulerConfig(
                                  max_num_seqs=2), registry=regs[0],
                              metrics_labels={"replica": str(i)}),
                   SamplingParams)
            _serve(JaxEngineCore(models[0], num_blocks=64, block_size=4,
                                 scheduler_config=JaxSchedulerConfig(
                                     max_num_seqs=2), registry=regs[1],
                                 metrics_labels={"replica": str(i)}),
                   JaxSamplingParams)
        got, want = tp.series(regs[0]), tp.series(regs[1])
        excluded = {(n, labels + ("replica",)) if labels else
                    (n, ("replica",)) for n, labels in tp.JAX_ONLY_SERIES}
        assert got == want - excluded
        for name, labels in got:
            if name.startswith("serving_") and name not in (
                    "serving_sampled_tokens_total",
                    "serving_greedy_tokens_total",
                    "serving_lifecycle_events_total",
                    "serving_lifecycle_events_dropped_total"):
                assert "replica" in labels, name
        values = {k: v.get("value") for k, v in regs[0].snapshot().items()}
        jvalues = {k: v.get("value") for k, v in regs[1].snapshot().items()}
        for key, v in values.items():
            # counts of work match; compile counts differ by design (the
            # port's prefill families are eager and record no compile)
            if "_total" in key and not key.startswith(
                    ("serving_compile", "serving_jit")):
                assert v == jvalues[key], key

    def test_serving_metrics_views_backed_by_registry(self):
        m = ServingMetrics()
        m.count("requests_admitted", 2)
        m.observe_ttft(0.02)
        m.observe_inter_token(0.003)
        m.sample_gauges(3, 1, 0.5)
        m.observe_finish(0.5, slo_ms=1000.0)
        assert m.counters["requests_admitted"] == 2
        assert m.latency["time_to_first_token"].calls == 1
        assert m.latency["time_to_first_token"].max == pytest.approx(0.02)
        text = m.prometheus_text()
        assert "serving_requests_admitted_total 2" in text
        assert "serving_queue_depth 3" in text
        assert m.snapshot()["serving_kv_pool_occupancy"]["value"] == 0.5
        bd = m.slo_breakdown()
        assert bd["e2e"]["count"] == 1 and bd["goodput"]["ratio"] == 1.0
        assert "SLO breakdown" in m.summary()

    def test_profile_ops_raises_naming_a12(self, models):
        """(The name is from before the op bus, when the setting raised
        naming A12.)  ``profile_ops=True`` builds, serves, fills the host
        operator table and releases its timer after each step."""
        from paddle_tpu_torch.core import dispatch

        eng = EngineCore(models[1], config=EngineConfig(
            num_blocks=16, block_size=4, profile_ops=True))
        tp.run(eng, SamplingParams, tp.prompts(n=2), max_new=3)
        assert dispatch._op_timer is None
        assert eng.metrics._host_ops.stats["linear"].calls > 0
        assert "Host operator summary" in eng.metrics.summary()


class TestMetricsServer:
    def test_scrape_engine_page_and_close(self, models):
        eng = tp.port_engine(models[1], "unified", audit=False,
                             num_blocks=64)
        tp.run(eng, SamplingParams, tp.prompts(n=2), max_new=3)
        reg = eng.metrics.registry
        srv = start_metrics_server(reg, port=0)
        try:
            assert srv in _httpd._started
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=10)
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == 200
            assert resp.getheader("Content-Type").startswith(
                "text/plain; version=0.0.4")
            assert body == metrics_page(reg)
            text = body.decode()
            for name in ("serving_step_seconds_bucket",
                         "serving_scheduled_tokens_total",
                         "serving_pool_free_blocks",
                         "serving_prefix_cache_hit_tokens_total",
                         "serving_lifecycle_events_total"):
                assert name in text, name
            conn.request("GET", "/healthz")
            assert conn.getresponse().read() == b"ok\n"
            conn.request("GET", "/nope")
            assert conn.getresponse().status == 404
            conn.close()
        finally:
            srv.close()
        srv.close()
        with pytest.raises(OSError):
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=2)
            c.request("GET", "/metrics")
            c.getresponse()

    def test_close_without_start_does_not_hang(self):
        srv = MetricsServer(MetricsRegistry(), port=0)
        srv.close()
        srv.close()
