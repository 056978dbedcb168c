"""The port's step profiler (``paddle_tpu_torch/observability/stepprof.py``)
held to the JAX package's (``tests/test_stepprof.py``'s engine-level
classes), on the CPU.

* **Unit** (``TestStepProfilerUnit``): the record ring and compile table
  stay bounded, the bucket-key cap collapses into ``other``, a disabled
  profiler registers nothing and refuses a capture, one window at a time
  with a partial cancel, the step range is checked — and the same
  sequence of calls gives the same records, tables and Prometheus text
  as the JAX profiler.
* **Engine** (``TestEngineIntegration``): on the legacy churn run (it
  chunks, forks, preempts and recomputes), the port's engine with step
  graphs and under ``disable_graphs()`` records every telemetry view the
  JAX engine records (``torch_obs_pairs.assert_telemetry_matches``); the
  scheduled-token invariant against the scheduler's ``tokens_planned``;
  one compile per capture, each the capture's own wall time, and none for
  the eager prefill families; step profiling on vs off gives the same
  tokens and captures; the series are on the page only when on; the
  utilization report and the summary table.
* **Capture windows** (``TestCaptureWindow``): N annotated engine steps
  with their program children, loadable by the chrome loader, and only
  the steps inside the window; without a CUDA device ``device_trace``
  defaults off, and a forced device trace runs ``torch.profiler`` on the
  host and writes its trace under ``log_dir``.
"""

import json

import pytest

from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import StepProfiler as JaxStepProfiler
from paddle_tpu_torch.observability import (
    CaptureBusy,
    MetricsRegistry,
    StepProfiler,
    load_profiler_result,
)
from paddle_tpu_torch.observability import stepprof as port_stepprof
from paddle_tpu_torch.serving import SamplingParams
from paddle_tpu_torch.serving.graphs import disable_graphs

import torch_obs_pairs as tp


def _drive(sp):
    """A fixed sequence of profiler calls (no engine)."""
    for i in range(6):
        sp.begin_step()
        sp.record_program("decode", (4, 8), scheduled=3, capacity=4,
                          wall_s=0.001, table_width=7)
        if i % 2:
            sp.record_program("chunk", (8, 2), scheduled=5, capacity=8,
                              wall_s=0.002, request="r1", start=4)
        sp.end_step()
    sp.record_compile("decode", (4, 8), 0.5)
    sp.record_compile("chunk", (8, 2), 0.25)


def _strip(rec):
    """A record without its timestamps (the compile rows' and the report's
    ``aot`` entries are compared too)."""
    return {k: v for k, v in rec.items() if k not in ("t", "unix")}


def _record(rec):
    """A step record with its timestamps and its own wall time left
    out."""
    out = dict(_strip(rec), programs=[_strip(p) for p in rec["programs"]])
    del out["wall_s"]
    return out


class TestStepProfilerUnit:
    def test_record_ring_bounded(self):
        sp = StepProfiler(registry=MetricsRegistry(), last_k=4)
        for i in range(10):
            sp.begin_step()
            sp.record_program("decode", (4, 8), scheduled=3, capacity=4,
                              wall_s=0.001)
            sp.end_step()
        recs = sp.records()
        assert len(recs) == 4
        assert recs[-1]["step"] == 10 and sp.steps == 10
        assert recs[-1]["utilization"] == 0.75

    def test_compile_table_bounded(self):
        sp = StepProfiler(registry=MetricsRegistry(), compile_table_max=8)
        for i in range(20):
            sp.record_compile("decode", (i, 8), 0.5)
        assert len(sp.compile_table()) == 8
        assert sp.compile_totals()["decode"]["count"] == 8
        assert sp._compile_c["decode"].value == 20

    def test_bucket_key_cap_collapses_to_other(self):
        sp = StepProfiler(registry=None, enabled=True)
        for i in range(port_stepprof._MAX_BUCKET_KEYS + 10):
            sp.record_program("decode", (i,), scheduled=1, capacity=1,
                              wall_s=0.0)
        assert len(sp._programs) <= port_stepprof._MAX_BUCKET_KEYS + 1
        assert "other" in sp.bucket_set("decode")

    def test_disabled_registers_nothing_and_refuses_capture(self):
        reg = MetricsRegistry()
        sp = StepProfiler(registry=reg, enabled=False)
        sp.begin_step()
        sp.record_program("decode", (4, 8), 3, 4, 0.001)
        sp.record_compile("decode", (4, 8), 0.5)
        sp.end_step()
        assert sp.records() == [] and sp.compile_table() == []
        assert reg.prometheus_text() == ""
        with pytest.raises(RuntimeError):
            sp.arm_capture(4)

    def test_capture_busy_and_cancel_partial(self):
        sp = StepProfiler(registry=MetricsRegistry())
        w = sp.arm_capture(5, device_trace=False)
        with pytest.raises(CaptureBusy):
            sp.arm_capture(2, device_trace=False)
        sp.begin_step()
        sp.record_program("decode", (2, 4), 2, 2, 0.001)
        sp.end_step()
        assert not w.done.is_set()
        sp.cancel_capture(w)
        assert w.done.is_set() and w.complete is False
        assert w.result["captureSteps"] == 1
        assert w.result["complete"] is False
        w2 = sp.arm_capture(1, device_trace=False)
        sp.begin_step()
        sp.end_step()
        assert w2.done.is_set() and w2.complete is True

    def test_steps_range_validated(self):
        sp = StepProfiler(registry=MetricsRegistry())
        with pytest.raises(ValueError):
            sp.arm_capture(0)
        with pytest.raises(ValueError):
            sp.arm_capture(sp.max_capture_steps + 1)

    def test_same_calls_same_tables_and_page_as_jax(self):
        port, jax = MetricsRegistry(), JaxRegistry()
        a = StepProfiler(registry=port, labels={"replica": "0"})
        b = JaxStepProfiler(registry=jax, labels={"replica": "0"})
        _drive(a)
        _drive(b)
        assert [_record(r) for r in a.records()] == \
            [_record(r) for r in b.records()]
        assert a.program_table() == b.program_table()
        assert [_strip(r) for r in a.compile_table()] == \
            [_strip(r) for r in b.compile_table()]
        assert a.utilization_report() == _strip(b.utilization_report())
        assert port.prometheus_text() == jax.prometheus_text()


@pytest.fixture(scope="module")
def legacy():
    return tp.pair("legacy")


class TestEngineIntegration:
    def test_telemetry_matches_jax_engine(self, legacy):
        tp.assert_telemetry_matches(legacy)
        assert legacy["jax"].metrics.counters["preemptions"] > 0

    @pytest.mark.parametrize("mode", ["graphs", "eager"])
    def test_scheduled_token_invariant_and_buckets(self, legacy, mode):
        eng = legacy[mode]
        sp = eng.stepprof
        assert (sp.scheduled_tokens("prefill") + sp.scheduled_tokens("chunk")
                == eng.scheduler.tokens_planned_prefill
                == eng.metrics.counters["prefill_tokens_computed"])
        assert sp.scheduled_tokens("decode") == \
            eng.scheduler.tokens_planned_decode
        assert sp.scheduled_tokens() == eng.scheduler.tokens_planned
        want = {"prefill": set(), "chunk": set(), "decode": set()}
        for b in eng.prefill_buckets | eng.decode_buckets:
            want[b[0]].add("x".join(str(int(v)) for v in b[1:]))
        for prog in ("prefill", "chunk", "decode"):
            assert sp.bucket_set(prog) == want[prog], prog
        for row in sp.program_table():
            assert 0.0 < row["utilization"] <= 1.0, row
        for rec in sp.records():
            if rec["capacity_tokens"]:
                assert 0.0 < rec["utilization"] <= 1.0, rec

    def test_compile_attribution_matches_captures(self, legacy):
        eng = legacy["graphs"]
        table = eng.stepprof.compile_table()
        # one row per capture, the prefill families' included
        assert len(table) == eng.graphs.captures == \
            eng.decode_trace_count + eng.prefill_trace_count
        assert {r["program"] for r in table} == \
            {k[0] for k in eng.graphs.programs} >= {"chunk", "decode"}
        seconds = {(r["program"],) + tuple(int(x) for x in r["bucket"].split(
            "x")): r["seconds"] for r in table}
        for key, prog in eng.graphs.programs.items():
            assert seconds[key[:-1]] == round(prog.capture_seconds, 6)
        assert legacy["eager"].stepprof.compile_table() == []

    def test_profiling_off_same_tokens_and_captures(self, legacy):
        eng = tp.port_engine(legacy["model"], "legacy", audit=False,
                             step_profile=False)
        assert tp.run(eng, SamplingParams, tp.prompts()) == \
            legacy["tokens"]["graphs"]
        assert eng.graphs.captures == legacy["graphs"].graphs.captures
        assert eng.decode_trace_count == legacy["graphs"].decode_trace_count
        text = eng.metrics.prometheus_text()
        for banned in ("serving_step_", "serving_compile",
                       "serving_padding", "serving_scheduled",
                       "serving_bucket_utilization"):
            assert banned not in text, banned
        text = legacy["graphs"].metrics.prometheus_text()
        for name in ("serving_step_seconds", "serving_bucket_utilization",
                     "serving_scheduled_tokens_total",
                     "serving_padding_tokens_total",
                     "serving_compile_seconds_total",
                     "serving_compiles_total"):
            assert name in text, name

    def test_utilization_report_and_summary_table(self, legacy):
        eng = legacy["graphs"]
        rep = eng.stepprof.utilization_report()
        assert rep["scheduled_tokens"] == eng.scheduler.tokens_planned
        assert rep["padding_tokens"] == \
            rep["capacity_tokens"] - rep["scheduled_tokens"]
        assert set(rep["programs"]) <= {"prefill", "chunk", "decode"}
        assert rep["compiles"]["decode"]["count"] == eng.decode_trace_count
        jax_rep = legacy["jax"].stepprof.utilization_report()
        for key in ("steps", "scheduled_tokens", "capacity_tokens",
                    "padding_tokens", "padding_ratio"):
            assert rep[key] == jax_rep[key], key
        report = eng.metrics.summary()
        assert "Bucket utilization / padding waste" in report
        assert "compile attribution" in report


class TestCaptureWindow:
    def test_capture_n_annotated_steps_loadable(self, legacy, tmp_path):
        eng = tp.port_engine(legacy["model"], "legacy", audit=False)
        window = eng.stepprof.arm_capture(5)
        assert window.device_trace is False     # no CUDA device here
        tp.run(eng, SamplingParams, tp.prompts())
        assert window.done.is_set() and window.complete
        result = window.result
        assert result["captureSteps"] == 5
        assert "deviceTraceDir" not in result
        steps = [e for e in result["traceEvents"]
                 if e["name"] == "engine_step"]
        assert len(steps) == 5
        for ev in steps:
            assert ev["ph"] == "X" and ev["args"]["program"]
            assert ev["args"]["bucket"]
            assert 0.0 < ev["args"]["utilization"] <= 1.0
        children = [e for e in result["traceEvents"]
                    if e.get("cat") == "stepprof"
                    and e["name"] in ("prefill", "chunk", "decode")]
        assert children
        step_ids = {e["args"]["id"] for e in steps}
        assert all(e["args"]["parent"] in step_ids for e in children)
        path = tmp_path / "capture.json"
        path.write_text(json.dumps(result))
        loaded = load_profiler_result(str(path))
        assert len(loaded.find("engine_step")) == 5

    def test_capture_excludes_steps_outside_window(self, legacy):
        eng = tp.port_engine(legacy["model"], "unified", audit=False)
        tp.run(eng, SamplingParams, tp.prompts(n=2))
        before = eng.stepprof.steps
        window = eng.stepprof.arm_capture(3, device_trace=False)
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=4))
                for p in tp.prompts(n=2, rng_seed=1)]
        eng.run(max_steps=100)
        assert all(r.finished for r in reqs)
        assert window.result["captureSteps"] == 3
        first = min(e["args"]["step"] for e in window.result["traceEvents"]
                    if e["name"] == "engine_step")
        assert first == before + 1

    def test_forced_device_trace_writes_a_profiler_trace(self, legacy,
                                                         tmp_path):
        eng = tp.port_engine(legacy["model"], "unified", audit=False)
        window = eng.stepprof.arm_capture(2, device_trace=True,
                                          log_dir=str(tmp_path))
        with disable_graphs():
            tp.run(eng, SamplingParams, tp.prompts(n=2), max_new=3)
        result = window.result
        assert result["captureSteps"] == 2 and result["complete"]
        assert "deviceTraceError" not in result
        assert result["deviceTraceDir"] == str(tmp_path)
        trace = json.loads(open(result["deviceTraceFile"]).read())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert any(n and "aten::" in n for n in names)

    def test_failed_device_trace_start_is_reported(self, legacy, tmp_path,
                                                   monkeypatch):
        def refuse():
            raise RuntimeError("profiler already running")

        monkeypatch.setattr(port_stepprof, "_start_device_trace", refuse)
        sp = StepProfiler(registry=MetricsRegistry())
        window = sp.arm_capture(1, device_trace=True, log_dir=str(tmp_path))
        sp.begin_step()
        sp.end_step()
        assert window.result["complete"]
        assert "deviceTraceDir" not in window.result
        assert "profiler already running" in \
            window.result["deviceTraceError"]
