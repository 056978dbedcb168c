"""The port's cross-process tracing primitives
(``paddle_tpu_torch/observability/distrib.py``) against the JAX package's
(``paddle_tpu/observability/distrib.py``).

Every case of ``tests/test_zzzzzzz_distrib.py``'s pure classes
(``TestClockSync`` … ``TestWireStats``, ``TestChromeStitch``) runs through
both packages' classes on the same inputs: the outputs are equal, and the
port's meet the JAX test's assertions.  On top of those:

* random replayed / reordered delta streams merge to the same applied
  set, intervals, mirror and drop counts in both, each seq exactly once;
* ``WireStats`` on a registry renders the same Prometheus text as the
  JAX class on the JAX registry.

Everything here is in-process and deterministic (no worker process).
"""

import json
import time

import numpy as np
import pytest

from paddle_tpu.observability import distrib as jax_distrib
from paddle_tpu.observability import export as jax_export
from paddle_tpu.observability.lifecycle import (
    LifecycleTracker as JaxLifecycleTracker,
)
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.observability import distrib as port_distrib
from paddle_tpu_torch.observability import export as port_export
from paddle_tpu_torch.observability.lifecycle import LifecycleTracker
from paddle_tpu_torch.observability.metrics import MetricsRegistry

# (distrib module, LifecycleTracker, export module, registry class) of
# each package; every case runs once per package and compares
PACKAGES = {
    "jax": (jax_distrib, JaxLifecycleTracker, jax_export, JaxRegistry),
    "port": (port_distrib, LifecycleTracker, port_export, MetricsRegistry),
}


def both(scenario):
    """``scenario(*package)`` for each package; asserts the two results
    are equal and returns the port's."""
    jax_out = scenario(*PACKAGES["jax"])
    port_out = scenario(*PACKAGES["port"])
    assert port_out == jax_out
    return port_out


# --- clock sync -------------------------------------------------------------

class TestClockSync:
    def test_symmetric_exchange_recovers_exact_offset(self):
        def run(d, *_):
            cs = d.ClockSync()
            cs.observe(10.0, 15.001, 15.002, 10.003)
            return cs.offset, cs.rtt, cs.to_router(15.0015)

        offset, rtt, mapped = both(run)
        assert offset == pytest.approx(5.0)
        assert rtt == pytest.approx(0.002)
        assert mapped == pytest.approx(10.0015)

    def test_min_rtt_sample_wins_deterministically(self):
        off = 2.0
        probes = [(0.0, 0.050 + off, 0.051 + off, 0.200),
                  (1.0, 1.001 + off, 1.002 + off, 1.003),
                  (2.0, 2.090 + off, 2.091 + off, 2.100),
                  (3.0, 3.3 + off, 3.4 + off, 3.9),
                  (4.0, 4.0004 + off, 4.0005 + off, 4.0009)]

        def run(d, *_):
            cs = d.ClockSync()
            trail = []
            for p in probes:
                cs.observe(*p)
                trail.append((cs.offset, cs.rtt))
            return trail

        trail = both(run)
        assert trail[2][1] == pytest.approx(0.002)
        assert trail[2][0] == pytest.approx(off, abs=1e-9)
        assert trail[3][0] == pytest.approx(off, abs=1e-9)  # worse: kept
        assert trail[4][1] == pytest.approx(0.0008)          # better: taken

    def test_first_minimal_sample_wins_on_ties(self):
        def run(d, *_):
            cs = d.ClockSync()
            cs.observe(0.0, 0.001 + 1.0, 0.002 + 1.0, 0.003)
            cs.observe(5.0, 5.001 + 9.0, 5.002 + 9.0, 5.003)
            return cs.offset

        assert both(run) == pytest.approx(1.0)

    def test_negative_rtt_sample_is_skipped(self):
        def run(d, *_):
            cs = d.ClockSync()
            cs.observe(0.0, 10.0, 10.5, 0.1)
            return cs.samples, cs.offset, cs.rtt

        assert both(run) == (0, 0.0, 0.0)

    def test_window_is_bounded_and_slides(self):
        def run(d, *_):
            cs = d.ClockSync(window=8)
            cs.observe(0.0, 0.0001, 0.0002, 0.0003)
            for i in range(1, 20):
                t = float(i)
                cs.observe(t, t + 0.01, t + 0.02, t + 0.05)
            return cs.samples, len(cs._samples), cs.rtt

        samples, kept, rtt = both(run)
        assert (samples, kept) == (20, 8)
        assert rtt == pytest.approx(0.04)

    def test_snapshot_shape(self):
        def run(d, *_):
            cs = d.ClockSync()
            empty = cs.snapshot()
            cs.observe(1.0, 3.5, 3.6, 1.2)
            return empty, cs.snapshot()

        empty, one = both(run)
        assert empty == {"offset_s": 0.0, "rtt_s": 0.0, "samples": 0}
        assert one["samples"] == 1


# --- worker outbox / host mirror --------------------------------------------

class TestTelemetryOutbox:
    def test_seqs_monotonic_and_drain_clears(self):
        def run(d, *_):
            ob = d.TelemetryOutbox(capacity=16)
            for i in range(5):
                ob.on_event(f"r{i}", "enqueued", float(i), 7, {"k": i})
            pending = ob.pending
            first = ob.drain()
            return pending, first, ob.pending, ob.drain()

        pending, first, after, second = both(run)
        assert pending == 5 and after == 0
        assert [e["seq"] for e in first["events"]] == [0, 1, 2, 3, 4]
        assert first["dropped"] == 0 and second["events"] == []

    def test_flood_drops_oldest_with_exact_count(self):
        def run(d, *_):
            ob = d.TelemetryOutbox(capacity=8)
            for i in range(100):
                ob.on_event("r", "decode_token", float(i), 0, {})
            return ob.pending, ob.drain()

        pending, drained = both(run)
        assert pending == 8 and drained["dropped"] == 92
        assert [e["seq"] for e in drained["events"]] == list(range(92, 100))

    def test_drain_limit_slices_oldest_first(self):
        def run(d, *_):
            ob = d.TelemetryOutbox(capacity=16)
            for i in range(10):
                ob.on_event("r", "e", float(i), 0, {})
            ob.push("r", "step_record", 11.0, program="unified")
            return ob.drain(limit=3), ob.pending

        drained, pending = both(run)
        assert [e["seq"] for e in drained["events"]] == [0, 1, 2]
        assert pending == 8


class TestMirrorRing:
    def test_flood_stays_bounded_with_exact_drop_count(self):
        def run(d, *_):
            ring = d.MirrorRing(capacity=64)
            for i in range(10_000):
                ring.append({"seq": i})
            return ring.snapshot(), ring.dropped

        snap, dropped = both(run)
        assert len(snap["events"]) == 64
        assert snap["dropped"] == dropped == 10_000 - 64
        assert snap["events"][-1]["seq"] == 9999


# --- delta merge (real LifecycleTrackers) -----------------------------------

def _delta(seqs, rid="req-1", name="decode_token", ts=100.0):
    return {"events": [{"seq": s, "rid": rid, "name": name,
                        "ts": ts + s, "tid": 3, "attrs": {}}
                       for s in seqs],
            "dropped": 0}


def _merger(d, offset=0.0, lc=None, pid=4242):
    clock = d.ClockSync()
    if offset:
        clock.observe(0.0, 0.001 + offset, 0.002 + offset, 0.003)
    mirror = d.MirrorRing(capacity=512)
    return d.DeltaMerger("0", pid, clock, mirror, lambda: lc), mirror


class TestDeltaMerger:
    def test_replay_is_idempotent(self):
        def run(d, *_):
            m, mirror = _merger(d)
            counts = [m.merge(_delta(range(5))), m.merge(_delta(range(5)))]
            return counts, m.applied, mirror.snapshot(), m.snapshot()

        counts, applied, mirror, snap = both(run)
        assert counts == [5, 0] and applied == 5
        assert len(mirror["events"]) == 5 and snap["intervals"] == 1

    def test_out_of_order_batches_all_apply_once(self):
        def run(d, *_):
            m, mirror = _merger(d)
            counts = [m.merge(_delta(range(5, 10))),
                      m.merge(_delta(range(0, 5))),
                      m.merge(_delta(range(0, 10)))]
            return counts, m.snapshot(), len(mirror.snapshot()["events"])

        counts, snap, mirrored = both(run)
        assert counts == [5, 5, 0]
        assert snap == {"applied": 10, "last_seq": 9, "worker_dropped": 0,
                        "intervals": 1}
        assert mirrored == 10

    def test_offset_correction_and_stamping(self):
        def run(d, Tracker, *_):
            lc = Tracker()
            lc.event("req-1", "submitted")
            m, mirror = _merger(d, offset=50.0, lc=lc)
            m.merge(_delta([0], ts=60.0))
            ev = mirror.snapshot()["events"][0]
            merged = [(e.name, round(e.ts, 9), e.attrs)
                      for e in lc.get("req-1").events
                      if "chrome_pid" in e.attrs]
            return ev, merged

        ev, merged = both(run)
        assert ev["ts"] == pytest.approx(10.0, abs=1e-6)
        assert ev["attrs"] == {"replica": "0", "chrome_pid": 4242}
        assert len(merged) == 1
        assert merged[0][1] == pytest.approx(10.0, abs=1e-6)

    def test_rid_less_events_mirror_but_skip_the_tracker(self):
        def run(d, Tracker, *_):
            lc = Tracker()
            m, mirror = _merger(d, lc=lc)
            m.merge({"events": [{"seq": 0, "rid": None,
                                 "name": "step_record", "ts": 1.0,
                                 "tid": 0, "attrs": {}}], "dropped": 0})
            return len(mirror.snapshot()["events"]), \
                lc.get("step_record") is None

        assert both(run) == (1, True)

    def test_worker_dropped_is_cumulative_max(self):
        def run(d, *_):
            m, _ = _merger(d)
            m.merge({"events": [], "dropped": 7})
            m.merge({"events": [], "dropped": 3})
            return m.worker_dropped

        assert both(run) == 7

    def test_interval_list_is_capped(self):
        def run(d, *_):
            m, _ = _merger(d)
            for s in range(0, 400, 2):
                m.merge(_delta([s]))
            return m.snapshot(), d.DeltaMerger._MAX_INTERVALS

        snap, cap = both(run)
        assert snap["intervals"] <= cap and snap["applied"] == 200

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_replay_and_reorder_apply_each_seq_once(self, seed):
        """An outbox's batches delivered over two connections: shuffled,
        with replays, through both packages' mergers.  Each seq applies
        exactly once, and the two packages agree on every output."""
        rng = np.random.default_rng(seed)
        batches = [list(range(i, i + int(n))) for i, n in zip(
            range(0, 200, 8), rng.integers(1, 9, 25))]
        order = [int(i) for i in rng.permutation(len(batches))]
        order += [int(i) for i in rng.integers(0, len(batches), 10)]

        def run(d, Tracker, *_):
            lc = Tracker()
            lc.event("req-1", "submitted")
            m, mirror = _merger(d, offset=3.0, lc=lc)
            applied = [m.merge(dict(_delta(batches[i]),
                                    dropped=int(i))) for i in order]
            seqs = [e["seq"] for e in mirror.snapshot()["events"]]
            return applied, m.snapshot(), sorted(seqs), len(seqs)

        applied, snap, seqs, n = both(run)
        want = sorted({s for b in batches for s in b})
        assert seqs == want and n == len(want)
        assert sum(applied) == snap["applied"] == len(want)
        assert snap["worker_dropped"] == max(order)


# --- wire attribution -------------------------------------------------------

class TestWireStats:
    def test_share_math_is_exact(self):
        stamps = {"recv": 100.000, "eng0": 100.001,
                  "eng1": 100.007, "reply": 100.008}

        def run(d, *_):
            ws = d.WireStats()
            ws.observe(50.000, 50.010, stamps, program="decode")
            return ws.report()

        rep = both(run)
        assert rep["steps"] == 1
        assert rep["wire_s"] == pytest.approx(0.002)
        assert rep["queue_s"] == pytest.approx(0.001)
        assert rep["engine_s"] == pytest.approx(0.006)
        assert rep["shares"]["wire"] == pytest.approx(0.3, abs=1e-3)
        assert rep["shares"]["engine"] == pytest.approx(0.6, abs=1e-3)
        assert rep["shares"]["host"] == pytest.approx(0.1, abs=1e-3)
        assert "decode" in rep["per_program"]

    def test_partial_stamps_are_skipped(self):
        def run(d, *_):
            ws = d.WireStats()
            ws.observe(0.0, 1.0, None)
            ws.observe(0.0, 1.0, {"recv": 0.1})
            return ws.steps

        assert both(run) == 0

    def test_per_program_table_is_bounded(self):
        stamps = {"recv": 0.0, "eng0": 0.0, "eng1": 0.5, "reply": 0.9}

        def run(d, *_):
            ws = d.WireStats()
            for i in range(100):
                ws.observe(0.0, 1.0, stamps, program=f"prog-{i}")
            return ws.report()["per_program"], d.WireStats._MAX_PROGRAMS

        per, cap = both(run)
        assert len(per) == cap + 1
        assert per["_other"]["steps"] == 100 - cap

    def test_registry_series_render_as_the_jax_ones(self):
        rng = np.random.default_rng(5)
        rounds = []
        for _ in range(40):
            recv = float(rng.uniform(0, 1))
            eng0 = recv + float(rng.uniform(0, 0.002))
            eng1 = eng0 + float(rng.uniform(0, 0.05))
            reply = eng1 + float(rng.uniform(0, 0.001))
            t0 = float(rng.uniform(5, 6))
            t3 = t0 + (reply - recv) + float(rng.uniform(0, 0.02))
            rounds.append((t0, t3, {"recv": recv, "eng0": eng0,
                                    "eng1": eng1, "reply": reply}))

        def run(d, _tracker, _export, Registry):
            reg = Registry()
            ws = d.WireStats(registry=reg, labels={"replica": "0"})
            for t0, t3, stamps in rounds:
                ws.observe(t0, t3, stamps, program="unified")
            return reg.prometheus_text(), ws.report()

        page, rep = both(run)
        assert "serving_wire_rtt_seconds" in page
        assert "serving_wire_queue_seconds" in page
        assert rep["steps"] == 40

    def test_metric_names_match(self):
        assert port_distrib.METRIC_NAMES == jax_distrib.METRIC_NAMES


# --- stitched chrome export -------------------------------------------------

class TestChromeStitch:
    def test_cross_process_trace_roundtrip(self, tmp_path):
        """Router events + merged worker events export as ONE chrome
        trace in each package: worker spans on their own pid row (named
        metadata), offset-corrected INSIDE the router's request span,
        and the stock loader round-trips the nesting."""
        def run(d, Tracker, export, _registry):
            lc = Tracker()
            rid = "cmpl-stitch"
            lc.event(rid, "submitted")
            lc.event(rid, "route", replica="0")
            clock = d.ClockSync()
            base = time.perf_counter()
            clock.observe(base, base + 1000.0, base + 1000.0, base)
            m = d.DeltaMerger("0", 7777, clock, d.MirrorRing(), lambda: lc)
            m.merge({"events": [
                {"seq": 0, "rid": rid, "name": "enqueued",
                 "ts": base + 1000.0 + 1e-4, "tid": 9, "attrs": {}},
                {"seq": 1, "rid": rid, "name": "first_token",
                 "ts": base + 1000.0 + 2e-4, "tid": 9, "attrs": {}},
            ], "dropped": 0})
            time.sleep(0.002)
            lc.event(rid, "finish", reason="length")
            doc = export.chrome_trace_dict(lc.get(rid).chrome_spans())
            pids = {ev["pid"] for ev in doc["traceEvents"]
                    if ev.get("ph") in ("X", "i")}
            meta = {ev["pid"]: ev["args"]["name"]
                    for ev in doc["traceEvents"]
                    if ev.get("ph") == "M" and ev["name"] == "process_name"}
            path = tmp_path / f"{export.__name__}.json"
            path.write_text(json.dumps(doc))
            res = export.load_profiler_result(str(path))
            roots = [r for r in res.roots if r.name.startswith("request ")]
            lo, hi = roots[0].ts, roots[0].ts + roots[0].dur
            worker = [e for e in res.events
                      if e.attrs.get("chrome_pid") == 7777]
            return {"worker_in_pids": 7777 in pids, "rows": len(pids),
                    "meta": meta[7777].split(" ", 1)[1],
                    "roots": len(roots),
                    "worker_events": sorted(e.name for e in worker),
                    "nested": all(lo <= e.ts <= hi for e in worker)}

        out = both(run)
        assert out["worker_in_pids"] and out["rows"] >= 2
        assert out["meta"] == "worker pid=7777"
        assert out["roots"] == 1
        assert out["worker_events"] == ["enqueued", "first_token"]
        assert out["nested"], "a worker span sits outside the request span"
