"""Cross-process serving worker (the port of ``paddle_tpu/serving/worker.py``).

``python -m paddle_tpu_torch.serving.worker`` wraps ONE
:class:`~paddle_tpu_torch.serving.EngineCore` behind the fleet wire
protocol (``serving/wire.py``): the router process drives it through a
:class:`~paddle_tpu_torch.serving.procfleet.WorkerEngineProxy` exactly the
way an in-process fleet drives a live engine, so FleetRouter and
FleetSupervisor transfer unchanged.

Boot protocol: the worker binds an ephemeral localhost port, builds its
engine (optionally onto a shared ``--aot-path`` artifact, whose manifest
``model_hash`` becomes the handshake's ``aot_hash``; ``--warm`` captures
the artifact's whole universe before the ready line), loads every CUDA
kernel that engine will launch, then prints ONE machine-readable ready
line to stdout::

    PADDLE_TPU_WORKER_READY port=<p> pid=<pid> aot_hash=<h> boot_s=<s>

The parent reads that line to learn the port; everything after it is
free-form logging.  ``boot_s`` spans the engine build, the kernels'
build and load and the warm, so no step and no heartbeat ever waits on
``nvcc`` or a capture.  A worker booted off an artifact loads the kernels
from the artifact's ``kernels/`` and runs no ``nvcc``.
With ``--compile-cache DIR`` the kernels are built into (or loaded from)
``DIR`` instead of ``paddle_tpu_torch/_build/``, under a cross-process
lock on the directory, so N sibling workers run ``nvcc`` once; the boot
log reports the count of built libraries before and after::

    PADDLE_TPU_COMPILE_CACHE dir=<d> entries_before=<a> entries_after=<b>

On the CPU no kernel is built and both counts are 0.

Connection model: one ``engine`` connection (submit/abort/step — driven
by the parent replica's engine thread, strictly serial) plus any number
of ``control`` connections (health/debug/drain — heartbeats and HTTP
debug handlers).  Engine state is guarded by one lock, which the health
reply never takes; a handshake or frame error poisons only its
connection (the process survives), while an engine-step failure is fatal
by design: the worker reports ``step_error`` with its traceback plus any
newly-fired fault-plan indexes, then exits so the supervisor's rebuild
respawns a clean process.

The port's departures from the JAX worker:

* **Spec keys** ``preset`` (``"tiny"``, the default, or ``"llama3_8b"``),
  ``dtype`` (``"float32"``, the default, or ``"bfloat16"``: the model's and
  the pools'), ``device`` (``"cpu"``, or the card when absent), ``weights``
  (the path of an ``.npz`` of the JAX model's numpy parameters, loaded
  through :func:`~paddle_tpu_torch.convert.llama_from_paddle_tpu`) and
  ``max_seq_len`` (the model's ``max_position_embeddings``).  Without
  ``weights`` the model is drawn from ``torch.Generator(device)`` seeded
  with ``seed``, as the server CLI's toy model is.  The JAX worker builds
  only the tiny model; the port's must also run Llama-3-8B at full width
  on the card and take the JAX package's weights on the CPU.  The keys
  ride the handshake's deployment identity, so a worker built otherwise
  than the router expects answers ``deploy_mismatch``.
* **``launches`` and ``captures`` fields** in the ``describe`` debug
  reply.  ``captures``: the step graphs this process's engine captured
  (with an artifact bound the trace counters stay 0, and this shows
  whether serving captured anything after a warm boot).  ``launches``: this
  process's ragged and decode kernel launch counts by route, beside the
  launches its engine's steps call for (once per layer per unified step;
  once per layer per decode step and burst iteration), so the router can
  check the launch rule for a process whose counters it cannot read.
* **Hand-off timings**: ``kv_run_begin`` and ``kv_import_ok`` carry
  ``t``, the seconds of each part of the export (gather, device-to-host,
  digest, framing) and of the import (receive, assemble, verify, pool
  import, scatter); a router that does not read them loses nothing.
* **``mp`` > 1**: the JAX worker builds an mp mesh in its one process.
  This worker is the controller of a world of ``mp`` ranks of its own
  (``serving/tp.py``): it starts ranks 1..mp-1 as follower processes on
  its own rendezvous address (``--tp-master``, which the process fleet
  gives each spawn; a free local port without it), joins the world and
  lays it out at mp before its model, and each follower builds its shard
  of the same model and follows the worker's steps.  The followers exit
  when the worker dies, even by ``kill -9``; when a follower dies, the
  worker fails its step or, idle, notices the exit, and exits for a
  respawn, which starts a fresh world.  ``describe``'s ``launches`` then
  sum every rank's counters, each rank's in ``ranks``; the deployment
  identity (``hello_ok``, ``describe``) carries ``mp``, as the JAX
  worker's does.
* ``--warm`` captures the step graphs of the artifact's universe on this
  worker's engine (the JAX worker executes the loaded programs once), and
  needs ``--aot-path``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
import traceback
from typing import Dict, Optional

from . import wire

# metric names this module owns
METRIC_NAMES = (
    "serving_worker_connections_total",
    "serving_worker_boot_seconds",
)

from .wire import CACHE_PREFIX, READY_PREFIX  # noqa: E402,F401  (canonical
# home is wire.py; re-exported here since they are worker protocol)

# engine-spec keys forwarded into EngineConfig (everything else in the
# spec is scheduler/model shape); a bounded vocabulary so a drifted
# parent fails loudly instead of silently half-configuring the worker
_ENGINE_KEYS = ("lifecycle_events", "decode_event_sample", "step_profile",
                "cache_stats", "history", "unified_step", "prefix_cache",
                "burst_steps", "role")
_SPEC_KEYS = _ENGINE_KEYS + (
    "layers", "num_blocks", "block_size", "max_num_seqs",
    "max_prefill_tokens_per_step", "max_tokens_per_step", "seed",
    "audit_enabled", "audit_sample_every", "telemetry", "mp",
    "spec") + wire.MODEL_KEYS

_PRESETS = ("tiny", "llama3_8b")
_DTYPES = ("float32", "bfloat16")


def _model(spec: Dict, dev):
    import numpy as np
    import torch

    from ..convert import llama_from_paddle_tpu
    from ..models import LlamaConfig, LlamaForCausalLM

    preset = spec.get("preset") or "tiny"
    if preset not in _PRESETS:
        raise ValueError(f"unknown model preset {preset!r} "
                         f"(expected one of {_PRESETS})")
    kw = {"num_hidden_layers": int(spec.get("layers", 2))}
    if spec.get("max_seq_len") is not None:
        kw["max_position_embeddings"] = int(spec["max_seq_len"])
    cfg = getattr(LlamaConfig, preset)(**kw)
    dtype = getattr(torch, spec.get("dtype") or "float32")
    if spec.get("weights"):
        with np.load(spec["weights"]) as npz:
            state = {k: npz[k] for k in npz.files}
        return llama_from_paddle_tpu(state, cfg, device=dev, dtype=dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(spec.get("seed", 0)))
    return LlamaForCausalLM(cfg, device=dev, dtype=dtype, generator=gen)


def build_engine(spec: Dict, replica: int, registry, aot=None):
    """Deterministic engine factory, mirroring the server's ``_toy_fleet``
    shape: one model instance, per-replica metric labels.  The spec is
    the SAME dict the router's proxies template their gate attributes
    from, so the heterogeneity gates in ``FleetRouter.__init__`` hold
    across the process boundary.  At ``mp`` > 1 every rank of the
    worker's world calls it after :func:`join_world`, and builds its
    shard."""
    unknown = sorted(set(spec) - set(_SPEC_KEYS))
    if unknown:
        raise ValueError(f"unknown engine-spec key(s) {unknown} — "
                         "router/worker version drift")
    mp = int(spec.get("mp", 1) or 1)
    if (spec.get("dtype") or "float32") not in _DTYPES:
        raise ValueError(f"unknown dtype {spec['dtype']!r} "
                         f"(expected one of {_DTYPES})")
    import torch

    from ..device import resolve_device
    from ..observability.audit import AuditConfig
    from .engine import EngineConfig, EngineCore
    from .scheduler import SchedulerConfig

    spec_decode = None
    if spec.get("spec"):
        from .spec import SpecConfig

        spec_decode = SpecConfig(**spec["spec"])
    model = _model(spec, resolve_device(spec.get("device")))
    audit = None
    if spec.get("audit_enabled"):
        audit = AuditConfig(
            enabled=True,
            sample_every=max(1, int(spec.get("audit_sample_every", 1))))
    kwargs = {k: spec[k] for k in _ENGINE_KEYS if k in spec}
    cfg = EngineConfig(
        num_blocks=int(spec.get("num_blocks", 64)),
        block_size=int(spec.get("block_size", 4)),
        dtype=getattr(torch, spec.get("dtype") or "float32"),
        mp=mp if mp > 1 else None,
        scheduler=SchedulerConfig(
            max_num_seqs=int(spec.get("max_num_seqs", 4)),
            max_prefill_tokens_per_step=spec.get(
                "max_prefill_tokens_per_step"),
            max_tokens_per_step=spec.get("max_tokens_per_step")),
        audit=audit, aot=aot, spec=spec_decode, **kwargs)
    return EngineCore(model, config=cfg, registry=registry,
                      metrics_labels={"replica": str(replica)})


def launch_report(engine) -> Dict:
    """This process's kernel launches by route since its ready line, and
    those its engine's steps call for: the ragged kernel once per layer
    per unified step, the decode kernel once per layer per decode step
    and burst iteration (the legacy prefill families and the hand-off
    launch neither).  At mp > 1 every rank of the worker's world reports
    (``ranks``, the worker's first: its pid, launches, peak card memory
    and due from its forwards) and ``ragged``, ``decode`` and ``due`` are
    their sums."""
    from .tp import launch_counts, rank_report

    layers = engine.model.config.num_hidden_layers
    decode_steps = engine.metrics.histogram("decode_step").count
    burst_iters = int(engine._burst_counters["length"].sum)
    out = {**launch_counts(),
           "due": {"ragged": engine.ragged_launches * layers,
                   "decode": (decode_steps + burst_iters) * layers},
           "steps": {"unified": engine.ragged_launches,
                     "decode": decode_steps,
                     "burst_iterations": burst_iters}}
    if engine.tp is None:
        return out
    ranks = []
    for r in engine.tp.report(rank_report(engine)):
        prog = r.pop("programs")
        r["due"] = {"ragged": prog.get("ragged", 0) * layers,
                    "decode": (prog.get("decode", 0)
                               + prog.get("burst", 0)) * layers}
        ranks.append(r)
    out["ranks"] = ranks
    for key in ("ragged", "decode", "due"):
        out[key] = {k: sum(r[key][k] for r in ranks) for k in ranks[0][key]}
    return out


def join_world(spec: Dict) -> None:
    """Join the worker's world (launched by :func:`main`) and lay it out
    at the spec's mp: every rank, before its model."""
    from .. import device as _device
    from ..distributed import env, topology

    if spec.get("device") == "cpu":
        _device.set_device("cpu")
    env.init_parallel_env()
    topology.init_mesh(mp=int(spec["mp"]))


def follower_main(spec: Dict, replica: int,
                  compile_cache: Optional[str]) -> None:
    """A follower rank of a worker at mp > 1 (started by the worker): its
    shard of the worker's engine, following the worker's steps until the
    worker releases it."""
    import signal

    from ..distributed import env
    from ..observability.metrics import MetricsRegistry
    from ..ops import _build
    from .tp import follow

    # the worker stops this rank (and it exits when the worker dies)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    if compile_cache:
        _build.set_build_dir(compile_cache)
    join_world(spec)
    follow(build_engine(spec, replica, MetricsRegistry()))
    env.destroy_process_group()


def _watch_followers(ctx, host: "WorkerHost") -> None:
    """Fail the worker when a follower exits before the worker released
    it: the world lost a rank, so the worker exits for a respawn."""
    import multiprocessing.connection as mpc

    mpc.wait([p.sentinel for p in ctx.processes])
    if host.dead.is_set():
        return                  # the worker is stopping its world itself
    codes = [p.exitcode for p in ctx.processes]
    sys.stderr.write(f"[worker {host.replica}] a follower rank exited "
                     f"({codes}); exiting for respawn\n")
    host.exit_code = 3
    host.dead.set()


def _stop_world(host: "WorkerHost", ctx) -> int:
    """The worker's exit at mp > 1: with every follower alive and no
    failure, release them (between steps), join them and leave the world
    (a follower's failure is the worker's); else leave at once, without
    tearing down a world that lost a rank."""
    from ..distributed import env

    if host.exit_code == 0 and all(p.is_alive() for p in ctx.processes):
        with host.lock:
            host.engine.tp.release()
        ctx.join(timeout=120)
        env.destroy_process_group()
        return 0
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(host.exit_code or 3)


class WorkerHost:
    """The serving side of the wire: owns the engine, the lock that
    serializes engine mutation, and the fired-fault bookkeeping the
    router needs to keep its exactly-once chaos accounting across
    respawns."""

    def __init__(self, engine, registry, replica: int,
                 aot_hash: Optional[str], max_frame: int,
                 telemetry: bool = False,
                 deploy: Optional[Dict] = None):
        self.engine = engine
        self.registry = registry
        self.replica = int(replica)
        self.aot_hash = aot_hash
        self.max_frame = max_frame
        # deployment identity: mesh-slice shape + spec-decoding config +
        # role (+ the port's model identity), validated against every
        # hello — a router driving a different deployment is refused
        # with a typed deploy_mismatch, connection-scoped like
        # aot_mismatch
        self.deploy = deploy
        # telemetry streaming: buffer this engine's lifecycle events
        # (sequence-numbered, bounded) and piggyback deltas onto
        # step/health replies — the router merges them into ITS tracker
        self.telemetry = bool(telemetry)
        self.outbox = None
        if self.telemetry and getattr(engine, "lifecycle", None) is not None:
            from ..observability.distrib import TelemetryOutbox

            self.outbox = TelemetryOutbox()
            engine.lifecycle.add_listener(self.outbox.on_event)
        self.lock = threading.RLock()
        self.started = time.time()
        self.draining = False
        self.dead = threading.Event()  # set => main exits the process
        self.exit_code = 0
        self._live: Dict = {}  # rid -> engine Request, evicted on finish
        self._fired_reported: set = set()  # unbounded-ok: subset of the frozen fault plan's finite index set
        self._conns = registry.counter(
            "serving_worker_connections_total",
            "accepted wire connections by role", role="engine",
            replica=str(replica))
        self._conns_ctl = registry.counter(
            "serving_worker_connections_total",
            "accepted wire connections by role", role="control",
            replica=str(replica))

    # --- fault bookkeeping --------------------------------------------------
    def _fired_delta(self):
        fi = self.engine._fault
        if fi is None:
            return []
        fired = set(fi.snapshot().get("fired_plan_indexes", []))
        delta = sorted(fired - self._fired_reported)
        self._fired_reported |= fired
        return delta

    def _drain(self, limit: int = 256) -> Optional[Dict]:
        """Pop a bounded telemetry delta for piggybacking (``None``
        when streaming is off or there is nothing to report)."""
        if self.outbox is None:
            return None
        delta = self.outbox.drain(limit)
        if not delta["events"] and not delta["dropped"]:
            return None
        return delta

    # --- frame handlers -----------------------------------------------------
    def _state(self) -> Dict:
        eng = self.engine
        return {
            "step_seq": int(eng.step_seq),
            "has_work": bool(eng.scheduler.has_work()),
            "queue_depth": int(eng.scheduler.queue_depth),
            "occupancy": float(eng.kv.occupancy()),
            "degraded": bool(eng.audit.degraded),
        }

    def handle_submit(self, frame: Dict) -> Dict:
        from .request import SamplingParams

        if self.draining:
            return wire.error_frame("protocol",
                                    "worker is draining; not admitting")
        sp = frame.get("sampling") or {}
        sampling = SamplingParams(
            max_new_tokens=int(sp.get("max_new_tokens", 16)),
            temperature=float(sp.get("temperature", 0.0)),
            top_k=int(sp.get("top_k", 0)),
            top_p=float(sp.get("top_p", 1.0)),
            eos_token_id=sp.get("eos_token_id"),
            seed=int(sp.get("seed", 0)))
        hashes = frame.get("prefix_hashes")
        if hashes is not None:
            hashes = [bytes.fromhex(h) for h in hashes]
        resume = frame.get("resume_tokens")
        with self.lock:
            req = self.engine.add_request(
                [int(t) for t in frame["prompt_ids"]], sampling=sampling,
                request_id=frame["rid"],
                priority=int(frame.get("priority", 0)),
                trace_id=str(frame.get("trace_id", frame["rid"])),
                prefix_hashes=hashes, slo_ms=frame.get("slo_ms"),
                resume_tokens=([int(t) for t in resume]
                               if resume else None))
            if frame.get("arrival") is not None:
                # migrated request: its e2e span starts at the ORIGINAL
                # arrival stamp (perf_counter is CLOCK_MONOTONIC
                # machine-wide, so the donor worker's stamp is valid in
                # this process too)
                req.arrival_time = float(frame["arrival"])
            self._live[frame["rid"]] = req
        return {"type": "submit_ok", "rid": frame["rid"],
                "telemetry": self._drain(limit=64)}

    def handle_abort(self, frame: Dict) -> Dict:
        from .request import FinishReason

        reason = FinishReason(frame.get("reason", "abort"))
        with self.lock:
            ok = self.engine.abort_request(frame["rid"], reason)
            if ok:
                self._live.pop(frame["rid"], None)
        return {"type": "abort_ok", "rid": frame["rid"], "ok": bool(ok),
                "telemetry": self._drain(limit=64)}

    def handle_step(self, conn: wire.Connection,
                    t_recv: Optional[float] = None) -> None:
        """One engine step, ONE reply: ``step_done`` carries the step's
        full emission batch (``emitted``: rid -> [tokens], possibly many
        per row when the engine ran a decode burst — the wire cost of a
        burst is one round-trip regardless of N), the post-step
        state + fired-fault delta + a full metrics dump (the router
        merges it before ticking the shared history, so alert rules see
        fresh cross-process values deterministically), plus — with
        telemetry streaming on — the worker-clock timestamps
        (recv/eng0/eng1/reply) feeding the router's wire-latency
        attribution, the pending lifecycle-event delta, and the step's
        stepprof record.  A step failure sends ``step_error`` and kills
        the process — the supervisor's respawn path owns recovery."""
        if t_recv is None:
            t_recv = time.perf_counter()
        with self.lock:
            eng = self.engine
            if not eng.scheduler.has_work():
                now = time.perf_counter()
                conn.send({"type": "step_done", "stepped": False,
                           "finished": {}, "fired": self._fired_delta(),
                           "metrics": wire.dump_registry(self.registry),
                           "telemetry": self._drain(),
                           "t": {"recv": t_recv, "eng0": now, "eng1": now,
                                 "reply": time.perf_counter()},
                           **self._state()})
                return
            before = {rid: len(req.output_tokens)
                      for rid, req in self._live.items()}
            t_eng0 = time.perf_counter()
            try:
                eng.step()
            except Exception:
                err = traceback.format_exc()
                try:
                    # final drain: ship everything buffered so the
                    # router's mirror holds the events leading into the
                    # death before this process exits
                    conn.send({"type": "step_error", "error": err,
                               "fired": self._fired_delta(),
                               "telemetry": self._drain(limit=1024),
                               "metrics": wire.dump_registry(
                                   self.registry)})
                except wire.WireError:
                    pass  # swallow-ok: the parent's socket died first; its heartbeat/EOF path already reports this death
                sys.stderr.write(f"[worker {self.replica}] engine step "
                                 f"failed; exiting for respawn:\n{err}")
                self.exit_code = 3
                self.dead.set()
                return
            t_eng1 = time.perf_counter()
            finished: Dict = {}
            emitted: Dict = {}
            for rid, req in list(self._live.items()):
                toks = req.output_tokens
                fresh = toks[before.get(rid, 0):]
                if fresh:
                    emitted[rid] = [int(tok) for tok in fresh]
                if req.finished:
                    finished[rid] = (req.finish_reason.value
                                     if req.finish_reason else None)
                    del self._live[rid]
            conn.send({"type": "step_done", "stepped": True,
                       "emitted": emitted,
                       "finished": finished,
                       "fired": self._fired_delta(),
                       "metrics": wire.dump_registry(self.registry),
                       "telemetry": self._drain(),
                       "step_record": eng.stepprof.last_record(),
                       "t": {"recv": t_recv, "eng0": t_eng0,
                             "eng1": t_eng1,
                             "reply": time.perf_counter()},
                       **self._state()})

    # --- KV hand-off ----------------------------------------------------------
    def handle_kv_export(self, conn: wire.Connection, frame: Dict) -> None:
        """Serialize a request's computed prompt KV (or a hot prefix
        chain, when ``chain`` is given) and stream it back as
        ``kv_run_begin`` + chunked ``kv_run_chunk`` frames.  An empty /
        untransferable run answers one ``kv_export_ok empty`` frame —
        the router falls back to re-prefill."""
        from . import handoff

        timings: Dict[str, float] = {}
        with self.lock:
            try:
                if frame.get("chain") is not None:
                    mb = frame.get("max_blocks")
                    run = handoff.export_prefix_run(
                        self.engine, bytes.fromhex(str(frame["chain"])),
                        max_blocks=(int(mb) if mb is not None else None))
                else:
                    run = handoff.export_request_run(
                        self.engine, frame["rid"], timings=timings)
            except Exception as e:
                conn.send(wire.error_frame("protocol",
                                           f"kv export failed: {e}"))
                return
        if run is None:
            conn.send({"type": "kv_export_ok", "empty": True})
            return
        t0 = time.perf_counter()
        frames = handoff.run_to_frames(run)
        timings["framing_s"] = time.perf_counter() - t0
        frames[0]["t"] = timings   # the port's: the export's parts
        for out in frames:
            conn.send(out)

    def handle_kv_import(self, conn: wire.Connection, begin: Dict) -> None:
        """Assemble a streamed KV run (the chunk frames follow ``begin``
        on this same strictly-serial connection) and admit it into the
        pool.  Corrupt/truncated streams answer the usual TYPED wire
        errors and the process keeps serving — frame boundaries stay
        intact because the declared chunk count is always consumed."""
        from . import handoff

        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        chunks = []
        declared = max(0, min(int(begin.get("chunks", 0) or 0), 4096))
        try:
            for _ in range(declared):
                chunks.append(conn.recv())
        except wire.FrameError as e:
            try:
                conn.send(wire.error_frame(e.kind, str(e)))
            except wire.WireError:
                pass  # swallow-ok: peer already gone; recv counted the error
            raise  # connection is desynced mid-stream: let the caller close it
        timings["receive_s"] = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            run = handoff.run_from_frames(begin, chunks)
            timings["assemble_s"] = time.perf_counter() - t0
            with self.lock:
                placed = handoff.import_run(self.engine, run,
                                            timings=timings)
        except wire.FrameError as e:
            conn.send(wire.error_frame(e.kind, str(e)))
            return
        except handoff.HandoffError as e:
            conn.send(wire.error_frame("malformed", str(e)))
            return
        conn.send({"type": "kv_import_ok",
                   "placed": (None if placed is None else int(placed)),
                   "t": timings})   # the port's: the import's parts

    def handle_kv_detach(self, frame: Dict) -> Dict:
        with self.lock:
            ok = self.engine.detach_request(frame["rid"])
            if ok:
                self._live.pop(frame["rid"], None)
        return {"type": "kv_detach_ok", "rid": frame["rid"],
                "ok": bool(ok)}

    def handle_debug(self, frame: Dict) -> Dict:
        what = frame.get("what")
        eng = self.engine
        with self.lock:
            if what == "audit":
                data = eng.audit.snapshot()
            elif what == "cache":
                data = eng.cachestat.snapshot()
            elif what == "cache_timeline":
                data = eng.cachestat.timeline()
            elif what == "compile_table":
                data = eng.stepprof.compile_table()
            elif what == "compile_totals":
                data = eng.stepprof.compile_totals()
            elif what == "aot":
                data = eng.stepprof.aot_snapshot()
            elif what == "records":
                data = eng.stepprof.records()
            elif what == "metrics":
                data = wire.dump_registry(self.registry)
            elif what == "describe":
                data = {"pid": os.getpid(), "replica": self.replica,
                        "aot_hash": self.aot_hash,
                        "deploy": wire.canonical_deploy(self.deploy),
                        "traces": {
                            "prefill": eng.prefill_trace_count,
                            "decode": eng.decode_trace_count,
                            "ragged": eng.ragged_trace_count,
                            "burst": eng.burst_trace_count},
                        "launches": launch_report(eng),
                        "captures": eng.graphs.captures,
                        **self._state()}
            else:
                return wire.error_frame(
                    "protocol", f"unknown debug target {what!r}")
        return {"type": "debug_ok", "what": what, "data": data}

    def handle_set_fault(self, frame: Dict) -> Dict:
        from .faultinject import FaultInjector, FaultPlan

        plan_obj = frame.get("plan")
        with self.lock:
            if not plan_obj:
                self.engine.set_fault_injector(None)
                return {"type": "ok"}
            plan = FaultPlan.from_obj(plan_obj)
            fi = FaultInjector(plan, replica=str(self.replica),
                               lifecycle=self.engine.lifecycle,
                               registry=self.registry)
            fi.mark_fired(frame.get("fired") or [])
            self._fired_reported = set(
                fi.snapshot().get("fired_plan_indexes", []))
            self.engine.set_fault_injector(fi)
        return {"type": "ok"}

    def health(self, frame: Dict, t_recv: float) -> Dict:
        """The heartbeat reply.  It reads ``step_seq`` WITHOUT the engine
        lock: a step (or a graph capture inside one) may hold the lock
        for longer than the router's heartbeat timeout, and a busy worker
        is not a dead one."""
        reply = {"type": "health_ok", "pid": os.getpid(),
                 "step_seq": int(self.engine.step_seq),
                 "draining": self.draining,
                 "uptime_s": round(time.time() - self.started, 3),
                 "telemetry": self._drain(limit=128)}
        if frame.get("t0") is not None:
            # clock-sync probe: echo the router's t0, stamp our receipt
            # (t1) and just-before-send (t2) so the router completes the
            # (t0,t1,t2,t3) NTP sample on receipt
            reply["t0"] = frame["t0"]
            reply["t1"] = t_recv
            reply["t2"] = time.perf_counter()
        return reply

    # --- connection loops ---------------------------------------------------
    def serve_connection(self, sock: socket.socket) -> None:
        labels = {"replica": str(self.replica)}
        conn = wire.Connection(sock, registry=self.registry,
                               labels=labels, side="worker",
                               max_frame=self.max_frame)
        try:
            conn.settimeout(60.0)
            try:
                hello = conn.recv()
                role = wire.check_hello(hello, self.aot_hash,
                                        deploy=self.deploy)
            except wire.HandshakeMismatch as e:
                conn.count_error(e.code)
                conn.send(wire.error_frame(e.code, str(e)))
                return
            except wire.FrameError as e:
                try:
                    conn.send(wire.error_frame(e.kind, str(e)))
                except wire.WireError:
                    pass  # swallow-ok: peer already gone; the frame error itself was counted by recv
                return
            except wire.ConnectionClosed:
                return  # swallow-ok: counted by recv; a port probe, not a peer
            conn.send({"type": "hello_ok", "version": wire.WIRE_VERSION,
                       "replica": self.replica, "pid": os.getpid(),
                       "aot_hash": self.aot_hash,
                       "deploy": wire.canonical_deploy(self.deploy)})
            (self._conns if role == "engine" else self._conns_ctl).inc()
            conn.settimeout(None)
            while not self.dead.is_set():
                try:
                    frame = conn.recv()
                except wire.ConnectionClosed:
                    return  # swallow-ok: clean peer disconnect at a frame boundary, counted by recv
                except wire.FrameError as e:
                    # per-connection error isolation: answer, close this
                    # connection, keep the process serving others
                    try:
                        conn.send(wire.error_frame(e.kind, str(e)))
                    except wire.WireError:
                        pass  # swallow-ok: peer already gone; the frame error itself was counted by recv
                    return
                self.dispatch(conn, frame)
        except wire.WireError:
            return  # swallow-ok: counted at the Connection layer; connection-scoped by design
        except Exception:
            sys.stderr.write(f"[worker {self.replica}] connection "
                             f"handler failed:\n{traceback.format_exc()}")
        finally:
            conn.close()

    def dispatch(self, conn: wire.Connection, frame: Dict) -> None:
        # dispatch-entry timestamp: the NTP-style clock probe's t1 and
        # the wire-attribution "recv" stamp (worker monotonic clock)
        t_recv = time.perf_counter()
        t = frame.get("type")
        if t == "step":
            self.handle_step(conn, t_recv)
        elif t == "submit":
            conn.send(self.handle_submit(frame))
        elif t == "abort":
            conn.send(self.handle_abort(frame))
        elif t == "health":
            conn.send(self.health(frame, t_recv))
        elif t == "kv_export":
            self.handle_kv_export(conn, frame)
        elif t == "hot_prefixes":
            k = frame.get("k")
            with self.lock:
                rows = self.engine.hot_prefixes(
                    int(k) if k is not None else None)
            conn.send({"type": "hot_prefixes_ok", "rows": rows})
        elif t == "kv_run_begin":
            self.handle_kv_import(conn, frame)
        elif t == "kv_detach":
            conn.send(self.handle_kv_detach(frame))
        elif t == "debug":
            conn.send(self.handle_debug(frame))
        elif t == "set_fault":
            conn.send(self.handle_set_fault(frame))
        elif t == "drain":
            self.draining = True
            with self.lock:
                pending = len(self._live)
            conn.send({"type": "drain_ok", "pending": pending})
        elif t == "shutdown":
            conn.send({"type": "ok"})
            self.dead.set()
        else:
            conn.send(wire.error_frame("protocol",
                                       f"unknown frame type {t!r}"))


def deploy_identity(engine, spec: Dict) -> Dict:
    """The worker's deployment identity, from its engine (as the JAX
    worker derives it) plus the port's model identity from its spec."""
    spec_cfg = getattr(engine, "spec", None)
    deploy = {"mp": int(engine.mp),
              "spec": (spec_cfg.config.manifest_dict()
                       if spec_cfg is not None else None),
              "role": engine.engine_config.role}
    model = wire.model_identity(spec)
    if model is not None:
        deploy["model"] = model
    return deploy


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.worker",
        description="one EngineCore replica behind the fleet wire "
                    "protocol (spawned by serving/procfleet.py)")
    p.add_argument("--replica", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--spec", default="{}",
                   help="JSON engine spec (layers/num_blocks/block_size/"
                        "scheduler caps/audit/unified, and the port's "
                        "preset/dtype/device/weights/max_seq_len) — must "
                        "match the router's proxy template exactly")
    p.add_argument("--aot-path", default=None,
                   help="boot off this shared AOT artifact (its kernels "
                        "load from it, no nvcc); its manifest model_hash "
                        "becomes the handshake hash the router must "
                        "present")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build directory of the CUDA kernels: sibling "
                        "workers on one DIR run nvcc once (a lock on the "
                        "directory serializes their builds)")
    p.add_argument("--warm", action="store_true",
                   help="capture every step graph of the artifact's "
                        "universe before the ready line (serving then "
                        "captures nothing); needs --aot-path")
    p.add_argument("--tp-master", default=None, metavar="HOST:PORT",
                   help="at spec mp > 1: the rendezvous address of this "
                        "worker's world (a free local port when absent)")
    p.add_argument("--max-frame", type=int, default=wire.MAX_FRAME_BYTES)
    args = p.parse_args(argv)
    if args.warm and not args.aot_path:
        p.error("--warm needs --aot-path (it warms the artifact's "
                "universe)")

    t0 = time.perf_counter()
    from ..observability.metrics import MetricsRegistry
    from ..ops import _build

    if args.compile_cache:
        _build.set_build_dir(args.compile_cache)
    entries_before = _build.count_libraries(args.compile_cache)
    from . import graphs
    from .aot import AotArtifact, AotError, engine_kernels

    registry = MetricsRegistry()
    spec = json.loads(args.spec)
    aot = aot_hash = None
    if args.aot_path:
        # the artifact's kernels load here, from its kernels/ directory
        # (the engine's bind holds it to the engine's platform and card)
        aot = AotArtifact.load(args.aot_path)
        aot_hash = aot.manifest["model_hash"]
    followers = None
    mp = int(spec.get("mp", 1) or 1)
    if mp > 1:
        # this process is rank 0 of a world of its own; the followers
        # build their shards while this rank builds its own
        from .tp import launch_followers, world_backend

        followers = launch_followers(
            mp, follower_main, (spec, args.replica, args.compile_cache),
            backend=world_backend(mp, spec.get("device")),
            master=args.tp_master)
        join_world(spec)
    engine = build_engine(spec, args.replica, registry, aot=aot)
    # every kernel this engine launches is built and loaded BEFORE the
    # ready line: no step and no heartbeat waits on nvcc.  Booted off an
    # artifact, they were loaded from it and nothing is built.
    kernels = engine_kernels(engine)
    if aot is None:
        _build.build(kernels)
    else:
        missing = sorted(set(kernels) - set(aot.manifest["kernels"]))
        if missing:
            raise AotError(f"the artifact at {args.aot_path!r} holds no "
                           f"library of kernel(s) {missing}, which this "
                           "engine launches; re-save it")
    for name in kernels:
        _build.load(name)
    if args.warm:
        wall = aot.warm(engine, registry=registry,
                        labels={"replica": str(args.replica)})
        print(f"[worker {args.replica}] warmed {aot.program_count} "
              f"program(s), {engine.graphs.captures} capture(s), in "
              f"{wall:.3f}s, of which {engine.graphs.capture_seconds:.3f}s "
              "capturing (the rest the eager first runs)", flush=True)
        # the warm's first runs launched the kernels outside any step:
        # the launch report counts from the ready line
        graphs.reset_counters()
    entries_after = _build.count_libraries(args.compile_cache)
    if args.compile_cache:
        print(f"{CACHE_PREFIX} dir={args.compile_cache} "
              f"entries_before={entries_before} "
              f"entries_after={entries_after}", flush=True)
    boot_s = time.perf_counter() - t0
    registry.gauge("serving_worker_boot_seconds",
                   "worker process boot wall (engine build, artifact "
                   "load, the kernels' build and load, optional warm)",
                   replica=str(args.replica)).set(boot_s)

    host = WorkerHost(engine, registry, args.replica, aot_hash,
                      args.max_frame,
                      telemetry=bool(spec.get("telemetry", False)),
                      deploy=deploy_identity(engine, spec))
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind((args.host, args.port))
    server.listen(16)
    port = server.getsockname()[1]
    print(f"{READY_PREFIX} port={port} pid={os.getpid()} "
          f"aot_hash={aot_hash} boot_s={boot_s:.3f}", flush=True)

    def _accept_loop() -> None:
        while not host.dead.is_set():
            try:
                sock, _addr = server.accept()
            except OSError:
                return  # swallow-ok: listener closed during shutdown
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=host.serve_connection, args=(sock,),
                             daemon=True).start()

    acceptor = threading.Thread(target=_accept_loop, daemon=True)
    acceptor.start()
    if followers is not None:
        threading.Thread(target=_watch_followers, args=(followers, host),
                         name="watch-followers", daemon=True).start()
    try:
        host.dead.wait()
    except KeyboardInterrupt:
        pass  # swallow-ok: Ctrl-C is a normal operator stop; the finally below closes the listener
    finally:
        try:
            server.close()
        except OSError:
            pass  # swallow-ok: closing an already-dead listener during shutdown
    if followers is not None:
        return _stop_world(host, followers)
    return host.exit_code


if __name__ == "__main__":
    sys.exit(main())
