"""The port's worker host (``paddle_tpu_torch/serving/worker.py``) against
the JAX package's (``paddle_tpu/serving/worker.py``), with no subprocess.

Each package's ``WorkerHost`` serves one end of a ``socket.socketpair()``
on a thread of its own; the other end sends both hosts the same frame
sequence — the handshake (and its refusals), submits, steps to the end,
an abort, health with a clock probe, debug fetches, a fault plan, a KV
export and its re-import, hot prefixes, drain, an unknown frame and
shutdown.  The JAX engine is the JAX worker's (``paddle.seed`` + tiny
Llama at 2 layers); the port's takes the same weights through the
worker spec's ``weights`` key (an ``.npz`` of the JAX parameters).  The
replies are equal, except pids, timestamps, wall times and what the
worker's docstring lists as the port's departures (``describe``'s
``launches`` and ``captures`` fields).
"""

import socket
import threading

import numpy as np
import pytest

from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from paddle_tpu.serving import wire as jax_wire
from paddle_tpu.serving import worker as jax_worker
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.serving import wire, worker
from paddle_tpu_torch.serving.aot import AotError

LAYERS = 2
SPEC = {"layers": LAYERS, "num_blocks": 32, "block_size": 4,
        "max_num_seqs": 4, "max_prefill_tokens_per_step": 8,
        "unified_step": False, "seed": 0, "audit_enabled": False,
        "audit_sample_every": 1, "lifecycle_events": True,
        "decode_event_sample": 8, "telemetry": True, "history": False}
_RNG = np.random.default_rng(3)
PREFIX = _RNG.integers(0, 256, 8).tolist()
PROMPTS = [PREFIX + _RNG.integers(0, 256, 5).tolist() for _ in range(3)]
# fields whose values are process ids, clocks or wall times
VOLATILE = {"pid", "t", "t0", "t1", "t2", "uptime_s", "ts", "t_unix",
            "unix", "time_unix", "wall_s", "seconds", "step_record",
            "arrival", "duration_ms", "last_access", "traceback", "error",
            "metrics", "telemetry"}


def _scrub(obj):
    """``obj`` without its volatile fields (recursively)."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """``{"jax": (host, client), "port": (host, client)}``: each host
    serving one end of a socketpair on its own thread.  Torn down with a
    shutdown frame; the serving threads must end."""
    jax_engine = jax_worker.build_engine(dict(SPEC), 0, JaxRegistry())
    path = tmp_path_factory.mktemp("worker") / "weights.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in
                      jax_engine.model.state_dict().items()})
    port_registry = MetricsRegistry()
    port_engine = worker.build_engine(
        dict(SPEC, weights=str(path), device="cpu"), 0, port_registry)
    out, threads = {}, []
    for name, mod, eng, reg in (
            ("jax", jax_worker, jax_engine, jax_engine.metrics.registry),
            ("port", worker, port_engine, port_registry)):
        host = mod.WorkerHost(eng, reg, 0, None, wire.MAX_FRAME_BYTES,
                              telemetry=True, deploy=None)
        a, b = socket.socketpair()
        th = threading.Thread(target=host.serve_connection, args=(a,),
                              daemon=True)
        th.start()
        threads.append(th)
        conn = (jax_wire if name == "jax" else wire).Connection(b)
        conn.settimeout(120)
        out[name] = (host, conn)
    yield out
    for host, conn in out.values():
        if not host.dead.is_set():
            conn.request({"type": "shutdown"})
        conn.close()
    for th in threads:
        th.join(30)
    assert not any(th.is_alive() for th in threads)


def _exchange(hosts, frame, n_replies=1):
    out = {}
    for name, (_, conn) in hosts.items():
        conn.send(frame)
        out[name] = [conn.recv() for _ in range(n_replies)]
    return out


def test_session_replies_equal_the_jax_host(hosts):
    # --- handshake, then the engine session
    hello = _exchange(hosts, wire.hello_frame("engine", None))
    assert _scrub(hello["port"]) == _scrub(hello["jax"])
    assert hello["port"][0]["type"] == "hello_ok"

    for i, p in enumerate(PROMPTS):
        r = _exchange(hosts, {"type": "submit", "rid": f"r{i}",
                              "prompt_ids": p, "trace_id": f"r{i}",
                              "sampling": {"max_new_tokens": 6}})
        assert _scrub(r["port"]) == _scrub(r["jax"])
        assert r["port"][0]["type"] == "submit_ok"
        # the telemetry deltas carry the same lifecycle events
        assert [(e["rid"], e["name"]) for e in
                r["port"][0]["telemetry"]["events"]] == \
            [(e["rid"], e["name"]) for e in
             r["jax"][0]["telemetry"]["events"]]

    tokens = {"jax": {}, "port": {}}
    for step in range(200):
        r = _exchange(hosts, {"type": "step"})
        assert _scrub(r["port"]) == _scrub(r["jax"]), f"step {step}"
        for name in tokens:
            done = r[name][0]
            assert done["type"] == "step_done"
            assert set(done["t"]) == {"recv", "eng0", "eng1", "reply"}
            for rid, toks in done.get("emitted", {}).items():
                tokens[name].setdefault(rid, []).extend(toks)
        if not r["port"][0]["has_work"]:
            break
    assert tokens["port"] == tokens["jax"]
    assert all(len(t) == 6 for t in tokens["port"].values())

    # an idle step answers stepped=False
    r = _exchange(hosts, {"type": "step"})
    assert _scrub(r["port"]) == _scrub(r["jax"])
    assert r["port"][0]["stepped"] is False

    # --- abort of an admitted request, and of an unknown one
    r = _exchange(hosts, {"type": "submit", "rid": "gone",
                          "prompt_ids": PROMPTS[0],
                          "sampling": {"max_new_tokens": 4}})
    r = _exchange(hosts, {"type": "abort", "rid": "gone"})
    assert _scrub(r["port"]) == _scrub(r["jax"])
    assert r["port"][0]["ok"] is True
    r = _exchange(hosts, {"type": "abort", "rid": "never"})
    assert _scrub(r["port"]) == _scrub(r["jax"])


def test_control_frames_equal_the_jax_host(hosts):
    # health with a clock probe: t0 echoed, t1 <= t2 stamped
    r = _exchange(hosts, {"type": "health", "t0": 12.5})
    assert _scrub(r["port"]) == _scrub(r["jax"])
    reply = r["port"][0]
    assert reply["t0"] == 12.5 and reply["t1"] <= reply["t2"]

    for what in ("audit", "aot", "cache_timeline"):
        r = _exchange(hosts, {"type": "debug", "what": what})
        assert r["port"][0]["type"] == r["jax"][0]["type"] == "debug_ok"
        if what != "cache_timeline":
            assert _scrub(r["port"]) == _scrub(r["jax"]), what
    # captures per family: the JAX engine's traces, the prefill families
    # included
    r = _exchange(hosts, {"type": "debug", "what": "compile_totals"})
    want = _scrub(r["jax"][0]["data"])
    assert _scrub(r["port"][0]["data"]) == want
    assert {"chunk", "decode"} <= set(want)
    cache = _exchange(hosts, {"type": "debug", "what": "cache"})
    for key in ("num_blocks", "block_size", "prefix_cache", "hit_depths",
                "revives", "reuse_hits", "attribution"):
        assert _scrub(cache["port"][0]["data"][key]) == \
            _scrub(cache["jax"][0]["data"][key]), key

    desc = _exchange(hosts, {"type": "debug", "what": "describe"})
    port_desc, jax_desc = desc["port"][0]["data"], desc["jax"][0]["data"]
    launches = port_desc.pop("launches")
    # the port's departures: launches (CPU: the plain versions, no kernel
    # launch, none due on the unified step) and captures (one per trace
    # here: no artifact is bound); traces.prefill equals the JAX worker's
    assert launches["ragged"]["all"] == launches["decode"]["all"] == 0
    assert launches["due"]["ragged"] == 0
    assert port_desc.pop("captures") == sum(port_desc["traces"].values())
    assert port_desc["traces"]["prefill"] == jax_desc["traces"]["prefill"] > 0
    assert _scrub(port_desc) == _scrub(jax_desc)

    r = _exchange(hosts, {"type": "debug", "what": "nope"})
    assert _scrub(r["port"]) == _scrub(r["jax"])
    assert r["port"][0]["code"] == "protocol"

    # a fault plan, and clearing it
    plan = {"faults": [{"point": "slow_step", "step": 1000,
                        "replica": "0", "seconds": 0.0}]}
    for frame in ({"type": "set_fault", "plan": plan, "fired": []},
                  {"type": "set_fault", "plan": None}):
        r = _exchange(hosts, frame)
        assert r["port"] == r["jax"] == [{"type": "ok"}]

    r = _exchange(hosts, {"type": "hot_prefixes", "k": 4})
    assert r["port"][0]["type"] == "hot_prefixes_ok"
    assert [row["chain"] for row in r["port"][0]["rows"]] == \
        [row["chain"] for row in r["jax"][0]["rows"]]

    r = _exchange(hosts, {"type": "bogus"})
    assert r["port"] == r["jax"]
    assert r["port"][0]["code"] == "protocol"


def test_kv_export_and_import_equal_the_jax_host(hosts):
    """A request left resident (one step short of its end) exports the
    same block records in both hosts; the port's run re-imports into the
    port host (its pool already holds the blocks: zero placed, as the
    JAX host answers for its own run)."""
    _exchange(hosts, {"type": "submit", "rid": "kv",
                      "prompt_ids": PROMPTS[1],
                      "sampling": {"max_new_tokens": 32}})
    for _ in range(3):
        _exchange(hosts, {"type": "step"})
    runs = {}
    for name, (_, conn) in hosts.items():
        conn.send({"type": "kv_export", "rid": "kv"})
        begin = conn.recv()
        assert begin["type"] == "kv_run_begin"
        chunks = [conn.recv() for _ in range(begin["chunks"])]
        runs[name] = (begin, chunks)
    assert runs["port"][0]["blocks"] == runs["jax"][0]["blocks"]
    assert runs["port"][0]["bytes"] == runs["jax"][0]["bytes"]
    assert set(runs["port"][0]["t"]) == {"gather_s", "device_to_host_s",
                                         "digest_s", "framing_s"}
    for name, (_, conn) in hosts.items():
        begin, chunks = runs[name]
        conn.send(begin)
        for c in chunks:
            conn.send(c)
        runs[name] = conn.recv()
    assert _scrub(runs["port"]) == _scrub(runs["jax"])
    assert runs["port"]["type"] == "kv_import_ok"
    # the port's hand-off timings, by part, on both frames
    assert set(runs["port"]["t"]) == {"receive_s", "assemble_s",
                                      "verify_s", "import_s"}
    r = _exchange(hosts, {"type": "kv_detach", "rid": "kv"})
    assert r["port"] == r["jax"]
    assert r["port"][0]["ok"] is True
    r = _exchange(hosts, {"type": "kv_export", "rid": "kv"})
    assert r["port"] == r["jax"] == [{"type": "kv_export_ok",
                                      "empty": True}]


def test_drain_then_refused_submit_equal_the_jax_host(hosts):
    r = _exchange(hosts, {"type": "drain"})
    assert r["port"] == r["jax"]
    assert r["port"][0]["type"] == "drain_ok"
    r = _exchange(hosts, {"type": "submit", "rid": "late",
                          "prompt_ids": PROMPTS[0],
                          "sampling": {"max_new_tokens": 2}})
    assert r["port"] == r["jax"]
    assert r["port"][0]["code"] == "protocol"


@pytest.mark.parametrize("hello, code", [
    ({"type": "hello", "version": 99, "role": "engine", "aot_hash": None},
     "version_mismatch"),
    (wire.hello_frame("engine", "deadbeef"), "aot_mismatch"),
    ({"type": "hello", "version": wire.WIRE_VERSION, "role": "root",
      "aot_hash": None}, "protocol"),
    (wire.hello_frame("engine", None, deploy={"mp": 1, "spec": None,
                                              "role": "prefill"}),
     "deploy_mismatch"),
    ({"type": "submit"}, "protocol"),
])
def test_handshake_refusals_equal_the_jax_host(hosts, hello, code):
    """A refused hello is answered with the same typed error by both
    hosts, and closes only that connection."""
    replies = {}
    for name, (host, _) in hosts.items():
        a, b = socket.socketpair()
        th = threading.Thread(target=host.serve_connection, args=(a,),
                              daemon=True)
        th.start()
        conn = (jax_wire if name == "jax" else wire).Connection(b)
        conn.settimeout(30)
        replies[name] = conn.request(hello)
        conn.close()
        th.join(30)
        assert not th.is_alive()
    assert _scrub(replies["port"]) == _scrub(replies["jax"])
    assert (replies["port"]["type"], replies["port"]["code"]) == \
        ("error", code)


def test_model_identity_refuses_a_drifted_router(tmp_path):
    """The port's model identity rides the handshake: a worker built as a
    bf16 llama3_8b refuses a router expecting the defaults, and the same
    spec on both ends shakes hands."""
    spec = {"preset": "llama3_8b", "dtype": "bfloat16", "device": "cpu",
            "weights": None}
    ident = wire.model_identity(spec)
    assert ident == {"preset": "llama3_8b", "dtype": "bfloat16",
                     "device": "cpu"}
    assert wire.model_identity({"preset": "tiny", "dtype": "float32"}) \
        is None
    deploy = {"mp": 1, "spec": None, "role": "unified", "model": ident}
    assert wire.check_hello(wire.hello_frame("engine", None, deploy=deploy),
                            None, deploy=deploy) == "engine"
    with pytest.raises(wire.HandshakeMismatch) as e:
        wire.check_hello(wire.hello_frame("engine", None), None,
                         deploy=deploy)
    assert e.value.code == "deploy_mismatch"
    # max_seq_len is the model's position limit, where a pool needs more
    eng = worker.build_engine({"device": "cpu", "layers": 1,
                               "max_seq_len": 1024}, 0, MetricsRegistry())
    assert eng.model.config.max_position_embeddings == 1024
    with pytest.raises(ValueError, match="unknown engine-spec"):
        worker.build_engine({"preset": "tiny", "colour": 1}, 0,
                            MetricsRegistry())
    # mp > 1: what waits for A11 raises naming it; the rest needs the
    # worker's world (join_world) laid out before the model
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        worker.build_engine({"mp": 2, "device": "cpu", "unified_step": True,
                             "max_tokens_per_step": 16, "spec": {"k": 2}},
                            0, MetricsRegistry())
    with pytest.raises(ValueError, match="init_mesh"):
        worker.build_engine({"mp": 2, "device": "cpu"}, 0,
                            MetricsRegistry())
    # an artifact path with no artifact is refused before the engine is
    # built, and a warm boot needs an artifact
    with pytest.raises(AotError, match="manifest.json missing"):
        worker.main(["--aot-path", str(tmp_path)])
    with pytest.raises(SystemExit):
        worker.main(["--warm"])
