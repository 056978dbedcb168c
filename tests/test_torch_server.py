"""The port's HTTP/SSE frontend (``serving/server.py``, ``protocol.py``)
and its CLI, held to the JAX server driven the same way (CPU,
``LlamaConfig.tiny`` at 2 layers, weights through
``convert.llama_from_paddle_tpu``; both servers over one legacy engine).

* The same requests — plain and SSE completions, a seeded sampled one,
  malformed bodies, an unknown route, a wrong method, the probes, the
  request timeline and the debug routes — give the JAX server's status
  codes, ``X-Request-Id`` headers and bodies (the ``created`` stamp
  aside).
* With one admission slot held by a stalled request the next POST gets
  429 with ``Retry-After``; a drain turns ``/readyz`` and new POSTs to
  503 and finishes the in-flight request.
* Over a dp=2 fleet with the supervisor on: completions equal
  ``LLM.generate`` on the same engine config, the prefix-sharing requests
  land on one replica, and ``/metrics`` carries the fleet and hand-off
  series.
* Every CLI flag that waits for a later item exits naming its item;
  ``--selftest`` passes on the CPU.
"""

import asyncio
import http.client
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import topology as jax_topology
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import EngineCore as JaxEngineCore
from paddle_tpu.serving import SchedulerConfig as JaxSchedulerConfig
from paddle_tpu.serving.server import CompletionServer as JaxCompletionServer
from paddle_tpu.serving.server import ServerConfig as JaxServerConfig
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.serving import (
    LLM,
    EngineConfig,
    EngineCore,
    FleetConfig,
    FleetRouter,
    FleetSupervisor,
    SamplingParams,
    SchedulerConfig,
    SupervisorConfig,
    graphs,
)
from paddle_tpu_torch.serving.server import CompletionServer, ServerConfig
from paddle_tpu_torch.serving.server import main as server_main

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 4
LAYERS = 2
_RNG = np.random.default_rng(3)
PREFIX = _RNG.integers(0, 256, 8).tolist()
PROMPTS = [PREFIX + _RNG.integers(0, 256, 6).tolist() for _ in range(3)] + [
    _RNG.integers(0, 256, 9).tolist()]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=1234)


class Harness:
    """A live server on an asyncio loop in a daemon thread."""

    def __init__(self, server):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = server
        self.run(server.start())
        self.port = server.port

    def run(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self):
        try:
            if not self.server._draining:
                self.run(self.server.shutdown(drain_timeout=2.0))
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(10)
            assert not self.thread.is_alive()
            self.loop.close()


def _request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    payload = raw if raw is not None else (
        None if body is None else json.dumps(body))
    conn.request(method, path, payload,
                 {"Content-Type": "application/json"} if payload else {})
    resp = conn.getresponse()
    data = resp.read()
    headers = {k.lower(): v for k, v in resp.getheaders()}
    conn.close()
    return resp.status, headers, data


def _sse(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(dict(body,
                                                             stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    rid = resp.getheader("X-Request-Id")
    events = []
    for line in resp.read().split(b"\n"):
        if line.startswith(b"data: "):
            events.append(line[len(b"data: "):])
    conn.close()
    assert events[-1] == b"[DONE]"
    return resp.status, rid, [json.loads(e) for e in events[:-1]]


def _plain(data):
    obj = json.loads(data)
    obj.pop("created", None)
    return obj


def _drive(port):
    """The requests both servers answer; returns what is compared."""
    out = []
    for body in ({"prompt": PROMPTS[0], "max_tokens": 8},
                 dict({"prompt": PROMPTS[1], "max_tokens": 8}, **SAMPLED)):
        status, headers, data = _request(port, "POST", "/v1/completions",
                                         body)
        out.append(("completion", status, headers.get("x-request-id"),
                    _plain(data)))
    status, rid, events = _sse(port, {"prompt": PROMPTS[2], "max_tokens": 8})
    # how many tokens an event carries depends on timing; what it carries
    # in order does not
    out.append(("sse", status, rid, events[0],
                [t for e in events for t in e["choices"][0]["token_ids"]],
                events[-1], {e["object"] for e in events}))
    for raw in (b"{not json", json.dumps({"prompt": [1, 2], "top_p": 0}),
                json.dumps({"max_tokens": 3})):
        status, _, data = _request(port, "POST", "/v1/completions", raw=raw)
        out.append(("bad", status, json.loads(data)["error"]["type"]))
    for method, path in (("GET", "/nope"), ("GET", "/v1/completions"),
                         ("POST", "/v1/debug/audit"),
                         ("GET", "/v1/requests/cmpl-999"),
                         ("GET", "/v1/requests?state=bogus"),
                         ("GET", "/v1/debug/history?window=x")):
        status, _, data = _request(port, method, path)
        out.append((method, path, status, json.loads(data)["error"]["type"]))
    for path in ("/healthz", "/readyz"):
        status, _, data = _request(port, "GET", path)
        out.append((path, status, data))
    status, _, data = _request(port, "GET", "/v1/requests/cmpl-1")
    tl = json.loads(data)
    out.append(("timeline", status, tl["summary"]["generated_tokens"],
                [e["name"] for e in tl["events"]
                 if e["name"] != "decode_token"]))
    status, _, data = _request(port, "GET", "/v1/debug/compiles")
    obj = json.loads(data)
    out.append(("compiles", status, obj["aot"],
                sorted({row["program"] for row in obj["data"]})))
    status, _, data = _request(port, "GET", "/v1/debug/wire")
    out.append(("wire", status, json.loads(data)["enabled"]))
    return out


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=LAYERS))
    state = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    pm = llama_from_paddle_tpu(
        state, LlamaConfig.tiny(num_hidden_layers=LAYERS), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def jax_answers(models):
    # the JAX engine takes its mp from the process-wide mesh, which an
    # earlier test file on the same worker may have left at mp=2 (ROADMAP
    # C3 (i)); the answers compared here are an mp=1 server's
    saved = jax_topology.get_mesh()
    jax_topology.set_mesh(None)
    try:
        eng = JaxEngineCore(models[0], num_blocks=64, block_size=BS,
                            scheduler_config=JaxSchedulerConfig(
                                max_num_seqs=4))
        h = Harness(JaxCompletionServer(eng, JaxServerConfig()))
        try:
            return _drive(h.port)
        finally:
            h.close()
    finally:
        jax_topology.set_mesh(saved)


def _engine(model, **kw):
    return EngineCore(model, num_blocks=64, block_size=BS,
                      scheduler_config=SchedulerConfig(max_num_seqs=4), **kw)


def test_answers_match_the_jax_server(models, jax_answers):
    h = Harness(CompletionServer(_engine(models[1]), ServerConfig()))
    try:
        mine = _drive(h.port)
    finally:
        h.close()
    programs = mine[-2][3]
    assert "decode" in programs          # the captures are listed
    for got, want in zip(mine, jax_answers):
        if got[0] == "compiles":
            # the JAX engine traces its prefill programs; the port runs
            # them eagerly and records the decode captures
            assert got[:3] == want[:3]
            continue
        assert got == want
    assert len(mine) == len(jax_answers)


def _saturated(model, cfg):
    eng = _engine(model)
    return Harness(CompletionServer(eng, cfg)), eng


def test_429_with_retry_after_while_the_slot_is_held(models):
    h, eng = _saturated(models[1], ServerConfig(max_queue=1,
                                                retry_after_s=7))
    result = {}
    try:
        # hold every step program: the first request prefills, then
        # stalls at its first decode step, holding the only slot
        with graphs._RUN_LOCK:
            t = threading.Thread(target=lambda: result.update(
                first=_request(h.port, "POST", "/v1/completions",
                               {"prompt": PROMPTS[0], "max_tokens": 6})))
            t.start()
            deadline = threading.Event()
            for _ in range(6000):
                if h.server._handles:
                    break
                deadline.wait(0.01)
            assert h.server._handles, "first request never admitted"
            status, headers, data = _request(
                h.port, "POST", "/v1/completions",
                {"prompt": PROMPTS[1], "max_tokens": 2})
        t.join(120)
        assert not t.is_alive()
        assert status == 429 and headers["retry-after"] == "7"
        assert json.loads(data)["error"]["type"] == "overloaded_error"
        first = result["first"]
        assert first[0] == 200
        assert len(json.loads(first[2])["choices"][0]["token_ids"]) == 6
        _, _, page = _request(h.port, "GET", "/metrics")
        assert b"serving_admission_rejected_total 1" in page
    finally:
        h.close()


def test_503_while_draining_and_the_in_flight_request_finishes(models):
    h, eng = _saturated(models[1], ServerConfig())
    result = {}
    try:
        with graphs._RUN_LOCK:
            t = threading.Thread(target=lambda: result.update(
                first=_request(h.port, "POST", "/v1/completions",
                               {"prompt": PROMPTS[0], "max_tokens": 6})))
            t.start()
            wait = threading.Event()
            for _ in range(6000):
                if h.server._handles:
                    break
                wait.wait(0.01)
            assert h.server._handles
            fut = asyncio.run_coroutine_threadsafe(
                h.server.shutdown(drain_timeout=30.0), h.loop)
            for _ in range(6000):
                if h.server._draining:
                    break
                wait.wait(0.01)
            assert _request(h.port, "GET", "/readyz")[0] == 503
            status, _, data = _request(h.port, "POST", "/v1/completions",
                                       {"prompt": PROMPTS[1],
                                        "max_tokens": 2})
            assert status == 503
            assert json.loads(data)["error"]["type"] == "unavailable_error"
        fut.result(timeout=120)
        t.join(120)
        first = result["first"]
        assert first[0] == 200
        choice = json.loads(first[2])["choices"][0]
        assert choice["finish_reason"] == "length"
        assert len(choice["token_ids"]) == 6
        assert eng.kv.occupancy() == 0.0
    finally:
        h.close()


def test_dp2_fleet_server_matches_llm_generate(models):
    model = models[1]
    config = EngineConfig(num_blocks=64, block_size=BS, unified_step=True,
                          scheduler=SchedulerConfig(max_num_seqs=4,
                                                    max_tokens_per_step=32))
    llm = LLM(model, config=config)
    want = [o.token_ids for o in llm.generate(
        PROMPTS, SamplingParams(max_new_tokens=8))]

    def make(i, registry):
        return EngineCore(model, config=config, registry=registry,
                          metrics_labels={"replica": str(i)})

    fleet = FleetRouter.build(make, dp=2, config=FleetConfig())
    sup = FleetSupervisor(fleet, config=SupervisorConfig())
    h = Harness(CompletionServer(fleet, ServerConfig()))
    sup.start()
    try:
        got, replicas = [], []
        for i, p in enumerate(PROMPTS):
            if i % 2:
                status, rid, events = _sse(h.port, {"prompt": p,
                                                    "max_tokens": 8})
                got.append([t for e in events
                            for t in e["choices"][0]["token_ids"]])
            else:
                status, headers, data = _request(
                    h.port, "POST", "/v1/completions",
                    {"prompt": p, "max_tokens": 8})
                rid = headers["x-request-id"]
                got.append(json.loads(data)["choices"][0]["token_ids"])
            assert status == 200
            _, _, data = _request(h.port, "GET", f"/v1/requests/{rid}")
            replicas.append(json.loads(data)["summary"]["replica"])
        assert got == want
        assert len(set(replicas[:3])) == 1        # one prefix, one replica
        _, _, page = _request(h.port, "GET", "/metrics")
        for series in (b"serving_fleet_replicas 2", b"serving_handoff_total",
                       b'serving_fleet_replica_alive{replica="1"} 1',
                       b"serving_replica_restarts_total"):
            assert series in page
        status, _, body = _request(h.port, "GET", "/readyz")
        assert status == 200 and body.startswith(b"ok dp=2 mp=1")
    finally:
        h.close()
    assert all(not r.thread.is_alive() for r in fleet.replicas)


# The cross-process fleet's and the AOT artifacts' flags are live: their
# cases (ids kept from when they waited for ROADMAP A9 rest) now hold the
# CLI's checks on them.  --mp > 1 serves; with --dp > 1 it still waits.
_REQUIRES_WORKERS = "they require --workers N"


@pytest.mark.parametrize("args,message", [
    pytest.param(("--workers", "2", "--dp", "2"), "two fleet modes",
                 id="args0-A9 rest"),
    pytest.param(("--autoscale",), _REQUIRES_WORKERS, id="args1-A9 rest"),
    pytest.param(("--workers", "2", "--autoscale-min", "0"),
                 "--autoscale-min must be >= 1", id="args2-A9 rest"),
    pytest.param(("--workers", "2", "--autoscale-min", "4",
                  "--autoscale-max", "3"),
                 "--autoscale-max must be >= --autoscale-min",
                 id="args3-A9 rest"),
    pytest.param(("--rebalance",), _REQUIRES_WORKERS, id="args4-A9 rest"),
    pytest.param(("--aot-save", "d", "--aot-max-seq", "0"),
                 "--aot-max-seq must be >= 1", id="args5-A9 rest"),
    pytest.param(("--aot-path", "d"), "no AOT artifact there",
                 id="args6-A9 rest"),
    pytest.param(("--aot-warm",), "it requires --aot-save or --aot-path",
                 id="args7-A9 rest"),
    pytest.param(("--aot-max-seq", "64"), "it requires --aot-save",
                 id="args8-A9 rest"),
    pytest.param(("--compile-cache", "d"), _REQUIRES_WORKERS,
                 id="args9-A9 rest"),
    pytest.param(("--mp", "2", "--dp", "2", "--audit-sample", "1"),
                 "(ROADMAP A11)", id="args10-A11")])
def test_waiting_flags_exit_naming_their_item(args, message, capsys):
    with pytest.raises(SystemExit) as e:
        server_main(["--device", "cpu", *args])
    assert e.value.code != 0
    assert message in capsys.readouterr().err


def test_cli_selftest_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.server", "--device",
         "cpu", "--layers", "2", "--dp", "2", "--unified", "--selftest"],
        cwd=_REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "selftest: OK" in proc.stdout and "device cpu" in proc.stdout


def test_cli_workers_selftest_on_the_cpu():
    """``--workers 2``: two worker processes behind the router, one
    completion over HTTP, the cross-process timeline markers and the wire
    attribution (``procfleet.py``, ``worker.py``)."""
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.server", "--device",
         "cpu", "--layers", "2", "--workers", "2", "--selftest"],
        cwd=_REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "selftest: OK" in proc.stdout and "workers=2" in proc.stdout


def test_cli_aot_save_then_serve_on_the_cpu(tmp_path):
    """``--aot-save`` (with ``--aot-warm``: every key captures on the
    saving engine), then ``--aot-path --aot-warm --selftest`` in process
    (dp=2) and over ``--workers 2``: each probe serves with zero traces,
    an empty compile table and every replica's ``aot`` block loaded."""
    art = str(tmp_path / "art")
    base = [sys.executable, "-m", "paddle_tpu_torch.serving.server",
            "--device", "cpu", "--layers", "2", "--blocks", "64"]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run(base + ["--aot-save", art, "--aot-max-seq", "32",
                                  "--aot-warm"],
                          cwd=_REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "aot-save:" in proc.stdout and "aot-warm: captured" in proc.stdout
    assert os.path.exists(os.path.join(art, "manifest.json"))
    for extra, marker in ((["--dp", "2"], "zero traces"),
                          (["--workers", "2"], "aot zero traces")):
        proc = subprocess.run(base + ["--aot-path", art, "--aot-warm",
                                      "--selftest", *extra],
                              cwd=_REPO, capture_output=True, text=True,
                              timeout=300, env=env)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "selftest: OK" in proc.stdout and marker in proc.stdout
