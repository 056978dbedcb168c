"""Tensor-parallel serving at dp x mp on the CPU: the in-process fleet of
replicas that each span an mp=2 group, the KV hand-off at mp=2, a worker
process at mp=2 over the wire and the server CLI, held to the JAX package
(the conftest's virtual CPU devices) and to the port at mp=1, on the same
weights (``LlamaConfig.tiny`` at 2 layers, from one JAX seed, fp32).

* The fleet (``serving/tp.py``: a replica's own mp and control groups,
  ``ReplicaFactory``, ``follow_replicas``): rank 0 routes to two replicas,
  rank 1 follows both on two threads.  Each prompt goes to the replica
  ``affinity_replica_index`` names, and the greedy tokens equal the JAX
  ``FleetRouter`` at dp=2 on an mp=2 mesh and the port at mp=1; each
  rank's pools hold its head slice of the mp=1 pages of every cached
  block; a replica killed mid-wave is rebuilt on both ranks by the
  supervisor and the wave ends token-identically.
* The hand-off (``serving/handoff.py``): the mp=2 run's header equals the
  JAX mp=2 donor's and its payload is within 1e-5 of its largest entry;
  runs move mp=2 -> mp=1, mp=1 -> mp=2 and JAX -> the port's mp=2, each
  continuing token-identically with every handed-off block served from
  the run (0 recomputed tokens of it); a corrupted run is refused before
  any rank's pool changes.
* A worker at mp=2 (``serving/worker.py``, ``procfleet.py``): its tokens
  equal the port's mp=1 engine's, a router at mp=1 is refused at the
  handshake, and ``kill -9`` of its follower fails the worker, whose
  process exits.
* The CLI: ``--dp 2 --mp 2`` answers ``ok dp=2 mp=2`` and the CLI model's
  mp=1 tokens; ``--workers 1 --mp 2`` serves and exits 0 on SIGTERM; the
  flags that still wait exit non-zero naming ROADMAP A11.
* bf16: the first step's logits at mp=2 against mp=1, the port's gap held
  within twice the JAX package's own.

One world (``torch_dist_ranks.tp_fleet_rank``, one spawn in a module
fixture), the worker fleet and the two servers run while the JAX side runs
here.
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_dist_ranks as ranks
from paddle_tpu import serving as jserving
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving.fleet import affinity_replica_index
from paddle_tpu_torch import serving
from paddle_tpu_torch.ops.paged_attention import shard_kv_pool
from paddle_tpu_torch.serving import wire

TP = ranks.TP
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODY = {"prompt": [5, 9, 23, 7], "max_tokens": 6}


def _jax_model():
    paddle.seed(0)
    return JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=2))


def _jax_fleet():
    """The JAX FleetRouter at dp=2 on the mp=2 mesh (a model a replica:
    a traced step swaps its model's parameters)."""
    models = [_jax_model() for _ in range(ranks.FLEET_REPLICAS)]
    fleet = jserving.FleetRouter.build(
        lambda i, registry: jserving.EngineCore(
            models[i], config=ranks.fleet_config(jserving),
            registry=registry, metrics_labels={"replica": str(i)}),
        dp=ranks.FLEET_REPLICAS).start()
    try:
        hs = [fleet.submit_request(p, jserving.SamplingParams(
            max_new_tokens=ranks.FLEET_NEW), request_id=f"j{i}")
            for i, p in enumerate(ranks.FLEET_PROMPTS)]
        fleet.wait(hs, timeout=300)
        return {"tokens": [list(map(int, h.output_tokens)) for h in hs],
                "replicas": [h.replica.index for h in hs],
                "mp": [e.mp for e in fleet.engines]}
    finally:
        fleet.shutdown(drain_timeout=5.0)


def _jax_bf16_logits(state):
    """The JAX model in bf16 on ``state``: its first step's logits at the
    current mesh, through the dense-cache route."""
    m = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=2))
    m.set_state_dict(state)
    m.to(dtype="bfloat16")
    cfg = m.config
    ids = ranks.BF16_IDS
    shape = (1, ids.shape[1], cfg.num_key_value_heads, cfg.head_dim)
    caches = [(Tensor(jnp.zeros(shape, jnp.bfloat16)),
               Tensor(jnp.zeros(shape, jnp.bfloat16)))
              for _ in range(cfg.num_hidden_layers)]
    with paddle.no_grad():
        out = m(Tensor(jnp.asarray(ids)), caches=caches,
                pos=Tensor(jnp.asarray(np.int32(0))))
    return np.asarray(out._value.astype(jnp.float32))[0, -1]


def _worker_fleet(path):
    """A process fleet of one worker at mp=2 on the JAX weights: its
    tokens, the mp=1 router's refusal, then its follower killed."""
    from paddle_tpu_torch.serving import ProcessFleet, ProcessFleetConfig

    pf = ProcessFleet(ProcessFleetConfig(
        dp=1, mp=TP, layers=2, device="cpu", weights=path, unified=True,
        num_blocks=64, block_size=4, max_num_seqs=4,
        max_prefill_tokens_per_step=None, heartbeat_interval_s=0.1,
        heartbeat_timeout_s=5.0))
    out = {}
    try:
        pf.start()
        hs = [pf.router.submit_request(p, serving.SamplingParams(
            max_new_tokens=ranks.FLEET_NEW), request_id=f"w{i}")
            for i, p in enumerate(ranks.FLEET_PROMPTS)]
        pf.router.wait(hs, timeout=120)
        out["tokens"] = [list(h.output_tokens) for h in hs]
        proxy = pf.proxy(0)
        out["describe"] = proxy.debug_fetch("describe")
        port = proxy.worker.port
        try:
            wire.connect("127.0.0.1", port, "control", None,
                         deploy={"mp": 1, "spec": None, "role": "unified",
                                 "model": wire.model_identity(
                                     pf.shared.worker_spec(0))})
            out["mp1_router"] = "accepted"
        except wire.HandshakeMismatch as e:
            out["mp1_router"] = f"{e.code}: {e}"
        world = [r["pid"] for r in out["describe"]["launches"]["ranks"]]
        out["pids"] = (proxy.pid, world)
        out["followers"] = world[1:]
        for c in out["followers"]:
            os.kill(c, signal.SIGKILL)
        out["worker_exit"] = proxy.worker.proc.wait(timeout=60)
        # no process of the worker's world is left
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(_alive(c) for c in world):
            time.sleep(0.05)
        out["left"] = [c for c in world if _alive(c)]
    finally:
        pf.stop()
    return out


def _alive(pid):
    """``pid`` runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


def _server(tmp_path_factory, name, *args):
    err = tmp_path_factory.mktemp(name) / "server.err"
    with open(err, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.server",
             "--device", "cpu", "--layers", "2", "--blocks", "64",
             "--unified", *args], cwd=REPO, stdout=subprocess.PIPE,
            stderr=f, text=True)
    return proc, err


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """``server --dp 2 --mp 2`` and ``server --workers 1 --mp 2``, started
    first so that they boot while the other sides run."""
    procs = {"dp2": _server(tmp_path_factory, "dp2", "--dp", "2", "--mp",
                            "2"),
             "workers1": _server(tmp_path_factory, "workers1", "--workers",
                                 "1", "--mp", "2")}
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            # SIGTERM first: the server then stops its worker processes
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        proc.stdout.close()


@pytest.fixture(scope="module")
def sides(tmp_path_factory, servers):
    """The ranks and the worker fleet run while the JAX side runs here:
    its mp=2 donor first (rank 0 imports its run), then its fleet, then
    its bf16 logits at mp=2 and at mp=1."""
    out = str(tmp_path_factory.mktemp("tp_fleet"))
    jtopology.init_mesh(mp=TP)
    try:
        jm = _jax_model()
        state = {k: np.array(np.asarray(v), dtype=np.float32)
                 for k, v in jm.state_dict().items()}
        path = os.path.join(out, "state.npz")
        np.savez(path, **state)
        world = ranks.start_world(ranks.tp_fleet_rank, out, path, nprocs=TP)
        with ThreadPoolExecutor(1) as pool:
            procfleet = pool.submit(_worker_fleet, path)
            try:
                want = {}
                run, resume, tokens = ranks.handoff_donor(
                    jserving.EngineCore(jm, config=ranks.fleet_config(
                        jserving)), jserving.SamplingParams)
                np.savez(os.path.join(out, "run_jax.npz"),
                         **ranks.run_arrays(run))
                with open(os.path.join(out, "run_jax.json"), "w") as f:
                    json.dump({"resume": resume}, f)
                open(os.path.join(out, "run_jax.npz.done"), "w").close()
                want["run"], want["donor_tokens"] = run, tokens
                want["fleet"] = _jax_fleet()
                want["bf16_mp2"] = _jax_bf16_logits(state)
                jtopology.set_mesh(None)
                want["bf16_mp1"] = _jax_bf16_logits(state)
            finally:
                world.join()
            want["procfleet"] = procfleet.result()
    finally:
        jtopology.set_mesh(None)
    got = []
    for r in range(TP):
        with open(os.path.join(out, f"tp_fleet_rank{r}.json")) as f:
            got.append(json.load(f))
        with np.load(os.path.join(out, f"fleet_pools_rank{r}.npz")) as f:
            got[r]["pools"] = {k: f[k] for k in f.files}
    with np.load(os.path.join(out, "fleet_pools_mp1.npz")) as f:
        got[0]["mp1_pools"] = {k: f[k] for k in f.files}
    with np.load(os.path.join(out, "run_mp2.npz")) as f:
        got[0]["run_mp2"] = ranks.run_from_arrays({k: f[k] for k in f.files})
    return got, want


# --- the in-process fleet -------------------------------------------------------

def test_fleet_routes_by_affinity_and_matches_jax_fleet_and_mp1(sides):
    got, want = sides
    row = got[0]["fleet"]["first"]
    predicted = [affinity_replica_index(p, ranks.FLEET_REPLICAS, 4)
                 for p in ranks.FLEET_PROMPTS]
    assert row["replicas"] == predicted == want["fleet"]["replicas"]
    assert got[0]["fleet"]["predicted"] == predicted
    assert set(predicted) == {0, 1}          # both replicas served
    assert want["fleet"]["mp"] == [TP, TP]
    assert row["tokens"] == want["fleet"]["tokens"] == got[0]["mp1_tokens"]
    assert row["finish"] == ["length"] * len(ranks.FLEET_PROMPTS)


def test_each_replica_has_its_own_groups_and_labelled_series(sides):
    got, _ = sides
    for r in range(TP):
        assert [g[0] for g in got[r]["fleet_groups"]] == [[0, 1], [0, 1]]
        assert all(g[1] for g in got[r]["fleet_groups"])
    text = got[0]["fleet"]["metrics"]
    for i in range(ranks.FLEET_REPLICAS):
        assert f'serving_mp_shards{{replica="{i}"}} 2' in text
        m = re.search(r'serving_collective_seconds_count\{phase="ragged",'
                      rf'replica="{i}"\}} (\S+)', text)
        assert m and float(m.group(1)) > 0


def test_each_rank_holds_its_head_slice_of_the_mp1_pages(sides):
    """Every block a replica cached holds, on each rank, that rank's heads
    of the same chain hash's block of an mp=1 engine over the same
    prompts; free + reuse + allocated == num_blocks on every rank of
    every replica."""
    got, _ = sides
    mp1 = got[0]["mp1_pools"]
    where = got[0]["mp1_hashes"]
    checked = 0
    for i, hashes in enumerate(got[0]["fleet_hashes"]):
        for block, h in hashes.items():
            if h not in where:
                continue
            for r in range(TP):
                for kv in ("k", "v"):
                    for layer in range(2):
                        whole = torch.from_numpy(
                            mp1[f"r0_{kv}{layer}"][where[h]])
                        np.testing.assert_allclose(
                            got[r]["pools"][f"r{i}_{kv}{layer}"][int(block)],
                            shard_kv_pool(whole[None], r, TP)[0].numpy(),
                            rtol=0, atol=1e-5)
            checked += 1
    assert checked >= len(ranks.FLEET_PROMPTS) * 3
    for r in range(TP):
        assert got[r]["fleet_invariant"] == [True, True]
    assert got[0]["fleet"]["occupancy"] == [0.0, 0.0]


def test_killed_replica_rebuilt_on_both_ranks_token_identically(sides):
    got, want = sides
    fleet = got[0]["fleet"]
    assert fleet["restarts"] == 1
    assert fleet["killed"]["tokens"] == want["fleet"]["tokens"]
    assert fleet["killed"]["finish"] == ["length"] * len(ranks.FLEET_PROMPTS)
    # the follower's rebuilt replica followed the controller's: each
    # rank's replica counts the same forwards
    assert got[0]["fleet_forwards"] == got[1]["fleet_forwards"]


# --- the hand-off ---------------------------------------------------------------

def test_mp2_run_equals_the_jax_mp2_donors(sides):
    got, want = sides
    mine, theirs = got[0]["run_mp2"], want["run"]
    for key in ("version", "block_size", "layers", "kv_heads", "head_dim",
                "dtype", "tokens_total"):
        assert mine[key] == theirs[key], key
    assert [(r["hash"], r["depth"], tuple(r["tokens"]))
            for r in mine["blocks"]] == \
        [(r["hash"], r["depth"], tuple(r["tokens"])) for r in theirs["blocks"]]
    ref = np.asarray(theirs["payload"])
    assert mine["payload"].shape == ref.shape
    np.testing.assert_allclose(mine["payload"], ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert got[0]["handoff"]["donor"]["tokens"] == want["donor_tokens"]


@pytest.mark.parametrize("case", ["to_mp1", "from_mp1", "from_jax"])
def test_runs_cross_layouts_token_identically_with_0_recompute(sides, case):
    got, want = sides
    ho = got[0]["handoff"]
    row = ho[case]
    donor = {"to_mp1": ho["donor"]["tokens"],
             "from_mp1": ho["mp1_donor"]["tokens"],
             "from_jax": want["donor_tokens"]}[case]
    assert row["placed"] == row["blocks"] > 0
    assert row["tokens"] == donor
    # every handed-off block served from the run: none recomputed
    assert row["cached"] == row["blocks"] * 4


def test_corrupted_run_refused_before_any_rank_pool_changes(sides):
    got, _ = sides
    ho = got[0]["handoff"]
    assert ho["corrupt"].startswith("HandoffError") and \
        "digest" in ho["corrupt"]
    for r in range(TP):
        before, after = got[r]["handoff"]["pool_sum"]
        assert before == after and before > 0
        assert got[r]["handoff"]["invariant"]


# --- a worker at mp=2 -------------------------------------------------------------

def test_worker_at_mp2_over_the_wire(sides):
    got, want = sides
    pf = want["procfleet"]
    assert pf["tokens"] == got[0]["mp1_tokens"]
    assert pf["mp1_router"].startswith("deploy_mismatch") and \
        "mp degree" in pf["mp1_router"]
    launches = pf["describe"]["launches"]
    assert len(launches["ranks"]) == TP
    assert all(r["due"] == launches["ranks"][0]["due"]
               for r in launches["ranks"])
    assert pf["pids"][1][0] == pf["pids"][0]       # the worker is rank 0
    assert len(pf["followers"]) == TP - 1
    assert pf["worker_exit"] != 0 and not pf["left"]


# --- the CLI -----------------------------------------------------------------------

def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _banner(proc, err, shape):
    port, seen = None, []
    deadline = time.monotonic() + 120
    while port is None and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        m = re.search(rf"serving on http://[\d.]+:(\d+) {shape}", line)
        port = int(m.group(1)) if m else None
    assert port is not None, (seen, err.read_text()[-3000:])
    return port


def _cli_tokens():
    from paddle_tpu_torch.serving.server import _toy_engine, _toy_model

    eng = _toy_engine(_toy_model(2, "cpu"), num_blocks=64, unified=True)
    req = eng.add_request(BODY["prompt"], serving.SamplingParams(
        max_new_tokens=BODY["max_tokens"]))
    eng.run()
    return [int(t) for t in req.output_tokens]


@pytest.mark.parametrize("name, shape", [("dp2", "dp=2 mp=2"),
                                         ("workers1", "dp=1 mp=2")])
def test_cli_at_mp2_readyz_completion_and_sigterm(servers, name, shape):
    """``--dp 2 --mp 2``: this process the controller of both replicas;
    ``--workers 1 --mp 2``: the worker the controller of its own world.
    Each answers ``/readyz`` with its shape and the CLI model's mp=1
    tokens, and exits 0 on SIGTERM, its ranks joined."""
    proc, err = servers[name]
    port = _banner(proc, err, shape)
    assert _http(port, "GET", "/readyz") == (200, f"ok {shape}\n".encode())
    status, data = _http(port, "POST", "/v1/completions", BODY)
    assert status == 200, data
    assert json.loads(data)["choices"][0]["token_ids"] == _cli_tokens()
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=120) == 0, err.read_text()[-3000:]


@pytest.mark.parametrize("flag", [("--spec-decode",), ("--audit-sample", "1"),
                                  ("--selftest",), ("--aot-save", "d"),
                                  ("--aot-path", "d")])
def test_cli_flags_that_wait_exit_naming_a11(flag, capsys):
    from paddle_tpu_torch.serving.server import main as server_main

    with pytest.raises(SystemExit) as e:
        server_main(["--device", "cpu", "--mp", "2", "--dp", "2", *flag])
    assert e.value.code != 0
    assert "(ROADMAP A11)" in capsys.readouterr().err


def test_what_waits_for_a11_raises_naming_it(sides):
    got, _ = sides
    for r in range(TP):
        for what, err in got[r]["waiting"].items():
            assert err.startswith("NotImplementedError") and \
                "ROADMAP A11" in err, (what, err)


# --- bf16 at mp=2 against the reference ------------------------------------------

def test_bf16_mp2_gap_within_twice_the_jax_packages(sides):
    """The first step's logits in bf16 (through the dense-cache route, as
    chip_smoke.py's mp_serve gate reads them): the four pairwise gaps,
    each over the largest entry of the second; the port's mp=2-to-mp=1
    gap is held within twice the JAX package's own."""
    got, want = sides
    port2 = np.asarray(got[0]["bf16_mp2"])
    port1 = np.asarray(got[0]["bf16_mp1"])
    jax2, jax1 = want["bf16_mp2"], want["bf16_mp1"]
    assert np.array_equal(np.asarray(got[1]["bf16_mp2"]), port2)

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    gaps = {"jax mp2-mp1": gap(jax2, jax1), "port mp2-mp1": gap(port2, port1),
            "mp2 port-jax": gap(port2, jax2), "mp1 port-jax": gap(port1, jax1)}
    print("bf16 first-step logit gaps:", json.dumps(gaps))
    assert gaps["port mp2-mp1"] <= 2 * gaps["jax mp2-mp1"], gaps
