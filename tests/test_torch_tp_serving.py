"""Tensor-parallel serving of the port at mp=2 on the CPU: 2 gloo ranks,
rank 0 the controller and rank 1 its follower (``serving/tp.py``), held to
the JAX engine at mp=2 (the conftest's virtual CPU devices) and to the port
at mp=1, on the same weights (``LlamaConfig.tiny`` at 2 layers, from one
JAX seed, each rank's shard cut by ``convert.llama_from_paddle_tpu``).

* Greedy tokens identical in every scenario of ``tests/test_serving_mp.py``
  (plain, preemption with recompute, a warm prefix-cache fork, chunked
  prefill) and with bursts (``test_zzzzzzzzz_burst.py``'s mp=2 run), on the
  unified and the legacy families; ``LLM.generate`` as SPMD.
* ``generate`` equals the JAX ``generate`` at mp=2, greedy and seeded
  sampled; the dense-cache route's logits are within 1e-5 of their largest
  entry (fp32; the two frameworks differ only in summation order) and
  bit-equal on the two ranks.
* Every family runs eagerly at mp=2 (no capture), over the bucket sets of
  mp=1; each forward issues 2L+1 all-reduces and one all-gather on every
  rank; each rank's pools hold its head slice of the mp=1 pools; the pool
  invariant holds on every rank; ``serving_mp_shards`` and
  ``serving_collective_seconds`` report mp=2 and stay silent at mp=1.
* The errors: a topology that disagrees with ``EngineConfig.mp``, heads mp
  does not divide, a model built before the topology; a follower cannot
  step (what waits for the rest of ROADMAP A11 at mp > 1 is tested with
  the fleet, in ``tests/test_torch_tp_fleet.py``).
* ROADMAP C13: the JAX engine refuses ``use_pallas_paged=True`` on its
  legacy families at mp > 1; the port's ranks take it.
* ``server --mp 2`` on the CPU: ``/readyz`` says ``ok dp=1 mp=2``, a
  completion equals the CLI model's mp=1 tokens, SIGTERM exits 0.

One world (``torch_dist_ranks.tp_serving_rank``, one spawn in a module
fixture) runs every port scenario while the JAX side runs here.
"""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
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
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.ops.paged_attention import shard_kv_pool

TP = ranks.TP
CASES = [f"{n}.{f}" for n in ranks.TP_SCENARIOS for f in ranks.TP_FAMILIES]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_runs(jm):
    """The JAX engine at mp=2: every scenario's tokens, generate, and the
    dense-cache logits."""
    local = threading.local()

    def scenario(case):
        name, family = case.split(".")
        fields, waves = ranks.TP_SCENARIOS[name]
        if not hasattr(local, "model"):
            # a model a thread: tracing a step swaps the model's
            # parameters for tracers
            with lock:
                paddle.seed(0)
                local.model = JaxLlama(JaxLlamaConfig.tiny(
                    num_hidden_layers=2))
        eng = jserving.EngineCore(local.model, config=ranks.tp_config(
            jserving, family, **fields))
        assert eng.mp == TP
        return ranks.tp_waves(eng, jserving.SamplingParams, waves)

    def generate():
        return jm.generate(paddle.to_tensor(ranks.TP_GENERATE_IDS),
                           max_new_tokens=6,
                           **ranks.TP_GENERATE).numpy().tolist()

    # the engines' and generate's compiles overlap on threads, each engine
    # with its own model
    lock = threading.Lock()
    with ThreadPoolExecutor(3) as pool:
        gen = pool.submit(generate)
        want = dict(zip(CASES, pool.map(scenario, CASES)))
        want["generate"] = gen.result()
    ids = ranks.TP_GENERATE_IDS
    cfg = jm.config
    shape = (2, 7, cfg.num_key_value_heads, cfg.head_dim)
    caches = [(Tensor(jnp.zeros(shape)), Tensor(jnp.zeros(shape)))
              for _ in range(2)]
    with paddle.no_grad():
        pre = jm(Tensor(jnp.asarray(ids)), caches=caches,
                 pos=Tensor(jnp.asarray(np.int32(0))))
        dec = jm(Tensor(jnp.asarray(ids[:, :1])), caches=caches,
                 pos=Tensor(jnp.asarray(np.int32(6))))
    want["logits"] = {"prefill": np.asarray(pre._value)[:, -1],
                      "decode": np.asarray(dec._value)[:, -1]}
    # ROADMAP C13: the JAX legacy families refuse the kernel flag at mp > 1
    with pytest.raises(ValueError, match="use_pallas_paged") as e:
        jserving.EngineCore(jm, num_blocks=16, block_size=4,
                            use_pallas_paged=True)
    want["c13"] = str(e.value)
    return want


@pytest.fixture(scope="module")
def mp_server(tmp_path_factory):
    """``server --mp 2`` on the CPU, started first so that it boots while
    the other sides run: the process and its stderr's file."""
    err = tmp_path_factory.mktemp("mp_server") / "server.err"
    with open(err, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.server",
             "--device", "cpu", "--layers", "2", "--blocks", "64", "--mp",
             "2", "--unified"], cwd=REPO, stdout=subprocess.PIPE, stderr=f,
            text=True)
    yield proc, err
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    proc.stdout.close()


@pytest.fixture(scope="module")
def sides(tmp_path_factory, mp_server):
    """The ranks (the port at mp=2, then at mp=1 on rank 0) run while the
    JAX side runs here."""
    out = str(tmp_path_factory.mktemp("tp_serving"))
    jtopology.init_mesh(mp=TP)
    try:
        paddle.seed(0)
        jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=2))
        state = {k: np.array(np.asarray(v), dtype=np.float32)
                 for k, v in jm.state_dict().items()}
        path = os.path.join(out, "state.npz")
        np.savez(path, **state)
        world = ranks.start_world(ranks.tp_serving_rank, out, path,
                                  nprocs=TP)
        try:
            want = _jax_runs(jm)
        finally:
            world.join()
    finally:
        jtopology.set_mesh(None)
    got = []
    for r in range(TP):
        with open(os.path.join(out, f"tp_serving_rank{r}.json")) as f:
            got.append(json.load(f))
        with np.load(os.path.join(out, f"tp_pools_rank{r}.npz")) as f:
            got[r]["pools"] = [f[f"k{i}"] for i in range(2)]
    mp1 = got[0]["mp1"]
    with np.load(os.path.join(out, "tp_pools_mp1.npz")) as f:
        mp1["plain.unified"]["pools"] = [f[f"k{i}"] for i in range(2)]
    return got, want, mp1


@pytest.mark.parametrize("case", CASES)
def test_greedy_tokens_match_jax_mp2_and_port_mp1(sides, case):
    got, want, mp1 = sides
    row = got[0]["scenarios"][case]
    assert row["tokens"] == want[case]
    assert row["tokens"] == mp1[case]["tokens"]
    name, family = case.split(".")
    c = row["counters"]
    if name == "preemption":
        assert c["preemptions"] > 0
    if name == "warm_prefix":
        assert c["prefix_cache_hit_tokens"] > 0
    if name == "chunked" and family == "legacy":
        assert c["chunked_prefill_steps"] > 0
    if name == "burst":
        assert row["burst_launches"] > 0
    assert row["occupancy"] == 0.0


@pytest.mark.parametrize("family", ranks.TP_FAMILIES)
def test_eager_at_mp2_over_the_bucket_sets_of_mp1(sides, family):
    """No capture at mp=2, on either rank (the reason is the engine's
    ``graphs.eager_reason``); the controller's bucket sets are mp=1's."""
    got, _, mp1 = sides
    for name in ranks.TP_SCENARIOS:
        case = f"{name}.{family}"
        assert got[0]["scenarios"][case]["buckets"] == mp1[case]["buckets"]
        assert got[0]["scenarios"][case]["traces"] == 0
        for r in range(TP):
            row = got[r]["scenarios"][case]
            assert row["captures"] == 0
            assert "ROADMAP A11 item 7" in row["eager_reason"]


def test_each_forward_issues_2l_plus_1_all_reduces_and_one_all_gather(sides):
    got, _, _ = sides
    layers = 2
    for case in CASES:
        fwd = got[0]["scenarios"][case]["forwards"]
        assert fwd > 0
        for r in range(TP):
            row = got[r]["scenarios"][case]
            assert row["forwards"] == fwd
            assert row["calls"] == {"all_reduce": fwd * (2 * layers + 1),
                                    "all_gather": fwd}


def test_ranks_hold_their_head_slices_of_the_mp1_pools(sides):
    """Each rank's pools are [num_blocks, block_size, Hkv/2, D], and after
    the plain unified run they hold the rank's heads of the mp=1 pools;
    free + reuse + allocated == num_blocks on every rank after every
    scenario."""
    got, _, mp1 = sides
    full = mp1["plain.unified"]["pools"]
    for r in range(TP):
        assert got[r]["scenarios"]["plain.unified"]["pool_shape"] == \
            [64, 4, 1, 16]
        for layer in range(2):
            want = shard_kv_pool(torch.from_numpy(full[layer]), r, TP)
            np.testing.assert_allclose(got[r]["pools"][layer], want.numpy(),
                                       rtol=0, atol=1e-5)
        assert all(row["pool_invariant"]
                   for row in got[r]["scenarios"].values())


def test_follower_launches_every_step_and_cannot_step_itself(sides):
    """The follower launches each of the controller's steps and samples the
    same tokens on its device (bursts feed those back), and stepping its
    engine itself raises."""
    got, _, _ = sides
    for case in CASES:
        row = got[1]["scenarios"][case]
        assert row["launches"] > 0
        assert row["sampled"] == got[0]["scenarios"][case]["sampled"]
        assert "follows the controller" in row["step_error"]


@pytest.mark.parametrize("family", ranks.TP_FAMILIES)
def test_mp_metrics_at_mp2_and_silent_at_mp1(sides, family):
    got, _, mp1 = sides
    phases = {"unified": ("ragged",), "legacy": ("prefill", "decode")}
    for name in ranks.TP_SCENARIOS:
        case = f"{name}.{family}"
        row = got[0]["scenarios"][case]
        assert row["mp_shards"] == TP
        for ph in phases[family]:
            assert row["collective"][ph] > 0
        if name == "burst":
            assert row["collective"]["burst"] > 0
        assert mp1[case]["mp_shards"] == 1
        assert not any(mp1[case]["collective"].values())


def test_llm_generate_is_spmd(sides):
    """Every rank returns the controller's outputs: the legacy plain
    tokens."""
    got, _, mp1 = sides
    for r in range(TP):
        assert got[r]["llm"] == mp1["plain.legacy"]["tokens"]


def test_generate_matches_jax_at_mp2(sides):
    got, want, _ = sides
    for r in range(TP):
        assert got[r]["generate"] == want["generate"]


def test_dense_cache_logits_within_1e5_of_jax_and_equal_on_both_ranks(sides):
    got, want, _ = sides
    for step in ("prefill", "decode"):
        ref = want["logits"][step]
        out = np.asarray(got[0]["logits"][step])
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        np.testing.assert_array_equal(np.asarray(got[1]["logits"][step]),
                                      out)


def test_c13_port_legacy_families_take_the_kernel_flag_at_mp2(sides):
    """The JAX engine raises on ``use_pallas_paged=True`` without the
    unified step at mp > 1 (its decode kernel is single-shard); the port's
    ranks launch the decode kernel on their own heads and build."""
    got, want, _ = sides
    assert "requires unified_step=True" in want["c13"]
    for r in range(TP):
        assert got[r]["c13"] == "no error"


def test_engine_checks_its_degree_heads_and_model(sides):
    got, _, _ = sides
    for r in range(TP):
        e = got[r]["errors"]
        assert e["whole_model"].startswith("ValueError") and \
            "init_mesh(mp=2)" in e["whole_model"]
        assert e["one_kv_head"].startswith("ValueError") and \
            "num_key_value_heads=1" in e["one_kv_head"]
        assert e["mismatch"].startswith("ValueError") and \
            "EngineConfig.mp=4" in e["mismatch"]


def test_mp2_without_a_topology_raises_in_process():
    from paddle_tpu_torch.models import LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1),
                             device="cpu")
    with pytest.raises(ValueError, match="init_mesh"):
        serving.EngineCore(model, config=serving.EngineConfig(mp=2))


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_server_mp2_readyz_completion_and_sigterm(mp_server):
    """``server --mp 2``: the child is the controller and starts one
    follower; a completion equals the same CLI model served at mp=1 in
    process; SIGTERM drains, and the controller (which joins its follower
    and fails on a follower's nonzero exit) exits 0."""
    from paddle_tpu_torch.serving.server import _toy_engine, _toy_model

    proc, err = mp_server
    port, seen = None, []
    deadline = time.monotonic() + 120
    while port is None and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        seen.append(line)
        m = re.search(r"serving on http://[\d.]+:(\d+) dp=1 mp=2", line)
        port = int(m.group(1)) if m else None
    assert port is not None, (seen, err.read_text()[-3000:])
    assert _http(port, "GET", "/readyz") == (200, b"ok dp=1 mp=2\n")
    status, data = _http(port, "POST", "/v1/completions",
                         {"prompt": [5, 9, 23, 7], "max_tokens": 6})
    assert status == 200, data
    tokens = json.loads(data)["choices"][0]["token_ids"]
    status, page = _http(port, "GET", "/metrics")
    assert b"serving_mp_shards 2" in page
    assert b'serving_collective_seconds_count{phase="ragged"}' in page
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=120) == 0, err.read_text()[-3000:]
    eng = _toy_engine(_toy_model(2, "cpu"), num_blocks=64, unified=True)
    req = eng.add_request([5, 9, 23, 7],
                          serving.SamplingParams(max_new_tokens=6))
    eng.run()
    assert tokens == [int(t) for t in req.output_tokens]


def test_b1_and_b2_geometry_at_a_ranks_heads_and_indivisible_heads_raise():
    """At Llama-3-8B widths and mp=2 a rank passes 16 query and 4 KV heads:
    B1's grid (``launch_shape``, on the card's 132 SMs) and B2's head
    groups come from those counts alone (the GQA group of 4 is mp=1's), as
    ``chip_smoke.py``'s ``mp_serve_shape`` reads them on the card; heads
    that do not group over the KV heads raise in both dispatches."""
    from paddle_tpu_torch.ops import paged_decode as pd
    from paddle_tpu_torch.ops import ragged_paged as rp

    assert rp.launch_shape(512, 16, 4, 128, 132) == {
        "per": 32, "nsplit": 5, "chunk_blocks": 66, "decode_blocks": 27}
    assert rp.launch_shape(512, 32, 8, 128, 132)["nsplit"] == 3
    assert pd.head_groups(16, 4, "mma") == (4, 4)
    q = torch.zeros(4, 3, 16)
    pool = torch.zeros(8, 4, 2, 16)
    i32 = torch.int32
    with pytest.raises(ValueError, match="do not group"):
        rp.ragged_paged_attention(q, pool, pool, torch.zeros(4, 2, dtype=i32),
                                  torch.ones(4, dtype=i32),
                                  torch.zeros(4, dtype=i32),
                                  torch.zeros(4, dtype=i32))
    with pytest.raises(ValueError, match="do not group"):
        pd.paged_attention_decode(q, pool, pool, torch.zeros(4, 2, dtype=i32),
                                  torch.ones(4, dtype=i32))
