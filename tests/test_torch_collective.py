"""The port's collectives, process topology, spawn and launch on 4 gloo
ranks on the CPU, against the JAX package's collectives inside
``shard_map`` over 4 of the 8 CPU devices (``tests/conftest.py``) and
against numpy, on the same per-rank inputs.

One world of 4 ranks (``torch_dist_ranks.collectives_rank``, started by
the port's ``spawn`` in a module fixture) runs every collective and
writes its results; each test reads them.  The spawn has its own
timeouts: a collective waits at most ``PG_TIMEOUT`` seconds for a peer and
the test at most ``JOIN_TIMEOUT`` for the world, so a hung collective
fails a test and never the run.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_ranks as ranks
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.distributed import collective as jc
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.distributed.launch.main import launch as jax_launch
from paddle_tpu.parallel._compat import shard_map
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed.spawn import (
    ProcessRaisedException,
    SpawnTimeout,
    spawn,
)
from paddle_tpu_torch.distributed.launch.main import launch as port_launch

W = ranks.WORLD
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("collectives"))
    ranks.spawn_world(ranks.collectives_rank, out)
    return [ranks.load(out, "collectives", r) for r in range(W)]


@pytest.fixture(scope="module")
def inputs():
    return [ranks.collective_inputs(r) for r in range(W)]


@pytest.fixture(scope="module")
def jax_results(inputs):
    return _jax_collectives(inputs)


def _jax_collectives(inputs):
    """The JAX package's collectives on the same per-rank inputs, one
    shard_map over a 4-device ``dp`` axis: rank r is device r."""
    mesh = Mesh(np.array(jax.devices()[:W]), ("dp",))
    stack = {k: np.stack([i[k] for i in inputs]) for k in inputs[0]}

    def body(x, blocks, parts, scat):
        x, blocks, parts, scat = x[0], blocks[0], parts[0], scat[0]
        out = {}
        for name, op in (("sum", jc.ReduceOp.SUM), ("max", jc.ReduceOp.MAX),
                         ("min", jc.ReduceOp.MIN), ("avg", jc.ReduceOp.AVG)):
            t = JaxTensor(x)
            jc.all_reduce(t, op=op, group="dp")
            out[f"all_reduce_{name}"] = t._value
        lst = []
        jc.all_gather(lst, JaxTensor(x), group="dp")
        out["all_gather"] = jnp.stack([t._value for t in lst])
        t = JaxTensor(x)
        jc.reduce_scatter(t, JaxTensor(blocks), group="dp")
        out["reduce_scatter"] = t._value
        t = JaxTensor(x)
        jc.broadcast(t, src=2, group="dp")
        out["broadcast"] = t._value
        t = JaxTensor(scat[0])
        jc.scatter(t, [JaxTensor(s) for s in scat], src=1, group="dp")
        out["scatter"] = t._value
        t = JaxTensor(x)
        jc.reduce(t, dst=3, group="dp")
        out["reduce"] = t._value
        lst = []
        jc.alltoall(lst, [JaxTensor(p) for p in parts], group="dp")
        out["alltoall"] = jnp.stack([t._value for t in lst])
        t = JaxTensor(blocks)
        jc.alltoall_single(t, JaxTensor(blocks), group="dp")
        out["alltoall_single"] = t._value
        out["ring"] = jc.ppermute(JaxTensor(x), "dp",
                                  [(i, (i + 1) % W) for i in range(W)])._value
        return {k: v[None] for k, v in out.items()}

    keys = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
            "all_reduce_avg", "all_gather", "reduce_scatter", "broadcast",
            "scatter", "reduce", "alltoall", "alltoall_single", "ring"]
    f = shard_map(lambda *a: tuple(body(*a)[k] for k in keys), mesh=mesh,
                  in_specs=(P("dp"),) * 4, out_specs=(P("dp"),) * len(keys),
                  check_vma=False)
    # the JAX scatter takes every rank's list; rank 1's is the source
    scat = np.broadcast_to(stack["scatter"][1], stack["scatter"].shape)
    got = jax.jit(f)(stack["x"], stack["blocks"], stack["parts"],
                     np.ascontiguousarray(scat))
    return {k: np.asarray(v) for k, v in zip(keys, got)}


def _numpy_collectives(inputs):
    x = np.stack([i["x"] for i in inputs])
    blocks = np.stack([i["blocks"] for i in inputs])
    parts = np.stack([i["parts"] for i in inputs])
    per_rank = []
    for r in range(W):
        per_rank.append({
            "all_reduce_sum": x.sum(0), "all_reduce_max": x.max(0),
            "all_reduce_min": x.min(0), "all_reduce_avg": x.mean(0),
            "all_reduce_prod": np.prod(np.stack([i["pos"] for i in inputs]),
                                       0),
            "all_gather": x, "reduce_scatter":
                blocks.sum(0)[2 * r:2 * r + 2],
            "broadcast": x[2], "scatter": inputs[1]["scatter"][r],
            "alltoall": parts[:, r],
            "alltoall_single": np.concatenate(
                [blocks[s][2 * r:2 * r + 2] for s in range(W)]),
            "ring": x[(r - 1) % W]})
    return per_rank


CASES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
         "all_reduce_avg", "all_gather", "reduce_scatter", "broadcast",
         "scatter", "alltoall", "alltoall_single", "ring"]


@pytest.mark.parametrize("case", CASES)
def test_collective_matches_jax_and_numpy(case, results, inputs,
                                          jax_results):
    jax_out = jax_results[case]
    want = _numpy_collectives(inputs)
    for r in range(W):
        got = results[r][case]
        np.testing.assert_allclose(got, want[r][case], rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r} against numpy")
        np.testing.assert_allclose(got, jax_out[r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"rank {r} against JAX")


def test_reduce_lands_on_dst_and_prod_matches_numpy(results, inputs,
                                                    jax_results):
    """``reduce`` holds the sum on rank 3 only (the JAX ``reduce`` is an
    all-reduce: every device holds it); PROD, which the JAX collective
    lacks, against numpy."""
    want = _numpy_collectives(inputs)
    jax_out = jax_results["reduce"]
    np.testing.assert_allclose(results[3]["reduce"], want[3]["all_reduce_sum"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(results[3]["reduce"], jax_out[3], rtol=1e-6,
                               atol=1e-6)
    for r in range(W):
        np.testing.assert_allclose(results[r]["all_reduce_prod"],
                                   want[r]["all_reduce_prod"], rtol=1e-6)


def test_paddle_contracts(results, inputs):
    """A full output list is written in place; ``sync_op=False`` results
    arrive at ``wait()``; the stream variant; a list form of
    reduce_scatter; a subgroup (ranks 1 and 3, the others not members);
    the per-rank counters."""
    x = np.stack([i["x"] for i in inputs])
    for r in range(W):
        res = results[r]
        np.testing.assert_allclose(res["all_gather_inplace"], x, rtol=1e-6)
        np.testing.assert_allclose(res["async_all_reduce"], x.sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["async_all_gather"], x, rtol=1e-6)
        np.testing.assert_allclose(res["stream_all_reduce"], x.sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(res["reduce_scatter_list"],
                                   res["reduce_scatter"], rtol=1e-6)
        want = x[1] + x[3] if r in (1, 3) else x[r]
        np.testing.assert_allclose(res["subgroup"], want, rtol=1e-6,
                                   atol=1e-6)
        assert int(res["subgroup_rank"]) == {1: 0, 3: 1}.get(r, -1)
        calls = res["calls"]
        assert calls[0] >= 8 and calls[1] == 3


def test_unsupported_collective_names_the_backend(results):
    for r in range(W):
        msg = str(results[r]["refusal"])
        assert "gloo backend" in msg and "all_reduce" in msg, msg


def test_hybrid_topology_matches_jax_layout(results, inputs):
    """dp2 x mp2: mp innermost, as the JAX mesh lays devices out; each
    rank's coordinates, degrees and groups; an all-reduce over the mp
    group sums the two mp neighbours."""
    jmesh = jtopology.init_mesh(dp=2, mp=2)
    try:
        jdev = np.vectorize(lambda d: d.id)(jmesh.devices)
        jhcg = jtopology.get_hybrid_communicate_group()
        jsizes = (jhcg.get_data_parallel_world_size(),
                  jhcg.get_model_parallel_world_size())
    finally:
        jtopology.set_mesh(None)
    x = np.stack([i["x"] for i in inputs])
    for r in range(W):
        res = results[r]
        np.testing.assert_array_equal(res["mesh"], jdev - jdev.min())
        dp, mp = divmod(r, 2)
        np.testing.assert_array_equal(res["hcg"], [dp, mp, *jsizes])
        np.testing.assert_array_equal(res["mp_group"], [2 * dp, 2 * dp + 1])
        np.testing.assert_array_equal(res["dp_group"], [mp, mp + 2])
        np.testing.assert_allclose(res["mp_all_reduce"],
                                   x[2 * dp] + x[2 * dp + 1], rtol=1e-6,
                                   atol=1e-6)


def test_world_size_is_per_rank_unlike_jax(results):
    """ROADMAP C12: the port's ``get_world_size`` counts ranks (4 at
    dp2 x mp2); the JAX package's is the dp degree (2) while a mesh is
    active, the process count (1) otherwise."""
    for r in range(W):
        assert int(results[r]["rank"]) == r
        assert int(results[r]["world"]) == W
    jtopology.init_mesh(dp=2, mp=2)
    try:
        assert jenv.get_world_size() == 2
        assert jenv.get_rank() == 0
    finally:
        jtopology.set_mesh(None)
    assert jenv.get_world_size() == 1
    assert tenv.get_world_size() == 1 and tenv.get_rank() == 0


def test_a_failing_rank_fails_spawn_and_stops_the_others(tmp_path):
    with pytest.raises(ProcessRaisedException) as e:
        ranks.spawn_world(ranks.failing_rank, str(tmp_path))
    assert e.value.rank == 2 and e.value.exitcode == 1
    assert "rank 2 fails on purpose" in e.value.error


def test_a_hung_collective_fails_on_the_group_timeout(tmp_path):
    """Rank 1 sleeps 120 s, past the process group's 5 s timeout: a rank
    fails long before the sleep ends (the others' all-reduce times out),
    and spawn stops every rank, rank 1 too."""
    t0 = time.monotonic()
    ctx = spawn(ranks.hanging_rank, args=(str(tmp_path), 120), nprocs=W,
                backend="gloo", pg_timeout=5, timeout=ranks.JOIN_TIMEOUT,
                join=False)
    with pytest.raises(ProcessRaisedException):
        ctx.join()
    assert time.monotonic() - t0 < 100
    assert all(not p.is_alive() for p in ctx.processes)


def test_spawn_join_timeout_stops_every_rank(tmp_path):
    ctx = spawn(ranks.hanging_rank, args=(str(tmp_path), 120), nprocs=W,
                backend="gloo", pg_timeout=ranks.PG_TIMEOUT, join=False)
    with pytest.raises(SpawnTimeout):
        ctx.join(timeout=8)
    assert all(not p.is_alive() for p in ctx.processes)


def test_nccl_refuses_two_ranks_on_one_card():
    tenv.check_nccl_devices(2, 2)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        tenv.check_nccl_devices(2, 1)


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return str(p)


@pytest.mark.parametrize("launcher", ["jax", "port"])
def test_launch_two_workers_env(tmp_path, launcher):
    """``tests/test_launch.py::test_launch_two_workers_env`` through both
    launchers: each rank sees its id, the world size and the master."""
    script = _write(tmp_path, "worker.py", f"""
        import os
        rank = os.environ["PADDLE_TRAINER_ID"]
        assert os.environ["PADDLE_TRAINERS_NUM"] == "2"
        assert os.environ["MASTER_ADDR"] == "127.0.0.1"
        assert os.environ["PADDLE_RANK_IN_NODE"] == rank
        open(r"{tmp_path}/rank_" + rank, "w").write("ok")
    """)
    if launcher == "jax":
        code = jax_launch(script, nproc_per_node=2, cpu_sim=True,
                          log_dir=str(tmp_path / "logs"))
    else:
        code = port_launch(script, nproc_per_node=2, backend="gloo",
                           log_dir=str(tmp_path / "logs"))
    assert code == 0
    assert (tmp_path / "rank_0").exists()
    assert (tmp_path / "rank_1").exists()
    assert (tmp_path / "logs" / "workerlog.0").exists()


@pytest.mark.parametrize("launcher", ["jax", "port"])
def test_launch_failure_propagates(tmp_path, launcher):
    script = _write(tmp_path, "bad.py", """
        import sys
        sys.exit(3)
    """)
    if launcher == "jax":
        assert jax_launch(script, nproc_per_node=2, cpu_sim=True) == 3
    else:
        assert port_launch(script, nproc_per_node=2, backend="gloo") == 3


def test_launch_cli_runs_a_gloo_world(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch --devices 0,1``: two
    ranks join one gloo group, all-reduce, and each rank's selected card
    is its entry of ``--devices``."""
    script = _write(tmp_path, "allreduce.py", f"""
        import os, torch
        import paddle_tpu_torch as paddle
        paddle.set_device("cpu")
        from paddle_tpu_torch import distributed as dist
        dist.init_parallel_env()
        t = torch.ones(3) * (dist.get_rank() + 1)
        dist.all_reduce(t)
        assert t.tolist() == [3.0, 3.0, 3.0], t
        assert os.environ["FLAGS_selected_gpus"] == str(dist.get_rank())
        open(r"{tmp_path}/done_" + str(dist.get_rank()), "w").write("ok")
    """)
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--devices", "0,1", "--backend", "gloo", script],
        capture_output=True, text=True, cwd=str(REPO), timeout=120,
        env={**os.environ,
             "PYTHONPATH": f"{REPO}:" + os.environ.get("PYTHONPATH", "")})
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "done_0").exists() and (tmp_path / "done_1").exists()
