"""The port's tensor-parallel layers at mp=4, the global-norm clip over
sliced gradients, the model-parallel RNG tracker, ``SyncBatchNorm`` at
dp=4 and ``DataParallel`` on 4 gloo ranks on the CPU, against the JAX
package's layers on the same weights and inputs.

The JAX side runs ``tests/test_parallel.py``'s cases (``:49-96``) on its
dp2 x mp4 mesh of the 8 CPU devices; the port's side is one world of 4
ranks (``torch_dist_ranks.mp_layers_rank``, one spawn in a module
fixture), each holding its slices; their outputs and their gradients,
gathered to full tensors, must match within rtol 1e-5.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
import torch_dist_ranks as ranks
from paddle_tpu import nn as jnn
from paddle_tpu import parallel as jpl
from paddle_tpu.distributed import topology as jtopology

W = ranks.WORLD
RTOL = 1e-5


def _arr(t):
    return np.asarray(t.numpy(), dtype=np.float32)


def _jax_side():
    """Weights, inputs and the JAX layers' outputs and gradients."""
    rng = np.random.default_rng(7)
    a, want = {}, {}

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def grads(prefix, layer):
        for name, p in layer.named_parameters():
            want[f"{prefix}.{name}.grad"] = _arr(p.grad)

    def weights(prefix, layer):
        for name, p in layer.named_parameters():
            a[f"{prefix}.{name}"] = _arr(p)
            if name == "bias":       # non-zero biases: they must reach y
                b = f32(*p.shape)
                p.set_value(b)
                a[f"{prefix}.{name}"] = b

    jtopology.init_mesh(dp=2, mp=4)
    try:
        paddle.seed(11)
        col = jpl.ColumnParallelLinear(16, 32, gather_output=False)
        row = jpl.RowParallelLinear(32, 16, input_is_parallel=True)
        weights("pair.col", col)
        weights("pair.row", row)
        a["pair.x"], a["pair.dy"] = f32(4, 8, 16), f32(4, 8, 16)
        x = paddle.to_tensor(a["pair.x"], stop_gradient=False)
        y = row(col(x))
        (y * paddle.to_tensor(a["pair.dy"])).sum().backward()
        want["pair.out"], want["pair.x.grad"] = _arr(y), _arr(x.grad)
        grads("pair.col", col)
        grads("pair.row", row)
        pairs = [(p, p.grad) for p in [col.weight, col.bias, row.weight,
                                       row.bias]]
        norm = np.sqrt(sum(float((_arr(g) ** 2).sum()) for _, g in pairs))
        a["clip_norm"] = np.float32(norm / 4)     # the clip must act
        for (p, g), name in zip(jnn.ClipGradByGlobalNorm(norm / 4)(pairs),
                                ["col.weight", "col.bias", "row.weight",
                                 "row.bias"]):
            want[f"clip.{name}"] = _arr(g)

        col = jpl.ColumnParallelLinear(8, 16, gather_output=True)
        weights("gather.col", col)
        a["gather.x"] = f32(2, 8)
        y = col(paddle.to_tensor(a["gather.x"]))
        y.sum().backward()
        want["gather.out"] = _arr(y)
        grads("gather.col", col)

        emb = jpl.VocabParallelEmbedding(32, 16)
        weights("emb", emb)
        a["emb.ids"] = np.array([[1, 5, 31], [0, 2, 7]], np.int64)
        a["emb.dy"] = f32(2, 3, 16)
        y = emb(paddle.to_tensor(a["emb.ids"]))
        (y * paddle.to_tensor(a["emb.dy"])).sum().backward()
        want["emb.out"] = _arr(y)
        grads("emb", emb)

        col = jpl.ColumnParallelLinear(16, 8, gather_output=False)
        row = jpl.RowParallelLinear(8, 16, input_is_parallel=True)
        weights("flat.col", col)
        weights("flat.row", row)
        a["flat.x"] = f32(8, 16)
        y = row(col(paddle.to_tensor(a["flat.x"])))
        y.sum().backward()
        want["flat.out"] = _arr(y)
        grads("flat.col", col)
        grads("flat.row", row)

        row = jpl.RowParallelLinear(16, 8, input_is_parallel=False)
        weights("split.row", row)
        a["split.x"], a["split.dy"] = f32(3, 16), f32(3, 8)
        x = paddle.to_tensor(a["split.x"], stop_gradient=False)
        y = row(x)
        (y * paddle.to_tensor(a["split.dy"])).sum().backward()
        want["split.out"], want["split.x.grad"] = _arr(y), _arr(x.grad)
        grads("split.row", row)

        a["ce.logits"] = f32(6, 32) * 3
        a["ce.labels"] = np.array([3, 31, 8, -100, 17, 0], np.int64)
        logits = paddle.to_tensor(a["ce.logits"], stop_gradient=False)
        loss = jpl.ParallelCrossEntropy()(logits,
                                          paddle.to_tensor(a["ce.labels"]))
        loss.backward()
        want["ce.loss"], want["ce.grad"] = _arr(loss), _arr(logits.grad)
    finally:
        jtopology.set_mesh(None)

    # SyncBatchNorm: the JAX layer holds the whole batch in one process
    bn = jnn.SyncBatchNorm(3)
    a["bn.weight"], a["bn.bias"] = f32(3), f32(3)
    bn.weight.set_value(a["bn.weight"])
    bn.bias.set_value(a["bn.bias"])
    a["bn.x"], a["bn.dy"] = f32(8, 3, 4, 4) * 2 + 1, f32(8, 3, 4, 4)
    x = paddle.to_tensor(a["bn.x"], stop_gradient=False)
    y = bn(x)
    (y * paddle.to_tensor(a["bn.dy"])).sum().backward()
    want.update({"bn.out": _arr(y), "bn.x.grad": _arr(x.grad),
                 "bn.weight.grad": _arr(bn.weight.grad),
                 "bn.bias.grad": _arr(bn.bias.grad),
                 "bn.mean": _arr(bn._mean), "bn.variance": _arr(bn._variance)})

    # DataParallel: the JAX model on the whole batch
    lin1, lin2 = jnn.Linear(6, 5), jnn.Linear(5, 3)
    for prefix, lin in (("0", lin1), ("2", lin2)):
        lin.bias.set_value(f32(*lin.bias.shape))
        a[f"dp.{prefix}.weight"] = _arr(lin.weight).T.copy()  # port layout
        a[f"dp.{prefix}.bias"] = _arr(lin.bias)
    a["dp.x"] = f32(8, 6)
    x = paddle.to_tensor(a["dp.x"])
    lin2(paddle.tanh(lin1(x))).square().mean().backward()
    for prefix, lin in (("0", lin1), ("2", lin2)):
        want[f"dp.{prefix}.weight.grad"] = _arr(lin.weight.grad).T
        want[f"dp.{prefix}.bias.grad"] = _arr(lin.bias.grad)
    return a, want


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_layers")
    a, want = _jax_side()
    path = str(out / "arrays.npz")
    np.savez(path, **a)
    ranks.spawn_world(ranks.mp_layers_rank, str(out), path)
    return [ranks.load(str(out), "mp_layers", r) for r in range(W)], want


def _check(got, want, key):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("case", ["pair", "gather", "emb", "flat", "split"])
def test_layer_outputs_and_gathered_grads_match_jax(case, sides):
    got, want = sides
    keys = [k for k in want if k.startswith(case + ".")]
    assert len(keys) >= 2
    for r in range(W):
        for k in keys:
            _check(got[r][k], want[k], f"rank {r} {k}")


def test_parallel_cross_entropy_matches_jax(sides):
    got, want = sides
    for r in range(W):
        _check(got[r]["ce.loss"], want["ce.loss"], "loss")
        _check(got[r]["ce.grad"], want["ce.grad"], "logits grad")


def test_global_norm_clip_sums_slices_over_the_mp_group(sides):
    """Each rank clips its slices with the whole model's norm: the
    gathered clipped gradients are the JAX clip's (a norm taken rank by
    rank would scale them by another factor)."""
    got, want = sides
    for r in range(W):
        for name in ("col.weight", "col.bias", "row.weight", "row.bias"):
            _check(got[r][f"clip.{name}"], want[f"clip.{name}"], name)
    assert not np.allclose(want["clip.col.weight"],
                           want["pair.col.weight.grad"])


def test_rng_tracker_streams(sides):
    """At dp2 x mp2: the tracker's draws differ across mp ranks and agree
    across dp ranks; draws outside it agree everywhere, and the global
    stream goes on as if the tracker's draws had not happened; a second
    entry continues the tracker's stream."""
    got, _ = sides
    for key in ("rng_outside", "rng_after"):
        for r in range(1, W):
            np.testing.assert_array_equal(got[r][key], got[0][key])
    for r in range(W):
        mp, dp_peer = r % 2, (r + 2) % W
        for key in ("rng_inside", "rng_dropout", "rng_inside2"):
            np.testing.assert_array_equal(got[r][key], got[dp_peer][key])
            assert not np.array_equal(got[r][key], got[r ^ 1][key]), key
        assert not np.array_equal(got[r]["rng_inside"],
                                  got[r]["rng_inside2"])
        assert mp in (0, 1)


def test_sync_batch_norm_at_dp4_matches_the_jax_layer(sides):
    """Each rank's quarter of the JAX layer's outputs and input gradients,
    parameter gradients whose sum over the ranks is the JAX layer's, and
    the JAX layer's running statistics."""
    got, want = sides
    q = want["bn.out"].shape[0] // W
    for r in range(W):
        _check(got[r]["bn.out"], want["bn.out"][r * q:(r + 1) * q], "out")
        _check(got[r]["bn.x.grad"], want["bn.x.grad"][r * q:(r + 1) * q],
               "x grad")
        _check(got[r]["bn.mean"], want["bn.mean"], "running mean")
        _check(got[r]["bn.variance"], want["bn.variance"], "running var")
        assert str(got[r]["bn.converted"]) == "SyncBatchNorm"
    for name in ("bn.weight.grad", "bn.bias.grad"):
        _check(sum(got[r][name] for r in range(W)), want[name], name)


def test_data_parallel_averages_over_the_group(sides):
    """Gradients of the mean loss over the whole batch (the JAX model's),
    through several buckets; under ``no_sync`` a rank keeps its own, and
    the next synced backward averages what accumulated."""
    got, want = sides
    for r in range(W):
        assert int(got[r]["dp.buckets"]) >= 2
        for name in ("0.weight", "0.bias", "2.weight", "2.bias"):
            _check(got[r][f"dp.{name}.grad"], want[f"dp.{name}.grad"], name)
    local = [got[r]["dp.local.0.weight.grad"] for r in range(W)]
    assert not np.allclose(local[0], local[1])
    for r in range(W):
        _check(got[r]["dp.accum.0.weight.grad"],
               want["dp.0.weight.grad"] + sum(local) / W, "accumulated")
