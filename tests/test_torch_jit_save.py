"""``jit.save`` / ``jit.load`` of the port held to the JAX package's on the
CPU (``paddle_tpu/jit/__init__.py``): the same weights, carried over by
``convert``, through both packages' save and load.

* ``tests/test_jit.py``'s ``test_export_roundtrip``, mirrored: a small MLP
  saved and loaded, within 1e-5 of its eager output.
* A small CNN with BatchNorm (buffers in the state) and a ``None`` batch
  dim (1, as in the JAX package): the loaded outputs within 1e-5 of the
  JAX package's round trip, and the ``.pdiparams`` arrays equal to the
  JAX package's, in its ``state_dict`` order and layout.
* A bf16 layer's ``.pdiparams`` unpickles (with ``ml_dtypes``, as the JAX
  package reads it) to the bf16 values.
* A 2-layer narrow ViT (head dim 64): its exported graph holds
  ``paddle_tpu_torch::flash_fwd`` and none of the attention's own ops
  (the composite's ``softmax``, the twin's ``amax`` / ``exp``); the loaded
  program within 1e-5 of the JAX package's round trip.
* ``train()`` on a loaded program raises, and so does a batch of another
  size than the export's; ``save`` without an input spec raises as the
  JAX one does.
* A fresh process that imports ``paddle_tpu_torch.jit`` alone, names no
  model class and loads no JAX runs the ViT artifact to the same
  outputs.

On the card (``tests/test_torch_jit_cuda.py``) the loaded ViT launches
the flash kernel.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.static import InputSpec as JInputSpec
from paddle_tpu.vision.models import VisionTransformer as JViT
from paddle_tpu_torch import convert, jit
from paddle_tpu_torch import nn
from paddle_tpu_torch.static import InputSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _a(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _pdiparams(path):
    with open(path + ".pdiparams", "rb") as f:
        return pickle.load(f)


def test_export_roundtrip(tmp_path):
    model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    model.eval()
    x = torch.from_numpy(_a((2, 4), 0))
    expected = model(x).detach().numpy()
    path = str(tmp_path / "model")
    jit.save(model, path, input_spec=[InputSpec([2, 4], "float32")])
    loaded = jit.load(path)
    np.testing.assert_allclose(loaded(x).numpy(), expected, rtol=1e-5)


def _cnn(pkg):
    return pkg.Sequential(pkg.Conv2D(3, 4, 3, padding=1),
                          pkg.BatchNorm2D(4), pkg.ReLU(),
                          pkg.MaxPool2D(2, 2), pkg.Flatten(),
                          pkg.Linear(4 * 4 * 4, 5))


def test_same_weights_through_both_packages(tmp_path):
    paddle.seed(3)
    jm = _cnn(jnn)
    state = _state(jm)
    rng = np.random.default_rng(4)          # running statistics of a run
    state["1._mean"] = rng.standard_normal(4).astype(np.float32) * 0.1
    state["1._variance"] = rng.uniform(0.5, 1.5, 4).astype(np.float32)
    jm.set_state_dict(state)
    tm = _cnn(nn)
    convert.load_paddle_tpu_state(tm, state)
    x = _a((1, 3, 8, 8), 5)
    jpath, tpath = str(tmp_path / "jax" / "m"), str(tmp_path / "port" / "m")
    paddle.jit.save(jm, jpath,
                    input_spec=[JInputSpec([None, 3, 8, 8], "float32")])
    jit.save(tm, tpath, input_spec=[InputSpec([None, 3, 8, 8], "float32")])
    want = np.asarray(paddle.jit.load(jpath)(paddle.to_tensor(x)).numpy())
    got = jit.load(tpath)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jarrs, tarrs = _pdiparams(jpath), _pdiparams(tpath)
    assert len(tarrs) == len(jarrs) == len(state)
    assert jit.state_order(tm) == list(jm.state_dict())
    for t, j in zip(tarrs, jarrs):
        assert t.dtype == j.dtype
        np.testing.assert_array_equal(t, j)


def test_bf16_state_crosses_as_the_jax_package_reads_it(tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    lin = nn.Linear(4, 3, dtype=torch.bfloat16)
    path = str(tmp_path / "bf16")
    jit.save(lin, path, input_spec=[InputSpec([2, 4], "bfloat16")])
    w, b = _pdiparams(path)
    assert w.dtype == b.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(w.astype(np.float32),
                                  lin.weight.detach().float().numpy().T)
    np.testing.assert_array_equal(b.astype(np.float32),
                                  lin.bias.detach().float().numpy())
    loaded = jit.load(path)
    x = torch.from_numpy(_a((2, 4), 6)).bfloat16()
    assert torch.equal(loaded(x), lin(x).detach())


VIT = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2,
           class_num=5)


@pytest.fixture(scope="module")
def vit_artifact(tmp_path_factory):
    paddle.seed(7)
    jm = JViT(**VIT)
    jm.eval()
    tm = convert.vit_from_paddle_tpu(_state(jm), num_heads=2, device="cpu")
    root = tmp_path_factory.mktemp("vit")
    jpath, tpath = str(root / "jax"), str(root / "port")
    paddle.jit.save(jm, jpath, input_spec=[JInputSpec([2, 3, 32, 32])])
    jit.save(tm, tpath, input_spec=[InputSpec([2, 3, 32, 32])])
    x = _a((2, 3, 32, 32), 8)
    want = np.asarray(paddle.jit.load(jpath)(paddle.to_tensor(x)).numpy())
    return tpath, x, want


def test_exported_vit_holds_the_flash_op(vit_artifact):
    path, x, want = vit_artifact
    loaded = jit.load(path)
    targets = [str(n.target) for n in loaded.program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paddle_tpu_torch.flash_fwd.default") == 2
    attention = {"aten.softmax.int", "aten._softmax.default",
                 "aten.amax.default", "aten.exp.default",
                 "aten.logsumexp.default", "aten.einsum.default"}
    assert not attention & set(targets)
    got = loaded(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_loaded_program_is_inference_only(vit_artifact):
    loaded = jit.load(vit_artifact[0])
    assert loaded.eval() is loaded
    with pytest.raises(RuntimeError, match="inference-only"):
        loaded.train()
    with pytest.raises(ValueError, match="takes"):    # one batch size (C8)
        loaded(torch.zeros(1, 3, 32, 32))
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(nn.Linear(2, 2), str(vit_artifact[0]) + "_x")


CHILD = """
import sys
import numpy as np
import torch
from paddle_tpu_torch import jit
loaded = jit.load(sys.argv[1])
out = loaded(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], out.numpy())
assert not [m for m in sys.modules
            if m == "paddle_tpu" or m.startswith(("jax", "paddle_tpu."))]
"""


def test_a_fresh_process_loads_with_no_model_class(vit_artifact, tmp_path):
    path, x, want = vit_artifact
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", CHILD, path, str(tmp_path / "x.npy"),
                    str(tmp_path / "out.npy")], check=True, env=env,
                   cwd=str(tmp_path), timeout=120)
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want,
                               rtol=1e-5, atol=1e-5)
