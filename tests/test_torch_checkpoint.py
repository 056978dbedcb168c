"""Checkpoints across the packages: ``paddle_tpu_torch.framework`` save /
load in the JAX file format, the optimizer and scheduler state dicts, and
``convert``'s mapping of names, parameter order and linear layouts.

* JAX → port: the JAX GPT trains 2 AdamW steps (under ``LinearWarmup`` →
  ``CosineAnnealingDecay``) and ``paddle_tpu.save``s model and optimizer;
  the port ``load``s, converts and trains 2 more.  Losses within 1e-5
  relative of the JAX model's own steps 3 and 4, parameters within 1% of
  the largest move of the 4 steps (``torch_train_pairs.py``).
* Port → JAX: the same the other way.
* Port → port: 2 steps, save, a fresh model and optimizer load, 2 more —
  bit-equal to 4 uninterrupted steps on the CPU.
* bf16 leaves both ways: a JAX bf16 model's file loads into a bf16 port
  model bit for bit (weights, masters, moments; the file names
  ``ml_dtypes``), and the port's bf16 tensors reach ``paddle_tpu.load`` as
  ``ml_dtypes.bfloat16`` arrays with the same bits; without ``ml_dtypes``
  installed (hidden in a fresh interpreter) the port reads and writes them
  all the same.
* A scheduler's state crosses with the optimizer's (``LR_Scheduler``).
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import convert, framework
from paddle_tpu_torch.models import GPTConfig, GPTPretrainingCriterion
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as lr_mod
from torch_train_pairs import assert_params_close, gradient_scales

REPO = Path(__file__).resolve().parent.parent
CFG = dict(num_hidden_layers=2)
LR = 1e-3


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(LR, T_max=8), 2, 0.0,
                            LR)


def _batches(n=4):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (2, 16)) for _ in range(n)]


def _jax_setup(dtype=None, multi_precision=False):
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig.tiny(**CFG))
    if dtype:
        jm.to(dtype=dtype)
    sched = _sched(jlr)
    opt = paddle.optimizer.AdamW(learning_rate=sched,
                                 parameters=jm.parameters(),
                                 weight_decay=0.01,
                                 multi_precision=multi_precision)
    return jm, opt, sched


def _port_setup(state, dtype=None, multi_precision=False):
    model = convert.gpt_from_paddle_tpu(state, GPTConfig.tiny(**CFG),
                                        device="cpu", dtype=dtype)
    sched = _sched(lr_mod)
    opt = AdamW(learning_rate=sched, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=multi_precision)
    return model, opt, sched


def _jax_state(jm):
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _jax_steps(jm, opt, sched, batches, scales=None):
    losses = []
    for ids in batches:
        jids = paddle.to_tensor(ids, dtype="int64")
        loss = JaxCriterion()(jm(jids), jids)
        loss.backward()
        if scales is not None and not scales:
            scales.update(gradient_scales(jm))
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
    return losses


def _port_steps(model, opt, sched, batches):
    losses = []
    for ids in batches:
        tids = torch.from_numpy(ids)
        loss = GPTPretrainingCriterion()(model(tids), tids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss.item())
    return losses


def test_jax_checkpoint_trains_on_in_the_port(tmp_path):
    batches = _batches()
    jm, jopt, jsched = _jax_setup()
    scales = {}
    _jax_steps(jm, jopt, jsched, batches[:2], scales)
    path = str(tmp_path / "jax.pdparams")
    paddle.save({"model": jm.state_dict(), "opt": jopt.state_dict()}, path)
    tail = _jax_steps(jm, jopt, jsched, batches[2:])

    ck = framework.load(path, device="cpu")
    model, opt, sched = _port_setup(ck["model"])
    opt.set_state_dict(convert.optimizer_state_from_paddle_tpu(ck["opt"],
                                                               model))
    assert opt._step_count == 2 and sched.last_epoch == 2
    got = _port_steps(model, opt, sched, batches[2:])
    np.testing.assert_allclose(got, tail, rtol=1e-5)
    assert_params_close(convert.to_paddle_tpu(model), jm, scales, 4 * LR)
    assert sched.state_dict() == jsched.state_dict()


def test_port_checkpoint_trains_on_in_jax(tmp_path):
    batches = _batches()
    jm, jopt, jsched = _jax_setup()
    model, opt, sched = _port_setup(_jax_state(jm))
    _port_steps(model, opt, sched, batches[:2])
    path = str(tmp_path / "port.pdparams")
    framework.save({"model": convert.to_paddle_tpu(model),
                    "opt": convert.optimizer_state_to_paddle_tpu(
                        opt.state_dict(), model)}, path)
    tail = _port_steps(model, opt, sched, batches[2:])

    ck = paddle.load(path)
    missing, unexpected = jm.set_state_dict(ck["model"])
    assert not missing and not unexpected
    jopt.set_state_dict(ck["opt"])
    assert jsched.last_epoch == 2
    scales = {}
    got = _jax_steps(jm, jopt, jsched, batches[2:], scales)
    np.testing.assert_allclose(got, tail, rtol=1e-5)
    assert_params_close(convert.to_paddle_tpu(model), jm, scales, 4 * LR)


def test_port_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    batches = _batches()
    jm, _, _ = _jax_setup()
    state = _jax_state(jm)
    model, opt, sched = _port_setup(state)
    whole = _port_steps(model, opt, sched, batches)

    first, opt1, sched1 = _port_setup(state)
    part = _port_steps(first, opt1, sched1, batches[:2])
    path = str(tmp_path / "resume.pdparams")
    framework.save({"model": first.state_dict(), "opt": opt1.state_dict()},
                   path)
    ck = framework.load(path, device="cpu")
    again, opt2, sched2 = _port_setup(state)
    again.load_state_dict(ck["model"])
    opt2.set_state_dict(ck["opt"])
    part += _port_steps(again, opt2, sched2, batches[2:])
    assert part == whole
    for (name, p), q in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
    assert not any(v.requires_grad for v in ck["model"].values())


def _raw_dtype_names(path):
    """The dtype name of every array in a checkpoint, read with the JAX
    package's own (plain) unpickling."""
    names = set()

    def walk(o):
        if isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif isinstance(o, np.ndarray):
            names.add(o.dtype.name)

    with open(path, "rb") as f:
        walk(pickle.load(f))
    return names


@pytest.mark.parametrize("multi_precision", [False, True])
def test_bf16_checkpoints_cross_both_ways(tmp_path, multi_precision):
    batches = _batches(2)
    jm, jopt, jsched = _jax_setup("bfloat16", multi_precision)
    _jax_steps(jm, jopt, jsched, batches[:1])
    path = str(tmp_path / "jax_bf16.pdparams")
    paddle.save({"model": jm.state_dict(), "opt": jopt.state_dict()}, path)
    assert "bfloat16" in _raw_dtype_names(path)

    ck = framework.load(path, device="cpu")
    model, opt, sched = _port_setup(ck["model"], torch.bfloat16,
                                    multi_precision)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    opt.set_state_dict(convert.optimizer_state_from_paddle_tpu(ck["opt"],
                                                               model))
    back = convert.to_paddle_tpu(model)
    for name, arr in _jax_state(jm).items():
        np.testing.assert_array_equal(back[name], arr.astype(np.float32),
                                      err_msg=name)
    # every slot, moved through the port's optimizer and back, bit-equal
    again = convert.optimizer_state_to_paddle_tpu(opt.state_dict(), model)
    jstate = jopt.state_dict()
    assert set(again) == set(jstate)
    for k, v in jstate.items():
        if k in ("step", "LR_Scheduler"):
            assert again[k] == v
            continue
        want = np.asarray(v._value)
        assert str(again[k].dtype) == f"torch.{want.dtype.name}", k
        np.testing.assert_array_equal(again[k].float().numpy(),
                                      want.astype(np.float32), err_msg=k)

    # the port's bf16 tensors into the JAX package: ml_dtypes arrays
    _port_steps(model, opt, sched, batches[1:])
    out = str(tmp_path / "port_bf16.pdparams")
    framework.save({"weights": dict(model.state_dict()),
                    "opt": convert.optimizer_state_to_paddle_tpu(
                        opt.state_dict(), model)}, out)
    assert "bfloat16" in _raw_dtype_names(out)
    jck = paddle.load(out)
    for name, p in model.state_dict().items():
        got = np.asarray(jck["weights"][name]._value)
        assert got.dtype.name == "bfloat16"
        np.testing.assert_array_equal(got.astype(np.float32),
                                      p.float().numpy(), err_msg=name)
    jopt.set_state_dict(jck["opt"])
    missing, _ = jm.set_state_dict(convert.to_paddle_tpu(model))
    assert not missing


def test_bf16_without_ml_dtypes(tmp_path):
    """A fresh interpreter with ``ml_dtypes`` hidden reads a JAX bf16 file
    and writes one that ``paddle_tpu.load`` reads back."""
    src = str(tmp_path / "jax.pdparams")
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    jt = paddle.to_tensor(a).astype("bfloat16")
    paddle.save({"w": jt, "n": 3}, src)
    dst = str(tmp_path / "port.pdparams")
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from paddle_tpu_torch import framework\n"
        f"o = framework.load({src!r}, device='cpu')\n"
        "assert o['w'].dtype == torch.bfloat16 and o['n'] == 3\n"
        f"framework.save({{'w': o['w'] * 2}}, {dst!r})\n"
        "assert 'ml_dtypes' not in [m for m in sys.modules "
        "if sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    back = paddle.load(dst)["w"]
    want = np.asarray(jt._value).astype(np.float32) * 2
    np.testing.assert_array_equal(np.asarray(back._value).astype(np.float32),
                                  want)
