"""The PyTorch port's training path, held to the JAX package on the CPU.

* ``cross_entropy`` against the JAX function: hard labels with and without
  ``ignore_index``, soft labels, class weights, label smoothing and the
  three reductions, within 1e-6 in fp32; bf16 logits give a bf16 loss.
* ``CosineAnnealingDecay`` and ``LinearWarmup`` give the JAX schedulers'
  value sequences exactly (the same Python arithmetic).
* ``AdamW`` and ``Adam`` against the JAX optimizers on the same weights and
  gradients over 5 steps: fp32 within 1e-6; bf16 parameters without master
  weights (bf16 moments, a bf16 bias correction) and with
  ``multi_precision`` (fp32 masters) within one bf16 rounding step.
* The slice as a whole: ``LlamaConfig.tiny()`` in fp32, the JAX weights
  carried across by ``convert.llama_from_paddle_tpu``.  The logits match
  within 1e-4, the first step's parameter gradients normalised by their max
  within 1e-4, and 6 AdamW steps give losses within 1e-4 relative — with
  ``recompute`` off and on, and with the JAX model's ``scan_layers=True``
  against the port's module loop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu_torch.convert import llama_from_paddle_tpu
from paddle_tpu_torch.models import LlamaConfig, LlamaPretrainingCriterion
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as lr_mod
from torch_jax_cache import jax_compile_cache  # noqa: F401

# --- cross entropy ----------------------------------------------------------

CE_CASES = {
    "hard": dict(),
    "hard_ignore": dict(ignore_index=3),
    "hard_sum": dict(reduction="sum"),
    "hard_none": dict(reduction="none", ignore_index=3),
    "hard_weight": dict(weight=True, ignore_index=3),
    "hard_smooth": dict(label_smoothing=0.1),
    "soft": dict(soft_label=True),
    "soft_weight_smooth": dict(soft_label=True, weight=True,
                               label_smoothing=0.2),
}


@pytest.mark.parametrize("name", list(CE_CASES))
def test_cross_entropy_matches_jax(name):
    kw = dict(CE_CASES[name])
    rng = np.random.default_rng(len(name))
    logits = rng.standard_normal((2, 7, 5)).astype(np.float32)
    if kw.get("soft_label"):
        label = rng.random((2, 7, 5)).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.integers(0, 5, (2, 7)).astype(np.int64)
    weight = (rng.random(5).astype(np.float32) + 0.5
              if kw.pop("weight", False) else None)
    want = np.asarray(JF.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label),
        weight=None if weight is None else paddle.to_tensor(weight),
        **kw).numpy())
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                        weight=None if weight is None
                        else torch.from_numpy(weight), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_keeps_bf16_and_ignores_masked_labels():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 6, 9))
                              .astype(np.float32)).to(torch.bfloat16)
    label = torch.from_numpy(rng.integers(0, 9, (2, 6)))
    label[0, :3] = -100
    loss = cross_entropy(logits, label)
    assert loss.dtype == torch.bfloat16
    want = torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, 9), label.reshape(-1), ignore_index=-100)
    torch.testing.assert_close(loss.float(), want, atol=2e-2, rtol=2e-2)


# --- schedulers ---------------------------------------------------------------

def _values(sched, n=12):
    out = []
    for _ in range(n):
        out.append(sched())
        sched.step()
    return out


def test_schedulers_match_jax():
    from paddle_tpu.optimizer import lr as jlr

    assert _values(lr_mod.CosineAnnealingDecay(1e-3, T_max=10)) == \
        _values(jlr.CosineAnnealingDecay(1e-3, T_max=10))
    assert _values(lr_mod.CosineAnnealingDecay(0.1, 7, eta_min=0.01)) == \
        _values(jlr.CosineAnnealingDecay(0.1, 7, eta_min=0.01))
    assert _values(lr_mod.LinearWarmup(0.5, 4, 0.0, 0.5)) == \
        _values(jlr.LinearWarmup(0.5, 4, 0.0, 0.5))
    assert _values(lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(1e-3, T_max=6), 3, 1e-5, 1e-3)) == \
        _values(jlr.LinearWarmup(jlr.CosineAnnealingDecay(1e-3, T_max=6),
                                 3, 1e-5, 1e-3))


# --- optimizers ---------------------------------------------------------------

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("opt_name, dtype, master", [
    ("AdamW", torch.float32, False),
    ("AdamW", torch.bfloat16, False),
    ("AdamW", torch.bfloat16, True),
    ("Adam", torch.float32, False),
])
def test_optimizer_matches_jax(opt_name, dtype, master):
    """Weights and gradients from numpy through both optimizers, a
    scheduled learning rate, a per-parameter learning-rate scale and a
    parameter group with its own weight decay."""
    from paddle_tpu import optimizer as jopt

    rng = np.random.default_rng(3)
    shapes = [(4, 6), (6,), (3, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jp = [JaxParameter(jnp.asarray(a, _JDT[dtype])) for a in init]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy()).to(dtype))
          for a in init]
    jp[1].optimize_attr["learning_rate"] = 0.5
    tp[1].optimize_attr = {"learning_rate": 0.5}
    kw = dict(weight_decay=0.01)
    if master:
        kw["multi_precision"] = True
    jsched = jopt.lr.CosineAnnealingDecay(1e-2, T_max=4)
    tsched = lr_mod.CosineAnnealingDecay(1e-2, T_max=4)
    jo = getattr(jopt, opt_name)(
        learning_rate=jsched, parameters=[
            {"params": jp[:2]}, {"params": jp[2:], "weight_decay": 0.1}],
        **kw)
    to = {"AdamW": AdamW, "Adam": Adam}[opt_name](
        learning_rate=tsched, parameters=[
            {"params": tp[:2]}, {"params": tp[2:], "weight_decay": 0.1}],
        **kw)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for step_grads in grads:
        for j, t, g in zip(jp, tp, step_grads):
            j.grad = JaxTensor(jnp.asarray(g, _JDT[dtype]))
            t.grad = torch.from_numpy(g).to(dtype)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        jsched.step()
        tsched.step()
        for j, t in zip(jp, tp):
            assert t.dtype == dtype and t.grad is None
            np.testing.assert_allclose(
                t.detach().float().numpy(),
                np.asarray(j._value, np.float32), rtol=tol, atol=tol)


def test_bf16_bias_correction_is_a_bf16_power():
    """Without master weights the betas and t take the weight's dtype, as
    in the JAX package: bf16(0.999) is 1.0, so the bias correction
    1 - beta2 ** t is 0, vhat is inf and the Adam step is 0 — a bf16 weight
    does not move.  With ``multi_precision`` the fp32 master does.  This is
    the JAX package's arithmetic, reproduced, not fixed."""
    bf = torch.bfloat16
    assert float(torch.tensor(0.999, dtype=bf)) == 1.0
    moved = {}
    for master in (False, True):
        p = torch.nn.Parameter(torch.ones(2, dtype=bf))
        opt = AdamW(learning_rate=1e-2, parameters=[p],
                    multi_precision=master)
        p.grad = torch.ones(2, dtype=bf)
        opt.step()
        state = opt._state[id(p)]
        assert state["v"].dtype == (torch.float32 if master else bf)
        moved[master] = float(p.detach()[0]) - 1.0
    assert moved[False] == 0.0
    assert -0.02 < moved[True] < -0.005


# --- the slice as a whole -----------------------------------------------------

def _jax_model(**cfg):
    paddle.seed(0)
    return JaxLlama(JaxLlamaConfig.tiny(**cfg))


def _port_model(jax_model, **cfg):
    state = {k: np.array(np.asarray(v), copy=True)
             for k, v in jax_model.state_dict().items()}
    return llama_from_paddle_tpu(state, LlamaConfig.tiny(**cfg),
                                 device="cpu")


def _ids(seed=0, B=2, S=16):
    return np.random.default_rng(seed).integers(0, 256, (B, S))


def test_no_cache_logits_match_jax():
    jm = _jax_model()
    model = _port_model(jm)
    ids = _ids()
    with paddle.no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids, dtype="int64")).numpy())
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["plain", "recompute", "scan_layers"])
def test_adamw_training_matches_jax(variant):
    """6 AdamW steps of the tiny Llama on the same weights and batches."""
    jcfg = {"recompute": variant == "recompute",
            "scan_layers": variant == "scan_layers"}
    tcfg = {"recompute": variant == "recompute"}
    jm = _jax_model(**jcfg)
    model = _port_model(jm, **tcfg)       # before the JAX model steps
    model.train()
    jcrit, tcrit = JaxCriterion(), LlamaPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                 weight_decay=0.01)
    jparams = dict(jm.named_parameters())
    jlosses, tlosses = [], []
    ids = _ids()     # one batch: the loss must fall as it is learned
    for step in range(6):
        jids = paddle.to_tensor(ids, dtype="int64")
        jloss = jcrit(jm(jids), jids)
        jloss.backward()
        tids = torch.from_numpy(ids)
        tloss = tcrit(model(tids), tids)
        tloss.backward()
        if step == 0:
            for name, p in model.named_parameters():
                want = np.asarray(jparams[name].grad.numpy())
                got = p.grad.numpy()
                if got.ndim == 2 and "embed_tokens" not in name:
                    got = got.T
                scale = np.abs(want).max() + 1e-12
                np.testing.assert_allclose(got / scale, want / scale,
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=name)
        jopt.step()
        jopt.clear_grad()
        topt.step()
        topt.clear_grad()
        jlosses.append(float(jloss))
        tlosses.append(tloss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
