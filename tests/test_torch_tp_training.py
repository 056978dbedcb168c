"""Tensor- and data-parallel training of the port on 4 gloo ranks on the
CPU against the JAX package on the same weights and batches.

* Tiny Llama (2 layers) at dp2 x mp2 against the JAX model on its
  ``init_mesh(dp=2, mp=2)`` mesh (``tests/test_llama.py:134``'s layout):
  3 AdamW steps with global-norm clipping (the clip acting), losses within
  1e-5 relative, the first step's gradients, gathered over mp, within 1e-5
  of each tensor's largest entry, the first step's logits too.
* Tiny GPT at mp=4 against the JAX model's single-device forward
  (``tests/test_models.py:322``), within 2e-4: logits, the loss, and the
  fused QKV projection's gradient (three blocks split over the ranks).

One world (``torch_dist_ranks.tp_training_rank``, one spawn in a module
fixture) runs both, with the spawn's own timeouts.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
import torch_dist_ranks as ranks
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import topology as jtopology
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.parallel import apply_param_shardings

W = ranks.WORLD


def _state(model):
    return {k: np.array(np.asarray(v), dtype=np.float32)
            for k, v in model.state_dict().items()}


def _jax_inputs():
    """The JAX models' weights and batches, and the clip norm (half the
    first step's gradient norm: the clip acts)."""
    a = {"ids": np.random.default_rng(3).integers(0, 256, (4, 16))}
    jtopology.init_mesh(dp=2, mp=2)
    try:
        paddle.seed(0)
        jm = JaxLlama(JaxLlamaConfig.tiny(num_hidden_layers=2))
        apply_param_shardings(jm)
        a.update({f"llama.{k}": v for k, v in _state(jm).items()})
        jids = paddle.to_tensor(a["ids"], dtype="int64")
        JaxCriterion()(jm(jids), jids).backward()
        norm = np.sqrt(sum(float((np.asarray(p.grad.numpy()) ** 2).sum())
                           for p in jm.parameters()))
        jm.clear_gradients()
        a["clip_norm"] = np.float32(norm / 2)
    finally:
        jtopology.set_mesh(None)
    paddle.seed(0)
    jg = JaxGPT(JaxGPTConfig.tiny())
    a["gpt_ids"] = np.random.default_rng(0).integers(
        1, jg.config.vocab_size, (2, 16))
    a.update({f"gpt.{k}": v for k, v in _state(jg).items()})
    return a, jm, jg


def _jax_runs(a, jm, jg):
    """The JAX side's 3 clipped AdamW steps at dp2 x mp2, and GPT's
    single-device forward and backward."""
    want = {}
    jtopology.init_mesh(dp=2, mp=2)
    try:
        crit = JaxCriterion()
        jids = paddle.to_tensor(a["ids"], dtype="int64")
        opt = paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(),
            weight_decay=0.01,
            grad_clip=jnn.ClipGradByGlobalNorm(float(a["clip_norm"])))
        losses = []
        for step in range(3):
            logits = jm(jids)
            loss = crit(logits, jids)
            loss.backward()
            if step == 0:
                want["logits0"] = np.asarray(logits.numpy())
                want["grads"] = {n: np.asarray(p.grad.numpy())
                                 for n, p in jm.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        want["losses"] = np.array(losses)
    finally:
        jtopology.set_mesh(None)
    gj = paddle.to_tensor(a["gpt_ids"], dtype="int64")
    glogits = jg(gj)
    gloss = JaxCriterion()(glogits, gj)
    gloss.backward()
    want["gpt_logits"] = np.asarray(glogits.numpy())
    want["gpt_loss"] = float(gloss)
    want["gpt_qkv_grad"] = np.asarray(
        jg.gpt.layers[0].attn.qkv_proj.weight.grad.numpy())
    return want


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The ranks run while the JAX side trains."""
    out = tmp_path_factory.mktemp("tp_training")
    a, jm, jg = _jax_inputs()
    path = str(out / "arrays.npz")
    np.savez(path, **a)
    world = ranks.start_world(ranks.tp_training_rank, str(out), path)
    try:
        want = _jax_runs(a, jm, jg)
    finally:
        world.join()
    return [ranks.load(str(out), "tp_training", r) for r in range(W)], want


def test_llama_dp2_mp2_losses_match_jax(sides):
    got, want = sides
    assert want["losses"][-1] < want["losses"][0]
    for r in range(W):
        np.testing.assert_allclose(got[r]["losses"], want["losses"],
                                   rtol=1e-5)


def test_llama_dp2_mp2_first_step_grads_and_logits_match_jax(sides):
    """Each rank's gathered gradients are the JAX model's (every dp rank
    holds the mean over the global batch); each rank's logits are its dp
    half of the JAX logits."""
    got, want = sides
    for r in range(W):
        for name, g in want["grads"].items():
            scale = np.abs(g).max()
            np.testing.assert_allclose(got[r][f"grad.{name}"], g, rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"rank {r} {name}")
        dp = r // 2
        w = want["logits0"][2 * dp:2 * dp + 2]
        np.testing.assert_allclose(got[r]["logits0"], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_llama_ranks_hold_their_heads_and_shards(sides):
    """Each mp rank holds H/2 = 2 query heads and Hkv/2 = 1 KV head; a
    shard asked for another rank raises; mp=4 does not divide the tiny
    model's 2 KV heads, and the model raises naming them."""
    got, _ = sides
    for r in range(W):
        np.testing.assert_array_equal(got[r]["local_heads"], [2, 1])
        assert "asked for rank" in str(got[r]["wrong_rank"])
        assert "num_key_value_heads=2" in str(got[r]["mp4_error"])


def test_fleet_wraps_by_the_strategy(sides):
    """``fleet.distributed_model`` gives DataParallel at dp2 x mp2 and the
    model itself at mp=4 (dp inferred as 1); a pipeline degree raises
    naming ROADMAP A11."""
    got, _ = sides
    for r in range(W):
        assert str(got[r]["wrapped"]) == "DataParallel"
        assert str(got[r]["gpt_wrapped"]) == "GPTForCausalLM"
        np.testing.assert_array_equal(got[r]["mp4_topology"], [1, W])
        assert "ROADMAP A11" in str(got[r]["pp_error"])


def test_gpt_mp4_matches_the_jax_forward(sides):
    got, want = sides
    for r in range(W):
        np.testing.assert_allclose(got[r]["gpt_logits"], want["gpt_logits"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(float(got[r]["gpt_loss"]),
                                   want["gpt_loss"], rtol=2e-4)
        g = want["gpt_qkv_grad"]
        np.testing.assert_allclose(got[r]["gpt_qkv_grad"], g, rtol=0,
                                   atol=2e-4 * np.abs(g).max())
