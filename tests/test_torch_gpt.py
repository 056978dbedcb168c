"""The port's GPT (``paddle_tpu_torch/models/gpt.py``) held to the JAX
package's on the CPU, on the same weights (``convert.gpt_from_paddle_tpu``)
and the same numpy batches, as ``tests/test_models.py::TestGPT`` holds the
JAX model.

* ``GPTConfig.tiny()`` logits within 1e-5 in fp32; the port's parameter
  list in the JAX ``Layer`` order (breadth first, the bare
  ``gpt.position_embeddings`` first) and one embedding parameter with no
  ``lm_head`` when tied; an untied head maps too.
* 3 AdamW steps: losses within 1e-5 relative; every updated parameter
  (linear weights transposed back) within 1% of the largest move 3 steps
  can make, 3 x lr, and the weights whose gradient is zero but for
  rounding (the key bias) within 3 x lr (``torch_train_pairs.py`` says
  why).
* The tied head's gradient: the embedding's gradient sums the lookup's and
  the head's, against JAX's within 1e-5 of its max.
* Causality; ``recompute`` and ``scan_layers`` equal to the plain forward
  (loss and gradients); the JAX ``scan_layers`` stack against the port's
  loop; ``pp_microbatches`` > 1 and ``virtual_pp_degree`` > 1 raise naming
  A11.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import (
    GPTConfig,
    GPTForCausalLM,
    GPTPretrainingCriterion,
)
from paddle_tpu_torch.optimizer import AdamW
from torch_train_pairs import assert_params_close, gradient_scales

TOL = 1e-5


def _jax_model(seed=0, **cfg):
    paddle.seed(seed)
    return JaxGPT(JaxGPTConfig.tiny(**cfg))


def _port_model(jm, **cfg):
    return convert.gpt_from_paddle_tpu(convert_state(jm),
                                       GPTConfig.tiny(**cfg), device="cpu")


def convert_state(jm):
    return {k: np.array(np.asarray(v.numpy()), copy=True)
            for k, v in jm.state_dict().items()}


def _ids(seed=0, B=2, S=16, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S))


def _jax_logits(jm, ids):
    with paddle.no_grad():
        return np.asarray(jm(paddle.to_tensor(ids, dtype="int64")).numpy())


@pytest.mark.parametrize("tied", [True, False])
def test_logits_match_jax(tied):
    jm = _jax_model(tie_word_embeddings=tied)
    model = _port_model(jm, tie_word_embeddings=tied)
    ids = _ids()
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _jax_logits(jm, ids), rtol=TOL,
                               atol=TOL)
    assert (model.lm_head is None) == tied
    assert ("lm_head.weight" in dict(model.named_parameters())) != tied


def test_parameters_register_in_the_jax_order():
    jm = _jax_model()
    model = _port_model(jm)
    jax_names = [n for n, _ in jm.named_parameters()]
    assert convert.paddle_parameter_order(model) == jax_names
    assert jax_names[0] == "gpt.position_embeddings"
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(jax_names)
    assert sum("embed_tokens" in n for n in names) == 1
    qkv = model.gpt.layers[0].attn.qkv_proj.weight
    assert tuple(qkv.shape) == (3 * 64, 64)     # [out, in]: (3, heads, hd)


def test_adamw_steps_match_jax():
    """3 AdamW steps on the same weights and batches: losses and every
    updated parameter."""
    jm = _jax_model(num_hidden_layers=2)
    model = _port_model(jm, num_hidden_layers=2)
    model.train()
    jcrit, tcrit = JaxCriterion(), GPTPretrainingCriterion()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                 weight_decay=0.01)
    jlosses, tlosses = [], []
    for step in range(3):
        ids = _ids(seed=step)
        jids = paddle.to_tensor(ids, dtype="int64")
        jloss = jcrit(jm(jids), jids)
        jloss.backward()
        if step == 0:
            scales = gradient_scales(jm)
        jopt.step()
        jopt.clear_grad()
        tids = torch.from_numpy(ids)
        tloss = tcrit(model(tids), tids)
        tloss.backward()
        topt.step()
        topt.clear_grad()
        jlosses.append(float(jloss))
        tlosses.append(tloss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert_params_close(convert.to_paddle_tpu(model), jm, scales, 3 * 1e-3)


def test_tied_head_gradient_sums_both_uses():
    jm = _jax_model()
    model = _port_model(jm)
    ids = _ids(seed=3)
    jids = paddle.to_tensor(ids, dtype="int64")
    JaxCriterion()(jm(jids), jids).backward()
    tids = torch.from_numpy(ids)
    GPTPretrainingCriterion()(model(tids), tids).backward()
    want = np.asarray(jm.gpt.embed_tokens.weight.grad.numpy())
    got = model.gpt.embed_tokens.weight.grad.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL)
    # the head's share alone (the lookup's rows masked out) is not the sum
    head_only = got.copy()
    head_only[np.unique(ids)] = 0.0
    assert np.abs(head_only).max() > 0.0
    assert not np.allclose(got[np.unique(ids)], 0.0)


def test_causality():
    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    ids = _ids()
    with torch.no_grad():
        base = model(torch.from_numpy(ids)).numpy()
        pert = ids.copy()
        pert[:, 10] = (pert[:, 10] + 1) % 256
        got = model(torch.from_numpy(pert)).numpy()
    np.testing.assert_allclose(base[:, :10], got[:, :10], rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(base[:, 10:], got[:, 10:])


def _loss_and_grads(model, ids):
    model.zero_grad()
    tids = torch.from_numpy(ids)
    loss = GPTPretrainingCriterion()(model(tids), tids)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


@pytest.mark.parametrize("flag", ["recompute", "scan_layers"])
def test_recompute_and_scan_equal_the_plain_forward(flag):
    gen = torch.Generator().manual_seed(1)
    plain = GPTForCausalLM(GPTConfig.tiny(), device="cpu", generator=gen)
    other = GPTForCausalLM(GPTConfig.tiny(**{flag: True}), device="cpu")
    other.load_state_dict(plain.state_dict())
    plain.train()
    other.train()
    ids = _ids(seed=5)
    loss_p, grads_p = _loss_and_grads(plain, ids)
    loss_o, grads_o = _loss_and_grads(other, ids)
    assert loss_o == loss_p
    for name, g in grads_p.items():
        torch.testing.assert_close(grads_o[name], g, rtol=1e-6, atol=1e-7)


def test_jax_scan_stack_equals_the_ports_loop():
    """The JAX model's ``lax.scan`` stack against the port's module loop on
    the same weights."""
    jm = _jax_model(scan_layers=True)
    model = _port_model(jm, scan_layers=True)
    ids = _ids(seed=7)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _jax_logits(jm, ids), rtol=TOL,
                               atol=TOL)


def test_pipeline_microbatches_raise_naming_a11():
    model = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    ids = torch.from_numpy(_ids())
    assert model(ids, pp_microbatches=1).shape == (2, 16, 256)
    with pytest.raises(NotImplementedError, match="A11"):
        model(ids, pp_microbatches=2)


def test_virtual_pipeline_stages_raise_naming_a11():
    assert GPTForCausalLM(GPTConfig.tiny(virtual_pp_degree=1),
                          device="cpu") is not None
    with pytest.raises(NotImplementedError, match="A11"):
        GPTForCausalLM(GPTConfig.tiny(virtual_pp_degree=2), device="cpu")


def test_bf16_model_takes_the_jax_weights_exactly():
    jm = _jax_model()
    jm.to(dtype="bfloat16")
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    model = convert.gpt_from_paddle_tpu(state, GPTConfig.tiny(),
                                        device="cpu", dtype=torch.bfloat16)
    back = convert.to_paddle_tpu(model)
    for name, arr in state.items():
        np.testing.assert_array_equal(back[name], arr.astype(np.float32),
                                      err_msg=name)
    ids = _ids()
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).float().numpy()
    want = _jax_logits(jm, ids).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
