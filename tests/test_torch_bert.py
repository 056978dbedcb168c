"""The port's BERT and ERNIE (``paddle_tpu_torch/models/bert.py``,
``ernie.py``) held to the JAX package's on the CPU, on the same weights
(``convert.bert_from_paddle_tpu`` / ``ernie_from_paddle_tpu``) and the
same numpy inputs, as ``tests/test_models.py::TestBert`` and ``TestErnie``
hold the JAX models.

* Eval-mode outputs of every model (``BertModel``'s sequence and pooled
  outputs, the classification and QA heads, ``ErnieModel`` and its
  classifier) within 1e-5 in fp32, with pad tokens under the default
  mask, with an explicit mask and with token types; parameters in the JAX
  order.
* Pad tokens isolated: the content of masked positions does not reach the
  others.
* A dropout-0 fine-tune: 3 AdamW steps under ``LinearWarmup`` →
  ``PolynomialDecay`` of the QA head (and of ERNIE's classifier), losses
  within 1e-5 relative and parameters within 1% of the largest move the
  steps can make, and those whose gradient is zero but for rounding within
  that move (``torch_train_pairs.py`` says why).
* ERNIE's task-type default: no ``task_type_ids`` equals task 0, and
  differs from task 1.
* Dropout on in training: drawn from ``dropout_generator`` (the same seed
  gives the same loss, another seed another), off in eval.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.models as jmodels
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import (
    BertConfig,
    BertForQuestionAnswering,
    ErnieConfig,
)
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as lr_mod
from torch_train_pairs import assert_params_close, gradient_scales

TOL = 1e-5
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)

# (JAX class, config pair, converter)
MODELS = {
    "bert": ("BertModel", "Bert"),
    "bert_cls": ("BertForSequenceClassification", "Bert"),
    "bert_qa": ("BertForQuestionAnswering", "Bert"),
    "ernie": ("ErnieModel", "Ernie"),
    "ernie_cls": ("ErnieForSequenceClassification", "Ernie"),
}


def _pair(kind, seed=0, **cfg):
    cls_name, family = MODELS[kind]
    paddle.seed(seed)
    jcfg = getattr(jmodels, f"{family}Config").tiny(**cfg)
    jm = getattr(jmodels, cls_name)(jcfg)
    state = {k: np.array(np.asarray(v.numpy()), copy=True)
             for k, v in jm.state_dict().items()}
    tcfg = (ErnieConfig if family == "Ernie" else BertConfig).tiny(**cfg)
    fn = (convert.ernie_from_paddle_tpu if family == "Ernie"
          else convert.bert_from_paddle_tpu)
    model = fn(state, tcfg, device="cpu")
    assert type(model).__name__ == cls_name
    return jm, model


def _ids(seed=0, B=2, S=16, pad=4):
    ids = np.random.default_rng(seed).integers(1, 128, (B, S))
    ids[0, S - pad:] = 0      # pad_token_id
    return ids


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


def _jnp(out):
    return [np.asarray(o.numpy()) for o in _flat(out)]


def _tnp(out):
    return [o.detach().numpy() for o in _flat(out)]


INPUTS = {
    "default_mask": lambda ids: {},
    "explicit_mask": lambda ids: {"attention_mask": (
        np.arange(ids.shape[1])[None, :] < np.array([[11], [16]])
    ).astype(np.float32)},
    "token_types": lambda ids: {"token_type_ids": (
        np.arange(ids.shape[1])[None, :] >= 8).astype(np.int64)
        .repeat(ids.shape[0], 0)},
}


@pytest.mark.parametrize("inputs", list(INPUTS))
@pytest.mark.parametrize("kind", list(MODELS))
def test_eval_outputs_match_jax(kind, inputs):
    jm, model = _pair(kind)
    jm.eval()
    model.eval()
    ids = _ids()
    extra = INPUTS[inputs](ids)
    with paddle.no_grad():
        want = _jnp(jm(paddle.to_tensor(ids), **{
            k: paddle.to_tensor(v) for k, v in extra.items()}))
    with torch.no_grad():
        got = _tnp(model(torch.from_numpy(ids), **{
            k: torch.from_numpy(v) for k, v in extra.items()}))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert convert.paddle_parameter_order(model) == \
        [n for n, _ in jm.named_parameters()]


def test_pad_tokens_are_isolated():
    _, model = _pair("bert")
    model.eval()
    ids = _ids(B=1, pad=0)
    mask = np.ones((1, 16), np.float32)
    mask[0, -4:] = 0.0
    a, b = ids.copy(), ids.copy()
    a[0, -4:] = 0
    b[0, -4:] = [7, 9, 0, 11]
    with torch.no_grad():
        outs = [model(torch.from_numpy(x),
                      attention_mask=torch.from_numpy(mask))[0].numpy()
                for x in (a, b)]
        default = model(torch.from_numpy(a))[0].numpy()
    np.testing.assert_allclose(outs[0][0, :12], outs[1][0, :12], atol=1e-5)
    np.testing.assert_allclose(default, outs[0], atol=1e-6)   # ids != pad


def test_qa_head_shapes_and_spans():
    jm, model = _pair("bert_qa")
    jm.eval()
    model.eval()
    ids = _ids()
    with torch.no_grad():
        start, end = model(torch.from_numpy(ids))
        logits = model.qa_outputs(model.bert(torch.from_numpy(ids))[0])
    assert start.shape == (2, 16) and end.shape == (2, 16)
    torch.testing.assert_close(start, logits[..., 0])
    torch.testing.assert_close(end, logits[..., 1])
    with paddle.no_grad():
        jstart, jend = jm(paddle.to_tensor(ids))
    np.testing.assert_allclose(start.numpy(), np.asarray(jstart.numpy()),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(end.numpy(), np.asarray(jend.numpy()),
                               rtol=TOL, atol=TOL)


def _schedulers(steps):
    from paddle_tpu.optimizer import lr as jlr

    j = jlr.LinearWarmup(jlr.PolynomialDecay(learning_rate=2e-3,
                                             decay_steps=steps, end_lr=0.0),
                         warmup_steps=1, start_lr=0.0, end_lr=2e-3)
    t = lr_mod.LinearWarmup(lr_mod.PolynomialDecay(
        learning_rate=2e-3, decay_steps=steps, end_lr=0.0), warmup_steps=1,
        start_lr=0.0, end_lr=2e-3)
    return j, t


@pytest.mark.parametrize("kind", ["bert_qa", "ernie_cls"])
def test_dropout_free_finetune_matches_jax(kind):
    """The example's step (``examples/finetune_bert_squad.py``): the mean
    of the start and end cross-entropies for QA, the class cross-entropy
    for ERNIE; 3 steps under warmup → polynomial decay."""
    jm, model = _pair(kind, **NO_DROPOUT)
    jm.train()
    model.train()
    steps = 3
    jsched, tsched = _schedulers(steps)
    jopt = paddle.optimizer.AdamW(learning_rate=jsched,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01)
    topt = AdamW(learning_rate=tsched, parameters=model.parameters(),
                 weight_decay=0.01)
    rng = np.random.default_rng(1)
    jlosses, tlosses = [], []
    for step in range(steps):
        ids = _ids(seed=int(rng.integers(1 << 20)))
        if kind == "bert_qa":
            labels = (rng.integers(1, 12, (2,)), rng.integers(1, 12, (2,)))
        else:
            labels = (rng.integers(0, 2, (2,)),)
        jout = _flat(jm(paddle.to_tensor(ids)))
        jloss = sum(JF.cross_entropy(o, paddle.to_tensor(y))
                    for o, y in zip(jout, labels)) / len(labels)
        jloss.backward()
        if step == 0:
            scales = gradient_scales(jm)
        jopt.step()
        jopt.clear_grad()
        jsched.step()
        tout = _flat(model(torch.from_numpy(ids)))
        tloss = sum(cross_entropy(o, torch.from_numpy(y))
                    for o, y in zip(tout, labels)) / len(labels)
        tloss.backward()
        topt.step()
        topt.clear_grad()
        tsched.step()
        jlosses.append(float(jloss))
        tlosses.append(tloss.item())
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL)
    assert_params_close(convert.to_paddle_tpu(model), jm, scales,
                        steps * 2e-3)


def test_ernie_task_type_default_is_task_zero():
    jm, model = _pair("ernie")
    jm.eval()
    model.eval()
    ids = _ids()
    zeros = np.zeros_like(ids)
    with torch.no_grad():
        none = model(torch.from_numpy(ids))[0].numpy()
        task0 = model(torch.from_numpy(ids),
                      task_type_ids=torch.from_numpy(zeros))[0].numpy()
        task1 = model(torch.from_numpy(ids),
                      task_type_ids=torch.from_numpy(zeros + 1))[0].numpy()
    np.testing.assert_allclose(none, task0, rtol=1e-6, atol=1e-6)
    assert not np.allclose(none, task1)
    with paddle.no_grad():
        want = np.asarray(jm(paddle.to_tensor(ids), task_type_ids=(
            paddle.to_tensor(zeros + 1)))[0].numpy())
    np.testing.assert_allclose(task1, want, rtol=TOL, atol=TOL)


def _dropout_loss(seed):
    cfg = BertConfig.tiny()
    model = BertForQuestionAnswering(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0),
        dropout_generator=torch.Generator().manual_seed(seed))
    ids = torch.from_numpy(_ids())
    model.train()
    s, e = model(ids)
    train = (s.sum() + e.sum()).item()
    model.eval()
    s, e = model(ids)
    return train, (s.sum() + e.sum()).item()


def test_dropout_draws_from_the_dropout_generator():
    a, b, c = _dropout_loss(1), _dropout_loss(1), _dropout_loss(2)
    assert a == b
    assert a[0] != c[0]
    assert a[1] == c[1]            # eval: no dropout
    assert a[0] != a[1]
