"""BERT model family — the port of ``paddle_tpu/models/bert.py`` (BERT-base
SQuAD and classification fine-tuning).

Post-LN encoder blocks with plain dense layers (``nn/common.py::Linear``,
weights ``[out, in]``; ``convert.bert_from_paddle_tpu`` transposes).  The
attention is torch ops, as it is XLA code in the JAX package: the scores
in fp32 (the JAX einsum's fp32 accumulation), the additive ``-1e9`` bias
at padded keys, the softmax in fp32 and the probabilities cast to V's
dtype for the product.  The JAX rules kept:

* the default mask is ``input_ids != pad_token_id`` (PaddleNLP's rule; HF
  defaults to all ones);
* with no ``token_type_ids``, ``token_type_embeddings.weight[0]`` is still
  added;
* the attention layer declares a dropout it never applies (the hidden
  dropouts after the attention and the FFN are applied).

Models are built on ``device`` (the card unless ``device="cpu"``) in
``dtype`` (fp32 by default), initialised from ``generator``; every dropout
draws from ``dropout_generator`` (on ``device``) when given, else from
torch's default generator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..nn.common import Dropout, Embedding, Linear
from ..nn.container import LayerList
from ..nn.initializer import Normal
from ..nn.norm import LayerNorm


@dataclass
class BertConfig:
    """BERT-base defaults."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=64, type_vocab_size=2)
        defaults.update(kw)
        return cls(**defaults)


def _kw(device, dtype, generator):
    return dict(device=device, dtype=dtype, generator=generator)


class BertEmbeddings(nn.Module):
    """word + position + token-type embeddings, LayerNorm, dropout."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator=None, dropout_generator=None):
        super().__init__()
        init = Normal(0.0, config.initializer_range)
        kw = _kw(device, dtype, generator)
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h,
                                         weight_attr=init, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, weight_attr=init, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               weight_attr=init, **kw)
        self._add_embeddings(config, init, kw)
        self.layer_norm = LayerNorm(h, epsilon=config.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=dropout_generator)

    def _add_embeddings(self, config, init, kw):
        """Overridable: further tables, registered (so their parameters
        listed) before the LayerNorm, as ERNIE's task types are."""

    def _summed(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            # the default token_type_ids are zeros: segment 0 is added
            return x + self.token_type_embeddings.weight[0]
        return x + self.token_type_embeddings(token_type_ids)

    def forward(self, input_ids, token_type_ids=None):
        return self.dropout(self.layer_norm(
            self._summed(input_ids, token_type_ids)))


class BertSelfAttention(nn.Module):
    """Bidirectional multi-head attention with an additive padding mask."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator=None, dropout_generator=None):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        init = Normal(0.0, config.initializer_range)
        kw = _kw(device, dtype, generator)
        self.q_proj = Linear(h, h, weight_attr=init, **kw)
        self.k_proj = Linear(h, h, weight_attr=init, **kw)
        self.v_proj = Linear(h, h, weight_attr=init, **kw)
        self.out_proj = Linear(h, h, weight_attr=init, **kw)
        # declared as in the JAX package, which applies no dropout to the
        # attention probabilities
        self.dropout = Dropout(config.attention_probs_dropout_prob,
                               generator=dropout_generator)

    def forward(self, x, attention_mask=None):
        B, S = x.shape[0], x.shape[1]
        n, d = self.num_heads, self.head_dim

        def heads(t):
            return t.reshape(B, S, n, d).transpose(1, 2)

        qh, kh, vh = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        logits = logits / math.sqrt(d)
        if attention_mask is not None:
            m = attention_mask[:, None, None, :].to(logits.dtype)
            logits = logits + (1.0 - m) * -1e9
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs.to(vh.dtype), vh)
        return self.out_proj(out.transpose(1, 2).reshape(B, S, n * d))


class BertLayer(nn.Module):
    """Post-norm transformer encoder block (original BERT residual order)."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator=None, dropout_generator=None):
        super().__init__()
        init = Normal(0.0, config.initializer_range)
        kw = _kw(device, dtype, generator)
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(
            config, dropout_generator=dropout_generator, **kw)
        self.attn_norm = LayerNorm(h, epsilon=eps, device=device,
                                   dtype=dtype)
        self.linear1 = Linear(h, config.intermediate_size, weight_attr=init,
                              **kw)
        self.linear2 = Linear(config.intermediate_size, h, weight_attr=init,
                              **kw)
        self.ffn_norm = LayerNorm(h, epsilon=eps, device=device, dtype=dtype)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=dropout_generator)

    def forward(self, x, attention_mask=None):
        h = self.attn_norm(x + self.dropout(self.attention(x,
                                                           attention_mask)))
        ff = self.linear2(F.gelu(self.linear1(h)))
        return self.ffn_norm(h + self.dropout(ff))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            weight_attr=Normal(0.0, config.initializer_range),
                            **_kw(device, dtype, generator))

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings + encoder stack + pooler (PaddleNLP ``BertModel``
    analog); returns ``(sequence [B, S, H], pooled [B, H])``."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.embeddings = self._build_embeddings(
            config, dropout_generator=dropout_generator, **kw)
        self.encoder = LayerList(
            [BertLayer(config, dropout_generator=dropout_generator, **kw)
             for _ in range(config.num_hidden_layers)])
        self.pooler = BertPooler(config, **kw)

    def _build_embeddings(self, config, **kw):
        """Overridable factory (ERNIE swaps in task-type embeddings)."""
        return BertEmbeddings(config, **kw)

    @staticmethod
    def _pad_default_mask(input_ids, pad_token_id):
        """Pad positions masked out (PaddleNLP's default; HF's is all
        ones)."""
        return (input_ids != pad_token_id).to(torch.float32)

    def _encode(self, h, input_ids, attention_mask):
        if attention_mask is None:
            attention_mask = self._pad_default_mask(
                input_ids, self.config.pad_token_id)
        for layer in self.encoder:
            h = layer(h, attention_mask)
        return h, self.pooler(h)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        return self._encode(self.embeddings(input_ids, token_type_ids),
                            input_ids, attention_mask)


class BertForSequenceClassification(nn.Module):
    def __init__(self, config: BertConfig, num_classes: int = 2, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(config, device, dtype, generator,
                              dropout_generator)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=dropout_generator)
        self.classifier = Linear(
            config.hidden_size, num_classes,
            weight_attr=Normal(0.0, config.initializer_range),
            **_kw(device, dtype, generator))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class BertForQuestionAnswering(nn.Module):
    """SQuAD head: start and end span logits, ``[B, S]`` each."""

    def __init__(self, config: BertConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.bert = BertModel(config, device, dtype, generator,
                              dropout_generator)
        self.qa_outputs = Linear(
            config.hidden_size, 2,
            weight_attr=Normal(0.0, config.initializer_range),
            **_kw(device, dtype, generator))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, _ = self.bert(input_ids, token_type_ids, attention_mask)
        logits = self.qa_outputs(seq)          # [B, S, 2]
        return logits[..., 0], logits[..., 1]
