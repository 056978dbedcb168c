"""ERNIE family — the port of ``paddle_tpu/models/ernie.py``: a post-LN
BERT encoder (the port's :class:`~paddle_tpu_torch.models.bert.BertModel`)
whose embeddings also carry a task-type embedding (ERNIE 3.0
``use_task_id``).  With no ``task_type_ids``, task 0's embedding is still
added, as with token types.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..nn.common import Dropout, Embedding, Linear
from ..nn.initializer import Normal
from .bert import BertConfig, BertEmbeddings, BertModel


@dataclass
class ErnieConfig(BertConfig):
    """ERNIE-3.0-base defaults (PaddleNLP ``ernie-3.0-base-zh`` shape)."""

    vocab_size: int = 40000
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 3
    use_task_id: bool = True

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        max_position_embeddings=64, type_vocab_size=2,
                        task_type_vocab_size=3)
        defaults.update(kw)
        return cls(**defaults)


class ErnieEmbeddings(BertEmbeddings):
    """word + position + token-type (+ task-type) embeddings, LayerNorm,
    dropout."""

    def _add_embeddings(self, config, init, kw):
        self.task_type_embeddings = (
            Embedding(config.task_type_vocab_size, config.hidden_size,
                      weight_attr=init, **kw)
            if config.use_task_id else None)

    def forward(self, input_ids, token_type_ids=None, task_type_ids=None):
        x = self._summed(input_ids, token_type_ids)
        if self.task_type_embeddings is not None:
            if task_type_ids is None:
                x = x + self.task_type_embeddings.weight[0]
            else:
                x = x + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(x))


class ErnieModel(BertModel):
    """Embeddings + post-LN encoder stack + pooler; only the embeddings and
    the ``task_type_ids`` threading differ from :class:`BertModel`."""

    def _build_embeddings(self, config, **kw):
        return ErnieEmbeddings(config, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        h = self.embeddings(input_ids, token_type_ids, task_type_ids)
        return self._encode(h, input_ids, attention_mask)


class ErnieForSequenceClassification(nn.Module):
    def __init__(self, config: ErnieConfig, num_classes: int = 2,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.ernie = ErnieModel(config, device, dtype, generator,
                                dropout_generator)
        self.dropout = Dropout(config.hidden_dropout_prob,
                               generator=dropout_generator)
        self.classifier = Linear(
            config.hidden_size, num_classes,
            weight_attr=Normal(0.0, config.initializer_range),
            device=device, dtype=dtype, generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask,
                               task_type_ids)
        return self.classifier(self.dropout(pooled))
