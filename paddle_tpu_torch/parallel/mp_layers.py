"""The tensor-parallel layers of ``paddle_tpu/parallel/mp_layers.py`` at
mp=1: a plain embedding and plain linear layers.

Parameter names match the JAX package's (``weight``, ``bias``) so state
dicts map one to one, but the layout is PyTorch's: a linear weight is
``[out, in]`` here and ``[in, out]`` there (``convert.py`` transposes).
Parameters are created uninitialised on ``device``; the model initialises
them.  Sharding over ``mp`` > 1 is ROADMAP A11.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dispatch import run_op
from ..nn.functional.common import embedding


class VocabParallelEmbedding(nn.Module):
    """Token embedding, ``weight`` ``[num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, x):
        return embedding(x, self.weight)


class _Linear(nn.Module):
    def __init__(self, in_features, out_features, has_bias=True, device=None,
                 dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        return run_op("linear", F.linear, x, self.weight, self.bias)


class ColumnParallelLinear(_Linear):
    """``x @ W.T + b``; the column-parallel layer at mp=1."""


class RowParallelLinear(_Linear):
    """``x @ W.T + b``; the row-parallel layer at mp=1."""
