"""GPT family — the port of ``paddle_tpu/models/gpt.py``: a pre-LN decoder
LM with learned position embeddings, a GELU (tanh) MLP and a tied LM head.

Module and parameter names are the JAX package's, so
``convert.gpt_from_paddle_tpu`` maps its ``state_dict()`` one to one
(linear weights transposed), including the bare
``gpt.position_embeddings`` parameter and, with tied embeddings, no
``lm_head`` key.  The fused QKV projection keeps the JAX column order
``(3, heads, head_dim)``.  Attention is MHA through
``parallel/ring_attention.ring_flash_attention`` (sep=1: the dispatch of
``ops/flash_attention.py``, so the CUDA flash kernels run forward and
backward on a CUDA tensor).  The tied head is ``h @ embed.weight.T`` on the
embedding's own parameter, so its gradient sums both uses.

Each step the JAX model dispatches is an op of the bus under the JAX name
(``embedding``, ``add_pos_embed``, ``linear``, ``split_qkv``,
``ring_attention_fallback``, ``merge_heads``, ``add``, ``gelu``,
``layer_norm``, ``tied_head``), so ``amp.auto_cast`` casts what the JAX
package casts and ``amp.debugging.low_precision_op_list`` counts the same.

With a hybrid topology of mp > 1 the layers are tensor-parallel as in the
JAX package: the fused QKV projection is column-parallel in three blocks
(each rank holds its ``heads/mp`` heads of Q, of K and of V, in the JAX
column order), the MLP's first layer column-parallel, the attention output
and the MLP's second layer row-parallel, the embedding vocab-parallel and
the tied head's logits gathered (``parallel_matmul``); position embeddings
and the LayerNorms are whole on every rank.

``recompute`` checkpoints each decoder layer in training
(``torch.utils.checkpoint``); ``scan_layers=True`` takes the same module
loop (the JAX ``lax.scan`` is a compile-time device with the same math).
Pipeline micro-batches (``pp_microbatches`` > 1) and virtual pipeline
stages (``virtual_pp_degree`` > 1) wait for ROADMAP A11: both raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.dispatch import run_op
from ..device import resolve_device
from ..nn import functional as F
from ..nn.container import LayerList
from ..nn.norm import LayerNorm
from ..parallel.mp_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    parallel_matmul,
)
from ..parallel.ring_attention import ring_flash_attention
from ..parallel.utils import axis_group
from ..tensor.math import add
from .llama import LlamaPretrainingCriterion, check_mp_degree


@dataclass
class GPTConfig:
    """GPT-2/3 hyperparameters (defaults = GPT-3 6.7B shape)."""

    vocab_size: int = 50304
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    intermediate_size: int = 16384
    max_position_embeddings: int = 2048
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = True
    recompute: bool = False
    scan_layers: bool = False
    dtype: str = "float32"
    virtual_pp_degree: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, **kw):
        defaults = dict(vocab_size=256, hidden_size=64,
                        num_hidden_layers=4, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=128)
        defaults.update(kw)
        return cls(**defaults)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads // axis_group("mp").nranks
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, True,
                                             gather_output=False,
                                             fused_blocks=3, **kw)
        self.o_proj = RowParallelLinear(h, h, True, input_is_parallel=True,
                                        **kw)

    def forward(self, x):
        B, S = x.shape[0], x.shape[1]
        hd = self.config.head_dim
        nh = self.num_heads

        def split(a):
            # views into the fused projection: the kernels read them in place
            a = a.reshape(B, S, 3, nh, hd)
            return a[:, :, 0], a[:, :, 1], a[:, :, 2]

        q, k, v = run_op("split_qkv", split, self.qkv_proj(x))
        out = ring_flash_attention(q, k, v, causal=True)
        out = run_op("merge_heads", lambda a: a.reshape(B, S, nh * hd), out)
        return self.o_proj(out)


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.fc_in = ColumnParallelLinear(
            config.hidden_size, config.intermediate_size, True,
            gather_output=False, **kw)
        self.fc_out = RowParallelLinear(
            config.intermediate_size, config.hidden_size, True,
            input_is_parallel=True, **kw)

    def forward(self, x):
        return self.fc_out(F.gelu(self.fc_in(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    """Pre-LN block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        eps = config.layer_norm_epsilon
        self.ln_1 = LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(config.hidden_size, epsilon=eps, **kw)
        self.mlp = GPTMLP(config, **kw)

    def forward(self, x):
        x = add(x, self.attn(self.ln_1(x)))
        return add(x, self.mlp(self.ln_2(x)))


class GPTModel(nn.Module):
    """Token + learned-position embeddings, pre-LN stack, final LayerNorm.
    Parameters are created uninitialised; :class:`GPTForCausalLM`
    initialises them."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        if config.virtual_pp_degree != 1:
            raise NotImplementedError(
                f"virtual pipeline stages are not ported yet (ROADMAP A11); "
                f"the port runs virtual_pp_degree=1, got "
                f"{config.virtual_pp_degree}")
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = nn.Parameter(torch.empty(
            config.max_position_embeddings, config.hidden_size, **kw))
        self.layers = LayerList(
            [GPTDecoderLayer(config, **kw)
             for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              epsilon=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, pp_microbatches: Optional[int] = None):
        if pp_microbatches is not None and pp_microbatches > 1:
            raise NotImplementedError(
                "pipeline micro-batches are not ported yet (ROADMAP A11); "
                "the port runs pp=1")
        S = input_ids.shape[1]
        h = run_op("add_pos_embed", lambda a, p: a + p[:S],
                   self.embed_tokens(input_ids), self.position_embeddings)
        remat = self.config.recompute and self.training
        for layer in self.layers:
            h = (checkpoint(layer, h, use_reentrant=False) if remat
                 else layer(h))
        return self.ln_f(h)


class GPTForCausalLM(nn.Module):
    """GPT with (by default tied) LM head.

    Parameters are created directly on ``device`` (``cuda`` by default;
    raises when there is none, unless ``device="cpu"``) in ``dtype``
    (default: ``config.dtype``), and initialised like the JAX package's:
    linear, embedding and position weights from N(0, initializer_range),
    LayerNorms at 1, biases at 0 — drawn from ``generator`` when given (it
    must live on ``device``), else from torch's default generator."""

    def __init__(self, config: GPTConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_mp_degree(config, axis_group("mp").nranks)
        device = resolve_device(device)
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        self.config = config
        self.gpt = GPTModel(config, device=device, dtype=dtype)
        self.lm_head = (None if config.tie_word_embeddings else
                        ColumnParallelLinear(config.hidden_size,
                                             config.vocab_size, False,
                                             device=device, dtype=dtype))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        std = self.config.initializer_range
        self.gpt.position_embeddings.normal_(0.0, std, generator=generator)
        for m in self.modules():
            if isinstance(m, (ColumnParallelLinear, RowParallelLinear,
                              VocabParallelEmbedding)):
                m.init_normal_(std, generator)

    def forward(self, input_ids, pp_microbatches: Optional[int] = None):
        h = self.gpt(input_ids, pp_microbatches=pp_microbatches)
        if self.lm_head is None:
            emb = self.gpt.embed_tokens
            return run_op("tied_head",
                          lambda a, w: parallel_matmul(a, w, emb.group), h,
                          emb.weight)
        return self.lm_head(h)


# shifted-CE pretraining loss: identical semantics to Llama's
GPTPretrainingCriterion = LlamaPretrainingCriterion
