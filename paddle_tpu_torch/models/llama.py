"""Llama model family — the port of ``paddle_tpu/models/llama.py`` on its
ragged paged serving route.

Architecture follows Llama-3: RMSNorm pre-norm, rotary embeddings, grouped
query attention, SwiGLU MLP, untied LM head (tying supported).  Module and
parameter names are the JAX package's, so ``convert.llama_from_paddle_tpu``
maps its ``state_dict()`` one to one (linear weights transposed).

What this slice ports: attention through a
:class:`~paddle_tpu_torch.ops.paged_attention.PagedCache` routed with
``seg_ids`` — the unified ragged step, where the batch is ONE packed row of
tokens spanning many sequences.  What waits:

* the no-cache forward (training, and the JAX package's dense prefill) goes
  through ``ring_flash_attention`` and the flash kernels — ROADMAP A10;
* the dense-cache and the legacy paged decode / chunk routes — ROADMAP A7;
* MoE layers (``num_experts > 0``) and mp > 1 — ROADMAP A11.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn.norm import RMSNorm
from ..ops import ragged_paged as rp_mod
from ..parallel.mp_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)


@dataclass
class LlamaConfig:
    """Llama-3 family hyperparameters (defaults = Llama-3-8B); the same
    fields and presets as the JAX package's."""

    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    # parallel/perf knobs of the JAX package (training path, ROADMAP A10)
    sequence_parallel: bool = False
    recompute: bool = False
    use_flash_attention: bool = True
    scan_layers: bool = False
    dtype: str = "float32"
    virtual_pp_degree: int = 1
    attention_bias: bool = False        # q/k/v biases (Qwen2 family)
    # MoE knobs (0 experts = dense); MoE is ROADMAP A11
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0
    moe_norm_topk_prob: bool = True
    moe_shared_expert_gated: bool = False
    first_k_dense_replace: int = 0
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama3_8b(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """Test/dry-run config."""
        defaults = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rope_theta=10000.0)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def tiny_moe(cls, **kw):
        """Tiny MoE config (DeepSeek-MoE shape: shared + routed experts)."""
        defaults = dict(num_experts=4, num_experts_per_tok=2,
                        moe_intermediate_size=64, num_shared_experts=1)
        defaults.update(kw)
        return cls.tiny(**defaults)

    @classmethod
    def deepseek_moe_16b(cls, **kw):
        """DeepSeekMoE-16B: 64 routed + 2 shared experts, top-6 routing."""
        defaults = dict(
            vocab_size=102400, hidden_size=2048, intermediate_size=10944,
            num_hidden_layers=28, num_attention_heads=16,
            num_key_value_heads=16, max_position_embeddings=4096,
            num_experts=64, num_experts_per_tok=6,
            moe_intermediate_size=1408, num_shared_experts=2,
            moe_norm_topk_prob=False, first_k_dense_replace=1)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def qwen2_moe_a14b(cls, **kw):
        """Qwen2-57B-A14B MoE: 64 routed + shared expert, top-8, GQA 4:1."""
        defaults = dict(
            vocab_size=151936, hidden_size=3584, intermediate_size=18944,
            num_hidden_layers=28, num_attention_heads=28,
            num_key_value_heads=4, max_position_embeddings=32768,
            num_experts=64, num_experts_per_tok=8,
            moe_intermediate_size=2560, num_shared_experts=8,
            moe_norm_topk_prob=False, moe_shared_expert_gated=True,
            attention_bias=True)
        defaults.update(kw)
        return cls(**defaults)


def _rope_tables(head_dim: int, max_pos: int, theta: float):
    """cos/sin tables ``[max_pos, head_dim / 2]`` in fp32, computed in numpy
    exactly as the JAX package computes them."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))
    t = np.arange(max_pos, dtype=np.float32)
    freqs = np.outer(t, inv)                       # [S, D/2]
    return np.cos(freqs), np.sin(freqs)


def _apply_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [B, S, D/2] per-token tables (cast to x's
    dtype before the rotation, as the JAX package does)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(nn.Module):
    """Grouped-query attention with rotary embeddings, on the ragged paged
    route."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        bias = config.attention_bias
        kw = dict(device=device, dtype=dtype)
        self.q_proj = ColumnParallelLinear(h, self.num_heads * hd, bias, **kw)
        self.k_proj = ColumnParallelLinear(h, self.num_kv_heads * hd, bias,
                                           **kw)
        self.v_proj = ColumnParallelLinear(h, self.num_kv_heads * hd, bias,
                                           **kw)
        self.o_proj = RowParallelLinear(self.num_heads * hd, h, False, **kw)
        cos, sin = _rope_tables(hd, config.max_position_embeddings,
                                config.rope_theta)
        self.register_buffer("_rope_cos", torch.from_numpy(cos).to(device),
                             persistent=False)
        self.register_buffer("_rope_sin", torch.from_numpy(sin).to(device),
                             persistent=False)

    def forward(self, x, cache=None, pos=None):
        B, S = x.shape[0], x.shape[1]
        hd = self.config.head_dim
        q = self.q_proj(x).reshape(B, S, self.num_heads, hd)
        k = self.k_proj(x).reshape(B, S, self.num_kv_heads, hd)
        v = self.v_proj(x).reshape(B, S, self.num_kv_heads, hd)
        if cache is None:
            raise NotImplementedError(
                "the no-cache Llama forward runs ring_flash_attention and "
                "the flash kernels, which the port has not reached yet "
                "(ROADMAP A10); serve through the engine's paged caches")
        if getattr(cache, "seg_ids", None) is None:
            raise NotImplementedError(
                "only the unified ragged paged route is ported; the dense "
                "and legacy paged caches are ROADMAP A7")
        if pos is None or pos.dim() != 2:
            raise ValueError("the ragged route needs [B, S] per-token "
                             "positions")
        # rope at each token's own absolute position
        q = _apply_rope(q, self._rope_cos[pos], self._rope_sin[pos])
        k = _apply_rope(k, self._rope_cos[pos], self._rope_sin[pos])
        return self._ragged_paged_attention(q, k, v, cache, B, S, hd)

    def _ragged_paged_attention(self, q, k, v, cache, B, S, hd):
        """Unified ragged step: the batch is ONE packed row of S tokens
        spanning many sequences.  Each token writes its K/V into its own
        (block, offset) slot — pad tokens write the null page 0 — then one
        ragged attention launch serves every decode row and prefill chunk.

        The JAX program builds new pools (``pool.at[blocks, offs].set``)
        and donates the old ones; here the pools are allocated once by the
        engine and written in place with ``index_put_``."""
        kp, vp = cache.k_pool, cache.v_pool
        slots = (cache.slot_blocks, cache.slot_offsets)   # [T] each
        kp.index_put_(slots, k[0].to(kp.dtype))
        vp.index_put_(slots, v[0].to(vp.dtype))
        out = rp_mod.ragged_paged_attention(
            q[0], kp, vp, cache.block_tables, cache.seq_lens, cache.seg_ids,
            cache.q_start, use_pallas=cache.use_pallas)
        return self.o_proj(out.reshape(B, S, self.num_heads * hd))


class LlamaMLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, ff = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        self.gate_proj = ColumnParallelLinear(h, ff, False, **kw)
        self.up_proj = ColumnParallelLinear(h, ff, False, **kw)
        self.down_proj = RowParallelLinear(ff, h, False, **kw)

    def forward(self, x):
        return self.down_proj(
            nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    """Pre-norm decoder block."""

    def __init__(self, config: LlamaConfig, layer_idx: int = 0, device=None,
                 dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, cache=None, pos=None):
        h = x + self.self_attn(self.input_layernorm(x), cache=cache, pos=pos)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    """Embedding + decoder stack + final norm."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, layer_idx=i, **kw)
             for i in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def forward(self, input_ids, caches=None, pos=None):
        h = self.embed_tokens(input_ids)
        if caches is None:
            caches = [None] * len(self.layers)
        for layer, cache in zip(self.layers, caches):
            h = layer(h, cache=cache, pos=pos)
        return self.norm(h)


class LlamaForCausalLM(nn.Module):
    """Llama with LM head.

    Parameters are created directly on ``device`` (``cuda`` by default;
    raises when there is none, unless ``device="cpu"``) in ``dtype``
    (default: ``config.dtype``), and initialised like the JAX package's:
    linear and embedding weights from N(0, initializer_range), norms at 1,
    biases at 0 — drawn from ``generator`` when given (it must live on
    ``device``), else from torch's default generator."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.num_experts > 0:
            raise NotImplementedError(
                "MoE layers (num_experts > 0) are not ported yet "
                "(ROADMAP A11); this slice serves the dense Llama")
        device = resolve_device(device)
        dtype = dtype if dtype is not None else getattr(torch, config.dtype)
        self.config = config
        self.llama = LlamaModel(config, device=device, dtype=dtype)
        self.lm_head = (None if config.tie_word_embeddings else
                        ColumnParallelLinear(config.hidden_size,
                                             config.vocab_size, False,
                                             device=device, dtype=dtype))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, (ColumnParallelLinear, RowParallelLinear,
                              VocabParallelEmbedding)):
                m.weight.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, caches=None, pos=None):
        h = self.llama(input_ids, caches=caches, pos=pos)
        if self.lm_head is None:
            return h @ self.llama.embed_tokens.weight.T
        return self.lm_head(h)
