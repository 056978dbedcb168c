"""Llama model family — the port of ``paddle_tpu/models/llama.py``.

Architecture follows Llama-3: RMSNorm pre-norm, rotary embeddings, grouped
query attention, SwiGLU MLP, untied LM head (tying supported).  Module and
parameter names are the JAX package's, so ``convert.llama_from_paddle_tpu``
maps its ``state_dict()`` one to one (linear weights transposed).

The attention takes the routes of the JAX model's forward:

* no cache — training and scoring: rope at positions ``0..S-1``, then
  ``parallel/ring_attention.ring_flash_attention`` (at sep=1 the attention
  dispatch of ``ops/flash_attention.py``: the CUDA flash kernels on the
  card);
* a dense ``(k_buf, v_buf)`` cache — the one-shot prefill of the legacy
  engine and :meth:`LlamaForCausalLM.generate`;
* a :class:`~paddle_tpu_torch.ops.paged_attention.PagedCache`, told apart
  as the JAX model does: routed with ``seg_ids`` — the unified ragged step
  (``ops/ragged_paged.py``); with ``[B, S]`` slot arrays — a chunked
  prefill (``paged_prefill_attention``); with ``[B]`` slot arrays — a
  decode step (``paged_attention``, the CUDA decode kernel on the card).

``LlamaPretrainingCriterion`` is the shifted next-token cross-entropy of
the JAX package.

Tensor parallelism follows the JAX layout (``paddle_tpu/models/llama.py``
``LlamaAttention``, ``LlamaMLP``, ``LlamaForCausalLM``): with a hybrid
topology of mp > 1 (``distributed.topology.init_mesh``) each rank holds
``H/mp`` query heads and ``Hkv/mp`` KV heads (q, k, v column-parallel with
their outputs left sliced, o row-parallel), the MLP's ``I/mp`` columns, the
embedding's ``V/mp`` rows and the LM head's ``V/mp`` columns, whose logits
are gathered; the no-cache attention runs the flash kernels on the rank's
own heads, and every cached route its dense buffers or pools of the
rank's ``Hkv/mp`` KV heads (tensor-parallel serving and
:meth:`LlamaForCausalLM.generate`).  mp must divide the heads, the KV
heads, the intermediate size and the vocabulary, or the model raises.
What waits: MoE layers (``num_experts > 0``), pipeline micro-batches and
1F1B — ROADMAP A11.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.tensor import getitem
from ..device import resolve_device
from ..nn import functional as F
from ..nn.norm import RMSNorm
from ..ops import paged_attention as pa_mod
from ..ops import ragged_paged as rp_mod
from ..parallel.mp_layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    parallel_matmul,
)
from ..parallel.ring_attention import ring_flash_attention
from ..parallel.utils import axis_group


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
    # parallel/perf knobs of the JAX package.  recompute checkpoints each
    # decoder layer in training; use_flash_attention=False pins the
    # composite attention paths (the kernels stay off for this model);
    # scan_layers runs the same module loop (the JAX scan is a compile-time
    # device with the same math); sequence_parallel waits for ROADMAP A11
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


def check_mp_degree(config, mp: int) -> None:
    """mp must divide the heads, the KV heads, the intermediate size and
    the vocabulary: each rank holds whole heads and equal slices."""
    sizes = {"num_attention_heads": config.num_attention_heads,
             "num_key_value_heads": getattr(config, "num_key_value_heads",
                                            config.num_attention_heads),
             "intermediate_size": config.intermediate_size,
             "vocab_size": config.vocab_size}
    bad = {k: v for k, v in sizes.items() if v % mp}
    if bad:
        raise ValueError(f"mp degree {mp} does not divide "
                         + ", ".join(f"{k}={v}" for k, v in bad.items()))


def _rope_tables(head_dim: int, max_pos: int, theta: float):
    """cos/sin tables ``[max_pos, head_dim / 2]`` in fp32, computed in numpy
    exactly as the JAX package computes them."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                           / head_dim))
    t = np.arange(max_pos, dtype=np.float32)
    freqs = np.outer(t, inv)                       # [S, D/2]
    return np.cos(freqs), np.sin(freqs)


def _apply_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [B, S, D/2] (or [1, S, D/2]) per-token
    tables, cast to x's dtype before the rotation, as the JAX package
    does."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LlamaAttention(nn.Module):
    """Grouped-query attention with rotary embeddings: the no-cache route
    (flash attention) and the cached ones (dense buffers, paged decode,
    paged chunk, unified ragged)."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, hd = config.hidden_size, config.head_dim
        self.mp = axis_group("mp").nranks
        # this rank's heads (all of them at mp=1)
        self.num_heads = config.num_attention_heads // self.mp
        self.num_kv_heads = config.num_key_value_heads // self.mp
        bias = config.attention_bias
        kw = dict(device=device, dtype=dtype)
        col = dict(kw, gather_output=False)
        self.q_proj = ColumnParallelLinear(
            h, config.num_attention_heads * hd, bias, **col)
        self.k_proj = ColumnParallelLinear(
            h, config.num_key_value_heads * hd, bias, **col)
        self.v_proj = ColumnParallelLinear(
            h, config.num_key_value_heads * hd, bias, **col)
        self.o_proj = RowParallelLinear(config.num_attention_heads * hd, h,
                                        False, input_is_parallel=True, **kw)
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
        if cache is not None and pos is None:
            raise ValueError("a cached forward needs the tokens' positions")
        if pos is None:
            cos, sin = self._rope_cos[None, :S], self._rope_sin[None, :S]
        else:
            idx = self._rope_index(pos, S)
            cos, sin = self._rope_cos[idx], self._rope_sin[idx]
        q = _apply_rope(q, cos, sin)
        k = _apply_rope(k, cos, sin)
        if cache is None:
            # GQA KV heads are read natively by every attention path
            out = ring_flash_attention(
                q, k, v, causal=True,
                use_pallas=None if self.config.use_flash_attention else False)
            return self.o_proj(out.reshape(B, S, self.num_heads * hd))
        if not isinstance(cache, pa_mod.PagedCache):
            return self._cached_attention(q, k, v, cache, pos, B, S, hd)
        if cache.seg_ids is not None:
            return self._ragged_paged_attention(q, k, v, cache, B, S, hd)
        if cache.slot_blocks is not None and cache.slot_blocks.dim() == 2:
            return self._chunk_paged_attention(q, k, v, cache, B, S, hd)
        return self._paged_attention(q, k, v, cache, B, S, hd)

    def _rope_index(self, pos, S):
        """``[B, S]`` (or ``[1, S]``) rope-table rows for ``pos``, as the JAX
        ``rope_at`` reads it: a scalar is a shared first position, ``[B]``
        per-row first positions, ``[B, S]`` every token's own position
        (the packed ragged step).  A 0-d tensor is never read on the host,
        so a captured step program takes its position as data."""
        dev = self._rope_cos.device
        if not isinstance(pos, torch.Tensor):
            return (int(pos) + torch.arange(S, device=dev))[None, :]
        pos = pos.to(device=dev, dtype=torch.int64)
        if pos.dim() == 2:
            return pos
        if pos.dim() == 0:
            return (pos + torch.arange(S, device=dev))[None, :]
        return pos[:, None] + torch.arange(S, device=dev)[None, :]

    def _cached_attention(self, q, k, v, cache, pos, B, S, hd):
        """Dense KV cache: write this call's K/V into the static
        ``[B, M, Hkv, D]`` buffers at position ``pos`` (in place; the JAX
        version rebinds them), then grouped-query attention over the whole
        buffer with the causal mask ``col <= pos + row``.  Scores in fp32;
        the probabilities are cast to the buffers' dtype for the product
        with V, as in the JAX version.  ``pos`` is a Python int or a 0-d
        tensor; a tensor is never read on the host (the write is an
        ``index_copy_`` at ``pos + [0, S)``)."""
        k_buf, v_buf = cache
        dev = q.device
        if isinstance(pos, torch.Tensor):
            p = pos.to(device=dev, dtype=torch.int64)
            idx = p + torch.arange(S, device=dev)
            k_buf.index_copy_(1, idx, k.to(k_buf.dtype))
            v_buf.index_copy_(1, idx, v.to(v_buf.dtype))
        else:
            p = int(pos)
            k_buf[:, p:p + S] = k.to(k_buf.dtype)
            v_buf[:, p:p + S] = v.to(v_buf.dtype)
        rep = self.num_heads // self.num_kv_heads
        M = k_buf.shape[1]
        qg = q.reshape(B, S, self.num_kv_heads, rep, hd)
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                              k_buf.float()) / math.sqrt(hd)
        col = torch.arange(M, device=dev)[None, :]
        row = torch.arange(S, device=dev)[:, None]
        logits.masked_fill_(~(col <= p + row), -1e30)
        probs = torch.softmax(logits, dim=-1)
        del logits   # [B, Hkv, rep, S, M] fp32: the largest transient
        out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v_buf.dtype), v_buf)
        return self.o_proj(out.reshape(B, S, self.num_heads * hd).to(q.dtype))

    def _paged_attention(self, q, k, v, cache, B, S, hd):
        """Decode step over the shared pools: each row's one new token
        writes its K/V into its (block, offset) slot — pad rows write the
        null page 0 — then paged decode attention through the block tables
        (``ops/paged_attention.paged_attention``: the CUDA decode kernel on
        the card)."""
        if S != 1:
            raise ValueError(f"the paged decode route takes one token per "
                             f"row, got {S}")
        kp, vp = cache.k_pool, cache.v_pool
        slots = (cache.slot_blocks, cache.slot_offsets)   # [B] each
        kp.index_put_(slots, k[:, 0].to(kp.dtype))
        vp.index_put_(slots, v[:, 0].to(vp.dtype))
        out = pa_mod.paged_attention(
            q[:, 0], kp, vp, cache.block_tables, cache.seq_lens,
            use_pallas=cache.use_pallas)
        return self.o_proj(out.reshape(B, S, self.num_heads * hd))

    def _chunk_paged_attention(self, q, k, v, cache, B, S, hd):
        """Chunked prefill over the shared pools: the chunk's S tokens write
        their (block, offset) slots — pads write the null page — then causal
        attention over the gathered pages from ``cache.q_start``
        (``ops/paged_attention.paged_prefill_attention``, plain PyTorch)."""
        kp, vp = cache.k_pool, cache.v_pool
        slots = (cache.slot_blocks, cache.slot_offsets)   # [B, S] each
        kp.index_put_(slots, k.to(kp.dtype))
        vp.index_put_(slots, v.to(vp.dtype))
        out = pa_mod.paged_prefill_attention(
            q, kp, vp, cache.block_tables, cache.seq_lens, cache.q_start)
        return self.o_proj(out.reshape(B, S, self.num_heads * hd))

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
        self.gate_proj = ColumnParallelLinear(h, ff, False,
                                              gather_output=False, **kw)
        self.up_proj = ColumnParallelLinear(h, ff, False,
                                            gather_output=False, **kw)
        self.down_proj = RowParallelLinear(ff, h, False,
                                           input_is_parallel=True, **kw)

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

    def forward(self, input_ids, pp_microbatches: Optional[int] = None,
                caches=None, pos=None):
        """Without caches, in training with ``config.recompute``, each
        decoder layer is checkpointed (``torch.utils.checkpoint``, the
        port's ``jax.checkpoint``): its activations are recomputed in the
        backward.  ``config.scan_layers`` takes the same loop — the JAX
        package's ``lax.scan`` over stacked layer weights compiles one layer
        body instead of L, with the same math, and PyTorch compiles
        nothing."""
        if pp_microbatches:
            raise NotImplementedError(
                "pipeline micro-batches are not ported yet (ROADMAP A11); "
                "the port runs pp=1")
        h = self.embed_tokens(input_ids)
        if caches is not None:
            for layer, cache in zip(self.layers, caches):
                h = layer(h, cache=cache, pos=pos)
            return self.norm(h)
        remat = self.config.recompute and self.training
        for layer in self.layers:
            if remat:
                h = checkpoint(layer, h, None, pos, use_reentrant=False)
            else:
                h = layer(h, pos=pos)
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
        check_mp_degree(config, axis_group("mp").nranks)
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
        """Each weight drawn whole from ``generator``, in module order; at
        mp > 1 a rank keeps its slice, so every degree starts from the same
        full weights and no rank holds more than one full tensor at a
        time."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, (ColumnParallelLinear, RowParallelLinear,
                              VocabParallelEmbedding)):
                m.init_normal_(std, generator)

    def forward(self, input_ids, pp_microbatches: Optional[int] = None,
                caches=None, pos=None):
        h = self.llama(input_ids, pp_microbatches=pp_microbatches,
                       caches=caches, pos=pos)
        if self.lm_head is None:
            emb = self.llama.embed_tokens
            return parallel_matmul(h, emb.weight, emb.group)
        return self.lm_head(h)

    def train_batch_1f1b(self, input_ids, labels, n_microbatch: int,
                         criterion=None, recompute: bool = False):
        raise NotImplementedError(
            "the 1F1B pipeline schedule is not ported yet (ROADMAP A11); "
            "train with model(ids), the criterion and loss.backward()")

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0):
        """Autoregressive generation with a static dense KV cache: one
        prefill over ``input_ids`` (``[B, T0]``), then one decode step per
        new token.  Greedy when ``temperature == 0``; otherwise it samples
        on the host from ``np.random.default_rng(seed)`` exactly as the JAX
        package's ``generate`` does, so equal logits give equal tokens.
        Returns ``[B, T0 + n]`` int64 on the CPU (``n <= max_new_tokens``;
        it stops early once every row has emitted ``eos_token_id``).

        At mp > 1 every rank of the mp group calls it with the same
        arguments: each rank's caches hold its KV heads, the gathered
        logits are bit-equal on every rank, and so are the host draws."""
        cfg = self.config
        ids = (input_ids.detach().cpu().long()
               if isinstance(input_ids, torch.Tensor) else
               torch.as_tensor(np.asarray(input_ids), dtype=torch.int64))
        B, T0 = ids.shape
        M = T0 + max_new_tokens
        w = self.llama.embed_tokens.weight
        shape = (B, M, self.llama.layers[0].self_attn.num_kv_heads,
                 cfg.head_dim)
        caches = [(torch.zeros(shape, dtype=w.dtype, device=w.device),
                   torch.zeros(shape, dtype=w.dtype, device=w.device))
                  for _ in range(cfg.num_hidden_layers)]
        was_training = self.training
        self.eval()
        rng = np.random.default_rng(seed)

        def sample(logits_np):
            if temperature == 0.0:
                return logits_np.argmax(-1)
            logits_np = logits_np / max(temperature, 1e-6)
            if top_k > 0:
                kth = np.sort(logits_np, -1)[:, -top_k][:, None]
                logits_np = np.where(logits_np < kth, -1e30, logits_np)
            probs = np.exp(logits_np - logits_np.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            if top_p < 1.0:
                order = np.argsort(-probs, -1)
                sorted_p = np.take_along_axis(probs, order, -1)
                keep = np.cumsum(sorted_p, -1) - sorted_p < top_p
                mask = np.zeros_like(probs, bool)
                np.put_along_axis(mask, order, keep, -1)
                probs = np.where(mask, probs, 0.0)
                probs /= probs.sum(-1, keepdims=True)
            return np.array([rng.choice(probs.shape[-1], p=p) for p in probs])

        def last_logits(tokens, pos):
            logits = self(tokens.to(w.device), caches=caches, pos=pos)
            return logits[:, -1].float().cpu().numpy()

        out = [ids.numpy()]
        tok = sample(last_logits(ids, 0))
        finished = np.zeros((B,), bool)
        for step in range(max_new_tokens):
            if eos_token_id is not None:
                finished |= tok == eos_token_id
            out.append(tok[:, None])
            if eos_token_id is not None and finished.all():
                break
            if step == max_new_tokens - 1:
                break
            tok = sample(last_logits(
                torch.from_numpy(tok[:, None].astype(np.int64)), T0 + step))
        if was_training:
            self.train()
        return torch.from_numpy(np.concatenate(out, axis=1).astype(np.int64))


class LlamaPretrainingCriterion(nn.Module):
    """Shifted next-token cross-entropy (PaddleNLP
    ``LlamaPretrainingCriterion`` analog); ``ignore_index=-100`` masks
    padding."""

    def __init__(self, config: Optional[LlamaConfig] = None,
                 ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        # the JAX Tensor's indexing is the op ``getitem``
        shifted = getitem(logits, (slice(None), slice(None, -1), slice(None)))
        target = getitem(labels, (slice(None), slice(1, None)))
        return F.cross_entropy(shifted, target, reduction="mean",
                               ignore_index=self.ignore_index)
