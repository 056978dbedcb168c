"""Memory-bounded attention over KV chunks: the port of
``paddle_tpu/ops/chunked_attention.py``.

The FlashAttention-2 recurrence (online softmax over KV chunks, a
log-sum-exp residual, probabilities recomputed in the backward) written as
a Python loop over chunks of ``block_k`` keys, where the JAX package has a
``lax.scan``.  Live memory is O(Sq · block_k) per (batch, head), not
O(Sq · Sk).  It was XLA code in the JAX package, so it is plain torch ops
here, with no kernel.

Layout as ``ops/flash.py``: q ``[B, Sq, H, D]``, k/v ``[B, Sk, Hkv, D]``
(GQA: the query heads of a group are read against one KV head, which is
never repeated).  The causal mask is the composite's bottom-right one,
``col <= row + (Sk - Sq)``; a query row with no valid key (causal with
Sq > Sk) returns zeros with zero gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DEFAULT_BLOCK_K = 512
_NEG_INF = -1e30


def _grouped(x, Hkv):
    """``[B, S, H, D]`` → ``[B, Hkv, rep, S, D]``."""
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B, Hkv, H // Hkv, S, D)


def _chunks(x, block_k):
    """``[B, Sk, Hkv, D]`` → ``[B, Hkv, Skp, D]`` zero-padded to a multiple
    of ``block_k``, and the number of chunks."""
    Sk = x.shape[1]
    pad = (-Sk) % block_k
    x = x.permute(0, 2, 1, 3)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x, (Sk + pad) // block_k


def _valid(ci, block_k, Sq, Sk, causal, device):
    """``[Sq, block_k]`` mask of chunk ``ci``: real keys, and under causal
    the bottom-right triangle."""
    k_pos = ci * block_k + torch.arange(block_k, device=device)[None, :]
    valid = k_pos < Sk
    if causal:
        q_pos = torch.arange(Sq, device=device)[:, None]
        valid = valid & (k_pos <= q_pos + (Sk - Sq))
    return valid


def _scan_fwd(q, k, v, scale, causal, block_k):
    """Returns ``(out [B, Sq, H, D]`` in q's dtype, ``lse [B, H, Sq]``
    fp32)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kp, n_chunks = _chunks(k, block_k)
    vp, _ = _chunks(v, block_k)
    qg = _grouped(q, Hkv).float()
    m = torch.full((B, Hkv, rep, Sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, rep, Sq, D), dtype=torch.float32,
                      device=q.device)
    for ci in range(n_chunks):
        kb = kp[:, :, ci * block_k:(ci + 1) * block_k]
        vb = vp[:, :, ci * block_k:(ci + 1) * block_k]
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg, kb.float()) * scale
        valid = _valid(ci, block_k, Sq, Sk, causal, q.device)
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # p masked explicitly: a row with no valid key keeps l == 0, so the
        # epilogue returns zeros
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bgkd->bgrqd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / safe_l[..., None]).to(q.dtype)
    out = out.reshape(B, H, Sq, D).permute(0, 2, 1, 3)
    lse = (m + torch.log(safe_l)).reshape(B, H, Sq)
    return out, lse


def _scan_bwd(q, k, v, out, lse, g, scale, causal, block_k):
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    kp, n_chunks = _chunks(k, block_k)
    vp, _ = _chunks(v, block_k)
    qg = _grouped(q, Hkv)
    dog = _grouped(g, Hkv)
    lse_g = lse.reshape(B, Hkv, rep, Sq)
    delta = torch.einsum("bshd,bshd->bhs", g.float(),
                         out.float()).reshape(B, Hkv, rep, Sq)
    dq = torch.zeros((B, Hkv, rep, Sq, D), dtype=torch.float32,
                     device=q.device)
    dk_c, dv_c = [], []
    for ci in range(n_chunks):
        kb = kp[:, :, ci * block_k:(ci + 1) * block_k]
        vb = vp[:, :, ci * block_k:(ci + 1) * block_k]
        s = torch.einsum("bgrqd,bgkd->bgrqk", qg.float(), kb.float()) * scale
        valid = _valid(ci, block_k, Sq, Sk, causal, q.device)
        s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
        # the forward's explicit mask: rows with no valid key have p == 0
        p = torch.where(valid, torch.exp(s - lse_g[..., None]),
                        torch.zeros_like(s))
        dv_c.append(torch.einsum("bgrqk,bgrqd->bgkd", p, dog.float()))
        dp = torch.einsum("bgrqd,bgkd->bgrqk", dog.float(), vb.float())
        ds = p * (dp - delta[..., None]) * scale
        dk_c.append(torch.einsum("bgrqk,bgrqd->bgkd", ds, qg.float()))
        dq = dq + torch.einsum("bgrqk,bgkd->bgrqd", ds.to(kb.dtype).float(),
                               kb.float())
    dq = dq.reshape(B, H, Sq, D).permute(0, 2, 1, 3).to(q.dtype)
    dk = torch.cat(dk_c, dim=2)[:, :, :Sk].permute(0, 2, 1, 3).to(k.dtype)
    dv = torch.cat(dv_c, dim=2)[:, :, :Sk].permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


class ChunkedAttention(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``chunked_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        scale = 1.0 / math.sqrt(q.shape[-1])
        out, lse = _scan_fwd(q, k, v, scale, causal, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.block_k = causal, block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        scale = 1.0 / math.sqrt(q.shape[-1])
        dq, dk, dv = _scan_bwd(q, k, v, out, lse, g, scale, ctx.causal,
                               ctx.block_k)
        return dq, dk, dv, None, None


def chunked_attention(q, k, v, causal=False, block_k=DEFAULT_BLOCK_K):
    """O(Sq · block_k)-memory attention over ``[B, Sq, H, D]`` q and
    ``[B, Sk, Hkv, D]`` k/v; differentiable.  Fully masked query rows
    (causal with Sq > Sk) return zeros with zero gradients, where the
    composite reference gives NaN."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not divisible by kv "
                         f"heads {k.shape[2]}")
    return ChunkedAttention.apply(q, k, v, causal, block_k)
