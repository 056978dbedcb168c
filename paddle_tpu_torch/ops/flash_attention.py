"""Attention dispatch of the no-cache forward: the port of
``paddle_tpu/ops/flash_attention.py``.

Layout ``[B, S, H, D]`` (k/v ``[B, Sk, Hkv, D]``, GQA).  Three paths:

* ``"cuda"`` — the hand-written flash kernels behind
  ``ops/flash.py::FlashAttention``: on a CUDA tensor for every shape they
  take (head dim 64 or 128, any sequence length, at most 128 query heads a
  KV head; causal only with ``Sq == Sk``, because the kernels mask top-left
  and the composite paths bottom-right).  :func:`takes_kernels` is the
  rule, a pure function of the call's device, dtype and shape.  The JAX
  gate's ``seq >= 1024``, ``seq % 128 == 0`` and TPU check are Mosaic
  tiling and XLA-on-TPU choices and do not carry over.
* ``"chunked"`` — ``ops/chunked_attention.py`` when ``Sq · Sk >= 1024²``;
* ``"reference"`` — :func:`_reference_attention`, the composite, below it.

An exported graph (``jit.save``) takes the first path wherever the card
would (:func:`use_flash`).  The last two are the JAX package's off-TPU dispatch (its ``"xla_chunked"``
and ``"xla"``); a CPU tensor always takes it, so the CPU tests compare like
with like.  ``use_pallas=False`` pins it on the card too (the counterpart
of the JAX ``disable_pallas_kernels`` flag, scoped to one call), and
``use_pallas=True`` raises where the kernels cannot run.  There is no
fallback from a failing kernel, no environment switch and no autotuned
block geometry.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import flash
from .chunked_attention import chunked_attention

_CHUNKED_MIN_AREA = 1024 * 1024  # Sq*Sk at which S^2 scores become the
                                 # memory bottleneck -> chunked recurrence

# Which path the most recent dispatch took: "cuda" | "chunked" | "reference".
last_path: Optional[str] = None


def takes_kernels(device_type, dtype, head_dim, H, Hkv, causal, Sq,
                  Sk) -> bool:
    """Whether the CUDA kernels take a call: a CUDA tensor of a dtype and
    head dim they are built for, a GQA group of at most ``flash.MAX_GROUP``
    query heads a KV head (a block packs the group into its rows), and
    ``Sq == Sk`` when causal (the kernels mask top-left, the composite
    bottom-right).  Every other call takes the composite."""
    return (device_type == "cuda" and dtype in flash.DTYPES
            and head_dim in flash.HEAD_DIMS and H // Hkv <= flash.MAX_GROUP
            and (not causal or Sq == Sk))


def use_flash(q, k, causal: bool) -> bool:
    """Whether the CUDA kernels take this call (:func:`takes_kernels`).
    While ``torch.export`` traces (``jit.save``), a call takes the flash
    route wherever the kernels would take it on the card, whatever the
    tracing tensors' device: the graph then holds the registered
    ``paddle_tpu_torch::flash_fwd``, which picks the kernel or its twin by
    the device of the tensors the loaded program runs on."""
    if q.dim() != 4:
        return False
    device_type = ("cuda" if torch.compiler.is_exporting()
                   else q.device.type)
    return takes_kernels(device_type, q.dtype, q.shape[-1], q.shape[2],
                         k.shape[2], causal, q.shape[1], k.shape[1])


def _reference_attention(q, k, v, causal: bool):
    """The composite: grouped einsum (query heads ``[B, S, Hkv, rep, D]``
    against the ungrouped KV), fp32 scores, the bottom-right causal mask
    filled with ``-inf``, softmax, probabilities cast to q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dtype = torch.promote_types(q.dtype, v.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(dtype), v.to(dtype))
    return out.reshape(B, Sq, H, D)


def flash_attention_fwd(q, k, v, causal: bool = False,
                        use_pallas: Optional[bool] = None):
    """Dispatch: the CUDA flash kernels on the card, the JAX package's
    off-TPU paths otherwise (see the module docstring)."""
    global last_path
    if use_pallas is not False and use_flash(q, k, causal):
        out = flash.flash_attention(q, k, v, causal)
        last_path = "cuda"
        return out
    if use_pallas is True:
        raise RuntimeError(
            f"use_pallas=True asks for the CUDA flash kernels, which do not "
            f"take q {tuple(q.shape)} {q.dtype} on {q.device} with k "
            f"{tuple(k.shape)}, causal={causal}")
    if q.shape[1] * k.shape[1] >= _CHUNKED_MIN_AREA:
        last_path = "chunked"
        return chunked_attention(q, k, v, causal)
    last_path = "reference"
    return _reference_attention(q, k, v, causal)
