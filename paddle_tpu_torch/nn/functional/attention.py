"""Attention functionals: the port of
``paddle_tpu/nn/functional/attention.py`` for
``scaled_dot_product_attention``, ``flash_attention`` and
``sequence_mask`` (``flash_attn_unpadded`` and ``sparse_attention`` wait
for ROADMAP A12).

The routes are the JAX package's.  With no mask and no dropout (or not
training) both attention functions call
``ops/flash_attention.flash_attention_fwd``: the CUDA flash kernels on a
CUDA tensor whose shape they take (else the call raises), the composite
paths on the CPU.  With a mask, ``scaled_dot_product_attention`` takes the
composite below, as the JAX function does off its Pallas gate; with
dropout and no mask it takes the flash route where the kernels take the
call (dropout then applies to the output, the JAX wrapper's contract) and
the composite, with dropout on the probabilities, elsewhere.  Dropout
draws from ``generator`` when given, else from torch's default generator.
Both run as the JAX ops ``attention`` and ``flash_attention`` on the op
bus (``core/dispatch.py``), which casts the inputs (and a mask) under
``amp.auto_cast``.
"""

from __future__ import annotations

import math

import torch

from ...core.dispatch import run_op
from ...core.dtype import convert_dtype
from ...ops.flash_attention import flash_attention_fwd, use_flash
from .common import dropout as _dropout



def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Inputs ``[B, S, H, D]`` (Paddle's flash-attention layout); returns
    ``[B, S, H, D]``.  ``attn_mask`` is added to the scores."""
    q, k, v = query, key, value
    if attn_mask is None and (dropout_p == 0.0 or not training):
        return run_op("attention", _flash, q, k, v, causal=is_causal)
    if attn_mask is None and use_flash(q, k, is_causal):
        return flash_attention(q, k, v, dropout=dropout_p, causal=is_causal,
                               training=training, generator=generator)[0]

    def f(q, k, v, attn_mask):
        return _composite(q, k, v, attn_mask, dropout_p, is_causal, training,
                          generator)

    return run_op("attention", f, q, k, v, attn_mask)


def _flash(q, k, v, causal):
    return flash_attention_fwd(q, k, v, causal=causal)


def _composite(q, k, v, attn_mask, dropout_p, is_causal, training,
               generator):
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # B, H, S, D
    # the scores in q's dtype, as the JAX einsum gives them
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if attn_mask is not None:
        logits = logits + attn_mask
    if is_causal:
        Sq, Sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.to(torch.float32), dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = _dropout(probs, dropout_p, generator=generator)
    return torch.matmul(probs, vh).transpose(1, 2)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None, generator=None):
    """``paddle.nn.functional.flash_attention.flash_attention``: returns
    ``(out, None)``; ``dropout`` applies to the output in training."""
    out = run_op("flash_attention", _flash, query, key, value,
                 causal=causal)
    if dropout > 0.0 and training:
        out = _dropout(out, dropout, generator=generator)
    return out, None


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``[..., maxlen]``: 1 where the position is below the length in
    ``x``."""
    m = maxlen if maxlen is not None else int(x.max())
    d = convert_dtype(dtype)
    return (torch.arange(m, device=x.device) < x[..., None]).to(d)
