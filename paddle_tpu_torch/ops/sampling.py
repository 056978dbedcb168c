"""Per-row token sampling inside the step (the port of
``paddle_tpu/ops/sampling.py``).

Turns a ``[rows, vocab]`` logits block into ``[rows]`` token ids on the
device, so the host fetches token ids only.  The contract is the JAX
package's, bit for bit where it can be:

* **Greedy is the temperature==0 row of the same reduction**: rows with
  ``temperature <= 0`` reduce to a pure argmax.
* **Determinism under seed via counter-keyed Gumbel-max.**  The key of a
  draw is the raw u32 pair ``(seed, draw_index)``, the request's output
  position.  The noise is a murmur3 finalizer chain over
  ``(seed, draw, vocab lane)``; its u32 bits equal the JAX package's
  exactly (tested), so the same request draws from the same uniforms in
  both packages.  The u32 arithmetic runs in int64 masked with
  ``0xFFFFFFFF``, with each multiply split in 16-bit halves so no
  intermediate leaves int64's range.
* **Filter order**: temperature scale -> top-k mask -> top-p nucleus mask
  -> draw.  ``top_k <= 0`` means no top-k filter; ``top_p`` in (0, 1].
"""

from __future__ import annotations

import torch

_NEG = -1e30       # mask value: finite, so argmax ties stay sane
_MASK32 = 0xFFFFFFFF


def _mul32(z, c: int):
    """``(z * c) mod 2**32`` for int64 ``z`` in [0, 2**32) and a u32
    constant ``c``, without overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (z * lo + (((z * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(z):
    """murmur3 32-bit finalizer on int64 tensors holding u32 values."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    z = z ^ (z >> 16)
    return z


def _hash_bits(keys, V: int):
    """``[R, V]`` u32 hash bits (as int64) of the (seed, draw, lane)
    counter triples of raw ``[R, 2]`` (seed, draw) keys."""
    keys = keys.to(torch.int64) & _MASK32
    seed = keys[:, 0:1]
    draw = keys[:, 1:2]
    lane = torch.arange(V, dtype=torch.int64, device=keys.device)[None, :]
    return _fmix32(lane ^ _fmix32(draw ^ _fmix32(seed ^ 0x9E3779B9)))


def _gumbel_from_keys(keys, V: int):
    """``[R, V]`` Gumbel noise from raw ``[R, 2]`` (seed, draw) keys: the
    top 24 hash bits become a strictly-interior uniform, then the
    double-log Gumbel transform."""
    h = _hash_bits(keys, V)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def make_keys(seed_draws, out=None):
    """Pack ``[(seed, draw_index), ...]`` into the raw ``[n, 2]`` u32 key
    array :func:`sample_tokens` consumes (host-side numpy helper)."""
    import numpy as np

    n = len(seed_draws)
    keys = np.zeros((n, 2), dtype=np.uint32) if out is None else out
    for i, (seed, draw) in enumerate(seed_draws):
        keys[i, 0] = np.uint32(seed & 0xFFFFFFFF)
        keys[i, 1] = np.uint32(draw & 0xFFFFFFFF)
    return keys


def sample_tokens(logits, temps, top_ks, top_ps, keys):
    """Sample one token per row.

    Args:
      logits: ``[R, V]`` float (upcast to f32).
      temps:  ``[R]`` f32 — ``<= 0`` means greedy (pure argmax).
      top_ks: ``[R]`` int — ``<= 0`` means no top-k filter.
      top_ps: ``[R]`` f32 — nucleus mass in ``(0, 1]``; ``1.0`` = off.
      keys:   ``[R, 2]`` integer — raw ``(seed, draw_index)`` u32 values.

    Returns:
      ``[R]`` int32 token ids.
    """
    x32 = logits.to(torch.float32)
    V = x32.shape[-1]
    greedy = torch.argmax(x32, dim=-1).to(torch.int32)

    x = x32 / torch.clamp(temps[:, None].to(torch.float32), min=1e-6)

    # top-k: mask everything below the k-th largest scaled logit (k == V
    # when the filter is off, a no-op then)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    top_ks = top_ks.to(torch.int64)
    k_eff = torch.where(top_ks <= 0, torch.full_like(top_ks, V),
                        torch.clamp(top_ks, max=V))
    kth = torch.gather(sorted_desc, -1, (k_eff - 1)[:, None])
    neg = torch.full_like(x, _NEG)
    x = torch.where(x < kth, neg, x)

    # top-p over the top-k-filtered distribution, on the one sort above;
    # unnormalized mass against the actual total keeps top_p == 1.0 from
    # collapsing to greedy under rounding
    sorted_masked = torch.where(sorted_desc < kth, neg, sorted_desc)
    e = torch.exp(sorted_masked - sorted_masked[:, 0:1])
    csum = torch.cumsum(e, dim=-1)
    over = csum >= top_ps[:, None].to(torch.float32) * csum[:, -1:]
    cut = torch.argmax(over.to(torch.int8), dim=-1)
    # cut back in logit space, so the cut token itself is never masked
    pth = torch.gather(sorted_masked, -1, cut[:, None])
    x = torch.where(x < pth, neg, x)

    g = _gumbel_from_keys(keys, V)
    sampled = torch.argmax(x + g, dim=-1).to(torch.int32)
    return torch.where(temps <= 0.0, greedy, sampled)
