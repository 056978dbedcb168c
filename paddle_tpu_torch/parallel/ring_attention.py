"""Ring attention entry of the no-cache Llama forward: the port of
``paddle_tpu/parallel/ring_attention.py::ring_flash_attention`` at sep=1.

With the sequence unsharded (sep=1, the only degree the port runs) the JAX
function falls through to ``ops/flash_attention.flash_attention_fwd``, and
so does this one.  The ring itself — K/V blocks passed around a ``sep``
mesh axis with an online-softmax merge — comes with ROADMAP A11.
"""

from __future__ import annotations

from typing import Optional

from ..core.dispatch import run_op
from ..ops.flash_attention import flash_attention_fwd


def ring_flash_attention(q, k, v, causal: bool = True,
                         use_pallas: Optional[bool] = None, sep: int = 1):
    """Attention over global ``[B, S, H, D]`` q and ``[B, S, Hkv, D]`` k/v
    with the sequence sharded over ``sep`` ranks; at ``sep == 1`` it is
    :func:`flash_attention_fwd`, as the op ``ring_attention_fallback``."""
    if sep != 1:
        raise NotImplementedError(
            f"ring attention over sep={sep} sequence shards is not ported "
            f"yet (ROADMAP A11); the port runs sep=1")
    return run_op("ring_attention_fallback", flash_attention_fwd, q, k, v,
                  causal=causal, use_pallas=use_pallas)
