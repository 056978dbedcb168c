"""Paged KV-cache manager for the serving engine (the port of
``paddle_tpu/serving/kv_manager.py``).

Owns the *bookkeeping* of the shared block pool — block tables, sequence
lengths, reference counts — while the pool tensors themselves (one
``[num_blocks, block_size, Hkv, D]`` pair per layer) live on the engine.
A ragged batch of sequences at different lengths indexes one block pool
through per-sequence tables, so admission/eviction never reshapes a
tensor.

Exhaustion is a *scheduling event*, not an error: allocation never
partially succeeds, and the engine preempts the lowest-priority running
request (freeing its blocks for recompute later) instead of failing
anyone.  Block 0 is the reserved null page that padding tokens write into.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..ops.paged_attention import (  # noqa: F401  (PoolExhausted re-export)
    BlockPool,
    PoolExhausted,
)


class KVCacheManager(BlockPool):
    """Refcounted block-pool bookkeeping shared by all layers: every
    layer's pools use the same block index for a given (sequence,
    position), so one routing array drives the whole decoder stack.  This
    subclass adds decode-slot reservation (``append_slot``/``commit``) and
    the occupancy gauge.  With ``enable_prefix_cache=True`` (the serving
    default) capacity planning uses :attr:`num_available` (free +
    evictable-cached), not ``num_free``."""

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True):
        super().__init__(num_blocks, block_size,
                         enable_prefix_cache=enable_prefix_cache)

    def occupancy(self) -> float:
        """Fraction of the usable pool currently held by sequences
        (reuse-LRU blocks count as free capacity)."""
        usable = self.num_blocks - 1
        return (usable - self.num_available) / usable if usable else 0.0

    def append_slot(self, seq_id) -> Optional[Tuple[int, int]]:
        """(block, offset) slot for the sequence's NEXT token, allocating a
        fresh block on a boundary.  ``None`` on exhaustion — the caller
        preempts and retries.  ``commit`` advances the length after the
        model step wrote the slot."""
        if not self.allocate(seq_id, 1, cause="decode_slot"):
            return None
        pos = self._lens.get(seq_id, 0)
        table = self._tables[seq_id]
        return table[pos // self.block_size], pos % self.block_size

    def commit(self, seq_id, num_tokens: int = 1):
        self._lens[seq_id] = self._lens.get(seq_id, 0) + num_tokens

    def table(self, seq_id) -> List[int]:
        return self._tables.get(seq_id, [])

    def seq_len(self, seq_id) -> int:
        return self._lens.get(seq_id, 0)

    def num_owned_blocks(self, seq_id) -> int:
        return len(self._tables.get(seq_id, ()))
