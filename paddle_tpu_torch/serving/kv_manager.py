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
    subclass adds decode-slot reservation (``append_slot``/``commit``), the
    decode-burst headroom (``burst_capacity``) and rollback (``truncate``),
    and the occupancy gauge.  With ``enable_prefix_cache=True`` (the serving
    default) capacity planning uses :attr:`num_available` (free +
    evictable-cached), not ``num_free``."""

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True):
        super().__init__(num_blocks, block_size,
                         enable_prefix_cache=enable_prefix_cache)
        # the ``pool_exhaust`` fault-injection point: while True the pool
        # reports no available block; the engine arms it for ONE
        # scheduler-planning pass, so the refusal surfaces as a
        # preemption or a deferred admission, never as a failed launch
        self.refuse_allocations = False

    @property
    def num_available(self) -> int:
        if self.refuse_allocations:
            return 0
        return super().num_available

    def occupancy(self) -> float:
        """Fraction of the usable pool currently held by sequences
        (reuse-LRU blocks count as free capacity)."""
        usable = self.num_blocks - 1
        return (usable - self.num_available) / usable if usable else 0.0

    def burst_capacity(self, rows: int) -> int:
        """Largest per-row decode-burst length N the pool can promise
        ``rows`` concurrent decode rows.  Called AFTER the scheduler
        reserved each row's next-token slot, so a row needs at most
        ``ceil((N - 1) / block_size)`` more blocks for N burst tokens, even
        on the worst block boundary; giving each row
        ``num_available // rows`` whole blocks supports
        ``(num_available // rows) * block_size + 1`` tokens.  The ONE
        headroom accessor: the scheduler's plan and the engine's launch
        clamp both read it."""
        if rows <= 0:
            return 0
        return (self.num_available // rows) * self.block_size + 1

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

    def truncate(self, seq_id, new_len: int) -> int:
        """Roll the sequence back to ``new_len`` committed tokens and hand
        surplus tail blocks back (a burst's unused pre-allocated tail, a
        rejected speculative draft's slots).  A tail block whose refcount
        reaches 0 goes to the free list (its content is never cacheable
        prefix) and loses any chain-hash registration, so the prefix cache
        never names a rolled-back page; a shared one only loses this
        owner.  Stale K/V past ``new_len`` in the kept tail block is never
        attended (``lens`` routing) and the next slot overwrites it.
        Returns the number of blocks freed."""
        cur = self._lens.get(seq_id, 0)
        if new_len > cur:
            raise ValueError(
                f"truncate({seq_id!r}, {new_len}) extends past the "
                f"committed length {cur}")
        table = self._tables.get(seq_id)
        freed = 0
        if table is not None:
            keep = self.blocks_for(new_len)
            while len(table) > keep:
                b = table.pop()
                n = self._ref.get(b, 1) - 1
                if n > 0:
                    self._ref[b] = n
                    continue
                self._ref.pop(b, None)
                self._drop_hash(b)
                self._free.append(b)
                freed += 1
        self._lens[seq_id] = new_len
        return freed

    def table(self, seq_id) -> List[int]:
        return self._tables.get(seq_id, [])

    def seq_len(self, seq_id) -> int:
        return self._lens.get(seq_id, 0)

    def has(self, seq_id) -> bool:
        return seq_id in self._tables

    def num_owned_blocks(self, seq_id) -> int:
        return len(self._tables.get(seq_id, ()))
