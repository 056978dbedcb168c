"""Paged (block) KV-cache for serving: the bookkeeping and the legacy
attention paths.

The PyTorch counterpart of ``paddle_tpu/ops/paged_attention.py``: the KV
cache lives in fixed-size blocks indexed per sequence through a block
table, so sequences share one block pool with no per-request contiguous
allocation.

* :class:`BlockPool` — refcounted free list, prefix-chain hashes and the
  reuse LRU of the prefix cache (no device tensors).
* :func:`prefix_chain_hashes` / :func:`_hash_block` — byte-identical to the
  JAX package's chain: affinity routing and KV hand-off key on these
  digests, so a pool of either package recognises the other's prefixes.
* :class:`PagedCache` — one layer's view of the shared pools plus the
  per-step routing tensors the model's attention reads.
* :func:`paged_attention` — decode-step attention: the CUDA kernel of
  ``ops/paged_decode.py`` on the card, :func:`_xla_paged_attention` (the
  plain version, the JAX package's ``decode_oracle``) on the CPU or when
  pinned.
* :func:`paged_prefill_attention` — chunked-prefill attention over the
  pools, plain PyTorch on every device (XLA code in the JAX package).
* :data:`KV_POOL_SPEC`, :func:`kv_pool_shape`, :func:`shard_kv_pool` — the
  head-sharded layout of tensor-parallel serving: at mp > 1 each rank's
  pools hold its ``Hkv / mp`` KV heads, and every attention path above
  takes a rank's local head counts as they are.

The block-transfer methods (:meth:`BlockPool.export_blocks`,
:meth:`~BlockPool.export_chain`, :meth:`~BlockPool.import_blocks`) carry the
chain-hash records of a KV hand-off (``serving/handoff.py``).
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

# Which path the most recent paged_attention dispatch took:
# "cuda" | "reference".
last_path: Optional[str] = None


class PoolExhausted(RuntimeError):
    """The shared KV block pool has no free block for the request.

    A *typed* RuntimeError so serving layers can catch it and degrade
    gracefully (preempt + recompute, ``serving/kv_manager.py``) instead of
    failing the request."""


#: Root of every block-hash chain (the hash of the empty prefix).  The
#: same constant as the JAX package's, so the two chains agree byte for
#: byte.  SHA-256, not builtin ``hash()``: cached blocks are content-
#: addressed across tenants, so a collision would serve one prompt's KV to
#: another.
_HASH_ROOT = hashlib.sha256(b"paddle_tpu.prefix_cache.v1").digest()


def _hash_block(parent: bytes, block_tokens) -> bytes:
    m = hashlib.sha256(parent)
    m.update(b"".join(int(t).to_bytes(8, "little", signed=True)
                      for t in block_tokens))
    return m.digest()


def prefix_chain_hashes(token_ids, block_size: int,
                        max_blocks: Optional[int] = None) -> List[bytes]:
    """Chain hashes of the leading FULL blocks of ``token_ids`` —
    ``out[i]`` commits to every token in blocks ``0..i``
    (``h_i = sha256(h_{i-1} || block_tokens_i)``, the chain the prefix
    cache registers)."""
    n = len(token_ids) // block_size
    if max_blocks is not None:
        n = min(n, max_blocks)
    out: List[bytes] = []
    h = _HASH_ROOT
    for i in range(n):
        h = _hash_block(h, token_ids[i * block_size:(i + 1) * block_size])
        out.append(h)
    return out


class BlockPool:
    """Refcounted block-pool bookkeeping (no device tensors).  Block 0 is
    the reserved null page that padding rows of a bucketed batch write
    into.

    **Prefix caching** (``enable_prefix_cache=True``): a FULL block whose
    content is the KV of a known token chain carries a chain hash
    registered via :meth:`record_block_hashes`.  When its last owner frees
    it, the block parks in a reuse LRU instead of the free list — content
    intact, revivable by :meth:`fork_prefix` at zero recompute cost — and
    is evicted (clobbered) only when an allocation cannot be covered by
    the free list alone.  Every hash/LRU structure holds at most
    ``num_blocks`` entries.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = False):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the null page)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_cache_enabled = enable_prefix_cache
        self._free: list = list(range(num_blocks - 1, 0, -1))
        self._ref: dict = {}     # block -> owner count (shared prefixes)
        self._tables: dict = {}  # seq_id -> list[int]
        self._lens: dict = {}    # seq_id -> int
        self._block_hash: dict = {}   # block -> chain hash (≤ num_blocks)
        self._hash_index: dict = {}   # chain hash -> block (≤ num_blocks)
        self._chain_state: dict = {}  # seq -> (blocks_hashed, last_hash),
        # so per-chunk re-registration hashes only NEW blocks
        self.cache_epoch = 0  # bumped whenever _hash_index changes, so
                              # callers may memoize match_prefix results
        self._reuse: "OrderedDict" = OrderedDict()  # refcount-0 cached
        # blocks in LRU order (≤ num_blocks)
        self.reuse_evictions = 0  # cached blocks clobbered for allocation
        self.reuse_hits = 0       # blocks served from the prefix cache
        # host-side hook, fired on the mutating thread; an exception in it
        # is swallowed so telemetry never tears the bookkeeping
        self.on_evict = None   # fn(block, chain_depth, lifetime_steps, cause)
        self.on_revive = None  # fn(block, chain_depth, lru_depth, lifetime_steps)
        self.clock = 0         # caller-advanced step clock
        self._block_depth: dict = {}  # block -> chain depth (≤ num_blocks)
        self._park_step: dict = {}    # block -> clock at park (≤ num_blocks)
        self._block_parent: dict = {}  # block -> parent chain hash
                                       # (≤ num_blocks), for chain_lead
        # block -> the tokens its chain hash committed to (≤ num_blocks):
        # what export_blocks ships so a recipient pool re-verifies the
        # chain from the root before admitting foreign KV
        self._block_tokens: dict = {}

    @property
    def num_free(self) -> int:
        """Blocks on the free list alone (with a warm prefix cache,
        ``num_free < num_available``)."""
        return len(self._free)

    @property
    def num_available(self) -> int:
        """Blocks an allocation can take: free list + evictable reuse LRU."""
        return len(self._free) + len(self._reuse)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def blocks_needed(self, seq_id, num_tokens: int) -> int:
        cur = self._lens.get(seq_id, 0)
        held = len(self._tables.get(seq_id, ()))
        return max(0, self.blocks_for(cur + num_tokens) - held)

    def _take_block(self, cause: str = "other") -> int:
        """One block for a fresh allocation: free list first; then evict
        the LRU-oldest reusable cached block (its hash entries die with its
        content)."""
        if self._free:
            return self._free.pop()
        b, _ = self._reuse.popitem(last=False)
        depth = self._block_depth.get(b, 0)
        lifetime = self.clock - self._park_step.pop(b, self.clock)
        self._drop_hash(b)
        self.reuse_evictions += 1
        cb = self.on_evict
        if cb is not None:
            try:
                cb(b, depth, lifetime, cause)
            except Exception:
                pass  # telemetry must never tear the pool bookkeeping
        return b

    def _drop_hash(self, b: int) -> None:
        h = self._block_hash.pop(b, None)
        self._block_depth.pop(b, None)
        self._block_tokens.pop(b, None)
        self._block_parent.pop(b, None)
        if h is not None and self._hash_index.get(h) == b:
            del self._hash_index[h]
            self.cache_epoch += 1

    def allocate(self, seq_id, num_tokens: int,
                 cause: str = "other") -> bool:
        """All-or-nothing reservation of blocks for ``num_tokens`` more
        tokens; returns False (taking nothing) when the pool can't cover
        it."""
        need = self.blocks_needed(seq_id, num_tokens)
        if need > self.num_available:
            return False
        table = self._tables.setdefault(seq_id, [])
        for _ in range(need):
            b = self._take_block(cause)
            self._ref[b] = 1
            table.append(b)
        return True

    def fork(self, src_seq, dst_seq) -> int:
        """Share ``src_seq``'s FULL blocks with ``dst_seq`` (refcount++, no
        copy).  Returns the number of tokens ``dst_seq`` starts with."""
        if dst_seq in self._tables:
            raise ValueError(f"fork target seq {dst_seq!r} already exists")
        n_full = self._lens.get(src_seq, 0) // self.block_size
        shared = self._tables.get(src_seq, [])[:n_full]
        for b in shared:
            self._ref[b] = self._ref.get(b, 1) + 1
        self._tables[dst_seq] = list(shared)
        self._lens[dst_seq] = n_full * self.block_size
        return n_full * self.block_size

    def free(self, seq_id) -> int:
        """Release the sequence; returns how many blocks became available
        again.  With the prefix cache on, a hashed block parks in the
        reuse LRU instead of the free list; later-chain blocks of one
        sequence enter the eviction side first."""
        returned = 0
        for b in reversed(self._tables.pop(seq_id, [])):
            n = self._ref.get(b, 1) - 1
            if n > 0:
                self._ref[b] = n
                continue
            self._ref.pop(b, None)
            returned += 1
            if self.prefix_cache_enabled and b in self._block_hash:
                self._reuse[b] = self._block_hash[b]
                self._park_step[b] = self.clock
            else:
                self._free.append(b)
        self._lens.pop(seq_id, None)
        self._chain_state.pop(seq_id, None)
        return returned

    # --- prefix cache -------------------------------------------------------
    def match_prefix(self, token_ids,
                     precomputed: Optional[List[bytes]] = None) -> List[int]:
        """Blocks holding the longest cached block-prefix of ``token_ids``,
        capped so at least ONE token is always left to compute.
        ``precomputed`` carries leading chain hashes already computed over
        the same tokens, which are not hashed again."""
        if not self.prefix_cache_enabled or len(token_ids) < 2:
            return []
        limit = (len(token_ids) - 1) // self.block_size
        bs = self.block_size
        blocks, h = [], _HASH_ROOT
        for i in range(limit):
            if precomputed is not None and i < len(precomputed):
                h = precomputed[i]
            else:
                h = _hash_block(h, token_ids[i * bs:(i + 1) * bs])
            b = self._hash_index.get(h)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def reuse_count(self, blocks) -> int:
        """How many of ``blocks`` sit in the reuse LRU (refcount 0)."""
        return sum(1 for b in blocks if b in self._reuse)

    def fork_prefix(self, seq_id, token_ids,
                    blocks: Optional[List[int]] = None) -> int:
        """Start ``seq_id`` on the longest cached block-prefix of
        ``token_ids`` (live blocks gain an owner, reuse-LRU blocks are
        revived).  Returns the number of cached tokens it starts with."""
        if seq_id in self._tables:
            raise ValueError(f"fork target seq {seq_id!r} already exists")
        if blocks is None:
            blocks = self.match_prefix(token_ids)
        if blocks:
            self._chain_state[seq_id] = (
                len(blocks), self._block_hash[blocks[-1]])
        cb = self.on_revive
        # each parked block's LRU position before any revival reorders
        # them, counted from the eviction end (0 = the next allocation
        # would have clobbered it); walked only when a hook listens and a
        # revive is possible
        lru_order = ({b: i for i, b in enumerate(self._reuse)}
                     if cb is not None and blocks else None)
        for i, b in enumerate(blocks):
            if b in self._reuse:
                del self._reuse[b]
                self._ref[b] = 1
                lifetime = self.clock - self._park_step.pop(b, self.clock)
                if cb is not None:
                    try:
                        cb(b, self._block_depth.get(b, i + 1),
                           lru_order[b], lifetime)
                    except Exception:
                        pass  # telemetry must never tear the bookkeeping
            else:
                self._ref[b] = self._ref.get(b, 0) + 1
        self.reuse_hits += len(blocks)
        self._tables[seq_id] = list(blocks)
        self._lens[seq_id] = len(blocks) * self.block_size
        return len(blocks) * self.block_size

    def record_block_hashes(self, seq_id, token_ids,
                            num_tokens: Optional[int] = None) -> int:
        """Index ``seq_id``'s full blocks covered by the first
        ``num_tokens`` of ``token_ids`` (only tokens whose KV has been
        written).  Idempotent and incremental; the first block to claim a
        chain hash keeps it.  Returns how many new blocks were indexed."""
        if not self.prefix_cache_enabled:
            return 0
        table = self._tables.get(seq_id, [])
        upto = len(token_ids) if num_tokens is None else num_tokens
        n_full = min(upto // self.block_size, len(table))
        done, h = self._chain_state.get(seq_id, (0, _HASH_ROOT))
        if done > n_full:  # recompute path restarted shorter: re-walk
            done, h = 0, _HASH_ROOT
        bs = self.block_size
        added = 0
        for i in range(done, n_full):
            parent = h
            h = _hash_block(h, token_ids[i * bs:(i + 1) * bs])
            b = table[i]
            if b in self._block_hash or h in self._hash_index:
                continue
            self._block_hash[b] = h
            self._block_depth[b] = i + 1  # chain depth in blocks
            self._block_tokens[b] = tuple(
                int(t) for t in token_ids[i * bs:(i + 1) * bs])
            self._block_parent[b] = parent
            self._hash_index[h] = b
            added += 1
        self._chain_state[seq_id] = (n_full, h)
        if added:
            self.cache_epoch += 1
        return added

    def block_chain_hash(self, block: int) -> Optional[bytes]:
        """Chain hash registered for ``block`` (``None`` when unhashed):
        the prefix-heat table's key, since the deepest matched block's
        hash commits to the whole cached prefix."""
        return self._block_hash.get(block)

    def chain_lead(self, chain_hash: bytes) -> Optional[List[bytes]]:
        """Leading chain digests, root-first, of the indexed chain ending
        at ``chain_hash`` (what a router needs to place a cached prefix
        without its tokens); ``None`` when the chain is broken (an
        ancestor was evicted).  Pure read."""
        out: List[bytes] = []
        h = chain_hash
        while h != _HASH_ROOT:
            b = self._hash_index.get(h)
            if b is None:
                return None
            parent = self._block_parent.get(b)
            if parent is None:
                return None
            out.append(h)
            h = parent
        out.reverse()
        return out

    def block_chain_depth(self, block: int) -> int:
        """Chain depth (in blocks) ``block`` was registered at; 0 when
        unhashed."""
        return self._block_depth.get(block, 0)

    # --- block transfer -----------------------------------------------------
    def export_blocks(self, hashes) -> Optional[List[dict]]:
        """The pool-side records of the chain addressed by ``hashes``
        (leading chain digests, root-first, as :func:`prefix_chain_hashes`
        gives them): one ``{"hash", "depth", "tokens", "block"}`` per
        block, or ``None`` when any hash is unindexed (nothing to
        transfer).  Pure read: the caller gathers the pages at the
        returned ``block`` indices while the donor keeps serving."""
        records: List[dict] = []
        for h in hashes:
            b = self._hash_index.get(h)
            if b is None:
                return None
            tokens = self._block_tokens.get(b)
            if tokens is None:
                return None
            records.append({"hash": h, "depth": self._block_depth.get(b, 0),
                            "tokens": tokens, "block": b})
        return records

    def export_chain(self, chain_hash: bytes) -> Optional[List[dict]]:
        """:meth:`export_blocks` addressed by the DEEPEST chain digest
        alone (the prefix-heat table's key): the full leading chain,
        root-first, or ``None`` when it is broken (an ancestor was
        evicted)."""
        out: List[dict] = []
        h = chain_hash
        while h != _HASH_ROOT:
            b = self._hash_index.get(h)
            if b is None:
                return None
            tokens = self._block_tokens.get(b)
            parent = self._block_parent.get(b)
            if tokens is None or parent is None:
                return None
            out.append({"hash": h, "depth": self._block_depth.get(b, 0),
                        "tokens": tokens, "block": b})
            h = parent
        out.reverse()
        return out

    def import_blocks(self, records) -> Optional[Dict[bytes, int]]:
        """Admit a foreign block run (the :meth:`export_blocks` record
        shape, root-first) into this pool's prefix cache.  The chain is
        re-verified from the root over the shipped tokens before anything
        mutates: a digest mismatch raises ``ValueError`` and the pool is
        untouched.  All or nothing: ``None`` (no mutation) when the fresh
        blocks outnumber :attr:`num_available`; otherwise every fresh
        block is taken, registered and parked in the reuse LRU (refcount
        0, revivable by :meth:`fork_prefix` like a prefix computed here),
        and the ``{hash: block}`` placement map is returned for the
        caller to scatter the pages into.  Hashes already indexed are
        skipped.  Blocks move free -> reuse only, so
        ``free + reuse + allocated == num_blocks`` holds throughout."""
        if not self.prefix_cache_enabled:
            raise ValueError("import_blocks needs the prefix cache enabled")
        h = _HASH_ROOT
        parent_of: Dict[bytes, bytes] = {}
        for i, rec in enumerate(records):
            tokens = tuple(int(t) for t in rec["tokens"])
            if len(tokens) != self.block_size:
                raise ValueError(
                    f"imported block {i} carries {len(tokens)} tokens; "
                    f"this pool's block_size is {self.block_size}")
            parent = h
            h = _hash_block(h, tokens)
            if h != rec["hash"]:
                raise ValueError(
                    f"imported block {i} (depth {i + 1}) fails chain-hash "
                    "verification: content does not match its digest")
            parent_of[h] = parent
        fresh = [rec for rec in records
                 if rec["hash"] not in self._hash_index]
        if len(fresh) > self.num_available:
            return None
        placed: Dict[bytes, int] = {}
        taken = [self._take_block("kv_import") for _ in fresh]
        for b, rec in zip(taken, fresh):
            hh = rec["hash"]
            self._block_hash[b] = hh
            self._block_depth[b] = int(rec["depth"])
            self._block_tokens[b] = tuple(int(t) for t in rec["tokens"])
            self._block_parent[b] = parent_of[hh]
            self._hash_index[hh] = b
            self._reuse[b] = hh
            self._park_step[b] = self.clock
            placed[hh] = b
        if placed:
            self.cache_epoch += 1
        return placed


#: Dimension names of a ``[num_blocks, block_size, Hkv, D]`` KV pool under
#: tensor-parallel serving: sharded along the HEAD dim over ``mp``.  The one
#: source of the layout: :func:`kv_pool_shape` sizes a rank's pools and
#: :func:`shard_kv_pool` cuts a rank's slice out of a whole pool with it.
KV_POOL_SPEC = (None, None, "mp", None)
_POOL_SHARD_DIM = KV_POOL_SPEC.index("mp")


def kv_pool_shape(num_blocks: int, block_size: int, num_kv_heads: int,
                  head_dim: int, mp: int = 1) -> tuple:
    """The shape of one rank's pool at tensor-parallel degree ``mp``: its
    ``num_kv_heads / mp`` KV heads of every page.  Raises when ``mp`` does
    not divide the KV heads (the JAX ``shard_kv_pool`` leaves such a pool
    whole; the port's ranks hold slices only, so the engine validates
    divisibility before it allocates)."""
    if num_kv_heads % mp:
        raise ValueError(f"mp={mp} must divide num_key_value_heads="
                         f"{num_kv_heads} (the KV pools shard along the "
                         f"head dim)")
    shape = [num_blocks, block_size, num_kv_heads, head_dim]
    shape[_POOL_SHARD_DIM] //= mp
    return tuple(shape)


def shard_kv_pool(pool, rank: int, mp: int):
    """Rank ``rank``'s slice of a whole ``[num_blocks, block_size, Hkv, D]``
    pool at degree ``mp`` (the counterpart of the JAX ``shard_kv_pool``,
    which places the pool sharded over the mesh): its ``Hkv / mp`` heads,
    the layout of :func:`kv_pool_shape`."""
    kv_pool_shape(*pool.shape, mp=mp)      # validates divisibility
    part = pool.shape[_POOL_SHARD_DIM] // mp
    return pool.narrow(_POOL_SHARD_DIM, rank * part, part)


class PagedCache:
    """One layer's view of the shared block pools, handed to the model's
    attention as its ``cache``: the model writes this step's K/V into the
    slots and attends through the block tables.  ``k_pool``/``v_pool`` are
    the engine's ``[num_blocks, block_size, Hkv, D]`` tensors, written in
    place; the routing tensors are set by :meth:`route` before each step.

    The model tells the three routes apart as the JAX model does:
    ``seg_ids`` set → the unified ragged step; ``[B, S]`` slot arrays → a
    chunked prefill; ``[B]`` slot arrays → a decode step."""

    def __init__(self, k_pool: torch.Tensor, v_pool: torch.Tensor):
        self.k_pool = k_pool
        self.v_pool = v_pool
        self.block_tables = None   # [R, W] int32
        self.seq_lens = None       # [R] int32 (AFTER this step's tokens)
        self.slot_blocks = None    # int64 page of each new token: [B]
                                   # (decode), [B, S] (chunk) or [T] (ragged)
        self.slot_offsets = None   # int64 offset within the page, same shape
        self.q_start = None        # int32: the chunk's first position (a
                                   # scalar or [B]) — or, on the ragged
                                   # route, [T] positions of every token
        self.seg_ids = None        # [T] int32 row index of each packed
                                   # token; non-None routes the model's
                                   # attention through ops/ragged_paged.py
        self.use_pallas = None     # kernel routing: None/True = the CUDA
                                   # kernel on a CUDA tensor, False = the
                                   # plain version

    def route(self, block_tables, seq_lens, slot_blocks, slot_offsets,
              q_start=None, seg_ids=None):
        dev = self.k_pool.device

        def put(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=dev)

        self.block_tables = put(block_tables, torch.int32)
        self.seq_lens = put(seq_lens, torch.int32)
        # the scatter indexes with these, so they are int64
        self.slot_blocks = put(slot_blocks, torch.int64)
        self.slot_offsets = put(slot_offsets, torch.int64)
        if q_start is not None:
            self.q_start = put(q_start, torch.int32)
        if seg_ids is not None:
            self.seg_ids = put(seg_ids, torch.int32)


def _xla_paged_attention(q, k_cache, v_cache, block_tables, seq_lens):
    """Decode attention by gather (the JAX package's ``_xla_paged_attention``,
    which it exports as ``decode_oracle``): each row's pages gathered to a
    padded ``[B, W * bs, Hkv, D]`` context, a grouped einsum (KV heads never
    repeated), columns ``>= seq_lens`` masked.  Computes in fp32 and returns
    q's dtype.  The plain version of the CUDA decode kernel."""
    B, H, D = q.shape
    W = block_tables.shape[1]
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)

    bt = block_tables.long()
    k = k_cache[bt].reshape(B, W * bs, Hkv, D)
    v = v_cache[bt].reshape(B, W * bs, Hkv, D)

    qg = q.reshape(B, Hkv, rep, D)
    logits = torch.einsum("bhrd,bshd->bhrs", qg.float(), k.float()) * scale
    col = torch.arange(W * bs, device=q.device)
    mask = col[None, :] < seq_lens.long()[:, None]            # [B, S]
    logits.masked_fill_(~mask[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrs,bshd->bhrd", probs, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_prefill_attention(q, k_cache, v_cache, block_tables, seq_lens,
                            q_start):
    """Chunked-prefill attention over the paged pools (plain PyTorch on
    every device, as it was XLA code in the JAX package).

    ``q``: ``[B, S, H, D]`` — ``S`` new tokens per row at positions
    ``q_start + [0, S)`` (``q_start`` a scalar or ``[B]``).  The chunk's own
    K/V is already in the pools, so the causal mask ``col <= q_start + row``
    covers the earlier prefix and the chunk with one predicate;
    ``seq_lens`` (the KV length after the chunk) keeps pad rows off
    garbage pages.  Scores in fp32; the probabilities are cast to the
    pools' dtype for the product with V, as the JAX version does.  Returns
    ``[B, S, H, D]`` in q's dtype."""
    B, S, H, D = q.shape
    W = block_tables.shape[1]
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(D)

    bt = block_tables.long()
    k = k_cache[bt].reshape(B, W * bs, Hkv, D)
    v = v_cache[bt].reshape(B, W * bs, Hkv, D)

    qg = q.reshape(B, S, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * scale
    col = torch.arange(W * bs, device=q.device)[None, None, :]
    starts = torch.as_tensor(q_start, device=q.device).long()
    if starts.dim() == 1:                     # per-row chunk starts
        starts = starts[:, None, None]
    row = starts + torch.arange(S, device=q.device)[None, :, None]
    mask = (col <= row) & (col < seq_lens.long()[:, None, None])  # [B, S, K]
    logits.masked_fill_(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, D).to(q.dtype)


def paged_attention(q, k_cache, v_cache, block_tables, seq_lens,
                    use_pallas: Optional[bool] = None):
    """Decode-step attention over the paged pools: ``q`` ``[B, H, D]`` (one
    new token per row), ``block_tables`` ``[B, W]`` int32, ``seq_lens``
    ``[B]`` int32; returns ``[B, H, D]``.

    On a CUDA tensor it launches the CUDA decode kernel
    (``ops/paged_decode.py``) — or raises: there is no fallback and no
    tileability rule — and ``use_pallas=False`` pins
    :func:`_xla_paged_attention`.  On a CPU tensor the plain version runs
    and ``use_pallas=True`` raises.  ``last_path`` records the choice."""
    global last_path
    from . import paged_decode

    out = paged_decode.paged_attention_decode(
        q, k_cache, v_cache, block_tables, seq_lens, use_pallas=use_pallas)
    last_path = paged_decode.last_path
    return out
