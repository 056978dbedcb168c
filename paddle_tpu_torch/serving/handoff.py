"""Prefill/decode KV-cache hand-off (the port of
``paddle_tpu/serving/handoff.py``).

The block transfer between two replicas' pools: a **KV run** is the
serialized form of a leading block chain — the chain-hash records of
:meth:`~paddle_tpu_torch.ops.paged_attention.BlockPool.export_blocks` /
``export_chain`` plus the gathered pages of those blocks and a SHA-256
digest over them.  A donor builds a run with :func:`export_request_run`
(a migrating request's computed prompt KV) or :func:`export_prefix_run`
(a hot cached prefix); the recipient admits it with :func:`import_run`,
which

* re-checks the pool compatibility header (block size, layer count, KV
  heads, head dim, dtype) — a mismatch raises :class:`HandoffError`;
* re-verifies the payload digest — corruption raises
  :class:`HandoffError` before anything mutates;
* hands the block records to ``BlockPool.import_blocks`` (which
  re-verifies the token chain from the hash root and either places every
  fresh block atomically or refuses with ``None``), then scatters the
  pages into exactly the freshly placed blocks.

**The pools are written in place** (``index_copy_``): the engine's
captured step graphs hold the storages of the pools allocated at build,
so a rebound pool would leave every replayed step reading the old pages.
Nothing here runs inside a step program: a hand-off adds no capture and
no bucket.

**The payload on the host** is a numpy array ``[2, layers, blocks,
block_size, kv_heads, head_dim]``.  numpy has no bfloat16, so bf16 pages
travel as their raw 16-bit words (``uint16``) and are viewed back bit for
bit on the way in; the header's ``dtype`` is written as the JAX package
writes it (``"bfloat16"``, ``"float32"``) and the digest covers the same
bytes, so a run of either package imports into the other.

Cross-process, the same run ships as ``wire.py`` block-stream frames
(``kv_run_begin`` + chunked base64 ``kv_run_chunk``), converted by
:func:`run_to_frames` / :func:`run_from_frames`.  Given a ``timings``
dict, :func:`export_request_run` and :func:`import_run` record the wall
seconds of each part there (the device synchronised after each), which a
worker process reports on its hand-off frames.

**At mp > 1** the run is the same global, unsharded run (the JAX
package's: donor and recipient need not share a mesh layout).  The
controller gathers each rank's head slice of the listed blocks over the
replica's control channel (``serving/tp.py``) and joins them along the
head axis before the digest; an import verifies the header and the digest
first, places the blocks on the controller's pool, then scatters each
rank's head slice into that rank's pools.  So a run exported at mp=2
imports into an mp=1 engine and the other way round.  The timings then
also hold ``ranks_s``: the export's collection across the ranks, the
import's scatter across them.

A refused or failed import never loses a request: the fleet falls back to
re-prefill on the recipient (the prompt tokens always travel with the
request), so the hand-off is an optimisation layer.
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import wire

HANDOFF_VERSION = 1

# metric names this module owns; registered by the fleet router via
# register_handoff_metrics
METRIC_NAMES = (
    "serving_handoff_total",
    "serving_handoff_seconds",
    "serving_handoff_blocks",
)

_SECONDS_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5)
_BLOCKS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

# header dtype name -> (torch dtype, the numpy type carrying its bits)
_DTYPES = {
    "float32": (torch.float32, np.float32),
    "float16": (torch.float16, np.float16),
    "bfloat16": (torch.bfloat16, np.uint16),
}


class HandoffError(RuntimeError):
    """A KV run that cannot be admitted: deployment-shape mismatch,
    digest/content verification failure, or a malformed run.  Typed so
    the fleet answers with a typed error and falls back to recompute
    instead of dying."""


def register_handoff_metrics(registry, labels: Optional[Dict] = None):
    """Pre-register the ``serving_handoff_*`` family on ``registry`` and
    return ``{"total", "seconds", "blocks"}`` handles (the router bumps
    them per completed hand-off)."""
    labels = dict(labels or {})
    return {
        "total": registry.counter(
            "serving_handoff_total",
            "completed prefill→decode KV hand-offs (role-aware fleet "
            "migrations at the first-token boundary)", **labels),
        "seconds": registry.histogram(
            "serving_handoff_seconds",
            "end-to-end hand-off duration: export + transfer + verified "
            "import", buckets=_SECONDS_BUCKETS, **labels),
        "blocks": registry.histogram(
            "serving_handoff_blocks",
            "KV blocks shipped per hand-off", buckets=_BLOCKS_BUCKETS,
            **labels),
    }


def dtype_name(dtype: torch.dtype) -> str:
    """A pool dtype's header name (numpy's spelling, as the JAX package
    writes it)."""
    for name, (td, _) in _DTYPES.items():
        if td == dtype:
            return name
    raise HandoffError(f"no KV hand-off encoding for pool dtype {dtype}")


# --- the parts of a run (each timed on its own by chip_smoke.py) ------------
def pool_meta(engine) -> Dict:
    """The pool-compatibility header both ends must agree on before any
    page content moves."""
    cfg = engine.model.config
    return {
        "version": HANDOFF_VERSION,
        "block_size": int(engine.block_size),
        "layers": int(cfg.num_hidden_layers),
        "kv_heads": int(cfg.num_key_value_heads),
        "head_dim": int(cfg.head_dim),
        "dtype": dtype_name(engine._pool_dtype),
    }


def gather_pages(engine, blocks: List[int]) -> torch.Tensor:
    """This rank's pages of ``blocks``, every layer's K then V, as one
    device tensor ``[2, layers, len(blocks), block_size, kv_heads/mp,
    head_dim]``.  Pure read of the pools."""
    idx = torch.as_tensor(blocks, dtype=torch.long, device=engine.device)
    return torch.stack([
        torch.stack([p.index_select(0, idx) for p in pools])
        for pools in (engine._k_pools, engine._v_pools)])


def rank_pages(engine, blocks: List[int]) -> torch.Tensor:
    """This rank's pages of ``blocks`` on the host (a follower's share of
    an export at mp > 1)."""
    return gather_pages(engine, blocks).cpu()


def rank_pages_like(engine, n: int) -> torch.Tensor:
    """An empty host tensor shaped as this rank's pages of ``n`` blocks."""
    k = engine._k_pools[0]
    return torch.empty((2, len(engine._k_pools), n) + tuple(k.shape[1:]),
                       dtype=k.dtype)


def host_array(pages: torch.Tensor) -> np.ndarray:
    """Host pages as a contiguous numpy array (bf16 as its raw 16-bit
    words)."""
    if pages.dtype == torch.bfloat16:
        return np.ascontiguousarray(pages.view(torch.int16).numpy()
                                    .view(np.uint16))
    return np.ascontiguousarray(pages.numpy())


def host_tensor(pages: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Host ``pages`` (bf16 as its 16-bit words) as a tensor of ``dtype``,
    bit for bit: the inverse of :func:`host_array`."""
    pages = np.ascontiguousarray(pages)
    if dtype == torch.bfloat16:
        return torch.from_numpy(pages.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(pages)


def pages_to_host(pages: torch.Tensor) -> np.ndarray:
    """Copy gathered pages to a contiguous host array (bf16 as its raw
    16-bit words)."""
    return host_array(pages.cpu())


def payload_digest(payload: np.ndarray) -> bytes:
    return hashlib.sha256(np.ascontiguousarray(payload).tobytes()).digest()


def _carrier(payload, dtype: str) -> np.ndarray:
    """``payload`` as the numpy type that carries ``dtype``'s bits (a JAX
    run's bf16 array is viewed as uint16, bit for bit)."""
    payload = np.asarray(payload)
    want = np.dtype(_DTYPES[dtype][1])
    if payload.dtype == want:
        return payload
    if payload.dtype.itemsize == want.itemsize and dtype == "bfloat16":
        return payload.view(want)
    raise HandoffError(
        f"kv run payload of dtype {payload.dtype} for a {dtype} pool")


def write_pages(engine, dst: List[int], pages: torch.Tensor) -> None:
    """Write this rank's ``pages`` ``[2, layers, len(dst), ...]`` (a host
    tensor of the pool dtype) into blocks ``dst`` of every layer's pools,
    in place."""
    t = pages.to(engine.device)
    idx = torch.as_tensor(dst, dtype=torch.long, device=engine.device)
    for kv, pools in enumerate((engine._k_pools, engine._v_pools)):
        for layer, p in enumerate(pools):
            p.index_copy_(0, idx, t[kv, layer])


def scatter_pages(engine, dst: List[int], pages: np.ndarray,
                  timings: Optional[Dict] = None) -> None:
    """Write host ``pages`` ``[2, layers, len(dst), ...]`` (every KV head)
    into blocks ``dst`` of every layer's pools, in place; at mp > 1 each
    follower rank receives and writes its head slice."""
    t = time.perf_counter()
    slices = host_tensor(pages, engine._pool_dtype)
    if engine.tp is not None:
        slices = engine.tp.scatter_pages(dst, slices)
        t = _lap(timings, "ranks_s", t)
    write_pages(engine, dst, slices)
    _lap(timings, "scatter_s", t, engine.device)


def _lap(timings: Optional[Dict], name: str, t0: float, device=None
         ) -> float:
    """Record the wall seconds since ``t0`` under ``name`` in
    ``timings`` (after ``device``'s queued work, so each part's device
    time lands in that part) and return the new start; no-op without
    ``timings``."""
    if timings is None:
        return t0
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    now = time.perf_counter()
    timings[name] = now - t0
    return now


# --- run construction (donor side) ------------------------------------------
def build_run(engine, records: List[dict],
              timings: Optional[Dict] = None) -> Dict:
    """Gather the pages of ``records`` (the ``BlockPool.export_blocks``
    record shape) into one serialized run, every KV head's (at mp > 1 the
    follower ranks send theirs).  Pure read on the donor."""
    t = time.perf_counter()
    blocks = [r["block"] for r in records]
    pages = gather_pages(engine, blocks)
    t = _lap(timings, "gather_s", t, engine.device)
    pages = pages.cpu()
    t = _lap(timings, "device_to_host_s", t)
    if engine.tp is not None:
        # every rank's head slice, joined on the controller
        pages = engine.tp.gather_pages(blocks, pages)
        t = _lap(timings, "ranks_s", t)
    payload = host_array(pages)
    run = pool_meta(engine)
    run["blocks"] = [{"hash": r["hash"], "depth": int(r["depth"]),
                      "tokens": tuple(int(t) for t in r["tokens"])}
                     for r in records]
    run["payload"] = payload
    run["digest"] = payload_digest(payload)
    run["tokens_total"] = len(records) * engine.block_size
    _lap(timings, "digest_s", t)
    return run


def export_request_run(engine, request_id,
                       timings: Optional[Dict] = None) -> Optional[Dict]:
    """Serialize the hashed leading blocks of ``request_id``'s KV (the
    computed prompt prefix a decode specialist resumes from); ``None``
    when nothing is transferable (no table, nothing hashed yet)."""
    kv = engine.kv
    if not kv.has(request_id):
        return None
    hashes = []
    for b in kv.table(request_id):
        h = kv.block_chain_hash(b)
        if h is None:
            break
        hashes.append(h)
    if not hashes:
        return None
    records = kv.export_blocks(hashes)
    if not records:
        return None
    return build_run(engine, records, timings)


def export_prefix_run(engine, chain_hash: bytes,
                      max_blocks: Optional[int] = None) -> Optional[Dict]:
    """Serialize the full leading chain addressed by its DEEPEST digest
    (the prefix-heat table's key).  ``max_blocks`` bounds the run (the
    leading blocks win).  ``None`` when the chain is broken."""
    records = engine.kv.export_chain(chain_hash)
    if not records:
        return None
    if max_blocks is not None and len(records) > max_blocks:
        records = records[:max_blocks]
    return build_run(engine, records)


# --- run admission (recipient side) -----------------------------------------
def check_header(engine, run: Dict) -> Dict:
    """Verify a run's version and compatibility header against
    ``engine``'s pool (:class:`HandoffError` on a mismatch); returns the
    pool's header."""
    meta = pool_meta(engine)
    if int(run.get("version", -1)) != HANDOFF_VERSION:
        raise HandoffError(
            f"kv run version {run.get('version')!r}, this engine speaks "
            f"{HANDOFF_VERSION}")
    for key in ("block_size", "layers", "kv_heads", "head_dim", "dtype"):
        if run.get(key) != meta[key]:
            raise HandoffError(
                f"kv run {key}={run.get(key)!r} does not match this "
                f"pool's {key}={meta[key]!r} — donor and recipient must "
                "share one deployment shape")
    return meta


def check_payload(run: Dict, meta: Dict) -> np.ndarray:
    """Verify a run's payload digest and shape (:class:`HandoffError`,
    nothing mutated); returns the payload in its carrier type."""
    payload = _carrier(run["payload"], meta["dtype"])
    if payload_digest(payload) != run.get("digest"):
        raise HandoffError(
            "kv run payload fails SHA-256 digest verification — "
            "refusing corrupted content")
    expect = (2, meta["layers"], len(run["blocks"]), meta["block_size"],
              meta["kv_heads"], meta["head_dim"])
    if tuple(payload.shape) != expect:
        raise HandoffError(
            f"kv run payload shape {tuple(payload.shape)} does not "
            f"match its block records (expected {expect})")
    return payload


def import_run(engine, run: Dict,
               timings: Optional[Dict] = None) -> Optional[int]:
    """Admit a KV run into ``engine``'s pool: verify the header and the
    payload (:class:`HandoffError` on any mismatch — the pool is
    untouched), place the fresh blocks atomically through
    ``BlockPool.import_blocks``, then scatter their pages into the pools
    in place (at mp > 1 each rank's head slice into its pools).  Returns
    the number of freshly placed blocks (0 = everything was already
    cached here), or ``None`` on a capacity refusal — the caller
    re-prefills."""
    t = time.perf_counter()
    meta = check_header(engine, run)
    records = run.get("blocks") or []
    if not records:
        return 0
    payload = check_payload(run, meta)
    t = _lap(timings, "verify_s", t)
    try:
        placed = engine.kv.import_blocks(records)
    except ValueError as e:
        raise HandoffError(f"kv run rejected by the pool: {e}") from e
    _lap(timings, "import_s", t)
    if placed is None:
        return None
    if not placed:
        return 0
    src = [i for i, r in enumerate(records) if r["hash"] in placed]
    scatter_pages(engine, [placed[records[i]["hash"]] for i in src],
                  payload[:, :, src], timings)
    return len(placed)


# --- wire form ---------------------------------------------------------------
def run_to_frames(run: Dict) -> List[Dict]:
    """A run's ``wire.py`` block-stream frames: ``kv_run_begin`` plus
    chunked ``kv_run_chunk`` frames, each under ``MAX_FRAME_BYTES``."""
    payload = np.ascontiguousarray(np.asarray(run["payload"]))
    meta = {k: run[k] for k in ("version", "block_size", "layers",
                                "kv_heads", "head_dim", "dtype",
                                "tokens_total")}
    meta["shape"] = [int(s) for s in payload.shape]
    blocks = [[r["hash"].hex(), int(r["depth"]),
               [int(t) for t in r["tokens"]]] for r in run["blocks"]]
    return wire.kv_run_frames(meta, blocks, payload.tobytes(),
                              run["digest"].hex())


def run_from_frames(begin: Dict, chunks: List[Dict]) -> Dict:
    """Rebuild a run from its wire frames.  Frame-protocol violations
    raise :class:`wire.FrameError` with the usual typed kinds; a
    structurally valid run that lies about its own shape raises
    :class:`HandoffError` (and :func:`import_run`'s digest check still
    guards the content)."""
    payload_bytes = wire.kv_run_assemble(begin, chunks)
    meta = begin.get("meta") or {}
    try:
        arr = np.frombuffer(
            payload_bytes, dtype=_DTYPES[str(meta["dtype"])][1]
        ).reshape([int(s) for s in meta["shape"]])
        blocks = [{"hash": bytes.fromhex(h), "depth": int(d),
                   "tokens": tuple(int(t) for t in toks)}
                  for h, d, toks in begin.get("blocks") or []]
        digest = bytes.fromhex(str(begin.get("digest", "")))
    except (KeyError, TypeError, ValueError) as e:
        raise HandoffError(f"undecodable kv run frames: {e}") from e
    run = {k: meta.get(k) for k in ("version", "block_size", "layers",
                                    "kv_heads", "head_dim", "dtype",
                                    "tokens_total")}
    run["blocks"] = blocks
    run["payload"] = arr
    run["digest"] = digest
    return run
