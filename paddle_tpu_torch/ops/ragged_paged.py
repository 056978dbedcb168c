"""Ragged paged attention: ONE launch for mixed prefill chunks + decode.

The PyTorch counterpart of ``paddle_tpu/ops/ragged_paged.py``.  Every
scheduled token of an engine step — one token of a decode row, or one of
the n tokens of a prefill chunk — is one entry of a flat ``[T, H, D]``
query batch, routed to its sequence by per-token metadata:

``q``            ``[T, H, D]``   packed new-token queries (pads → pad row)
``k/v_cache``    ``[num_blocks, block_size, Hkv, D]`` shared block pools
``block_tables`` ``[R, W]`` int32  per-ROW page tables (pad rows all-null)
``kv_lens``      ``[R]`` int32   total KV length per row AFTER this step
``seg_ids``      ``[T]`` int32   row each packed token belongs to
``q_pos``        ``[T]`` int32   absolute KV position of each token
→ out            ``[T, H, D]``

Token ``t`` attends causally over its row's pages: columns
``< min(kv_lens[seg_ids[t]], q_pos[t] + 1)``.  Padding tokens point at a
pad row whose table is all null pages (block 0) with ``kv_len = 1``; their
output is finite and never read.

Written twice against this one interface:

* :func:`ragged_reference` — plain PyTorch, the twin of the JAX package's
  ``ragged_oracle`` (gather each token's pages into a dense context and
  mask).  The CPU tests hold it to the JAX oracle and to the JAX Pallas
  kernel; on the card it is what the CUDA kernel is compared with.
* :func:`ragged_kernel` — the hand-written CUDA kernels
  (``csrc/ragged_paged_attention.cu``), which replace the Pallas kernel
  ``paddle_tpu/ops/ragged_paged.py::_ragged_kernel``.  :func:`route` picks
  one of two routes from dtype and shape alone: ``"tma"`` (bf16 q and
  pools, head dim 64 or 128, block size 8, 16, 32 or 64: the serving path)
  builds a work list on the device and runs prefill chunks on TMA and
  ``wgmma``, decode rows on lane groups with a split KV walk;
  ``"simple"`` (every other shape the kernels take) is the first design,
  one block per (token, KV head).  :func:`work_items` is the plain twin of
  the device work list and :func:`launch_shape` the grid rule, both pure.

:func:`ragged_paged_attention` dispatches: on a CUDA tensor it launches the
kernel (or raises — there is no fallback and no switch to turn the kernel
off), and ``use_pallas=False`` pins the plain version; on a CPU tensor it
runs the plain version, and ``use_pallas=True`` raises.

Tensor-parallel serving: the JAX package runs its kernel on each shard's
heads through ``shard_map`` (``_mesh_kernel``).  Here each rank calls this
dispatch with its own ``q [T, H/mp, D]`` and its own pools
``[num_blocks, block_size, Hkv/mp, D]``: the kernels take any head counts
whose query heads group evenly over the KV heads, and raise otherwise
(where the JAX function falls back to its single-shard kernel; the engine
validates mp's divisibility first, as the JAX engine does).
"""

from __future__ import annotations

import ctypes
import threading
import math
from typing import Optional

import torch

from . import _build
from .paged_decode import _heads_per_block, sm_count

# Which path the most recent dispatch took: "cuda" | "reference".
last_path: Optional[str] = None
# Kernel launches since the last reset; ragged_kernel adds one per call, on
# either route, and one to the count of the route it took.
launches = 0
simple_launches = 0
tma_launches = 0
# the replicas of a fleet at mp > 1 launch from several threads at once
# (serving/graphs.py): an increment is not atomic
_COUNT_LOCK = threading.Lock()
# The route of the most recent ragged_kernel call: "simple" | "tma".
last_route: Optional[str] = None

_NEG_INF = -1e30
_KERNEL = "ragged_paged_attention"
_DTYPES = (torch.float32, torch.bfloat16)
TMA_HEAD_DIMS = (64, 128)          # the tma route's wgmma widths
TMA_BLOCK_SIZES = (8, 16, 32, 64)  # pages that tile 64 keys, 8 rows or more
BLOCK_ROWS = 128                   # rows of a chunk block: tokens x heads
_LIST_HEAD = 2                     # the work list's two counts
_MAX_SPLITS = 8
_SPLIT_SCRATCH = 1 << 26           # bytes of split-KV partials at most


def ragged_reference(q, k_cache, v_cache, block_tables, kv_lens, seg_ids,
                     q_pos):
    """Gather reference for the packed ragged step: gathers each token's
    row pages to a dense ``[T, W * bs, Hkv, D]`` context and masks with the
    per-token causal limit ``min(kv_lens[seg], q_pos + 1)``.  Computes in
    fp32 and returns q's dtype."""
    T, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    W = block_tables.shape[1]
    scale = 1.0 / math.sqrt(D)
    seg = seg_ids.long()

    bt = block_tables.long()[seg]                     # [T, W]
    k = k_cache[bt].reshape(T, W * bs, Hkv, D)
    v = v_cache[bt].reshape(T, W * bs, Hkv, D)

    qg = q.reshape(T, Hkv, rep, D)
    logits = torch.einsum("thrd,tkhd->thrk", qg.float(), k.float()) * scale
    col = torch.arange(W * bs, device=q.device)[None, :]
    limit = torch.minimum(kv_lens.long()[seg], q_pos.long() + 1)  # [T]
    mask = col < limit[:, None]
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("thrk,tkhd->thrd", probs, v.float())
    return out.reshape(T, H, D).to(q.dtype)


def route(device_type, q_dtype, kv_dtype, head_dim, block_size):
    """Which code computes a call, from dtype and shape alone:
    ``"reference"`` on the CPU, ``"tma"`` for bf16 q and pools at a head
    dim of 64 or 128 and a block size of 8, 16, 32 or 64 (TMA boxes of a
    page tile 64 keys with the 128-byte swizzle), ``"simple"`` otherwise."""
    if device_type != "cuda":
        return "reference"
    if (q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16
            and head_dim in TMA_HEAD_DIMS and block_size in TMA_BLOCK_SIZES):
        return "tma"
    return "simple"


def tokens_per_item(T, H, Hkv):
    """The most tokens of one work item: a chunk block's 128 rows hold the
    item's tokens times the GQA group's H / Hkv query heads."""
    return max(1, min(BLOCK_ROWS // (H // Hkv), T))


def work_items(seg_ids, per):
    """The plain twin of the device work list: each maximal run of
    consecutive tokens of one row, cut from its first token into items of
    at most ``per`` tokens.  Returns ``(chunks, decodes)``: the ``(first
    token, token count)`` of each item of more than one token, and the
    token of each item of one, both in token order."""
    seg = [int(x) for x in seg_ids]
    starts, run = [], 0
    for t in range(len(seg)):
        if t == 0 or seg[t] != seg[t - 1]:
            run = t
        if (t - run) % per == 0:
            starts.append(t)
    chunks, decodes = [], []
    for i, t0 in enumerate(starts):
        n = (starts[i + 1] if i + 1 < len(starts) else len(seg)) - t0
        if n > 1:
            chunks.append((t0, n))
        else:
            decodes.append(t0)
    return chunks, decodes


def launch_shape(T, H, Hkv, D, sms):
    """The tma route's grid, from shapes and the SM count only (never the
    table width or the data, so a row's output does not depend on its
    table bucket): ``per`` tokens an item at most, ``nsplit`` blocks sharing
    one decode row's KV walk, and the widths of the chunk and decode grids
    (their blocks loop over the items of their list).  The split count
    assumes at most 16 decode rows, a serving batch, so that the few decode
    rows of a mixed step still spread over the card; it is capped so that
    the partials (T x H x nsplit x D floats) stay within 64 MB.  ``sms``
    is the device's SM count."""
    rep = H // Hkv
    head_chunks = -(-rep // _heads_per_block(rep))
    rows = min(T, 16)
    nsplit = -(-2 * sms // (rows * Hkv * head_chunks))
    nsplit = max(1, min(_MAX_SPLITS, nsplit,
                        _SPLIT_SCRATCH // (T * H * D * 4)))
    return {
        "per": tokens_per_item(T, H, Hkv),
        "nsplit": nsplit,
        "chunk_blocks": max(1, min(T // 2, -(-2 * sms // Hkv))),
        "decode_blocks": max(1, min(T, -(-4 * sms
                                         // (Hkv * head_chunks * nsplit)))),
    }


def _check_kernel_args(q, k_cache, v_cache, block_tables, kv_lens, seg_ids,
                       q_pos):
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "kv_lens": kv_lens,
               "seg_ids": seg_ids, "q_pos": q_pos}
    for name, t in tensors.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"ragged kernel: {name} is on {t.device}; every "
                             f"input must be on q's CUDA device ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"ragged kernel: {name} must be contiguous")
    for name in ("block_tables", "kv_lens", "seg_ids", "q_pos"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"ragged kernel: {name} must be int32, got "
                            f"{tensors[name].dtype}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES:
        raise TypeError(f"ragged kernel: q and the pools must be float32 or "
                        f"bfloat16, got {q.dtype} and {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError("ragged kernel: k_cache and v_cache differ in "
                         "dtype or shape")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"ragged kernel: q must be [T, H, D] and the pools "
                         f"[num_blocks, block_size, Hkv, D]; got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    T, H, D = q.shape
    _, bs, Hkv, Dk = k_cache.shape
    if Dk != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"ragged kernel: q {tuple(q.shape)} does not fit "
                         f"pools {tuple(k_cache.shape)} (same D, H a "
                         f"multiple of Hkv)")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"ragged kernel: head dim {D} must be a multiple "
                         f"of 8 up to 256")
    if not 1 <= bs <= 64:
        raise ValueError(f"ragged kernel: block_size {bs} must be 1..64")
    if block_tables.dim() != 2 or kv_lens.shape != (block_tables.shape[0],):
        raise ValueError("ragged kernel: block_tables must be [R, W] and "
                         "kv_lens [R]")
    if seg_ids.shape != (T,) or q_pos.shape != (T,):
        raise ValueError("ragged kernel: seg_ids and q_pos must be [T]")


def ragged_kernel(q, k_cache, v_cache, block_tables, kv_lens, seg_ids,
                  q_pos):
    """Launch the CUDA kernels of :func:`route`'s choice on the current
    stream; returns ``[T, H, D]`` in q's dtype.  Reads nothing back to the
    host.  Raises on inputs the kernels do not take, when they cannot be
    built, and when a launch is refused: there is no fallback."""
    global launches, simple_launches, tma_launches, last_route
    _check_kernel_args(q, k_cache, v_cache, block_tables, kv_lens, seg_ids,
                       q_pos)
    T, H, D = q.shape
    NB, bs, Hkv = k_cache.shape[:3]
    W = block_tables.shape[1]
    out = torch.empty_like(q)
    if T == 0:
        return out
    way = route("cuda", q.dtype, k_cache.dtype, D, bs)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if way == "tma":
            for name, t in (("q", q), ("k_cache", k_cache),
                            ("v_cache", v_cache)):
                if t.data_ptr() % 16:
                    raise ValueError(f"ragged kernel: {name} must be 16-byte "
                                     f"aligned (TMA and 16-byte loads)")
            shape = launch_shape(T, H, Hkv, D, sm_count(q.device))
            nsplit = shape["nsplit"]
            work = torch.empty(_LIST_HEAD + 4 * T, dtype=torch.int32,
                               device=q.device)
            part_acc = part_ml = None
            if nsplit > 1:   # split-KV scratch, merged by the combine pass
                part_acc = torch.empty(T * H * nsplit * D,
                                       dtype=torch.float32, device=q.device)
                part_ml = torch.empty(T * H * nsplit * 2,
                                      dtype=torch.float32, device=q.device)
            err = lib.ragged_paged_attention_tma_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                block_tables.data_ptr(), kv_lens.data_ptr(),
                seg_ids.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
                work.data_ptr(),
                None if part_acc is None else part_acc.data_ptr(),
                None if part_ml is None else part_ml.data_ptr(),
                T, H, Hkv, D, bs, W, NB, shape["per"], nsplit,
                shape["chunk_blocks"], shape["decode_blocks"],
                1.0 / math.sqrt(D), stream)
        else:
            err = lib.ragged_paged_attention_launch(
                q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                block_tables.data_ptr(), kv_lens.data_ptr(),
                seg_ids.data_ptr(), q_pos.data_ptr(), out.data_ptr(), T, H,
                Hkv, D, bs, W, int(q.dtype == torch.bfloat16),
                int(k_cache.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
                stream)
    if err:
        msg = lib.ragged_paged_attention_error_string(err).decode()
        raise RuntimeError(f"ragged kernel launch failed ({way} route): CUDA "
                           f"error {err} ({msg})")
    with _COUNT_LOCK:
        launches += 1
        if way == "tma":
            tma_launches += 1
        else:
            simple_launches += 1
        last_route = way
    _build.note_launch("ragged paged attention")
    return out


def worklist_kernel(seg_ids, per):
    """The tma route's first kernel alone on a CUDA ``seg_ids``: returns
    ``(chunks, decodes)`` as :func:`work_items` does, read back from the
    device (for checks; the route itself never reads it back)."""
    if (seg_ids.device.type != "cuda" or seg_ids.dtype != torch.int32
            or seg_ids.dim() != 1 or not seg_ids.is_contiguous()
            or not 1 <= per <= BLOCK_ROWS):
        raise ValueError("ragged work list: seg_ids must be a contiguous "
                         "int32 [T] CUDA tensor and per in 1..128")
    T = seg_ids.shape[0]
    work = torch.empty(_LIST_HEAD + 4 * T, dtype=torch.int32,
                       device=seg_ids.device)
    lib = _lib()
    with torch.cuda.device(seg_ids.device):
        err = lib.ragged_worklist_launch(
            seg_ids.data_ptr(), T, per, work.data_ptr(),
            torch.cuda.current_stream(seg_ids.device).cuda_stream)
    if err:
        msg = lib.ragged_paged_attention_error_string(err).decode()
        raise RuntimeError(f"ragged work list launch failed: CUDA error "
                           f"{err} ({msg})")
    w = work.cpu().tolist()
    n_chunk, n_decode = w[0], w[1]
    t0 = w[_LIST_HEAD:_LIST_HEAD + n_chunk]
    n = w[_LIST_HEAD + T:_LIST_HEAD + T + n_chunk]
    decodes = w[_LIST_HEAD + 2 * T:_LIST_HEAD + 2 * T + n_decode]
    return list(zip(t0, n)), decodes


_lib_handle = None


def _lib():
    """The kernel's library, built on first use, with its C signatures."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(_KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.ragged_paged_attention_launch
        fn.argtypes = [ptr] * 8 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = i32
        fn = lib.ragged_paged_attention_tma_launch
        fn.argtypes = [ptr] * 11 + [i32] * 11 + [ctypes.c_float, ptr]
        fn.restype = i32
        fn = lib.ragged_worklist_launch
        fn.argtypes = [ptr, i32, i32, ptr, ptr]
        fn.restype = i32
        lib.ragged_paged_attention_error_string.argtypes = [i32]
        lib.ragged_paged_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def ragged_paged_attention(q, k_cache, v_cache, block_tables, kv_lens,
                           seg_ids, q_pos, use_pallas=None):
    """Packed ragged paged attention; returns ``[T, H, D]``.

    On a CUDA tensor, ``use_pallas`` None or True launches the CUDA kernel
    (a failure raises: there is no fallback) and False pins
    :func:`ragged_reference`.  On a CPU tensor the plain version runs, and
    True raises because the kernel cannot run there.  The argument keeps
    the JAX package's name so engine configs carry over."""
    global last_path
    if q.shape[-2] % k_cache.shape[2]:
        raise ValueError(
            f"ragged paged attention: {q.shape[-2]} query heads do not group "
            f"over {k_cache.shape[2]} KV heads; at mp > 1 a rank passes its "
            f"own H/mp and Hkv/mp heads, and mp must divide both")
    if q.device.type == "cuda" and use_pallas is not False:
        out = ragged_kernel(q, k_cache, v_cache, block_tables, kv_lens,
                            seg_ids, q_pos)
        last_path = "cuda"
        return out
    if use_pallas is True:
        raise RuntimeError(
            f"use_pallas=True asks for the CUDA kernel, but q is on "
            f"{q.device}: the kernel runs only on a CUDA device")
    out = ragged_reference(q, k_cache, v_cache, block_tables, kv_lens,
                           seg_ids, q_pos)
    last_path = "reference"
    return out
