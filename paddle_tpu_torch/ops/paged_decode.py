"""Paged decode attention: one new token per row over the shared KV pools.

The PyTorch counterpart of ``paddle_tpu/ops/pallas_paged.py``:

``q``            ``[B, H, D]``  one decode token per row
``k/v_cache``    ``[num_blocks, block_size, Hkv, D]`` shared block pools
``block_tables`` ``[B, W]`` int32  page ids per row, 0-padded
``seq_lens``     ``[B]`` int32   KV length of each row (this token included)
→ out            ``[B, H, D]`` in q's dtype

Row ``b`` attends to its columns ``< seq_lens[b]``; query head ``h`` reads
KV head ``h / (H / Hkv)``.  Pages past a row's length are never read, so
the pre-extended tables of a decode burst cost nothing.

Written twice against this one interface:

* :func:`decode_reference` — plain PyTorch, the JAX package's
  ``decode_oracle`` (``paged_attention._xla_paged_attention``): gather the
  pages to a dense context and mask.  The CPU tests hold it to the JAX
  oracle and to the JAX Pallas kernel; on the card it is what the CUDA
  kernel is compared with.
* :func:`decode_kernel` — the hand-written CUDA kernel
  (``csrc/paged_decode_attention.cu``), which replaces the Pallas kernel
  ``paddle_tpu/ops/pallas_paged.py::_decode_kernel``.  It cuts each row's
  walk into spans of :func:`span_tokens` tokens (a multiple of the page
  size, fixed by the page size alone), one work item per (row, KV head
  group, span), and merges a row's spans in span order.  :func:`route`
  picks one of two routes from dtype and shape alone: ``"mma"`` (bf16 q
  and pools, head dim 64 or 128, pages that divide 128 tokens: the serving
  path) computes on tensor cores, ``"simple"`` (every other pairing and
  shape the kernel takes) on lane groups.  :func:`span_plan` is the plain
  twin of the cut and :func:`decode_split_reference` of the arithmetic:
  each span's (max, sum, acc) in fp32, merged in the kernel's order.

:func:`paged_attention_decode` dispatches: on a CUDA tensor it launches the
kernel (or raises — there is no fallback and no switch to turn the kernel
off), and ``use_pallas=False`` pins the plain version; on a CPU tensor it
runs the plain version, and ``use_pallas=True`` raises.  At mp > 1 each rank
calls it with its own ``H/mp`` query and ``Hkv/mp`` KV heads, in the
legacy decode family and in burst iterations alike (ROADMAP C13: the JAX
engine pins those families to its gather path at mp > 1).

A row with ``seq_lens == 0`` (the engine never builds one) gets zeros from
the kernel and from :func:`decode_split_reference`, as from the TPU kernel,
and the mean of its gathered V rows from :func:`decode_reference`; the two
are not compared there.
"""

from __future__ import annotations

import ctypes
import threading
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .paged_attention import _xla_paged_attention

# Which path the most recent dispatch took: "cuda" | "reference".
last_path: Optional[str] = None
# Kernel launches since the last reset; decode_kernel adds one per call, on
# either route, and one to the count of the route it took.
launches = 0
simple_launches = 0
mma_launches = 0
# the replicas of a fleet at mp > 1 launch from several threads at once
# (serving/graphs.py): an increment is not atomic
_COUNT_LOCK = threading.Lock()
# The route of the most recent decode_kernel call: "simple" | "mma".
last_route: Optional[str] = None

SPAN_TOKENS = 128       # a span's length in tokens, before rounding to pages
                        # (at most MMA_SPAN on the mma route)
MAX_SPAN_PAGES = 128    # the simple route's buffer of a span's page ids
MMA_HEAD_DIMS = (64, 128)  # the mma route's head dims
MMA_SPAN = 128          # the mma route holds a span of at most this whole
MMA_HEADS = 16          # the mma route's query heads a block (its rows)
_KERNEL = "paged_decode_attention"
_DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30
_SCRATCH_BYTES = 1 << 26   # span partials of one launch slice at most
_sm_counts: Dict[int, int] = {}


def decode_reference(q, k_cache, v_cache, block_tables, seq_lens):
    """The plain version (the JAX package's ``decode_oracle``): computes in
    fp32 and returns q's dtype."""
    return _xla_paged_attention(q, k_cache, v_cache, block_tables, seq_lens)


def route(device_type, q_dtype, kv_dtype, head_dim, block_size):
    """Which code computes a call, from dtype and shape alone:
    ``"reference"`` on the CPU, ``"mma"`` for bf16 q and pools at a head dim
    of 64 or 128 with pages that divide 128 tokens (its span is one block's
    shared memory), ``"simple"`` otherwise."""
    if device_type != "cuda":
        return "reference"
    if (q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16
            and head_dim in MMA_HEAD_DIMS and MMA_SPAN % block_size == 0):
        return "mma"
    return "simple"


def span_tokens(block_size: int) -> int:
    """Tokens of one span of the kernel's walk: :data:`SPAN_TOKENS` rounded
    up to whole pages.  It depends on the page size only, so a row's result
    depends on its own length and data only."""
    return block_size * -(-SPAN_TOKENS // block_size)


def span_plan(lens, span: int):
    """The kernel's work items for one KV head group, as ``(row, span
    index, first column, end column)``: each row's columns ``[0, len)`` cut
    into spans of ``span`` tokens, rows in order, spans in order.  A row of
    length 0 has one empty item (the kernel writes its zeros there)."""
    items = []
    for row, n in enumerate(max(int(x), 0) for x in lens):
        for j in range(max(1, -(-n // span))):
            items.append((row, j, j * span, min(n, (j + 1) * span)))
    return items


def decode_split_reference(q, k_cache, v_cache, block_tables, seq_lens,
                           span: Optional[int] = None):
    """The plain twin of the kernel's arithmetic: for each span of
    :func:`span_plan` (``span`` defaults to :func:`span_tokens`), the fp32
    max ``m``, sum ``l`` and ``acc`` of its columns; then each row's spans
    merged in span order with an online rescale, ``M' = max(M, m_j)``,
    ``L = L e^(M - M') + l_j e^(m_j - M')``, ``A`` likewise, out
    ``A / max(L, 1e-9)`` in q's dtype.  Lengths are clipped to
    ``[0, W * bs]``; a row of length 0 gets zeros."""
    B, H, D = q.shape
    W = block_tables.shape[1]
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = H // Hkv
    span = span_tokens(bs) if span is None else span
    cols = W * bs
    bt = block_tables.long()
    k = k_cache[bt].reshape(B, cols, Hkv, D).float()
    v = v_cache[bt].reshape(B, cols, Hkv, D).float()
    logits = torch.einsum("bhrd,bshd->bhrs", q.reshape(B, Hkv, rep, D).float(),
                          k) * (1.0 / math.sqrt(D))
    lens = seq_lens.long().clamp(0, cols)
    n_spans = torch.clamp((lens + span - 1) // span, min=1)[:, None, None]
    M = torch.full((B, Hkv, rep), _NEG_INF, device=q.device)
    L = torch.zeros_like(M)
    A = torch.zeros(B, Hkv, rep, D, device=q.device)
    for j, a in enumerate(range(0, cols, span)):
        c = torch.arange(a, min(a + span, cols), device=q.device)
        live = (c[None, :] < lens[:, None])[:, None, None, :]
        s = logits[..., a:a + span].masked_fill(~live, _NEG_INF)
        m = s.amax(-1)
        p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
        acc = torch.einsum("bhrs,bshd->bhrd", p, v[:, a:a + span])
        use = j < n_spans
        m_new = torch.maximum(M, m)
        scale_old, w = torch.exp(M - m_new), torch.exp(m - m_new)
        L = torch.where(use, L * scale_old + p.sum(-1) * w, L)
        A = torch.where(use[..., None], A * scale_old[..., None]
                        + acc * w[..., None], A)
        M = torch.where(use, m_new, M)
    return (A / L.clamp(min=1e-9)[..., None]).reshape(B, H, D).to(q.dtype)


def _heads_per_block(rep: int) -> int:
    """Query heads one simple-route block holds (the kernel's HPB): groups
    wider than 4 heads are split over several blocks."""
    return 1 if rep == 1 else 2 if rep == 2 else 4


def head_groups(H: int, Hkv: int, way: str) -> Tuple[int, int]:
    """``(groups, heads)``: the head groups of a row (each reads its KV
    head's pages once) and the most query heads of one, on route ``way``:
    16 heads a group on the mma route, :func:`_heads_per_block` on the
    simple one."""
    rep = H // Hkv
    hpb = MMA_HEADS if way == "mma" else _heads_per_block(rep)
    return Hkv * -(-rep // hpb), min(rep, hpb)


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once a device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


@functools.lru_cache(maxsize=512)
def launch_plan(B: int, H: int, Hkv: int, D: int, block_size: int, W: int,
                span: int, way: str) -> Tuple[int, int]:
    """``(rows, scratch)`` on route ``way``: the rows of one launch slice
    and the fp32 scratch floats its span partials need (acc, max and sum
    of each head of each (row, head group, span), padded to 4 floats; 0
    when no row of a ``W``-page table has more than one span).  A slice
    holds at most 64 MB of partials; slices run one after another, and a
    row's result does not depend on its slice."""
    groups, heads = head_groups(H, Hkv, way)
    max_spans = max(1, -(-(W * block_size) // span))
    if max_spans == 1:
        return B, 0
    per_row = groups * max_spans * (-(-(heads * (D + 2)) // 4) * 4)
    rows = max(1, min(B, _SCRATCH_BYTES // (4 * per_row)))
    return rows, rows * per_row


def _check_kernel_args(q, k_cache, v_cache, block_tables, seq_lens):
    dev = q.device
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"decode kernel: {name} is on {t.device}; every "
                             f"input must be on q's CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"decode kernel: {name} must be contiguous")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        name = "block_tables" if block_tables.dtype != torch.int32 else \
            "seq_lens"
        got = block_tables.dtype if name == "block_tables" else seq_lens.dtype
        raise TypeError(f"decode kernel: {name} must be int32, got {got}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES:
        raise TypeError(f"decode kernel: q and the pools must be float32 or "
                        f"bfloat16, got {q.dtype} and {k_cache.dtype}")
    if v_cache.dtype != k_cache.dtype or v_cache.shape != k_cache.shape:
        raise ValueError("decode kernel: k_cache and v_cache differ in dtype "
                         "or shape")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode kernel: q must be [B, H, D] and the pools "
                         f"[num_blocks, block_size, Hkv, D]; got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    B, H, D = q.shape
    _, bs, Hkv, Dk = k_cache.shape
    if Dk != D or Hkv < 1 or H % Hkv:
        raise ValueError(f"decode kernel: q {tuple(q.shape)} does not fit "
                         f"pools {tuple(k_cache.shape)} (same D, H a "
                         f"multiple of Hkv)")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"decode kernel: head dim {D} must be a multiple of "
                         f"8 up to 256")
    if not 1 <= bs <= 64:
        raise ValueError(f"decode kernel: block_size {bs} must be 1..64")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] < 1 or seq_lens.shape != (B,)):
        raise ValueError(f"decode kernel: block_tables must be [B, W >= 1] "
                         f"and seq_lens [B] for B={B}; got "
                         f"{tuple(block_tables.shape)} and "
                         f"{tuple(seq_lens.shape)}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        name = "k_cache" if k_cache.data_ptr() % 16 else "v_cache"
        raise ValueError(f"decode kernel: {name} must be 16-byte aligned "
                         f"(the kernel reads it with 16-byte copies)")


def decode_kernel(q, k_cache, v_cache, block_tables, seq_lens):
    """Launch the CUDA kernel of :func:`route`'s choice on the current
    stream; returns ``[B, H, D]`` in q's dtype.  Reads nothing back to the
    host.  Raises on inputs the kernel does not take, when the kernel
    cannot be built, and when the launch is refused."""
    global launches, simple_launches, mma_launches, last_route
    _check_kernel_args(q, k_cache, v_cache, block_tables, seq_lens)
    B, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    W = block_tables.shape[1]
    way = route("cuda", q.dtype, k_cache.dtype, D, bs)
    span = span_tokens(bs)
    out = torch.empty_like(q)
    if B == 0:
        return out
    rows, scratch = launch_plan(B, H, Hkv, D, bs, W, span, way)
    dev = q.device
    part = torch.empty(scratch, dtype=torch.float32, device=dev) \
        if scratch else None
    lib = _lib()
    args = (way, q, k_cache, v_cache, block_tables, seq_lens, out, part, B,
            H, Hkv, D, bs, W, span, rows)
    if dev.index == torch.cuda.current_device():
        err = _launch(lib, dev, *args)
    else:
        with torch.cuda.device(dev):
            err = _launch(lib, dev, *args)
    if err:
        msg = lib.paged_decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode kernel launch failed ({way} route): CUDA "
                           f"error {err} ({msg})")
    with _COUNT_LOCK:
        launches += 1
        if way == "mma":
            mma_launches += 1
        else:
            simple_launches += 1
        last_route = way
    _build.note_launch("paged decode")
    return out


def _launch(lib, dev, way, q, k_cache, v_cache, block_tables, seq_lens, out,
            part, B, H, Hkv, D, bs, W, span, rows):
    """One call of the route's C launcher on the current stream of
    ``dev``, which is the current device."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr())
    scale = 1.0 / math.sqrt(D)
    if way == "mma":
        return lib.paged_decode_attention_mma_launch(
            *ptrs, B, H, Hkv, D, bs, W, span, rows, sm_count(dev), scale,
            stream)
    return lib.paged_decode_attention_launch(
        *ptrs, B, H, Hkv, D, bs, W, span, rows,
        int(q.dtype == torch.bfloat16), int(k_cache.dtype == torch.bfloat16),
        sm_count(dev), scale, stream)


_lib_handle = None


def _lib():
    """The kernel's library, built on first use, with its C signatures."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(_KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.paged_decode_attention_launch
        fn.argtypes = [ptr] * 7 + [i32] * 11 + [ctypes.c_float, ptr]
        fn.restype = i32
        fn = lib.paged_decode_attention_mma_launch
        fn.argtypes = [ptr] * 7 + [i32] * 9 + [ctypes.c_float, ptr]
        fn.restype = i32
        lib.paged_decode_attention_error_string.argtypes = [i32]
        lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def paged_attention_decode(q, k_cache, v_cache, block_tables, seq_lens,
                           use_pallas=None):
    """Paged decode attention; returns ``[B, H, D]``.

    On a CUDA tensor, ``use_pallas`` None or True launches the CUDA kernel
    (a failure raises: there is no fallback) and False pins
    :func:`decode_reference`.  On a CPU tensor the plain version runs, and
    True raises because the kernel cannot run there."""
    global last_path
    if q.shape[-2] % k_cache.shape[2]:
        raise ValueError(
            f"paged decode attention: {q.shape[-2]} query heads do not group "
            f"over {k_cache.shape[2]} KV heads; at mp > 1 a rank passes its "
            f"own H/mp and Hkv/mp heads, and mp must divide both")
    if q.device.type == "cuda" and use_pallas is not False:
        out = decode_kernel(q, k_cache, v_cache, block_tables, seq_lens)
        last_path = "cuda"
        return out
    if use_pallas is True:
        raise RuntimeError(
            f"use_pallas=True asks for the CUDA kernel, but q is on "
            f"{q.device}: the kernel runs only on a CUDA device")
    out = decode_reference(q, k_cache, v_cache, block_tables, seq_lens)
    last_path = "reference"
    return out
