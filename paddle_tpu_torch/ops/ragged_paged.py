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
* :func:`ragged_kernel` — the hand-written CUDA kernel
  (``csrc/ragged_paged_attention.cu``), which replaces the Pallas kernel
  ``paddle_tpu/ops/ragged_paged.py::_ragged_kernel``.

:func:`ragged_paged_attention` dispatches: on a CUDA tensor it launches the
kernel (or raises — there is no fallback and no switch to turn the kernel
off), and ``use_pallas=False`` pins the plain version; on a CPU tensor it
runs the plain version, and ``use_pallas=True`` raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

# Which path the most recent dispatch took: "cuda" | "reference".
last_path: Optional[str] = None
# Kernel launches since the last reset; ragged_kernel adds one per launch.
launches = 0

_NEG_INF = -1e30
_KERNEL = "ragged_paged_attention"
_DTYPES = (torch.float32, torch.bfloat16)


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
    """Launch the CUDA kernel on the current stream; returns ``[T, H, D]``
    in q's dtype.  Raises on inputs the kernel does not take, when the
    kernel cannot be built, and when the launch is refused."""
    global launches
    _check_kernel_args(q, k_cache, v_cache, block_tables, kv_lens, seg_ids,
                       q_pos)
    T, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ragged_paged_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), kv_lens.data_ptr(), seg_ids.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), T, H, Hkv, D, bs,
            block_tables.shape[1], int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            stream)
    if err:
        msg = lib.ragged_paged_attention_error_string(err).decode()
        raise RuntimeError(f"ragged kernel launch failed: CUDA error {err} "
                           f"({msg})")
    launches += 1
    return out


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
