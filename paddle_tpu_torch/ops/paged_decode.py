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
  ``paddle_tpu/ops/pallas_paged.py::_decode_kernel``.

:func:`paged_attention_decode` dispatches: on a CUDA tensor it launches the
kernel (or raises — there is no fallback and no switch to turn the kernel
off), and ``use_pallas=False`` pins the plain version; on a CPU tensor it
runs the plain version, and ``use_pallas=True`` raises.

A row with ``seq_lens == 0`` (the engine never builds one) gets zeros from
the kernel, as from the TPU kernel, and the mean of its gathered V rows
from the plain version; the two are not compared there.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import _build
from .paged_attention import _xla_paged_attention

# Which path the most recent dispatch took: "cuda" | "reference".
last_path: Optional[str] = None
# Kernel launches since the last reset; decode_kernel adds one per launch.
launches = 0

_KERNEL = "paged_decode_attention"
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SPLITS = 32
_sm_counts: Dict[int, int] = {}


def decode_reference(q, k_cache, v_cache, block_tables, seq_lens):
    """The plain version (the JAX package's ``decode_oracle``): computes in
    fp32 and returns q's dtype."""
    return _xla_paged_attention(q, k_cache, v_cache, block_tables, seq_lens)


def _heads_per_block(rep: int) -> int:
    """Query heads one block holds (the kernel's HPB): groups wider than 4
    heads are split over several blocks."""
    return 1 if rep == 1 else 2 if rep == 2 else 4


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once a device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def num_splits(device, B: int, H: int, Hkv: int) -> int:
    """How many blocks share one (row, head chunk): enough for about two
    blocks on every SM.  It depends on the batch and head shapes only —
    never on the table width or the lengths — so a row's result does not
    depend on how far its table is padded."""
    sms = sm_count(device)
    head_chunks = -(-(H // Hkv) // _heads_per_block(H // Hkv))
    blocks = B * Hkv * head_chunks
    return max(1, min(_MAX_SPLITS, -(-2 * sms // blocks)))


def _check_kernel_args(q, k_cache, v_cache, block_tables, seq_lens):
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "seq_lens": seq_lens}
    for name, t in tensors.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"decode kernel: {name} is on {t.device}; every "
                             f"input must be on q's CUDA device ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"decode kernel: {name} must be contiguous")
    for name in ("block_tables", "seq_lens"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"decode kernel: {name} must be int32, got "
                            f"{tensors[name].dtype}")
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
    for name in ("k_cache", "v_cache"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"decode kernel: {name} must be 16-byte aligned "
                             f"(the kernel reads it with 16-byte loads)")


def decode_kernel(q, k_cache, v_cache, block_tables, seq_lens):
    """Launch the CUDA kernel on the current stream; returns ``[B, H, D]``
    in q's dtype.  Raises on inputs the kernel does not take, when the
    kernel cannot be built, and when the launch is refused."""
    global launches
    _check_kernel_args(q, k_cache, v_cache, block_tables, seq_lens)
    B, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    nsplit = num_splits(q.device, B, H, Hkv)
    part_acc = part_ml = None
    if nsplit > 1:   # split-KV scratch, merged by the kernel's second pass
        part_acc = torch.empty(B * H * nsplit * D, dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty(B * H * nsplit * 2, dtype=torch.float32,
                              device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            B, H, Hkv, D, bs, block_tables.shape[1], nsplit,
            int(q.dtype == torch.bfloat16),
            int(k_cache.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            stream)
    if err:
        msg = lib.paged_decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode kernel launch failed: CUDA error {err} "
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
        fn = lib.paged_decode_attention_launch
        fn.argtypes = [ptr] * 8 + [i32] * 9 + [ctypes.c_float, ptr]
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
