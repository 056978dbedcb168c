"""The custom-op example kernel: ``o = x * alpha`` over a whole tensor.

The PyTorch counterpart of the worked example in
``paddle_tpu/utils/extension.py`` (the Pallas ``_scaled_kernel`` and its
runnable twin in ``tests/test_custom_op.py``), registered through the
port's :func:`paddle_tpu_torch.utils.extension.register_custom_op` as
``my_scaled`` with the example's custom VJP.

Rounding is JAX's: ``x * alpha`` on a bf16 or fp16 ``x`` rounds the weakly
typed ``alpha`` to ``x``'s type first, then multiplies and rounds once.
PyTorch's own ``x * alpha`` keeps ``alpha`` in fp32 and so differs from JAX
in the last bit of many elements (at ``alpha=0.1``, 860 of 4096 seeded bf16
values).  Both versions below round ``alpha`` first and multiply in fp32,
where the product of two bf16 or fp16 values is exact, so they agree with
each other and with the JAX kernel bit for bit.

Written twice against this one interface:

* :func:`scaled_reference` — plain PyTorch, the twin.
* :func:`scaled_kernel` — the hand-written CUDA kernel
  (``csrc/scaled.cu``), which replaces the Pallas ``_scaled_kernel``.

:func:`scaled` dispatches by the tensor's device: on a CUDA tensor it
launches the kernel (or raises — there is no fallback); on a CPU tensor the
twin runs.  A caller who wants the twin on the card calls
:func:`scaled_reference`.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch

from ..utils.extension import register_custom_op
from . import _build

# Which path the most recent dispatch took: "cuda" | "reference".
last_path: Optional[str] = None
# Kernel launches since the last reset; scaled_kernel adds one per launch.
launches = 0

_KERNEL = "scaled"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.lru_cache(maxsize=256)
def rounded_alpha(alpha: float, dtype: torch.dtype) -> float:
    """``alpha`` rounded to ``dtype`` (to nearest even), as JAX rounds a
    Python scalar multiplied into an array of that type.  Cached: a call
    with a known ``(alpha, dtype)`` builds no tensor."""
    return torch.tensor(alpha, dtype=dtype).item()


def scaled_reference(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """The twin: ``alpha`` rounded to x's dtype, the product in fp32 (exact
    for bf16 and fp16 operands), rounded once to x's dtype."""
    return (x.float() * rounded_alpha(alpha, x.dtype)).to(x.dtype)


def scaled_kernel(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; returns ``x * alpha``
    in x's dtype and shape.  A non-contiguous ``x`` is made contiguous
    first.  Raises on a tensor the kernel does not take, when the kernel
    cannot be built, and when the launch is refused."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"scaled kernel: x is on {x.device}; it must be on a "
                         f"CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"scaled kernel: x must be float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    # the launch goes to the runtime's current device: switch only when x
    # lies on another one
    switch = (torch.cuda.device(x.device)
              if x.device.index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scaled_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                                rounded_alpha(alpha, x.dtype),
                                _DTYPES[x.dtype], stream)
    if err:
        msg = lib.scaled_error_string(err).decode()
        raise RuntimeError(f"scaled kernel launch failed: CUDA error {err} "
                           f"({msg})")
    launches += 1
    _build.note_launch("the scale kernel")
    return out


_lib_handle = None


def _lib():
    """The kernel's library, built on first use, with its C signatures."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(_KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.scaled_launch.argtypes = [ptr, ptr, ctypes.c_int64,
                                      ctypes.c_float, i32, ptr]
        lib.scaled_launch.restype = i32
        lib.scaled_error_string.argtypes = [i32]
        lib.scaled_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def scaled(x: torch.Tensor, alpha: float = 2.0) -> torch.Tensor:
    """``x * alpha`` with JAX's rounding, in x's dtype.

    On a CUDA tensor the CUDA kernel runs (a failure raises: there is no
    fallback); on a CPU tensor :func:`scaled_reference` runs."""
    global last_path
    if x.device.type == "cuda":
        out = scaled_kernel(x, alpha)
        last_path = "cuda"
        return out
    out = scaled_reference(x, alpha)
    last_path = "reference"
    return out


def scaled_fwd(x, alpha=2.0):
    return scaled(x, alpha), None


def scaled_bwd(alpha, _, g):
    # the example's `g * alpha`: a plain product (not the kernel), with
    # JAX's rounding so that gradients agree with JAX bit for bit
    return (scaled_reference(g, alpha),)


my_scaled = register_custom_op(
    scaled, name="my_scaled", vjp=(scaled_fwd, scaled_bwd),
    nondiff_argnames=("alpha",))
