"""Runtime-compiled C++ custom ops (``paddle.utils.cpp_extension`` analog;
the JAX package's ``paddle_tpu/utils/cpp_extension.py``).

The reference compiles user C++/CUDA sources at import time and registers
the kernels as framework ops (``python/paddle/utils/cpp_extension/
extension_utils.py``, ``PD_BUILD_OP``).  The contract is explicit about
placement, as in the JAX package:

- **Host ops** (this module): C++ compiled with g++ into a shared object,
  bound via ctypes, run on the host CPU.  An input on the card is copied
  to the host explicitly, the host kernel runs, and the result is copied
  back to the input's device: the documented placement of a host op (the
  JAX package's ``jax.pure_callback`` makes the same two copies), not a
  fallback.  Inputs are cast to fp32 and the output is fp32.  An op is
  differentiable when a ``<name>_grad`` kernel is exported.
- **Device ops**: write a CUDA kernel and register it with
  :func:`paddle_tpu_torch.utils.extension.register_custom_op`
  (``ops/scaled.py`` is the example).

Exported kernel ABI (elementwise, shape-preserving)::

    extern "C" void my_op(const float* x, float* y, int64_t n);
    extern "C" void my_op_grad(const float* x, const float* gy,
                               float* gx, int64_t n);   // optional

``load(name=..., sources=[...], functions=[...])`` returns a namespace
whose attributes are framework ops (tensor in → tensor out, differentiable
when the grad kernel exists).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import types
from typing import List, Optional, Sequence

import torch

_DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(__file__), "..", "_build", "extensions")


class ExtensionBuildError(RuntimeError):
    pass


def get_build_directory() -> str:
    return os.environ.get("PADDLE_EXTENSION_DIR", _DEFAULT_BUILD_DIR)


def _compile(name: str, sources: Sequence[str], extra_cflags, build_dir,
             verbose: bool) -> str:
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(extra_cflags or []).encode())
    so = os.path.join(build_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = (["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]
           + list(extra_cflags or []) + [os.path.abspath(s) for s in sources]
           + ["-o", tmp])
    if verbose:
        print("[cpp_extension]", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise ExtensionBuildError(f"g++ failed for {name}:\n{proc.stderr}")
    os.replace(tmp, so)   # atomic: a reader never sees half a file
    return so


def _bind(lib: ctypes.CDLL, sym: str, n_in: int):
    """The exported ``sym`` as a host function over tensors: ``n_in`` inputs
    copied to contiguous fp32 host tensors, one fp32 host output of the
    first input's shape."""
    cfn = lib[sym]   # AttributeError when the library does not export it
    cfn.argtypes = [ctypes.c_void_p] * (n_in + 1) + [ctypes.c_int64]
    cfn.restype = None

    def call(*xs: torch.Tensor) -> torch.Tensor:
        host = [x.detach().to("cpu", torch.float32).contiguous() for x in xs]
        out = torch.empty_like(host[0])
        cfn(*(t.data_ptr() for t in host), out.data_ptr(), out.numel())
        from ..jit.partial import notify_opaque

        notify_opaque(f"host op {sym!r}")
        return out

    return call


class _HostOp(torch.autograd.Function):
    """A host kernel as an op: forward runs ``host_fn``; backward runs the
    exported grad kernel, or raises when there is none (as differentiating
    a ``pure_callback`` with no VJP does in the JAX package)."""

    @staticmethod
    def forward(ctx, op_name, host_fn, host_grad, x):
        ctx.op_name, ctx.host_grad = op_name, host_grad
        ctx.save_for_backward(x)
        return host_fn(x).to(x.device)

    @staticmethod
    def backward(ctx, g):
        if ctx.host_grad is None:
            raise RuntimeError(
                f"custom op '{ctx.op_name}' has no gradient: its library "
                f"exports no '{ctx.op_name}_grad'")
        (x,) = ctx.saved_tensors
        return None, None, None, ctx.host_grad(x, g).to(g.device)


def _make_op(op_name: str, host_fn, host_grad):
    def op(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, dtype=torch.float32)
        with torch.profiler.record_function(op_name):
            return _HostOp.apply(op_name, host_fn, host_grad, x)

    op.__name__ = op_name
    return op


def load(name: str, sources: Sequence[str],
         functions: Optional[List[str]] = None,
         extra_cflags: Optional[Sequence[str]] = None,
         build_directory: Optional[str] = None,
         verbose: bool = False) -> types.SimpleNamespace:
    """Compile ``sources`` and return a namespace of framework ops — the
    ``cpp_extension.load`` analog (build-and-import in one call).

    ``functions`` lists the exported op symbols (default: ``[name]``); a
    matching ``<fn>_grad`` export, if present, becomes the op's backward.
    The shared object is named by a hash of the sources and flags and
    reused when it exists (``__so_path__``).
    """
    so = _compile(name, sources, extra_cflags,
                  build_directory or get_build_directory(), verbose)
    lib = ctypes.CDLL(so)
    ns = types.SimpleNamespace(__so_path__=so)
    for fn_name in functions or [name]:
        host = _bind(lib, fn_name, 1)
        try:
            grad = _bind(lib, fn_name + "_grad", 2)
        except AttributeError:
            grad = None
        setattr(ns, fn_name, _make_op(fn_name, host, grad))
    return ns


class CppExtension:
    """setuptools-style descriptor (API-parity shim; ``load`` is the real
    entry point)."""

    def __init__(self, sources, *args, **kwargs):
        self.sources = list(sources)
        self.kwargs = kwargs


# accepted for portability: ``load`` builds host C++ only; a device kernel
# goes through register_custom_op
CUDAExtension = CppExtension


def setup(**kwargs):
    raise NotImplementedError(
        "ahead-of-time extension building is not used here; call "
        "paddle_tpu_torch.utils.cpp_extension.load(name=..., sources=[...]) "
        "for build-and-import")
