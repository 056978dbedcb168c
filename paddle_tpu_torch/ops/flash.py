"""Flash attention, forward and backward: the port of
``paddle_tpu/ops/pallas_flash.py``.

``q``        ``[B, Sq, H, D]``
``k``, ``v`` ``[B, Sk, Hkv, D]``  (H a multiple of Hkv: query head ``h``
             reads KV head ``h / (H / Hkv)``)
→ out        ``[B, Sq, H, D]`` in q's dtype, and for the backward an fp32
             log-sum-exp ``lse`` ``[B, H, Sq]``

with scale ``1/sqrt(D)`` and, when ``causal``, the TPU kernel's top-left
mask ``row >= col`` (it agrees with the composite paths' bottom-right mask
only when ``Sq == Sk``).

Written twice against this one interface:

* the plain PyTorch twins :func:`fwd_reference`, :func:`bwd_dq_reference`
  and :func:`bwd_dkv_reference`, each the arithmetic of one Pallas kernel
  (``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) over the whole
  score matrix at once: fp32 scores, the ``-1e30`` fill, the ``l == 0 → 1``
  guard, and ``p`` / ``dS`` rounded to the operand's dtype before the last
  products.  The CPU tests hold them to the Pallas kernels in interpret
  mode; on the card they are what the kernels are compared with.
* the hand-written CUDA kernels of ``csrc/flash_attention.cu``
  (:func:`fwd_kernel`, :func:`bwd_dq_kernel`, :func:`bwd_dkv_kernel`), which
  replace the three Pallas kernels: bf16 inputs on Hopper's TMA and
  ``wgmma``, fp32 inputs on fp32 FMAs.  The forward and dQ pack a GQA
  group's query heads into a block's 128 rows, so the kernels take at most
  :data:`MAX_GROUP` query heads a KV head; :func:`kernels_take` says so, and
  a wrapper refuses a larger group before any launch.

:func:`route` is the rule that picks among them, a pure function of the
device, dtype, head dim, pointers and strides.  TMA reads a tensor in
place only from a 16-byte-aligned base with strides that are multiples of
16 bytes; a bf16 input that is not so (a view with odd strides) is copied
to a contiguous tensor first, and :data:`copy_launches` counts the launches
that took that route.

The forward is also the registered operator ``paddle_tpu_torch::flash_fwd``
(:func:`flash_fwd`: the kernel for a CUDA tensor, the twin for a CPU one,
and shapes for ``torch.export``'s fake tensors), so that an exported
program (``jit.save``) holds the call, and its loaded copy launches the
kernel on the card and counts in :data:`fwd_launches`.

:class:`FlashAttention` is the ``torch.autograd.Function`` that mirrors the
JAX ``custom_vjp``: the forward (through the operator) saves ``(q, k, v,
out, lse)``; the backward
computes ``delta = rowsum(dO * O)`` in fp32 as a torch op, then dQ, then
dK/dV.  On a CUDA tensor whose group the kernels take it launches them (or
raises — there is no fallback and no switch to turn them off); on a CPU
tensor, and for a group of more than :data:`MAX_GROUP` heads, the twins
run.  The one switch is the dispatcher's
``use_pallas`` (``ops/flash_attention.py``), which pins the composite paths.

:func:`rowwise_error` is the measure by which the card's checks hold a
kernel to its twin.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

# Which path the most recent FlashAttention forward took: "cuda" | "reference".
last_path: Optional[str] = None
# Kernel launches since the last reset; each wrapper adds one per launch.
fwd_launches = 0
dq_launches = 0
dkv_launches = 0
# Launches whose bf16 inputs were copied to contiguous tensors first (route
# "copy"), and the route of the most recent launch.
copy_launches = 0
last_route: Optional[str] = None

_KERNEL = "flash_attention"
DTYPES = (torch.float32, torch.bfloat16)   # the dtypes the kernels take
HEAD_DIMS = (64, 128)        # the head dims the kernels are built for
MAX_GROUP = 128              # query heads a KV head, at most: a block's rows
_NEG_INF = -1e30


# --- the plain versions -------------------------------------------------------

def _heads(t, rep=1):
    """``[B, S, n, D]`` → ``[B, n * rep, S, D]`` in fp32 (each head repeated
    ``rep`` times: the query heads of a GQA group read one KV head)."""
    t = t.permute(0, 2, 1, 3).float()
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def _masked_scores(q, k, scale, causal):
    """fp32 scores ``[B, H, Sq, Sk]`` with the top-left causal fill."""
    rep = q.shape[2] // k.shape[2]
    s = torch.matmul(_heads(q), _heads(k, rep).transpose(-1, -2)) * scale
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        rows = torch.arange(Sq, device=s.device)[:, None]
        cols = torch.arange(Sk, device=s.device)[None, :]
        s = s.masked_fill(~(rows >= cols), _NEG_INF)
    return s


def _rounded(x, dtype):
    """``x`` cast to ``dtype`` and back to fp32: the value it takes when the
    TPU kernel casts it before a product that accumulates in fp32."""
    return x.to(dtype).float()


def fwd_reference(q, k, v, scale, causal):
    """``_fwd_kernel``'s arithmetic: returns ``(out [B, Sq, H, D]`` in q's
    dtype, ``lse [B, H, Sq]`` fp32)."""
    rep = q.shape[2] // k.shape[2]
    s = _masked_scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    del s
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    acc = torch.matmul(_rounded(p, v.dtype), _heads(v, rep))
    out = (acc / safe_l).to(q.dtype).permute(0, 2, 1, 3)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _probs_and_dscores(q, k, v, do, lse, delta, scale, causal):
    """P recomputed from the lse, and dS = P * (dO . V^T - delta) * scale,
    both ``[B, H, Sq, Sk]`` fp32."""
    rep = q.shape[2] // k.shape[2]
    p = torch.exp(_masked_scores(q, k, scale, causal) - lse[..., None])
    dp = torch.matmul(_heads(do), _heads(v, rep).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def bwd_dq_reference(q, k, v, do, lse, delta, scale, causal):
    """``_bwd_dq_kernel``'s arithmetic: dQ ``[B, Sq, H, D]`` in q's dtype."""
    rep = q.shape[2] // k.shape[2]
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dq = torch.matmul(_rounded(ds, k.dtype), _heads(k, rep))
    return dq.to(q.dtype).permute(0, 2, 1, 3)


def bwd_dkv_reference(q, k, v, do, lse, delta, scale, causal):
    """``_bwd_dkv_kernel``'s arithmetic: ``(dK, dV)``, each
    ``[B, Sk, Hkv, D]`` in k's and v's dtype, summed over the query heads of
    each GQA group."""
    B, Sk, Hkv, D = k.shape
    rep = q.shape[2] // Hkv
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, scale, causal)
    dv = torch.matmul(_rounded(p, do.dtype).transpose(-1, -2), _heads(do))
    del p
    dk = torch.matmul(_rounded(ds, q.dtype).transpose(-1, -2), _heads(q))
    dk = dk.reshape(B, Hkv, rep, Sk, D).sum(dim=2)
    dv = dv.reshape(B, Hkv, rep, Sk, D).sum(dim=2)
    return (dk.to(k.dtype).permute(0, 2, 1, 3),
            dv.to(v.dtype).permute(0, 2, 1, 3))


# --- the CUDA kernels ---------------------------------------------------------

def _check(op, named, stats=()):
    """Raise on what the kernels do not take; ``named`` are the
    ``[B, S, heads, D]`` tensors (q first), ``stats`` the fp32 ``[B, H, Sq]``
    ones."""
    q, k = named[0][1], named[1][1]
    if q.dim() == 4 and k.dim() == 4 and k.shape[2] >= 1 \
            and q.shape[2] // k.shape[2] > MAX_GROUP:
        raise ValueError(f"flash {op} kernel: a GQA group of "
                         f"{q.shape[2] // k.shape[2]} query heads a KV head "
                         f"is over the kernels' limit of {MAX_GROUP} (a "
                         f"block packs the group into its {MAX_GROUP} rows)")
    for name, t in list(named) + list(stats):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash {op} kernel: {name} is on {t.device}; "
                             f"every input must be on q's CUDA device "
                             f"({q.device})")
    for name, t in named:
        if t.dim() != 4:
            raise ValueError(f"flash {op} kernel: {name} must be "
                             f"[B, S, heads, D], got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash {op} kernel: {name} is {t.dtype}, q is "
                            f"{q.dtype}; the kernel takes one dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"flash {op} kernel: the last dim of {name} "
                             f"must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash {op} kernel: inputs must be float32 or "
                        f"bfloat16, got {q.dtype}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash {op} kernel: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash {op} kernel: {H} query heads are not a "
                         f"multiple of {Hkv} KV heads")
    for name, t in named:
        want = ((B, Sq, H, D) if name in ("q", "do")
                else (B, Sk, Hkv, D))
        if tuple(t.shape) != want:
            raise ValueError(f"flash {op} kernel: {name} is "
                             f"{tuple(t.shape)}, expected {want}")
    for name, t in stats:
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)
                or not t.is_contiguous()):
            raise ValueError(f"flash {op} kernel: {name} must be a "
                             f"contiguous fp32 [B, H, Sq] = {(B, H, Sq)} "
                             f"tensor")
    if min(B, Sq, Sk) < 1:
        raise ValueError(f"flash {op} kernel: empty input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def kernels_take(device_type, H, Hkv):
    """Whether :class:`FlashAttention` runs the kernels: on a CUDA tensor
    whose GQA group fits a block (``H / Hkv <= MAX_GROUP``); otherwise the
    twins compute."""
    return device_type == "cuda" and H // Hkv <= MAX_GROUP


def _tma_ready(ptr, shape, stride):
    """Whether TMA reads a ``[B, S, heads, D]`` bf16 tensor in place: a
    16-byte-aligned base, and the b, s and head strides of every dim longer
    than 1 multiples of 8 elements (16 bytes; a dim of extent 1 is never
    stepped over)."""
    return ptr % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(shape[:3], stride[:3]) if n > 1)


def route(device_type, dtype, head_dim, layouts):
    """Which code computes the forward or dK/dV for these inputs:

    * ``"reference"``: a tensor on the CPU takes the plain twin;
    * ``"fma"``: fp32 takes the FMA kernel;
    * ``"tma"``: bf16 whose every input TMA reads in place takes the
      TMA/``wgmma`` kernel;
    * ``"copy"``: other bf16 inputs are copied to contiguous tensors, then
      take the TMA/``wgmma`` kernel.

    ``layouts`` holds ``(data_ptr, shape, stride)`` of each
    ``[B, S, heads, D]`` input.  Raises on a dtype or head dim the kernels do
    not take."""
    if device_type != "cuda":
        return "reference"
    if dtype not in DTYPES:
        raise TypeError(f"flash kernels: inputs must be float32 or "
                        f"bfloat16, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash kernels: head dim {head_dim} is not one of "
                         f"{HEAD_DIMS}")
    if dtype == torch.float32:
        return "fma"
    return "tma" if all(_tma_ready(*lay) for lay in layouts) else "copy"


def _routed(tensors):
    """The inputs as the kernel reads them: contiguous copies on the copy
    route, else the inputs themselves."""
    global copy_launches, last_route
    q = tensors[0]
    way = route(q.device.type, q.dtype, q.shape[-1],
                [(t.data_ptr(), tuple(t.shape), t.stride()) for t in tensors])
    if way == "copy":
        tensors = [t.contiguous() for t in tensors]
        copy_launches += 1
    last_route = way
    return tensors


def _strides(*tensors):
    """The (b, s, head) element strides of each tensor, as a C array."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(err, op):
    if err:
        msg = _lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash {op} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def _shape_args(q, k):
    B, Sq, H, D = q.shape
    return (B, H, k.shape[2], Sq, k.shape[1], D,
            int(q.dtype == torch.bfloat16))


def fwd_kernel(q, k, v, causal):
    """Launch the forward kernel on the current stream; returns ``(out,
    lse)``.  Raises on inputs it does not take, when it cannot be built, and
    when the launch is refused.  bf16 inputs that TMA cannot read in place
    are copied first (:func:`route`)."""
    global fwd_launches
    _check("forward", [("q", q), ("k", k), ("v", v)])
    q, k, v = _routed([q, k, v])
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    B, Sq, H, D = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _strides(q, k, v, out), *_shape_args(q, k),
            int(causal), 1.0 / math.sqrt(D), stream)
    _raise_on(err, "forward")
    fwd_launches += 1
    _build.note_launch("flash forward")
    return out, lse


def bwd_dq_kernel(q, k, v, do, lse, delta, causal):
    """Launch the dQ kernel; returns dQ ``[B, Sq, H, D]`` in q's dtype.
    bf16 inputs that TMA cannot read in place are copied first
    (:func:`route`)."""
    global dq_launches
    _check("dq", [("q", q), ("k", k), ("v", v), ("do", do)],
           [("lse", lse), ("delta", delta)])
    q, k, v, do = _routed([q, k, v, do])
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides(q, k, v, do, dq), *_shape_args(q, k), int(causal),
            1.0 / math.sqrt(q.shape[-1]), stream)
    _raise_on(err, "dq")
    dq_launches += 1
    _build.note_launch("flash dQ")
    return dq


def bwd_dkv_kernel(q, k, v, do, lse, delta, causal):
    """Launch the dK/dV kernel; returns ``(dK, dV)`` ``[B, Sk, Hkv, D]``.
    bf16 inputs that TMA cannot read in place are copied first
    (:func:`route`)."""
    global dkv_launches
    _check("dkv", [("q", q), ("k", k), ("v", v), ("do", do)],
           [("lse", lse), ("delta", delta)])
    q, k, v, do = _routed([q, k, v, do])
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, do, dk, dv), *_shape_args(q, k), int(causal),
            1.0 / math.sqrt(q.shape[-1]), stream)
    _raise_on(err, "dkv")
    dkv_launches += 1
    _build.note_launch("flash dK/dV")
    return dk, dv


_lib_handle = None


def _lib():
    """The kernels' library, built on first use, with its C signatures."""
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load(_KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 8 + [ctypes.c_float, ptr]
        for name, n_ptrs in (("flash_attention_fwd_launch", 6),
                             ("flash_attention_bwd_dq_launch", 8),
                             ("flash_attention_bwd_dkv_launch", 9)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptrs + tail
            fn.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


# --- the forward as a registered op -------------------------------------------

@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as an operator of torch's dispatcher, so that a graph
    ``torch.export`` traces (``jit.save``) holds the call and not the code
    behind it: on a CUDA tensor the kernel (:func:`fwd_kernel`, which
    raises where it cannot launch), on a CPU tensor the twin.  Returns
    ``(out, lse)``, both contiguous."""
    raise NotImplementedError(f"flash_fwd: no implementation for "
                              f"{q.device.type} tensors")


@flash_fwd.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, causal):
    return fwd_kernel(q, k, v, causal)


@flash_fwd.register_kernel("cpu")
def _flash_fwd_cpu(q, k, v, causal):
    out, lse = fwd_reference(q, k, v, 1.0 / math.sqrt(q.shape[-1]), causal)
    return out.contiguous(), lse.contiguous()


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, Sq), dtype=torch.float32))


# --- the autograd function ----------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp`` of ``pallas_flash.flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        global last_path
        kernels = kernels_take(q.device.type, q.shape[2], k.shape[2])
        if q.shape[2] // k.shape[2] <= MAX_GROUP:
            out, lse = torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, causal)
        else:
            out, lse = fwd_reference(q, k, v, 1.0 / math.sqrt(q.shape[-1]),
                                     causal)
        last_path = "cuda" if kernels else "reference"
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kernels = causal, kernels
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do = g if g.stride(-1) == 1 else g.contiguous()
        do = do.to(q.dtype)
        # delta_i = rowsum(dO_i . O_i): a small reduction, left to torch
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             out.float()).contiguous()
        if ctx.kernels:
            dq = bwd_dq_kernel(q, k, v, do, lse, delta, ctx.causal)
            dk, dv = bwd_dkv_kernel(q, k, v, do, lse, delta, ctx.causal)
        else:
            scale = 1.0 / math.sqrt(q.shape[-1])
            dq = bwd_dq_reference(q, k, v, do, lse, delta, scale, ctx.causal)
            dk, dv = bwd_dkv_reference(q, k, v, do, lse, delta, scale,
                                       ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False):
    """Fused attention over ``[B, Sq, H, D]`` q and ``[B, Sk, Hkv, D]`` k/v
    (GQA: H a multiple of Hkv), scale ``1/sqrt(D)``; differentiable.  The
    CUDA kernels on a CUDA tensor whose group they take (a failure raises),
    the plain twins on a CPU tensor and for a group of more than
    :data:`MAX_GROUP` heads."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not divisible by kv "
                         f"heads {k.shape[2]}")
    return FlashAttention.apply(q, k, v, causal)


def rowwise_error(got, want, floor=1e-2, least=0.1):
    """How far a kernel's output ``got`` is from its twin's ``want``: the
    largest ``|got - want|`` over the largest ``|want|`` of its row (the last
    dim: one query's out or dQ, one key's dK or dV).  A row is held to at
    least ``floor`` times the tensor's largest ``|want|``, and to at least
    ``least``.

    Under the causal mask the rows span orders of magnitude: a late key's
    dK/dV sums few queries, each with a small probability.  Divided by the
    whole tensor's largest value, a missing tail of keys would read as
    rounding.  The two floors keep rows that are rounding noise around 0
    from being divided by themselves: with one key the gradients of q and k
    are 0, and fp32 leaves about 1e-6 there from terms of about 1 (standard
    normal inputs); ``least`` is a tenth of that scale.  Every row's divisor
    is at most ``max(max|want|, 1)``, so the measure is never looser than
    the tensor-wide one."""
    want = want.float()
    diff = (got.float() - want).abs()
    rows = want.abs().amax(dim=-1, keepdim=True)
    bound = max(floor * float(want.abs().max()), least)
    return float((diff / rows.clamp(min=bound)).max())
