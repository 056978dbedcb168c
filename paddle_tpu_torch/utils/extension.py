"""Custom-op registration for user kernels (the JAX package's
``paddle_tpu/utils/extension.py``, N37 analog).

The reference lets users add ops at runtime with ``PD_BUILD_OP``
(``paddle/fluid/framework/custom_operator.cc``) + ``paddle.utils.
cpp_extension.load``: forward/backward kernels become first-class ops with
autograd wiring.  In the port a user kernel is a function over torch
tensors: a torch composition, or the wrapper of a hand-written CUDA kernel
that launches on the tensor's device.  Registering it makes it a framework
op: autograd differentiates it (through the composition, or through the
custom VJP given with it), the profiler shows it by its name, and
:func:`get_custom_op` finds it.

Worked example (a CUDA kernel with a custom VJP; ``ops/scaled.py`` holds
it, and ``csrc/scaled.cu`` is the kernel)::

    import torch
    from paddle_tpu_torch.ops.scaled import scaled   # x * alpha, CUDA
    from paddle_tpu_torch.utils import register_custom_op

    def scaled_fwd(x, alpha=2.0):
        return scaled(x, alpha), None

    def scaled_bwd(alpha, _, g):
        return (g * alpha,)

    my_scaled = register_custom_op(
        scaled, name="my_scaled", vjp=(scaled_fwd, scaled_bwd),
        nondiff_argnames=("alpha",))

    x = torch.randn(1024, device="cuda", requires_grad=True)
    y = my_scaled(x, alpha=3.0)      # a framework op now
    y.sum().backward()               # uses scaled_bwd

A kernel of one's own is wrapped as ``ops/scaled.py::scaled_kernel`` wraps
``csrc/scaled.cu``: build the source with ``nvcc`` into a shared library
with a plain C launch function (``ops/_build.py`` does so for the sources
under ``csrc/``), load it with ``ctypes``, check the tensors, allocate the
output with ``torch.empty``, launch on ``torch.cuda.current_stream()`` and
raise when the launch returns an error.

A registered op runs inside a ``jit.to_static`` function like any torch
code: captured into the key's CUDA graph on the card, eagerly on the
CPU.  A kernel launched through ``ctypes`` is invisible to the dispatcher,
so a graph-broken function that calls one is not replayed in segments
(``jit/partial.py``): it runs eagerly.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

_REGISTRY: Dict[str, Callable] = {}


def _as_tensors(args) -> list:
    """Positional arguments as tensors: a tensor stays as it is (never moved
    to another device); anything else (a numpy array, a list, a number)
    becomes a tensor on the first tensor argument's device, or on
    :func:`resolve_device` (the card) when there is none.  float64 data
    takes the default dtype, as the JAX package's ``to_tensor`` does."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)
    out = []
    for a in args:
        if not isinstance(a, torch.Tensor):
            if device is None:
                device = resolve_device(None)
            a = np.asarray(a)
            dtype = torch.get_default_dtype() if a.dtype == np.float64 \
                else None
            a = torch.as_tensor(a, dtype=dtype, device=device)
        out.append(a)
    return out


_SAVED = object()   # marks a residual slot kept by save_for_backward


class _CustomVJP(torch.autograd.Function):
    """``jax.custom_vjp`` around one call: ``fwd`` runs forward, ``bwd``
    gets the configuration, the residuals and the output's cotangent and
    returns one gradient per positional input."""

    @staticmethod
    def forward(ctx, fwd, bwd, cfg, kwargs, *vals):
        out, res = fwd(*vals, **kwargs)
        ctx.bwd, ctx.cfg = bwd, cfg
        # residual tensors go through save_for_backward (no reference cycle
        # when a residual is the output itself); the rest stays on ctx
        items = res if isinstance(res, tuple) else (res,)
        ctx.save_for_backward(*(r for r in items
                                if isinstance(r, torch.Tensor)))
        ctx.res_layout = (isinstance(res, tuple),
                          [_SAVED if isinstance(r, torch.Tensor) else r
                           for r in items])
        return out

    @staticmethod
    def backward(ctx, *gs):
        is_tuple, layout = ctx.res_layout
        saved = iter(ctx.saved_tensors)
        items = [next(saved) if r is _SAVED else r for r in layout]
        res = tuple(items) if is_tuple else items[0]
        g = gs[0] if len(gs) == 1 else gs
        grads = tuple(ctx.bwd(*ctx.cfg, res, g))
        return (None, None, None, None, *grads)


def register_custom_op(fn: Callable = None, *, name: Optional[str] = None,
                       vjp: Optional[Tuple[Callable, Callable]] = None,
                       nondiff_argnames: Sequence[str] = ()):
    """Register ``fn`` (a kernel over torch tensors) as a framework op.

    Args:
        fn: callable over ``torch.Tensor`` positional inputs (+ static
            kwargs).
        name: op name (defaults to ``fn.__name__``); while a profiler
            runs, each call is a ``record_function`` range of this name.
            Registering a name again replaces the earlier op.
        vjp: optional ``(fwd, bwd)`` pair wired as a
            ``torch.autograd.Function`` —
            ``fwd(*args, **kw) -> (out, residuals)`` (residuals None, one
            tensor or a tuple), ``bwd(*nondiff_kwargs, residuals,
            cotangent) -> input grads``, one a positional input.  Without
            it, the op is ``fn`` itself and autograd differentiates its
            torch composition (a hand-written kernel has no autograd rule
            and needs ``vjp``).
        nondiff_argnames: kwarg names treated as static configuration:
            ``bwd`` receives the values of those passed as keywords in the
            call, in this order (a default left unpassed is not in them).

    Returns the framework-level op: ``op(Tensor..., **kw) -> Tensor``.
    Also retrievable via :func:`get_custom_op`.
    """
    if fn is None:
        return functools.partial(register_custom_op, name=name, vjp=vjp,
                                 nondiff_argnames=nondiff_argnames)

    op_name = name or fn.__name__

    def call(vals, kwargs):
        if vjp is None or not (torch.is_grad_enabled() and any(
                v.requires_grad for v in vals)):
            # nothing to differentiate: the primal kernel, as a custom_vjp
            # function evaluates outside a transformation
            return fn(*vals, **kwargs)
        fwd, bwd = vjp
        cfg = tuple(kwargs[k] for k in nondiff_argnames if k in kwargs)
        return _CustomVJP.apply(fwd, bwd, cfg, kwargs, *vals)

    @functools.wraps(fn)
    def op(*args, **kwargs):
        vals = _as_tensors(args)
        if not torch.autograd._profiler_enabled():
            # no trace is being taken: the range would cost more host time
            # a call than a small kernel takes on the card
            return call(vals, kwargs)
        with torch.profiler.record_function(op_name):
            return call(vals, kwargs)

    _REGISTRY[op_name] = op
    return op


def get_custom_op(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no custom op '{name}' registered "
            f"(have: {sorted(_REGISTRY)})") from None


def registered_ops() -> Dict[str, Callable]:
    return dict(_REGISTRY)
