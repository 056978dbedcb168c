"""Autograd controls: the port of ``paddle_tpu/core/autograd.py``.

Torch's autograd is the port's tape, so these are Paddle's names over
``torch.autograd``: ``no_grad``, ``enable_grad``, ``set_grad_enabled``,
``is_grad_enabled``, ``backward`` and ``grad`` with Paddle's arguments
(``retain_graph``, ``create_graph``, ``allow_unused``, ``no_grad_vars``).
``create_graph=True`` works here (the JAX tape raises on it).
"""

from __future__ import annotations

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _as_list(x):
    if x is None:
        return []
    return [x] if isinstance(x, torch.Tensor) else list(x)


def backward(tensors, grad_tensors=None, retain_graph=False):
    """``paddle.autograd.backward``: accumulate into the leaves' ``grad``."""
    tensors = _as_list(tensors)
    grads = (_as_list(grad_tensors) if grad_tensors is not None
             else [None] * len(tensors))
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, without touching any ``.grad``.  ``no_grad_vars`` are
    tensors the gradient does not flow through (treated as constants);
    an input ``outputs`` do not depend on raises unless
    ``allow_unused``, and then gets None."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    grad_outputs = (_as_list(grad_outputs) if grad_outputs is not None
                    else [None] * len(outputs))
    if retain_graph is None:
        retain_graph = create_graph
    # a blocked tensor passes a zero gradient on (a constant)
    hooks = [t.register_hook(torch.zeros_like)
             for t in _as_list(no_grad_vars) if t.requires_grad]
    try:
        got = list(torch.autograd.grad(
            outputs, inputs, grad_outputs, retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=allow_unused))
    finally:
        for h in hooks:
            h.remove()
    if not allow_unused and any(g is None for g in got):
        raise RuntimeError(
            "One of the differentiated tensors appears to not have been "
            "used in the graph. Set allow_unused=True if this is the "
            "desired behavior.")
    return got
