"""Gradient clipping: the port of ``paddle_tpu/nn/clip.py``.

A clip object is called on a list of ``(param, grad)`` pairs and returns a
new list of pairs; the optimizer's ``grad_clip`` calls it in ``step()``
before the per-parameter updates, over the pairs it is about to apply, in
their order.  A pair whose gradient is None, or whose parameter has
``need_clip = False``, passes through unchanged (and a global norm leaves
it out).

The arithmetic is the JAX package's: each gradient's squared norm is
summed in fp32, the global one pair by pair in the list's order, and the
scale ``where(norm > clip_norm, clip_norm / max(norm, 1e-12), 1)`` is a
0-d fp32 tensor that stays on the gradient's device, so a step captured by
``jit.to_static`` clips with no host read.  A gradient is multiplied by it
in fp32 and rounded back to its own dtype.  ``clip_norm / x`` is a true
division (``torch.full_like(x, clip_norm) / x``): torch computes a Python
number over a tensor as a reciprocal and a product, which can differ from
JAX's quotient in the last bit.

At mp > 1 a parameter that is a rank's slice of a tensor-parallel weight
(``parallel/utils.py::mark_sharded``) holds only part of its
gradient: the global norm sums the slices' squares, per mp group, with an
all-reduce over the group, and adds each replicated parameter's once (every
mp rank holds the same copy), so every rank gets the whole model's norm and
the same scale.  A norm taken rank by rank would be short by the other
ranks' slices.

``clip_grad_norm_`` and ``clip_grad_value_`` act on the parameters'
``.grad`` as torch's functions of those names do, with the JAX formulas
(``max_norm / (total + 1e-6)``, capped at 1).  They take a tensor, a list
or any iterable of parameters; a clipped gradient keeps its dtype (torch
requires a parameter's gradient to have the parameter's dtype; the JAX
function leaves a bf16 gradient in fp32).
"""

from __future__ import annotations

import torch


def _skipped(p, g) -> bool:
    return g is None or (hasattr(p, "need_clip") and not p.need_clip)


def _norm_scale(norm, clip_norm):
    """``where(norm > clip_norm, clip_norm / max(norm, 1e-12), 1)``."""
    quotient = torch.full_like(norm, clip_norm) / torch.clamp_min(norm, 1e-12)
    return torch.where(norm > clip_norm, quotient, torch.ones_like(norm))


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def _sum_sq(g):
    return torch.sum(torch.square(g.float()))


def _shard_group(p):
    """The mp group a parameter is a slice over (``parallel/utils.py``'s
    ``mark_sharded``), None for a whole (replicated) one."""
    group = getattr(p, "mp_group", None)
    return group if group is not None and group.nranks > 1 else None


class ClipGradBase:
    def _clip(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _clip(self, params_grads):
        return [(p, g) if _skipped(p, g)
                else (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to an L2 norm of at most ``clip_norm`` on its
    own."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, params_grads):
        return [(p, g) if _skipped(p, g) else
                (p, _scaled(g, _norm_scale(torch.sqrt(_sum_sq(g)),
                                           self.clip_norm)))
                for p, g in params_grads]


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by one factor, so that their global L2 norm is
    at most ``clip_norm``.  ``group_name`` and ``auto_skip_clip`` are
    accepted and unused, as in the JAX package."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def _global_norm_sq(self, params_grads):
        total, sharded = None, {}
        for p, g in params_grads:
            if _skipped(p, g):
                continue
            s = _sum_sq(g)
            group = _shard_group(p)
            if group is not None:
                key = id(group)
                prev = sharded.get(key, (group, None))[1]
                sharded[key] = (group, s if prev is None else prev + s)
                continue
            total = s if total is None else total + s
        for group, s in sharded.values():
            # a slice's squares summed over its group: the whole tensor's
            from ..distributed import collective

            collective.all_reduce(s, group=group)
            total = s if total is None else total + s
        return total

    def _clip(self, params_grads):
        total = self._global_norm_sq(params_grads)
        if total is None:
            return params_grads
        scale = _norm_scale(torch.sqrt(total), self.clip_norm)
        return [(p, g) if _skipped(p, g) else (p, _scaled(g, scale))
                for p, g in params_grads]


def _with_grads(parameters):
    params = ([parameters] if isinstance(parameters, torch.Tensor)
              else list(parameters))
    return [p for p in params if p.grad is not None]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients of ``parameters`` in place by ``min(max_norm /
    (total + 1e-6), 1)``, ``total`` their joint ``norm_type`` norm (the
    largest absolute element for ``inf``); returns ``total`` (None when no
    parameter has a gradient)."""
    params = _with_grads(parameters)
    if not params:
        return None
    if norm_type == float("inf"):
        total = torch.max(torch.stack([torch.max(torch.abs(p.grad))
                                       for p in params]))
    else:
        total = torch.sum(torch.stack(
            [torch.sum(torch.abs(p.grad.float()) ** norm_type)
             for p in params])) ** (1.0 / norm_type)
    denom = total + 1e-6
    scale = torch.clamp_max(torch.full_like(denom, max_norm) / denom, 1.0)
    for p in params:
        p.grad = (p.grad * scale).to(p.grad.dtype)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every gradient of ``parameters`` to ``[-clip_value,
    clip_value]`` in place."""
    for p in _with_grads(parameters):
        p.grad = torch.clamp(p.grad, -clip_value, clip_value)
