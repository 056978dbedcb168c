"""Dynamic loss scaling for fp16 AMP: the port of
``paddle_tpu/amp/grad_scaler.py``.

The same state machine as the JAX scaler: ``scale`` multiplies the loss by
the scale; ``step`` unscales every gradient, skips the optimizer step when
one of them holds an inf or a NaN, and then grows the scale after
``incr_every_n_steps`` good steps in a row or backs it off after
``decr_every_n_nan_or_inf`` bad ones (never below 1).  As in the JAX
package it scales whenever it is enabled, whatever the AMP dtype: bf16
needs no scaler, so build it with ``enable=False`` there (a pass-through).

Where the update runs: ``unscale_`` reads whether the gradients are finite
on the HOST (one device read for all of them), because the skip and the
scale's growth are host decisions, as in the JAX package.  Inside a
``jit.to_static`` step on the card that read is a graph break: the step
runs eagerly for that signature, with the break's warning.  Keep
``scaler.step(opt)`` / ``scaler.minimize`` outside a captured step, or
train bf16 without a scaler.
"""

from __future__ import annotations

import torch


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._all_params():
            if p.grad is not None:
                p.grad = p.grad * inv
                finite.append(torch.isfinite(p.grad).all())
        # one host read for every gradient: the skip is a host decision
        self._found_inf = bool(finite) and not bool(torch.stack(finite).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()

    def minimize(self, optimizer, loss):
        self.step(optimizer)

    def update(self):
        pass  # the scale moves inside step, as in the JAX scaler

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
            "use_dynamic_loss_scaling": self._dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)
