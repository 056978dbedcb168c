"""Optimizers: the port of ``paddle_tpu/optimizer/optimizer.py`` for the
training path (``Optimizer``, ``Adam``, ``AdamW``).

The same surface as the JAX package's: parameter groups (dicts with
``"params"`` and per-group ``learning_rate`` / ``weight_decay``), a
per-parameter ``optimize_attr["learning_rate"]`` scale, ``step``,
``clear_grad``, ``get_lr`` / ``set_lr`` with an ``LRScheduler``, and
``multi_precision`` fp32 master weights for bf16 / fp16 parameters (moments
then live in the master's dtype), and ``state_dict`` / ``set_state_dict``
with the JAX keys: ``"step"`` (the count of ``step`` calls), ``"p{i}/m"``,
``"p{i}/v"``, ``"p{i}/t"`` (a 0-d int32 tensor) and ``"p{i}/master"``,
where ``i`` is the parameter's position in the list the optimizer was
built on, and ``"LR_Scheduler"`` (the scheduler's own state dict).  The
values are the optimizer's tensors, not copies; ``framework.save`` writes
them in the JAX package's file format.  Across the packages the
parameter order and the linear layouts differ:
``convert.optimizer_state_from_paddle_tpu`` / ``..._to_paddle_tpu`` map
them.

The updates are plain torch ops (XLA code in the JAX package), in place
under ``torch.no_grad()``, one parameter at a time: a ``torch._foreach_*``
update over all parameters at once would hold every temporary of the step
together, which at full width is the size of the master weights again.
They round as the JAX package does: every Python constant takes the
weight's dtype before it is used (JAX's weak typing), and the bias
correction raises the betas to ``t`` cast to the weight's dtype.  In bf16
without master weights beta2 = bf16(0.999) = 1.0, so ``1 - beta2 ** t`` is
0, vhat is inf and the Adam step is 0: only the decay moves a bf16 weight,
as in the JAX package.  ``multi_precision=True`` is how bf16 trains.
``grad_clip`` and the other optimizers wait for ROADMAP A12.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _as(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX turns a Python constant into the
    array's dtype."""
    return float(torch.tensor(x, dtype=dtype))


class Optimizer:
    # ordered slot names created per parameter
    _slots = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if grad_clip is not None:
            raise NotImplementedError(
                "gradient clipping is not ported yet (ROADMAP A12); build "
                "the optimizer without grad_clip")
        self._lr = learning_rate
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._param_groups = None
        if self._parameter_list and isinstance(self._parameter_list[0], dict):
            self._param_groups = self._parameter_list
            flat = []
            for g in self._param_groups:
                flat.extend(g["params"])
            self._parameter_list = flat
        self._weight_decay = weight_decay
        self._state: Dict[int, Dict[str, object]] = {}
        self._step_count = 0
        self._use_master_weights = False

    # --- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    def set_lr(self, value):
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = value

    # --- params -----------------------------------------------------------
    def _all_params(self) -> List[torch.nn.Parameter]:
        if self._parameter_list is None:
            raise ValueError("optimizer constructed without parameters")
        return self._parameter_list

    def _params_with_group_attrs(self):
        if self._param_groups is None:
            for p in self._all_params():
                yield p, {}
        else:
            for g in self._param_groups:
                attrs = {k: v for k, v in g.items() if k != "params"}
                for p in g["params"]:
                    yield p, attrs

    # --- step -------------------------------------------------------------
    @staticmethod
    def _decay_value(wd):
        return 0.0 if wd is None else float(wd)

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad, attrs)
                        for p, attrs in self._params_with_group_attrs()
                        if p.grad is not None and p.requires_grad]
        self._step_count += 1
        for p, g, attrs in params_grads:
            self._apply_param(p, g, attrs)

    def _apply_param(self, p, grad, attrs):
        lr = (self.get_lr()
              * getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
              * attrs.get("learning_rate", 1.0))
        wd = attrs.get("weight_decay", self._weight_decay)
        state = self._state.setdefault(id(p), {})
        use_master = self._use_master_weights and p.dtype in _LOW_PRECISION
        if use_master and "master" not in state:
            state["master"] = p.detach().to(torch.float32)
        w = state["master"] if use_master else p.detach()
        for name in self._slots:
            if name not in state:
                state[name] = 0 if name == "t" else torch.zeros_like(w)
        self._update(w, grad.to(w.dtype), lr, wd, state, p)
        if use_master:
            p.detach().copy_(w)

    def _update(self, w, g, lr, wd, state, p):
        """Update the weight ``w`` (the parameter or its master) and the
        slots in ``state`` in place."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._all_params():
            p.grad = None

    # --- state dict -------------------------------------------------------
    def state_dict(self):
        out = {"step": self._step_count}
        names = {id(p): f"p{i}" for i, p in enumerate(self._all_params())}
        for key, st in self._state.items():
            for k, v in st.items():
                if k == "t":     # a Python int here, an int32 scalar there
                    v = torch.tensor(v, dtype=torch.int32)
                out[f"{names.get(key, key)}/{k}"] = v
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        """Load a ``state_dict`` of either package (tensors, or numpy arrays
        as the JAX package's ``state_dict`` values read back), copying each
        slot onto its parameter's device.  Keys of parameters the optimizer
        does not have are skipped, as in the JAX package."""
        self._step_count = int(state.get("step", 0))
        params = {f"p{i}": p for i, p in enumerate(self._all_params())}
        for k, v in state.items():
            if k in ("step", "LR_Scheduler"):
                continue
            pname, sname = k.split("/", 1)
            p = params.get(pname)
            if p is None:
                continue
            val = torch.as_tensor(v)
            slot = (int(val) if sname == "t" else
                    val.detach().to(p.device, copy=True))
            self._state.setdefault(id(p), {})[sname] = slot
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])


class Adam(Optimizer):
    _slots = ("m", "v", "t")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._use_master_weights = multi_precision

    def _adam_moments(self, w, g, state):
        """t += 1; m, v updated in place; returns the bias corrections
        ``1 - beta ** t`` with ``t`` and the betas in w's dtype."""
        dt = w.dtype
        state["t"] += 1
        m, v = state["m"], state["v"]
        b1, b2 = _as(self._beta1, dt), _as(self._beta2, dt)
        m.mul_(b1).add_(g * _as(1 - self._beta1, dt))
        v.mul_(b2).add_((g * _as(1 - self._beta2, dt)).mul_(g))
        tf = torch.tensor(state["t"], dtype=dt)
        bc1 = float(1 - torch.tensor(b1, dtype=dt) ** tf)
        bc2 = float(1 - torch.tensor(b2, dtype=dt) ** tf)
        return bc1, bc2

    def _apply_step(self, w, lr, state, bc1, bc2):
        """w -= lr * mhat / (sqrt(vhat) + eps), in the JAX order."""
        dt = w.dtype
        denom = torch.sqrt(state["v"] / bc2).add_(_as(self._eps, dt))
        w.sub_((state["m"] / bc1).mul_(_as(lr, dt)).div_(denom))

    def _update(self, w, g, lr, wd, state, p):
        d = self._decay_value(wd)
        if d and getattr(p, "regularizer", None) is None:
            g = g + w * _as(d, w.dtype)     # coupled L2 decay
        bc1, bc2 = self._adam_moments(w, g, state)
        self._apply_step(w, lr, state, bc1, bc2)


class AdamW(Adam):
    """Decoupled weight decay (the ``adamw_kernel`` analog)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision, name)
        self._wd = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, w, g, lr, wd, state, p):
        decay = self._wd if wd is None else self._decay_value(wd)
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(
                    getattr(p, "name", None) or "")):
            decay = 0.0
        bc1, bc2 = self._adam_moments(w, g, state)
        w.mul_(_as(1 - lr * decay, w.dtype))
        self._apply_step(w, lr, state, bc1, bc2)
