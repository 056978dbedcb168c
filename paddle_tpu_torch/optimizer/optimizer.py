"""Optimizers: the port of ``paddle_tpu/optimizer/optimizer.py`` for the
training paths (``Optimizer``, ``SGD``, ``Momentum``, ``Adam``,
``AdamW``).

The same surface as the JAX package's: parameter groups (dicts with
``"params"`` and per-group ``learning_rate`` / ``weight_decay``), a
per-parameter ``optimize_attr["learning_rate"]`` scale, ``step``,
``clear_grad``, ``get_lr`` / ``set_lr`` with an ``LRScheduler``, and
``multi_precision`` fp32 master weights for bf16 / fp16 parameters (slots
then live in the master's dtype), and ``state_dict`` / ``set_state_dict``
with the JAX keys: ``"step"`` (the count of ``step`` calls), ``"p{i}/m"``,
``"p{i}/v"``, ``"p{i}/t"`` (a 0-d int32 tensor), ``"p{i}/velocity"`` and
``"p{i}/master"``, where ``i`` is the parameter's position in the list the
optimizer was built on, and ``"LR_Scheduler"`` (the scheduler's own state
dict).  The values are the optimizer's tensors, not copies;
``framework.save`` writes them in the JAX package's file format.  Across
the packages the parameter order and the linear layouts differ:
``convert.optimizer_state_from_paddle_tpu`` / ``..._to_paddle_tpu`` map
them.

A step is two halves.  The host half (``_host_step``) advances the
counters (``step``, each Adam ``t``) and computes the scalars that change
from step to step (the learning rate, Adam's bias corrections, AdamW's
decay factor), each rounded to the weight's dtype as JAX rounds a Python
constant.  It goes through ``jit.host_scalars``, so a step captured by
``jit.to_static`` refills them before every replay.  The device half
updates each weight and its slots in place under ``torch.no_grad()``, one
parameter at a time (a ``torch._foreach_*`` update over all parameters at
once would hold every temporary of the step together, which at full width
is the size of the master weights again), in the JAX order of operations.
Constants (betas, momentum, epsilon, a coupled decay) take the weight's
dtype before they are used (JAX's weak typing), and the bias correction
raises the betas to ``t`` cast to the weight's dtype; the moments are
multiplied by its reciprocal (``_reciprocal``), where JAX divides, which
can differ in the last bit.  In bf16 without
master weights beta2 = bf16(0.999) = 1.0, so ``1 - beta2 ** t`` is 0,
vhat is inf and the Adam step is 0: only the decay moves a bf16 weight, as
in the JAX package.  ``multi_precision=True`` is how bf16 trains.

``weight_decay`` is a float or an ``L2Decay`` (coupled L2 in ``SGD``,
``Momentum`` and ``Adam``; AdamW decays decoupled); ``L1Decay`` raises.
``grad_clip`` (an ``nn.ClipGradBy*``) clips at the start of ``step()``, as
the JAX ``Optimizer.step`` does: over the ``(param, grad)`` pairs about to
be updated, in their order, before the host half; the clip's scale stays
on the device, so a captured step clips with no host read.  The other
optimizers wait for ROADMAP A12.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..jit.api import host_scalars
from ..regularizer import L1Decay, L2Decay
from .lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _as(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX turns a Python constant into the
    array's dtype."""
    return float(torch.tensor(x, dtype=dtype))


def _reciprocal(x: float, dtype) -> float:
    """``1 / x`` rounded to ``dtype`` (``inf`` for 0).  A step divides by a
    host scalar as a product with its reciprocal: on the card torch divides
    a tensor by a Python number that way (one reciprocal, then products),
    and by a tensor truly, so the eager step and a captured one (whose
    scalars are device tensors) agree only if both multiply."""
    return _as(1.0 / x, dtype) if x else float("inf")


class Optimizer:
    # ordered slot names created per parameter
    _slots = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
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
        self._grad_clip = grad_clip
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
        if wd is None:
            return 0.0
        if isinstance(wd, L1Decay):
            raise NotImplementedError(
                "L1Decay as an optimizer's weight_decay is not ported "
                "(ROADMAP A12); pass a float or an L2Decay")
        if isinstance(wd, L2Decay):
            return wd.coeff
        return float(wd)

    @torch.no_grad()
    def step(self):
        items = [(p, attrs) for p, attrs in self._params_with_group_attrs()
                 if p.grad is not None and p.requires_grad]
        grads = [p.grad for p, _ in items]
        if self._grad_clip is not None:
            grads = [g for _, g in self._grad_clip(
                [(p, g) for (p, _), g in zip(items, grads)])]
        scalars = host_scalars(lambda: self._host_step(items))
        for (p, attrs), g, sc in zip(items, grads, scalars):
            self._apply_param(p, g, attrs, sc)

    def _host_step(self, items):
        """The host half of a step over ``items`` (``(param, group
        attrs)``): advance the counters, and return for each parameter the
        ``(value, dtype)`` scalars its update reads."""
        self._step_count += 1
        self._memo = {}          # the step's scalars, shared by parameters
        rows = []
        for p, attrs in items:
            lr = (self.get_lr()
                  * getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
                  * attrs.get("learning_rate", 1.0))
            state = self._state.setdefault(id(p), {})
            if "t" in self._slots:
                state["t"] = state.get("t", 0) + 1
            rows.append(self._scalars(lr, attrs, state, p,
                                      self._weight_dtype(p)))
        return rows

    def _weight_dtype(self, p):
        """The dtype the update runs in: the master's (fp32) or p's."""
        if self._use_master_weights and p.dtype in _LOW_PRECISION:
            return torch.float32
        return p.dtype

    def _cached(self, key, compute):
        """``compute()``, once a step for each ``key`` (most parameters
        share their learning rate and step count)."""
        if key not in self._memo:
            self._memo[key] = compute()
        return self._memo[key]

    def _scalars(self, lr, attrs, state, p, dt):
        """The step's host scalars of one parameter: ``((value, dtype),
        ...)``, read by ``_update`` in that order.  The learning rate in
        the weight's dtype by default."""
        return ((self._cached(("lr", lr, dt), lambda: _as(lr, dt)), dt),)

    def _apply_param(self, p, grad, attrs, sc):
        wd = attrs.get("weight_decay", self._weight_decay)
        state = self._state.setdefault(id(p), {})
        use_master = self._use_master_weights and p.dtype in _LOW_PRECISION
        if use_master and "master" not in state:
            state["master"] = p.detach().to(torch.float32)
        w = state["master"] if use_master else p.detach()
        for name in self._slots:
            if name not in state:
                state[name] = torch.zeros_like(w)
        self._update(w, grad.to(w.dtype), sc, wd, state, p)
        if use_master:
            p.detach().copy_(w)

    def _coupled_decay(self, g, w, wd, p):
        """L2 regularization added to the gradient (SGD, Momentum, Adam)."""
        d = self._decay_value(wd)
        if d and getattr(p, "regularizer", None) is None:
            return g + w * _as(d, w.dtype)
        return g

    def _update(self, w, g, sc, wd, state, p):
        """Update the weight ``w`` (the parameter or its master) and the
        slots in ``state`` in place; ``sc`` are its host scalars (floats,
        or 0-d tensors inside a capture)."""
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


class SGD(Optimizer):
    """``w - lr * (g + decay * w)``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, w, g, sc, wd, state, p):
        (lr,) = sc
        g = self._coupled_decay(g, w, wd, p)
        w.sub_(g * lr)


class Momentum(Optimizer):
    """Heavy-ball momentum with coupled L2 decay (the JAX package's
    ``Momentum``): ``v = momentum v + g``, then ``w - lr v``, or with
    ``use_nesterov`` ``w - lr (g + momentum v)``; the slot ``velocity``."""

    _slots = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _update(self, w, g, sc, wd, state, p):
        (lr,) = sc
        mu = _as(self._momentum, w.dtype)
        g = self._coupled_decay(g, w, wd, p)
        v = state["velocity"]
        v.mul_(mu).add_(g)
        if self._nesterov:
            w.sub_((g + v * mu).mul_(lr))
        else:
            w.sub_(v * lr)


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

    def _scalars(self, lr, attrs, state, p, dt):
        """lr and the reciprocals of the bias corrections ``1 - beta **
        t``, with ``t`` (this step's, advanced by the host step) and the
        betas in w's dtype."""
        def corrections():
            tf = torch.tensor(state["t"], dtype=dt)
            return tuple(_reciprocal(float(1 - torch.tensor(
                _as(beta, dt), dtype=dt) ** tf), dt)
                for beta in (self._beta1, self._beta2))

        inv_bc1, inv_bc2 = self._cached(("bc", state["t"], dt), corrections)
        return super()._scalars(lr, attrs, state, p, dt) + (
            (inv_bc1, dt), (inv_bc2, dt))

    def _adam_moments(self, w, g, state):
        """m, v updated in place."""
        dt = w.dtype
        m, v = state["m"], state["v"]
        m.mul_(_as(self._beta1, dt)).add_(g * _as(1 - self._beta1, dt))
        v.mul_(_as(self._beta2, dt)).add_(
            (g * _as(1 - self._beta2, dt)).mul_(g))

    def _apply_step(self, w, lr, state, inv_bc1, inv_bc2):
        """w -= lr * mhat / (sqrt(vhat) + eps), in the JAX order; mhat and
        vhat by the reciprocals of the bias corrections."""
        denom = torch.sqrt(state["v"] * inv_bc2).add_(_as(self._eps,
                                                         w.dtype))
        w.sub_((state["m"] * inv_bc1).mul_(lr).div_(denom))

    def _update(self, w, g, sc, wd, state, p):
        lr, inv_bc1, inv_bc2 = sc
        g = self._coupled_decay(g, w, wd, p)
        self._adam_moments(w, g, state)
        self._apply_step(w, lr, state, inv_bc1, inv_bc2)


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

    def _scalars(self, lr, attrs, state, p, dt):
        """Adam's, then the decay factor ``1 - lr * decay``."""
        wd = attrs.get("weight_decay")
        decay = self._wd if wd is None else self._decay_value(wd)
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(
                    getattr(p, "name", None) or "")):
            decay = 0.0
        keep = self._cached(("keep", lr, decay, dt),
                            lambda: _as(1 - lr * decay, dt))
        return super()._scalars(lr, attrs, state, p, dt) + ((keep, dt),)

    def _update(self, w, g, sc, wd, state, p):
        lr, inv_bc1, inv_bc2, keep = sc
        self._adam_moments(w, g, state)
        w.mul_(keep)
        self._apply_step(w, lr, state, inv_bc1, inv_bc2)
