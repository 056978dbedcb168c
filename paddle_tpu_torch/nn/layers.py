"""``Layer``: the port of ``paddle_tpu/nn/layers.py``.

A ``torch.nn.Module`` with the JAX ``Layer``'s surface, so a user's
``class Net(paddle.nn.Layer)`` runs on the port:

* ``create_parameter(shape, attr, dtype, is_bias, default_initializer)``
  with a ``ParamAttr`` (initializer, learning-rate factor as
  ``optimize_attr``, regularizer, ``trainable``, ``need_clip``; not the
  name: a torch tensor's ``name`` is its named-tensor dims) and the
  port's initializers (a weight Xavier-normal, a bias zero by default),
  on ``paddle_tpu_torch.set_device``'s place, else the card;
  ``add_parameter``, ``add_sublayer``, ``register_buffer(persistable=)``,
  ``create_tensor``;
* the JAX walk: ``parameters()``, ``named_parameters()``, ``buffers()``,
  ``sublayers()`` / ``named_sublayers()`` and ``state_dict()`` take the
  layers BREADTH first (``Layer._walk``; torch's own walk is depth
  first), each layer's parameters before its sub-layers', the state
  dict's parameters before its persistent buffers — so keys and order are
  the JAX ``state_dict()``'s;
* ``set_state_dict`` / ``load_dict`` return ``(missing, unexpected)`` and
  copy in place, cast to each target's dtype; a numpy value is a JAX
  package value (``convert.state_from_paddle_tpu``): bf16 as 16-bit
  words, and the weight of one of the port's ``Linear`` layers in
  Paddle's ``[in, out]`` layout;
* ``clear_gradients``, ``register_forward_pre_hook`` (torch's, the same
  contract) and ``register_forward_post_hook`` (torch's forward hook),
  ``to(device, dtype)`` with Paddle's names, ``astype``, ``full_name``.

Any ``nn.Module`` child counts as a sub-layer.  The port's existing
layers keep ``torch.nn.Module`` as their base.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..base.param_attr import ParamAttr
from ..core import dtype as dtype_mod
from ..device import place_device


def walk(module: nn.Module, prefix: str = ""):
    """``(name, layer, name prefix)`` for ``module`` and every module under
    it, breadth first, each once: the JAX ``Layer._walk``."""
    queue: List[Tuple[str, nn.Module]] = [(prefix, module)]
    seen = set()
    while queue:
        name, layer = queue.pop(0)
        if id(layer) in seen:
            continue
        seen.add(id(layer))
        lp = name + "." if name else ""
        yield name, layer, lp
        for sname, sub in layer._modules.items():
            if sub is not None:
                queue.append((lp + sname, sub))


def walk_named(module: nn.Module, store: str = "_parameters",
               prefix: str = "", include_sublayers: bool = True,
               remove_duplicate: bool = True):
    """``(name, tensor)`` for the tensors of ``store`` (``"_parameters"``
    or ``"_buffers"``) in :func:`walk`'s order, each layer's own before its
    sub-layers', a shared tensor once unless ``remove_duplicate=False``."""
    seen = set()
    for _, layer, lp in walk(module, prefix):
        for n, t in getattr(layer, store).items():
            if t is not None and (not remove_duplicate or id(t) not in seen):
                seen.add(id(t))
                yield lp + n, t
        if not include_sublayers:
            break


class Layer(nn.Module):
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._dtype = dtype_mod.convert_dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()

    def __setattr__(self, name: str, value: Any):
        params = self.__dict__.get("_parameters")
        if (params is not None and name in params
                and isinstance(value, torch.Tensor)
                and not isinstance(value, nn.Parameter)):
            # a tensor assigned to a parameter: its value, in place
            with torch.no_grad():
                params[name].copy_(value)
            return
        super().__setattr__(name, value)

    # --- registration ---------------------------------------------------------
    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name: str, tensor, persistable: bool = True,
                        persistent: Optional[bool] = None):
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None):
        """A parameter drawn by ``attr``'s initializer, else
        ``default_initializer``, else zeros (a bias) or Xavier-normal."""
        from .initializer import Constant, XavierNormal

        attr = ParamAttr._to_attr(attr)
        d = dtype_mod.convert_dtype(dtype) or self._dtype
        init = default_initializer
        if attr is not None and attr.initializer is not None:
            init = attr.initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierNormal()
        p = nn.Parameter(init(tuple(int(s) for s in shape), d,
                              place_device()))
        if attr is not None:
            p.optimize_attr = {"learning_rate": attr.learning_rate}
            p.regularizer = attr.regularizer
            p.need_clip = attr.need_clip
            if attr.trainable is False:
                p.requires_grad_(False)
        return p

    def create_tensor(self, name=None, persistable=False, dtype=None):
        d = dtype_mod.convert_dtype(dtype) or self._dtype
        return torch.zeros((), dtype=d, device=place_device())

    # --- the JAX walk ----------------------------------------------------------
    def _walk(self, prefix: str = ""):
        return walk(self, prefix)

    def named_parameters(self, prefix: str = "",
                         include_sublayers: bool = True,
                         recurse: Optional[bool] = None,
                         remove_duplicate: bool = True
                         ) -> Iterator[Tuple[str, nn.Parameter]]:
        inc = include_sublayers if recurse is None else recurse
        return walk_named(self, "_parameters", prefix, inc,
                          remove_duplicate)

    def parameters(self, include_sublayers: bool = True,
                   recurse: Optional[bool] = None) -> List[nn.Parameter]:
        inc = include_sublayers if recurse is None else recurse
        return [p for _, p in self.named_parameters(include_sublayers=inc)]

    def named_buffers(self, prefix: str = "",
                      include_sublayers: bool = True,
                      recurse: Optional[bool] = None,
                      remove_duplicate: bool = True):
        inc = include_sublayers if recurse is None else recurse
        return walk_named(self, "_buffers", prefix, inc, remove_duplicate)

    def buffers(self, include_sublayers: bool = True,
                recurse: Optional[bool] = None):
        inc = include_sublayers if recurse is None else recurse
        return [b for _, b in self.named_buffers(include_sublayers=inc)]

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        for i, (name, layer, _) in enumerate(self._walk(prefix)):
            if i or include_self:
                yield name, layer

    def sublayers(self, include_self: bool = False) -> List[nn.Module]:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def clear_gradients(self, set_to_zero: bool = True):
        for p in self.parameters():
            p.grad = None

    # --- state dict -------------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *,
                   prefix=None, keep_vars=None):
        """The JAX ``state_dict()``: parameters (breadth first), then the
        persistent buffers, the tensors themselves.  Called by a parent
        ``nn.Module`` (with ``prefix`` / ``keep_vars``) it is torch's."""
        if prefix is not None or keep_vars is not None:
            return super().state_dict(destination=destination,
                                      prefix=prefix or "",
                                      keep_vars=bool(keep_vars))
        out = (destination if destination is not None
               else collections.OrderedDict())
        root = structured_name_prefix.rstrip(".")
        for name, p in self.named_parameters(
                prefix=root, include_sublayers=include_sublayers):
            out[name] = p
        for _, layer, lp in self._walk(root):
            skip = getattr(layer, "_non_persistent_buffers_set", set())
            for bname, b in layer._buffers.items():
                if b is not None and bname not in skip:
                    out[lp + bname] = b
            if not include_sublayers:
                break
        return out

    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name: bool = True):
        """Copy ``state_dict`` in; returns ``(missing, unexpected)``."""
        from ..convert import linear_weights

        own = self.state_dict()
        transposed = linear_weights(self)
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    unexpected.append(k)
                    continue
                target = own[k]
                val = _value_for(v, target, k in transposed)
                if tuple(val.shape) != tuple(target.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{tuple(val.shape)} vs "
                                     f"{tuple(target.shape)}")
                target.copy_(val)
        return missing, unexpected

    load_dict = set_state_dict

    # --- dtype, device, hooks -------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, *args, **kwargs):
        if isinstance(device, (str, torch.device)) and not isinstance(
                device, torch.dtype):
            try:
                dtype_mod.convert_dtype(device)
                device, dtype = None, device        # to("float16")
            except (KeyError, TypeError):
                pass
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        if dtype is not None:
            dtype = dtype_mod.convert_dtype(dtype)
            self._dtype = dtype
        if device is not None:
            device = place_device(device)
        return super().to(device=device, dtype=dtype, *args, **kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a non-None return replaces the
        outputs."""
        return self.register_forward_hook(hook)

    def full_name(self):
        return self._name_scope


def _value_for(v, target, paddle_linear):
    """A state value as a tensor for ``target``: a numpy array is a JAX
    package value (bf16 as uint16 words, a ``Linear`` weight ``[in,
    out]``), a tensor the port's own."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=target.device, dtype=target.dtype)
    a = np.asarray(v)
    if a.dtype == np.uint16 and target.dtype == torch.bfloat16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    elif a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if paddle_linear:
        t = t.T
    return t.to(device=target.device, dtype=target.dtype)
