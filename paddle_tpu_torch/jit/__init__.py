"""``paddle.jit`` of the port: ``to_static`` (see ``api.py``, and
``partial.py`` for the segment replay around a graph break),
``not_to_static``, ``in_to_static_trace``, ``enable_to_static``,
``enable_partial_graph``, ``ignore_module``, and ``save`` / ``load`` of a
compiled program: the port of ``paddle_tpu/jit/__init__.py``.

``jit.save`` exports what the JAX package exports: a function of ``(state
values, *inputs)`` over ``layer.forward`` after ``layer.eval()``, at the
fixed shapes of ``input_spec`` (a ``None`` or negative dim becomes 1, as
in the JAX package: one batch size a program).  Here it is traced by
``torch.export`` (``torch.func.functional_call`` puts the state values in
the layer's place) and written by ``torch.export.save`` to
``<path>.pt2``; the state goes to ``<path>.pdiparams`` in the JAX
package's format, a pickled list of numpy arrays in its ``state_dict``
order (the parameters as ``Layer._walk`` lists them, then the persistent
buffers; linear weights in its ``[in, out]`` layout; bf16 as
``framework.save`` writes it).  The flash forward reaches the exported
graph as the registered ``paddle_tpu_torch::flash_fwd``
(``ops/flash_attention.py::use_flash``), so the loaded program launches
the kernel on the card.

``jit.load`` needs no model class: it returns a :class:`TranslatedLayer`
that runs the deserialized program on the device it was saved from (a
program saved on the card runs on the card), inference only.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List

import numpy as np
import torch

from .api import (  # noqa: F401
    StaticFunction,
    enable_to_static,
    host_scalars,
    in_to_static_trace,
    not_to_static,
    to_static,
)
from .partial import enable_partial_graph  # noqa: F401

_ignored_modules: set = set()

_META = "paddle_tpu_torch.json"


def ignore_module(modules) -> None:
    """Functions defined in these modules are never captured: a direct call
    runs eagerly, and a call from inside a to_static function is a graph
    break of that function (and its trace runs eagerly)."""
    if not isinstance(modules, (list, tuple, set)):
        modules = [modules]
    for m in modules:
        _ignored_modules.add(m.__name__ if hasattr(m, "__name__") else str(m))


def state_order(layer) -> List[str]:
    """The JAX ``Layer.state_dict()``'s key order: the parameters as
    ``Layer._walk`` lists them (breadth first), then the persistent
    buffers in the same walk."""
    from ..convert import paddle_parameter_order

    names = paddle_parameter_order(layer)
    queue, visited = [("", layer)], set()
    while queue:
        prefix, m = queue.pop(0)
        if id(m) in visited:
            continue
        visited.add(id(m))
        for bname, b in m._buffers.items():
            if b is not None and bname not in m._non_persistent_buffers_set:
                names.append(prefix + bname)
        for sname, sub in m._modules.items():
            if sub is not None:
                queue.append((f"{prefix}{sname}.", sub))
    return names


class _Program(torch.nn.Module):
    """``layer.forward`` as a function of ``(state, *inputs)``.  The layer
    is held outside the module tree, so that its tensors are inputs of
    the exported graph and not a second copy inside it."""

    def __init__(self, layer, names):
        super().__init__()
        self._layer = [layer]
        self._names = names

    def forward(self, state, *xs):
        return torch.func.functional_call(
            self._layer[0], dict(zip(self._names, state)), xs)


def _example(spec, device):
    from ..static import InputSpec

    if isinstance(spec, InputSpec):
        shape = [1 if (s is None or s < 0) else s for s in spec.shape]
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    if isinstance(spec, torch.Tensor):
        return torch.zeros_like(spec, device=device)
    raise TypeError(f"unsupported input spec: {spec}")


def save(layer, path: str, input_spec=None, **configs):
    """Export ``layer.forward`` to ``<path>.pt2`` + ``<path>.pdiparams``
    (see the module docstring)."""
    from ..convert import linear_weights
    from ..framework import _host_array

    if input_spec is None:
        raise ValueError("jit.save requires input_spec (the program's "
                         "input shapes are fixed)")
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer")
    layer.eval()
    names = state_order(layer)
    tensors = dict(layer.named_parameters())
    tensors.update(layer.named_buffers())
    state = [tensors[n].detach() for n in names]
    device = state[0].device if state else torch.device("cpu")
    examples = [_example(s, device) for s in input_spec]
    with torch.no_grad():
        program = torch.export.export(_Program(layer, names),
                                      (state, *examples), strict=False)
    # the example inputs (the state among them) would go into the file
    program.example_inputs = None
    linear = linear_weights(layer)
    meta = {"names": names,
            "transposed": [i for i, n in enumerate(names) if n in linear],
            "device": device.type}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path + ".pt2",
                      extra_files={_META: json.dumps(meta)})
    with open(path + ".pdiparams", "wb") as f:
        pickle.dump([_host_array(v.t() if i in meta["transposed"] else v)
                     for i, v in enumerate(state)], f)


class TranslatedLayer:
    """A loaded program (``jit.load``): inference only.

    A program whose inputs and outputs are all the call's own (what
    ``save`` writes) runs its graph module directly on ``(state, *args)``,
    after checking the arguments' shapes and dtypes against the export:
    ``ExportedProgram.module()`` checks every input, the state's hundreds
    of tensors included, in Python at each call (about as long as the
    forward's own host work for a ViT)."""

    def __init__(self, program, state, names):
        from torch.export.graph_signature import InputKind, OutputKind

        self.program = program          # the torch.export ExportedProgram
        self._state = state
        self.names = names
        sig = program.graph_signature
        direct = (all(s.kind == InputKind.USER_INPUT
                      for s in sig.input_specs)
                  and all(s.kind == OutputKind.USER_OUTPUT
                          for s in sig.output_specs))
        self._module = None if direct else program.module()
        placeholders = [n for n in program.graph.nodes
                        if n.op == "placeholder"][len(state):]
        self._args = [(tuple(n.meta["val"].shape), n.meta["val"].dtype)
                      for n in placeholders]

    @property
    def device(self) -> torch.device:
        """Where the program runs: its state's device."""
        return self._state[0].device if self._state else torch.device("cpu")

    def __call__(self, *args):
        with torch.no_grad():
            if self._module is not None:
                return self._module(self._state, *args)
            got = [(tuple(a.shape), a.dtype) for a in args]
            if got != self._args:
                raise ValueError(f"the program takes {self._args}, got "
                                 f"{got}")
            out = self.program.graph_module(*self._state, *args)
            return torch.utils._pytree.tree_unflatten(
                list(out), self.program.call_spec.out_spec)

    def forward(self, *args):
        return self(*args)

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is inference-only")


def load(path: str, **configs) -> TranslatedLayer:
    """The program ``save`` wrote at ``path``, its state on the device it
    was saved from."""
    from .. import framework
    from ..device import resolve_device

    extra = {_META: ""}
    program = torch.export.load(path + ".pt2", extra_files=extra)
    meta = json.loads(extra[_META])
    device = resolve_device(meta["device"])
    with open(path + ".pdiparams", "rb") as f:
        values = framework._finish(framework._Unpickler(f).load(), "cpu")
    state = []
    for i, v in enumerate(values):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        if i in meta["transposed"]:
            t = t.t().contiguous()
        state.append(t.to(device))
    return TranslatedLayer(program, state, meta["names"])
