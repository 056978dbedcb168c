"""Layer containers: the port of ``paddle_tpu/nn/container.py`` over
torch's containers, with the JAX package's naming rules.

A ``Sequential`` takes modules (named ``"0"``, ``"1"``, ...), ``(name,
module)`` tuples, or one list of such tuples; a slice of it, or of a
``LayerList``, renumbers from ``"0"`` as the JAX containers do (torch keeps
the old names).  Sub-layers register in the order given, which is the order
of their parameters.
"""

from __future__ import annotations

from torch import nn


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        super().__init__()
        if (len(layers) == 1 and isinstance(layers[0], (list, tuple))
                and layers[0] and isinstance(layers[0][0], tuple)):
            for name, layer in layers[0]:
                self.add_module(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_module(layer[0], layer[1])
                else:
                    self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]


class LayerList(nn.ModuleList):
    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return super().__getitem__(idx)


# torch's ModuleDict and ParameterList have the JAX containers' whole
# surface (a mapping or pairs to ``update``, ``pop``, ``append``, ...)
LayerDict = nn.ModuleDict
ParameterList = nn.ParameterList
