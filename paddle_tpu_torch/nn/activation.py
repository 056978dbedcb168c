"""Activation layers: the port of ``paddle_tpu/nn/activation.py``, each a
module over the port's functional of the same name
(``nn/functional/activation.py``).  ``PReLU`` owns its slope ``weight``
(``num_parameters`` values of ``init``); ``RReLU`` draws its slopes from
``generator`` in training."""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from .common import make_parameter
from .initializer import Constant


def _plain(fname):
    """A layer with no argument: ``forward(x) = F.<fname>(x)``."""
    fn = getattr(F, fname)

    class Act(nn.Module):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return fn(x)

    return Act


def _configured(fname, *params):
    """A layer whose constructor takes ``params`` (name, default) and
    passes them on to ``F.<fname>`` as keywords."""
    fn = getattr(F, fname)

    class Act(nn.Module):
        def __init__(self, *args, name=None, **kwargs):
            super().__init__()
            values = dict(params)
            for (key, _), value in zip(params, args):
                values[key] = value
            unknown = set(kwargs) - set(values)
            if unknown:
                raise TypeError(f"unexpected arguments {sorted(unknown)}")
            values.update(kwargs)
            self._kwargs = values
            for key, value in values.items():
                setattr(self, key, value)

        def forward(self, x):
            return fn(x, **self._kwargs)

        def extra_repr(self):
            return ", ".join(f"{k}={v}" for k, v in self._kwargs.items())

    return Act


_LAYERS = {
    "ReLU": _plain("relu"),
    "ReLU6": _plain("relu6"),
    "Sigmoid": _plain("sigmoid"),
    "Tanh": _plain("tanh"),
    "Silu": _plain("silu"),
    "Mish": _plain("mish"),
    "Hardsigmoid": _plain("hardsigmoid"),
    "Hardswish": _plain("hardswish"),
    "Softsign": _plain("softsign"),
    "Tanhshrink": _plain("tanhshrink"),
    "LogSigmoid": _plain("log_sigmoid"),
    "GELU": _configured("gelu", ("approximate", False)),
    "Softmax": _configured("softmax", ("axis", -1)),
    "LogSoftmax": _configured("log_softmax", ("axis", -1)),
    "LeakyReLU": _configured("leaky_relu", ("negative_slope", 0.01)),
    "ELU": _configured("elu", ("alpha", 1.0)),
    "CELU": _configured("celu", ("alpha", 1.0)),
    "SELU": _configured("selu",
                        ("scale", 1.0507009873554804934193349852946),
                        ("alpha", 1.6732632423543772848170429916717)),
    "Hardshrink": _configured("hardshrink", ("threshold", 0.5)),
    "Hardtanh": _configured("hardtanh", ("min", -1.0), ("max", 1.0)),
    "Softplus": _configured("softplus", ("beta", 1.0), ("threshold", 20.0)),
    "Softshrink": _configured("softshrink", ("threshold", 0.5)),
    "ThresholdedReLU": _configured("thresholded_relu", ("threshold", 1.0),
                                   ("value", 0.0)),
    "Maxout": _configured("maxout", ("groups", None), ("axis", 1)),
    "GLU": _configured("glu", ("axis", -1)),
}
for _name, _cls in _LAYERS.items():
    _cls.__name__ = _cls.__qualname__ = _name
    globals()[_name] = _cls
del _name, _cls


class Swish(Silu):  # noqa: F821 (made above)
    pass


class PReLU(nn.Module):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__()
        self.data_format = data_format
        self.weight = make_parameter(weight_attr, Constant(init),
                                     (num_parameters,), dtype, device)

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(nn.Module):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None,
                 generator=None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = generator

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training,
                       generator=self.generator)


class Softmax2D(nn.Module):
    """Softmax over the channel dim of an NCHW input (dim -3)."""

    def forward(self, x):
        return torch.softmax(x, dim=-3)


__all__ = list(_LAYERS) + ["Swish", "PReLU", "RReLU", "Softmax2D"]
