"""Comparison, logical and bitwise ops: the port of
``paddle_tpu/tensor/logic.py``."""

from __future__ import annotations

import torch

from ..core.dispatch import run_op
from ..core.tensor import to_tensor
from .math import _binary, _ensure, _unary

equal = _binary("equal", torch.eq)
not_equal = _binary("not_equal", torch.ne)
greater_than = _binary("greater_than", torch.gt)
greater_equal = _binary("greater_equal", torch.ge)
less_than = _binary("less_than", torch.lt)
less_equal = _binary("less_equal", torch.le)
logical_and = _binary("logical_and", torch.logical_and)
logical_or = _binary("logical_or", torch.logical_or)
logical_xor = _binary("logical_xor", torch.logical_xor)
bitwise_and = _binary("bitwise_and", torch.bitwise_and)
bitwise_or = _binary("bitwise_or", torch.bitwise_or)
bitwise_xor = _binary("bitwise_xor", torch.bitwise_xor)
bitwise_left_shift = _binary("bitwise_left_shift", torch.bitwise_left_shift)
bitwise_right_shift = _binary("bitwise_right_shift",
                              torch.bitwise_right_shift)
logical_not = _unary("logical_not", torch.logical_not)
bitwise_not = _unary("bitwise_not", torch.bitwise_not)


def equal_all(x, y, name=None):
    return run_op("equal_all", _equal_all, _ensure(x), _ensure(y))


def _equal_all(a, b):
    if a.shape != b.shape:
        return torch.zeros((), dtype=torch.bool, device=a.device)
    return torch.all(a == b)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return run_op("isclose", lambda a, b: torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan), _ensure(x),
        _ensure(y))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return run_op("allclose", lambda a, b: torch.all(torch.isclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)), _ensure(x),
        _ensure(y))


def is_empty(x, name=None):
    t = _ensure(x)
    return to_tensor(t.numel() == 0, place=t.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)
