"""``paddle.static`` of the port: ``InputSpec``, the port of
``paddle_tpu/static/__init__.py:38``, which ``jit.save`` reads.

``Program``, ``Executor`` and the rest of the JAX package's ``static/``
wait for ROADMAP A12.
"""

from __future__ import annotations

import torch

# the JAX package's dtype names (``core/dtype.py``'s aliases), as torch's
_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
    "fp16": torch.float16, "bf16": torch.bfloat16, "fp32": torch.float32,
    "fp64": torch.float64,
}


def convert_dtype(dtype) -> torch.dtype:
    """A torch dtype from a name (``"float32"``, ``"bf16"``), a torch dtype
    or a numpy dtype."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        import numpy as np

        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"unknown dtype {dtype!r}")
    return _DTYPES[name]


class InputSpec:
    """``paddle.static.InputSpec``: a shape (``None`` or a negative size is
    a dimension left open), a dtype and a name."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=False):
        self.shape = list(shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
