"""Dtype names and helpers: the port of ``paddle_tpu/core/dtype.py``.

Paddle's dtype names map onto torch dtypes (the JAX package maps them onto
numpy dtypes); ``convert_dtype`` normalises a name, a numpy dtype or a
torch dtype to a torch dtype.  The default dtype lives in the flag
``default_dtype`` as in the JAX package.  ``framework.py``'s bf16 word
helpers stay where they are.
"""

from __future__ import annotations

import numpy as np
import torch

from . import flags

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "bfloat16": bfloat16,
    "float32": float32, "float64": float64, "complex64": complex64,
    "complex128": complex128, "float8_e4m3fn": float8_e4m3fn,
    "float8_e5m2": float8_e5m2,
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
    "half": float16, "float": float32, "double": float64, "int": int32,
    "long": int64, "bool_": bool_,
}
_NAMES = {v: k for k, v in reversed(list(_ALIASES.items()))}

FLOATING = {float16, bfloat16, float32, float64, float8_e4m3fn, float8_e5m2}
INTEGER = {uint8, int8, int16, int32, int64}
COMPLEX = {complex64, complex128}


def convert_dtype(dtype):
    """Any dtype spec (a name, numpy, torch) as a torch dtype; None stays
    None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype in _ALIASES:
            return _ALIASES[dtype]
        if dtype.startswith("paddle."):
            return _ALIASES[dtype[len("paddle."):]]
        return _ALIASES[np.dtype(dtype).name]
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return float32
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise TypeError(f"no torch dtype for {dtype!r}")
    return _ALIASES[name]


def dtype_name(dtype) -> str:
    """The Paddle name of a dtype (``"float32"``, ``"bfloat16"``, ...)."""
    return _NAMES[convert_dtype(dtype)]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in FLOATING


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return d in INTEGER or d == bool_


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in COMPLEX


def get_default_dtype():
    """``paddle.get_default_dtype``: a torch dtype."""
    return convert_dtype(flags.flag("default_dtype"))


def set_default_dtype(dtype) -> None:
    """``paddle.set_default_dtype``; floating dtypes only."""
    d = convert_dtype(dtype)
    if d not in FLOATING:
        raise TypeError(f"default dtype must be floating point, got {d}")
    flags.set_flags({"default_dtype": dtype_name(d)})


def promote_types(a, b):
    """A binary op's result dtype under torch's promotion."""
    return torch.promote_types(convert_dtype(a), convert_dtype(b))


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))
