"""Places, and ``save`` / ``load`` in the JAX package's file format: the
port of ``paddle_tpu/framework.py``.

The format is a pickle (protocol 4) of nested dicts, lists and tuples whose
tensor leaves are ``{"__tensor__": True, "data": ndarray, "stop_gradient":
bool, "param": bool}``.  ``paddle_tpu.load`` reads what :func:`save`
writes, and :func:`load` reads what ``paddle_tpu.save`` writes.

numpy has no bfloat16.  The JAX package writes a bf16 leaf as an
``ml_dtypes.bfloat16`` array, so its pickle names ``ml_dtypes`` — a
package the port does not need and a card's machine may lack.  So
:func:`load` unpickles through a ``find_class`` that reads such a leaf as
its raw 16-bit words (and any other array as numpy builds it), whether or
not ``ml_dtypes`` is installed; and :func:`save` writes a bf16 tensor's
words under a dtype that unpickles as ``ml_dtypes.bfloat16``, so
``paddle_tpu.load`` gets the JAX package's own bf16 arrays back.

Only unpickle files this program or the JAX package wrote: unpickling runs
the code a file names.
"""

from __future__ import annotations

import importlib
import os
import pickle
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch
from torch import nn

from .device import resolve_device

# numpy's array rebuilder, as its pickles name it (numpy.core.multiarray or
# numpy._core.multiarray, by numpy's version)
_RECONSTRUCT = np.empty(0).__reduce__()[0]
_MULTIARRAY = ("numpy.core.multiarray", "numpy._core.multiarray")


class Place:
    def __init__(self, id=0):
        self.id = id

    def __repr__(self):
        return f"{type(self).__name__}({self.id})"


class CPUPlace(Place):
    pass


class CUDAPlace(Place):
    pass


class TPUPlace(Place):
    pass


class CUDAPinnedPlace(Place):
    pass


# --- writing -----------------------------------------------------------------

class _MlDtypes:
    """Unpickles as the ``ml_dtypes`` module (imported by the reader)."""

    def __reduce__(self):
        return importlib.import_module, ("ml_dtypes",)


class _Bfloat16Type:
    """Unpickles as ``ml_dtypes.bfloat16``."""

    def __reduce__(self):
        return getattr, (_MlDtypes(), "bfloat16")


class _Bfloat16Dtype:
    """Unpickles as ``numpy.dtype(ml_dtypes.bfloat16)``."""

    def __reduce__(self):
        return np.dtype, (_Bfloat16Type(), False, True)


class _Bfloat16Array:
    """A bf16 tensor's 16-bit words; unpickles as an ndarray of dtype
    ``ml_dtypes.bfloat16`` with those bits, as numpy pickles one."""

    def __init__(self, words: np.ndarray):
        self.words = np.ascontiguousarray(words)

    def __reduce__(self):
        w = self.words
        return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                (1, w.shape, _Bfloat16Dtype(), False, w.tobytes()))


def _host_array(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _Bfloat16Array(t.contiguous().view(torch.int16).numpy())
    return t.numpy()


def _to_saveable(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": _host_array(obj),
                "stop_gradient": not obj.requires_grad,
                "param": isinstance(obj, nn.Parameter)}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **kwargs):
    """``paddle.save``: ``obj`` (nested dicts / lists / tuples of tensors,
    numpy arrays and Python values) to ``path`` in the JAX package's
    format.  Tensors are copied to the host."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_saveable(obj), f, protocol=protocol)


# --- reading -----------------------------------------------------------------

class _Bfloat16:
    """What ``ml_dtypes.bfloat16`` reads as."""


def _dtype(obj, align=False, copy=False):
    if obj is _Bfloat16:
        return _Bfloat16DtypeState()
    return np.dtype(obj, align, copy)


class _Bfloat16DtypeState:
    """The bf16 dtype while the pickle builds it (its state is dropped)."""

    def __setstate__(self, state):
        pass


class _ArrayState:
    """An ndarray while the pickle builds it; :func:`_finish` turns it
    into numpy's array, or into raw words when its dtype is bf16."""

    def __init__(self, *args):
        self.args = args
        self.state = None

    def __setstate__(self, state):
        self.state = state

    def finish(self):
        _, shape, dtype, fortran, raw = self.state
        if isinstance(dtype, _Bfloat16DtypeState):
            words = np.frombuffer(raw, dtype=np.int16)
            return _Words(words.reshape(shape, order="F" if fortran else "C"))
        a = _RECONSTRUCT(*self.args)
        a.__setstate__(self.state)
        return a


class _Words:
    """A bf16 array as its raw 16-bit words (``int16``)."""

    def __init__(self, words):
        self.words = words

    def tensor(self):
        return torch.from_numpy(np.array(self.words)).view(torch.bfloat16)


def _import_module(name):
    if name == "ml_dtypes":
        return SimpleNamespace(bfloat16=_Bfloat16)
    return importlib.import_module(name)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bfloat16
        if (module, name) == ("importlib", "import_module"):
            return _import_module
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if module in _MULTIARRAY and name == "_reconstruct":
            return _ArrayState
        return super().find_class(module, name)


def _finish(obj: Any, device) -> Any:
    """The loaded tree with every array finished and every tensor leaf a
    torch tensor on ``device``."""
    if isinstance(obj, _ArrayState):
        obj = obj.finish()
    if isinstance(obj, _Words):
        return obj.tensor().to(device)
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return _leaf(obj, device)
        return {k: _finish(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_finish(v, device) for v in obj)
    return obj


def _leaf(obj, device):
    data = obj["data"]
    if isinstance(data, _ArrayState):
        data = data.finish()
    t = (data.tensor() if isinstance(data, _Words)
         else torch.from_numpy(np.array(data))).to(device)
    trainable = not obj.get("stop_gradient", not obj.get("param"))
    if obj.get("param"):
        return nn.Parameter(t, requires_grad=trainable)
    if trainable and t.is_floating_point():
        t.requires_grad_(True)
    return t


def load(path: str, device=None, **kwargs) -> Any:
    """``paddle.load``: the object :func:`save` or ``paddle_tpu.save``
    wrote, with each tensor leaf a torch tensor on ``device`` (the card
    unless ``device="cpu"``): an ``nn.Parameter`` where the leaf was a
    parameter, trainable unless it was saved with ``stop_gradient``."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        return _finish(_Unpickler(f).load(), dev)
