"""``Tensor`` and ``to_tensor``: the port of ``paddle_tpu/core/tensor.py``.

The port's ``Tensor`` IS ``torch.Tensor`` and its ``Parameter`` is
``torch.nn.Parameter``: torch's autograd is the tape and torch's views are
the views (``x[np.int64(0)]`` is a write-back view, the contract the JAX
``Tensor`` documents).  The JAX ``Tensor`` methods that ``torch.Tensor``
lacks are added by ``paddle_tpu_torch.tensor`` (never replacing an
attribute torch has); the methods both have keep TORCH's meaning, and
Paddle's is reached through the module functions
(``paddle_tpu_torch.transpose(x, perm)``, ``reshape``, ``split``, ``max``
...) — ROADMAP C10.

``to_tensor`` puts data on ``place`` (``"cpu"``, ``"gpu:0"``, a torch
device); without one, on ``paddle_tpu_torch.set_device``'s choice, else the
card.  As in the JAX package, Python and float64 numpy floats become the
default dtype, the data is copied, and ``stop_gradient=True`` gives a
tensor that does not require grad.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import place_device
from . import dtype as dtype_mod
from .dispatch import run_op

Tensor = torch.Tensor
Parameter = torch.nn.Parameter


def _leaves(data):
    if isinstance(data, (list, tuple)):
        out = []
        for d in data:
            out.extend(_leaves(d))
        return out
    return [data]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``."""
    d = dtype_mod.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        dev = data.device if place is None else place_device(place)
        out = data.detach().to(device=dev, dtype=d, copy=True)
    else:
        if (isinstance(data, (list, tuple)) and data
                and any(isinstance(x, torch.Tensor) for x in _leaves(data))):
            data = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                    else x for x in data]
        arr = np.array(data)
        if d is None and arr.dtype == np.float64:
            d = dtype_mod.get_default_dtype()
        if arr.dtype == np.uint16 and d == torch.bfloat16:
            # bf16 carried as its 16-bit words (framework.py's convention)
            out = torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
            out = out.to(place_device(place), copy=True)
        else:
            out = torch.tensor(arr, device=place_device(place))
            if d is not None:
                out = out.to(d)
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_(True)
    return out


def getitem(x, idx):
    """``x[idx]`` as the op ``getitem`` (the JAX ``Tensor.__getitem__``;
    a basic index is a view, as torch's)."""
    return run_op("getitem", _getitem, x, idx)


def _getitem(v, idx):
    return v[idx]
