"""Device resolution for the port's entry points: the card unless the
caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device that is not there raises: the
    port never drops to the CPU on its own — pass ``device="cpu"`` for
    that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


# The tensor API's default place (``paddle.set_device``): where
# ``to_tensor`` and the creation ops put a tensor given no place.  The
# model constructors keep their own ``device=`` argument and never read it.
_current: Optional[str] = None


def set_device(device: str) -> str:
    """``paddle.set_device``: ``"cpu"``, ``"gpu"``, ``"gpu:N"``,
    ``"cuda"`` or ``"cuda:N"``."""
    global _current
    _current = device
    return device


def get_device() -> str:
    """The tensor API's default place, in Paddle's spelling."""
    dev = place_device(None)
    if dev.type == "cpu":
        return "cpu"
    return f"gpu:{dev.index if dev.index is not None else 0}"


def place_device(place=None) -> torch.device:
    """A Paddle place (a string, a torch device, ``None``) as a torch
    device: ``None`` is :func:`set_device`'s choice, else the card."""
    if place is None:
        place = _current
    if isinstance(place, str):
        kind, _, idx = place.partition(":")
        if kind in ("gpu", "cuda"):
            place = f"cuda:{idx}" if idx else "cuda"
    return resolve_device(place)
