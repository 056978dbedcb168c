"""``paddle.amp`` of the port: ``auto_cast`` at O1, ``decorate`` and
``GradScaler`` (``debugging`` and O2 wait for ROADMAP A13's rest and
A12)."""

import torch

from .auto_cast import (  # noqa: F401
    amp_guard,
    auto_cast,
    black_list,
    decorate,
    white_list,
)
from .grad_scaler import GradScaler  # noqa: F401


def is_bfloat16_supported(device=None):
    """Whether ``device`` (the card when None) computes in bf16."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cpu" or (torch.cuda.is_available()
                                 and torch.cuda.is_bf16_supported())


def is_float16_supported(device=None):
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cpu" or torch.cuda.is_available()
