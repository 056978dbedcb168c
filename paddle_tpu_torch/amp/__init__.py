"""``paddle.amp`` of the port: ``auto_cast`` and ``decorate`` at O1 and
O2 (the casts ride the op bus, ``core/dispatch.py``), ``GradScaler`` and
``debugging``."""

import torch

from .auto_cast import (  # noqa: F401
    amp_guard,
    auto_cast,
    black_list,
    decorate,
    white_list,
)
from .grad_scaler import GradScaler  # noqa: F401
from . import debugging  # noqa: F401,E402


def is_bfloat16_supported(device=None):
    """Whether ``device`` (the card when None) computes in bf16."""
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cpu" or (torch.cuda.is_available()
                                 and torch.cuda.is_bf16_supported())


def is_float16_supported(device=None):
    dev = torch.device("cuda" if device is None else device)
    return dev.type == "cpu" or torch.cuda.is_available()
