"""Normalisation layers (the port of ``paddle_tpu/nn/norm.py::RMSNorm``)."""

from __future__ import annotations

import torch
from torch import nn

from .functional.norm import rms_norm


class RMSNorm(nn.Module):
    """Root-mean-square norm with a learned per-channel ``weight`` (ones at
    construction), created directly on ``device``."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
