"""Optimizers and learning-rate schedulers of the port's training paths."""

from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer  # noqa: F401
