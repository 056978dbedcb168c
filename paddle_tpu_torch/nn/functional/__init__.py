"""Functional ops of the port's ``nn`` subset."""

from .loss import cross_entropy  # noqa: F401
from .norm import rms_norm  # noqa: F401
