"""Functional ops of the port's ``nn`` subset."""

from .norm import rms_norm  # noqa: F401
