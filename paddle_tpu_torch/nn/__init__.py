"""The ``nn`` subset the port's Llama uses."""

from .norm import RMSNorm  # noqa: F401
