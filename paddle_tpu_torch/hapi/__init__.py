"""The port's high-level API: ``Model`` (``prepare`` / ``fit`` /
``evaluate`` / ``predict``), its callbacks, ``summary`` and ``flops``."""

from .model import Model  # noqa: F401
from .summary import flops, summary  # noqa: F401
