"""Parallel layers of the port (mp=1)."""

from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)
