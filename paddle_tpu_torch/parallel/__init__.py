"""The port's hybrid-parallel layer: the tensor-parallel layers and the
parallel cross-entropy at any mp degree (:mod:`mp_layers`), the
model-parallel RNG tracker (:mod:`random`), the local-shard helpers
(:mod:`utils`) and the ring-attention entry at sep=1
(:mod:`ring_attention`).  Sequence parallel, pipelines, sharding stages
and MoE are ROADMAP A11."""

from . import mp_layers, random, utils  # noqa: F401
from .mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from .random import (  # noqa: F401
    RNGStatesTracker,
    get_rng_state_tracker,
    model_parallel_random_seed,
)
from .utils import axis_group, axis_rank, axis_size, local_shard  # noqa: F401
