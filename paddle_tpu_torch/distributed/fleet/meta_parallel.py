"""``paddle.distributed.fleet.meta_parallel``: the tensor-parallel layers
(implementations in :mod:`paddle_tpu_torch.parallel`).  The pipeline
layers and the sharding stages are ROADMAP A11."""

from ...parallel.mp_layers import (  # noqa: F401
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ...parallel.random import (  # noqa: F401
    get_rng_state_tracker,
    model_parallel_random_seed,
)
