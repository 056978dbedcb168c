"""``paddle.io`` of the port: datasets, samplers and the DataLoader, with
forked workers over the repo's shared-memory ring (``csrc/shm_ring.cpp``,
built with g++ at first use)."""

from .dataloader import DataLoader, get_worker_info  # noqa: F401
from .dataset import (  # noqa: F401
    ChainDataset,
    ComposeDataset,
    ConcatDataset,
    Dataset,
    IterableDataset,
    Subset,
    TensorDataset,
    random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler,
    DistributedBatchSampler,
    RandomSampler,
    Sampler,
    SequenceSampler,
    SubsetRandomSampler,
    WeightedRandomSampler,
)
