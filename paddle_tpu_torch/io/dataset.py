"""Dataset types: the port of ``paddle_tpu/io/dataset.py``.

Pure Python.  ``random_split`` draws its permutation from numpy's global
generator as the JAX function does, so one ``np.random.seed`` gives both
packages the same split; its ``generator`` argument is accepted and
ignored there and here.  ``TensorDataset`` takes numpy arrays or torch
tensors (anything with ``shape[0]`` and indexing).
"""

from __future__ import annotations

import bisect


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lens = {t.shape[0] for t in tensors}
        assert len(lens) == 1, "all tensors must share dim 0"
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert all(len(d) == len(self.datasets[0]) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple)) else [sample])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if di == 0 else self.cumulative_sizes[di - 1]
        return self.datasets[di][idx - start]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    import numpy as np

    if all(isinstance(l, float) for l in lengths):
        total = len(dataset)
        lengths = [int(l * total) for l in lengths]
        lengths[-1] += total - sum(lengths)
    assert sum(lengths) == len(dataset)
    perm = np.random.permutation(len(dataset))
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset : offset + l].tolist()))
        offset += l
    return out
