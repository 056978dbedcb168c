"""``paddle.text`` of the port: the port of ``paddle_tpu/text`` (the
datasets and Viterbi decoding).

Nothing is downloaded: each dataset is the JAX package's deterministic
synthetic corpus, drawn from the same numpy seeds in the same order, so
its samples are bit-equal to the JAX dataset's (numpy arrays, as there).

``viterbi_decode`` is the JAX scan as a loop over time on the potentials'
device: the best previous tag by a first-max ``argmax``, a step past a
sequence's length leaving its scores as they were and recording identity
back-pointers, so the walk back from the last step keeps the tag chosen
at ``length - 1``.  ``include_bos_eos_tag`` is accepted and unused, as in
the JAX package.  Paths are int64 (the JAX package's are int32).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..io.dataset import Dataset


class Imdb(Dataset):
    """IMDB sentiment: ``(token ids, label)``, 256 train / 64 test
    documents of 16-127 tokens over a 5000-word vocabulary."""

    def __init__(self, data_file: Optional[str] = None, mode: str = "train",
                 cutoff: int = 150, seed: int = 0):
        rng = np.random.default_rng(seed + (0 if mode == "train" else 1))
        n = 256 if mode == "train" else 64
        self.vocab_size = 5000
        lengths = rng.integers(16, 128, n)
        self.docs = [rng.integers(2, self.vocab_size, l).astype("int64")
                     for l in lengths]
        self.labels = rng.integers(0, 2, n).astype("int64")

    def word_idx(self):
        return {f"w{i}": i for i in range(self.vocab_size)}

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i], self.labels[i]


class Conll05st(Dataset):
    """Semantic role labelling: ``(token ids, tag ids)``, 128 sentences of
    8-39 tokens, 19 tags."""

    def __init__(self, mode: str = "train", seed: int = 0):
        rng = np.random.default_rng(seed)
        n = 128
        self.n_labels = 19
        lengths = rng.integers(8, 40, n)
        self.sents = [rng.integers(0, 5000, l).astype("int64")
                      for l in lengths]
        self.labels = [rng.integers(0, self.n_labels, l).astype("int64")
                       for l in lengths]

    def __len__(self):
        return len(self.sents)

    def __getitem__(self, i):
        return self.sents[i], self.labels[i]


class UCIHousing(Dataset):
    """13-feature regression: ``(features [13], target [1])``, 404 train /
    102 test rows."""

    def __init__(self, data_file=None, mode="train", seed=0):
        rng = np.random.default_rng(seed + (0 if mode == "train" else 1))
        n = 404 if mode == "train" else 102
        self.x = rng.standard_normal((n, 13)).astype("float32")
        w = rng.standard_normal(13).astype("float32")
        self.y = (self.x @ w + 0.1 * rng.standard_normal(n)).astype("float32")

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], np.asarray([self.y[i]], "float32")


class ViterbiDecoder:
    """CRF Viterbi decoding with fixed ``transitions`` ``[N, N]``."""

    def __init__(self, transitions, include_bos_eos_tag: bool = True,
                 name=None):
        self.transitions = torch.as_tensor(transitions)
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


def viterbi_decode(potentials, transition_params, lengths,
                   include_bos_eos_tag: bool = True, name=None):
    """Batched Viterbi: potentials ``[B, T, N]``, transitions ``[N, N]``
    (``[from, to]``), lengths ``[B]`` -> (best scores ``[B]``, tag paths
    ``[B, T]``)."""
    p = torch.as_tensor(potentials)
    tr = torch.as_tensor(transition_params).to(p.device)
    ln = torch.as_tensor(lengths).to(p.device)
    N = p.shape[2]
    ident = torch.arange(N, device=p.device)[None, :]
    alpha, backs = p[:, 0], []
    for t in range(1, p.shape[1]):
        scores = alpha[:, :, None] + tr[None] + p[:, t][:, None, :]
        keep = (t < ln)[:, None]
        alpha = torch.where(keep, scores.max(dim=1).values, alpha)
        backs.append(torch.where(keep, scores.argmax(dim=1), ident))
    score = alpha.max(dim=-1).values
    tag = alpha.argmax(dim=-1)
    path = [tag]
    for back_t in reversed(backs):
        tag = back_t.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    return score, torch.stack(path[::-1], dim=1)


from .datasets import WMT14, WMT16, Imikolov, Movielens  # noqa: F401,E402
