"""``paddle.text.datasets`` of the port: the port of
``paddle_tpu/text/datasets.py`` (``Imikolov``, ``Movielens``, ``WMT14``,
``WMT16``), the JAX package's synthetic corpora drawn from the same numpy
seeds, bit-equal: n-gram windows, rating triples and padded translation
pairs."""

from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset


class Imikolov(Dataset):
    """PTB-style n-gram samples: each item is a window of ``window_size``
    token ids as 1-element arrays (the first ``window_size - 1`` the
    context, the last the target), from a Markov-like stream over a
    2048-word vocabulary."""

    VOCAB = 2048

    def __init__(self, mode="train", data_type="NGRAM", window_size=5,
                 min_word_freq=50, **kwargs):
        n = 8000 if mode == "train" else 1000
        rng = np.random.RandomState(0 if mode == "train" else 1)
        stream = np.zeros(n + window_size, np.int64)
        for i in range(1, len(stream)):
            stream[i] = (stream[i - 1] * 31 + rng.randint(0, 7)) % self.VOCAB
        if data_type.upper() != "NGRAM":
            raise NotImplementedError(
                f"Imikolov data_type={data_type!r}: only NGRAM windows are "
                "implemented (SEQ pairs are not)")
        self._windows = np.lib.stride_tricks.sliding_window_view(
            stream, window_size)[:n]
        self.data_type = data_type

    def __getitem__(self, idx):
        return tuple(np.asarray([t]) for t in self._windows[idx])

    def __len__(self):
        return len(self._windows)


class Movielens(Dataset):
    """``(user features [4], movie features [2], rating [1])`` triples, the
    rating a hash of the user and the movie; the first ``test_ratio`` of
    10000 draws is the test split."""

    N_USERS, N_MOVIES = 943, 1682

    def __init__(self, mode="train", test_ratio=0.1, rand_seed=0, **kwargs):
        rng = np.random.RandomState(rand_seed)
        n_total = 10000
        users = rng.randint(0, self.N_USERS, n_total)
        movies = rng.randint(0, self.N_MOVIES, n_total)
        ratings = ((users * 7 + movies * 13) % 5 + 1).astype(np.float32)
        n_test = int(n_total * test_ratio)
        sl = slice(n_test, None) if mode == "train" else slice(0, n_test)
        self._users = users[sl]
        self._movies = movies[sl]
        self._ratings = ratings[sl]

    def __getitem__(self, idx):
        u = self._users[idx]
        m = self._movies[idx]
        user_feat = np.asarray([u, u % 2, u % 7, u % 21], np.int64)
        movie_feat = np.asarray([m, m % 19], np.int64)
        return user_feat, movie_feat, np.asarray(
            [self._ratings[idx]], np.float32)

    def __len__(self):
        return len(self._ratings)


class _WMTBase(Dataset):
    """Padded ``(src [seq_len], src_len [1], tgt_in [seq_len], tgt_out
    [seq_len], tgt_len [1])`` pairs over 4000-word vocabularies: the
    target is the source reversed and mapped into the target vocabulary,
    ``BOS`` = 0 starts ``tgt_in``, ``EOS`` = 1 pads both sides past the
    length."""

    SRC_VOCAB = 4000
    TGT_VOCAB = 4000
    BOS, EOS = 0, 1

    def __init__(self, mode="train", seq_len=16, seed=0, n=2000):
        rng = np.random.RandomState(seed if mode == "train" else seed + 1)
        n = n if mode == "train" else n // 10
        self._src = rng.randint(2, self.SRC_VOCAB, (n, seq_len)).astype(
            np.int64)
        self._lens = rng.randint(4, seq_len + 1, n)
        self._tgt = np.zeros_like(self._src)
        for i in range(n):
            L = self._lens[i]
            self._tgt[i, :L] = ((self._src[i, :L][::-1] * 3)
                                % (self.TGT_VOCAB - 2) + 2)
            self._src[i, L:] = self.EOS
            self._tgt[i, L:] = self.EOS

    def __getitem__(self, idx):
        L = self._lens[idx]
        tgt_in = np.concatenate([[self.BOS], self._tgt[idx][:-1]])
        return (self._src[idx], np.asarray([L], np.int64),
                tgt_in.astype(np.int64), self._tgt[idx],
                np.asarray([L], np.int64))

    def __len__(self):
        return len(self._src)


class WMT14(_WMTBase):
    """en-fr pairs (synthetic)."""

    def __init__(self, mode="train", dict_size=4000, **kwargs):
        super().__init__(mode=mode, seed=14)


class WMT16(_WMTBase):
    """en-de pairs (synthetic)."""

    def __init__(self, mode="train", src_dict_size=4000, trg_dict_size=4000,
                 lang="en", **kwargs):
        super().__init__(mode=mode, seed=16)
