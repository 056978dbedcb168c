"""The port's beam search, sequence functionals and ``text`` held to the
JAX package's on the CPU: the same inputs (from a numpy seed) through
both.

* ``BeamSearchDecoder`` / ``dynamic_decode`` on ``tests/test_nn.py``'s
  table cell (a row full of equal -10.0 logits: ties) and its reordered
  beams, and on a seeded ``LSTMCell`` with an embedding and an output
  layer (one case with fewer tokens than beams, so the first step ranks
  tied -1e9 totals): sequences and lengths equal for K = 1, 3 and 4, batch-
  and time-major.
* ``gather_tree``, ``edit_distance`` (normalised or not, ignored tokens,
  lengths) and ``viterbi_decode`` / ``ViterbiDecoder`` (lengths shorter
  than the sequence, and tied scores) against the JAX functions.
* Every ``text`` dataset bit-equal to the JAX one, both splits.

The seq2seq model through ``Model.fit``: ``tests/test_torch_seq2seq.py``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.text as jtext
from paddle_tpu.nn.decode import gather_tree as jgather_tree
from paddle_tpu_torch import convert, text
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") and not isinstance(
        t, torch.Tensor) else t.detach().cpu().numpy()


# --- beam search --------------------------------------------------------------

V, START, EOS = 6, 0, 5


def _table(reordered=False):
    """``tests/test_nn.py``'s tables: logits of the next token by the
    current one, -10.0 everywhere else."""
    t = np.full((V, V), -10.0, np.float32)
    t[START, 1] = np.log(0.5)
    if reordered:
        t[START, EOS] = np.log(0.4)
    else:
        t[START, 2] = np.log(0.4)
        t[2, 3] = np.log(0.99)
        t[3, EOS] = np.log(0.99)
    t[1, 4] = np.log(0.5)
    t[1, EOS] = np.log(0.5)
    t[4, EOS] = np.log(0.9)
    return t


class _JTableCell(jnn.Layer):
    def __init__(self, table):
        super().__init__()
        self.table = paddle.to_tensor(table)

    def forward(self, tok, state):
        return self.table[tok], state


class _PTableCell(torch.nn.Module):
    def __init__(self, table):
        super().__init__()
        self.table = torch.from_numpy(table)

    def forward(self, tok, state):
        return self.table[tok], state


def _decode(m, cell, state, K, start, end, time_major=False, **fns):
    dec = m.BeamSearchDecoder(cell, start_token=start, end_token=end,
                              beam_size=K, **fns)
    out, _, lens = m.dynamic_decode(dec, inits=state, max_step_num=6,
                                    output_time_major=time_major,
                                    return_length=True)
    return _np(out), _np(lens)


@pytest.mark.parametrize("reordered", [False, True])
@pytest.mark.parametrize("K", [1, 3, 4])
def test_beam_search_on_the_table_cell_matches_jax(K, reordered):
    table = _table(reordered)
    want = _decode(jnn, _JTableCell(table),
                   paddle.to_tensor(np.zeros((2, 8), np.float32)), K, START,
                   EOS)
    got = _decode(nn, _PTableCell(table), torch.zeros(2, 8), K, START, EOS)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if K == 3 and not reordered:
        np.testing.assert_array_equal(got[0][0, 0], [2, 3, EOS])


def _lstm_parts(m, vocab, emb, hidden):
    return (m.Embedding(vocab, emb), m.LSTMCell(emb, hidden),
            m.Linear(hidden, vocab))


@pytest.mark.parametrize("vocab, K, time_major", [
    (7, 1, False), (7, 3, True), (7, 4, False), (3, 4, False)])
def test_beam_search_on_an_lstm_cell_matches_jax(vocab, K, time_major):
    paddle.seed(31)
    jparts = _lstm_parts(jnn, vocab, 4, 8)
    pparts = _lstm_parts(nn, vocab, 4, 8)
    for j, p in zip(jparts, pparts):
        convert.load_paddle_tpu_state(p, {k: _np(v) for k, v in
                                          j.state_dict().items()})
    rng = np.random.default_rng(32)
    h0, c0 = (rng.standard_normal((3, 8)).astype(np.float32)
              for _ in range(2))
    end = vocab - 1
    want = _decode(jnn, jparts[1], [paddle.to_tensor(h0),
                                    paddle.to_tensor(c0)], K, 0, end,
                   time_major, embedding_fn=jparts[0], output_fn=jparts[2])
    with torch.no_grad():
        got = _decode(nn, pparts[1], [torch.from_numpy(h0),
                                      torch.from_numpy(c0)], K, 0, end,
                      time_major, embedding_fn=pparts[0],
                      output_fn=pparts[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_impute_finished_raises_as_in_jax():
    dec = nn.BeamSearchDecoder(_PTableCell(_table()), START, EOS, 2)
    with pytest.raises(NotImplementedError, match="impute_finished"):
        nn.dynamic_decode(dec, inits=torch.zeros(1, 2), impute_finished=True)


# --- sequence functionals -----------------------------------------------------

def test_gather_tree_matches_jax():
    rng = np.random.default_rng(33)
    ids = rng.integers(0, 9, (5, 3, 4))
    parents = rng.integers(0, 4, (5, 3, 4))
    want = _np(jgather_tree(ids, parents))
    np.testing.assert_array_equal(
        F.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents)),
        want)


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_matches_jax(normalized):
    rng = np.random.default_rng(34)
    a = rng.integers(0, 5, (4, 7))
    b = rng.integers(0, 5, (4, 6))
    la, lb = np.array([7, 3, 0, 5]), np.array([6, 6, 2, 1])
    kw = dict(normalized=normalized, ignored_tokens=[4])
    jd, jn = JF.edit_distance(paddle.to_tensor(a), paddle.to_tensor(b),
                              input_length=paddle.to_tensor(la),
                              label_length=paddle.to_tensor(lb), **kw)
    pd_, pn = F.edit_distance(torch.from_numpy(a), torch.from_numpy(b),
                              input_length=torch.from_numpy(la),
                              label_length=torch.from_numpy(lb), **kw)
    np.testing.assert_array_equal(pd_.numpy(), _np(jd))
    np.testing.assert_array_equal(pn.numpy(), _np(jn))
    full = F.edit_distance(torch.from_numpy(a), torch.from_numpy(b))[0]
    np.testing.assert_array_equal(full.numpy(), _np(JF.edit_distance(
        paddle.to_tensor(a), paddle.to_tensor(b))[0]))


@pytest.mark.parametrize("tied", [False, True])
def test_viterbi_decode_matches_jax(tied):
    rng = np.random.default_rng(35)
    if tied:    # small integers: equal path scores, the first max wins
        pot = rng.integers(0, 2, (3, 6, 4)).astype(np.float32)
        trans = rng.integers(0, 2, (4, 4)).astype(np.float32)
    else:
        pot = rng.standard_normal((3, 6, 4)).astype(np.float32)
        trans = rng.standard_normal((4, 4)).astype(np.float32)
    lens = np.array([6, 3, 1], np.int64)
    js, jp = jtext.viterbi_decode(paddle.to_tensor(pot),
                                  paddle.to_tensor(trans),
                                  paddle.to_tensor(lens))
    ps, pp = text.ViterbiDecoder(torch.from_numpy(trans))(
        torch.from_numpy(pot), torch.from_numpy(lens))
    np.testing.assert_allclose(ps.numpy(), _np(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(pp.numpy(), _np(jp))


# --- text datasets ------------------------------------------------------------

@pytest.mark.parametrize("name, kwargs", [
    ("Imdb", dict(mode="train")), ("Imdb", dict(mode="test")),
    ("Conll05st", {}), ("UCIHousing", dict(mode="train")),
    ("UCIHousing", dict(mode="test")), ("Imikolov", dict(mode="train")),
    ("Imikolov", dict(mode="test")), ("Movielens", dict(mode="train")),
    ("Movielens", dict(mode="test")), ("WMT14", dict(mode="train")),
    ("WMT14", dict(mode="test")), ("WMT16", dict(mode="train")),
    ("WMT16", dict(mode="test"))])
def test_text_datasets_are_bit_equal(name, kwargs):
    jd, pd_ = getattr(jtext, name)(**kwargs), getattr(text, name)(**kwargs)
    assert len(pd_) == len(jd)
    for i in sorted({0, 1, len(jd) // 2, len(jd) - 1}
                    | set(range(0, len(jd), max(1, len(jd) // 50)))):
        for a, b in zip(pd_[i], jd[i]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
