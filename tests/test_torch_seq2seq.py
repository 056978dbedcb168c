"""PaddleNLP's seq2seq attention model (``chip_smoke.py``'s
``seq2seq_model``, small) held to the same model written over the JAX
package, on the CPU, from the JAX model's weights: through ``Model.fit``
on ``text.WMT16`` with Adam and ``ClipGradByGlobalNorm`` every step's
loss within 1e-5 relative of the JAX ``fit``'s; then beam search (K=3)
over the test split, sequences and lengths equal, with the trained
weights and with the initial ones (whose beams run every step).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.text as jtext
from paddle_tpu.hapi.callbacks import Callback as JCallback
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, text
from paddle_tpu_torch import nn
from paddle_tpu_torch.hapi.callbacks import Callback as PCallback
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Adam


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_model", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


HID, LAYERS, B, N = 16, 2, 8, 16


class _JAttention(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.input_proj = jnn.Linear(HID, HID, bias_attr=False)
        self.output_proj = jnn.Linear(2 * HID, HID, bias_attr=False)

    def forward(self, h, encoder_output, mask):
        enc = self.input_proj(encoder_output)
        scores = paddle.matmul(h.unsqueeze(1), enc, transpose_y=True) + mask
        out = paddle.matmul(JF.softmax(scores, axis=-1), enc).squeeze(1)
        return self.output_proj(paddle.concat([out, h], 1))


class _JDecoderCell(jnn.RNNCellBase):
    def __init__(self):
        super().__init__()
        self.hidden_size = HID
        self.dropout = jnn.Dropout(0.0)
        self.lstm_cells = jnn.LayerList([
            jnn.LSTMCell(2 * HID if i == 0 else HID, HID)
            for i in range(LAYERS)])
        self.attention_layer = _JAttention()
        self.memory = None

    def forward(self, step_input, states):
        step_input = paddle.concat([step_input, states[-1]], 1)
        new = []
        for i, cell in enumerate(self.lstm_cells):
            out, (h, c) = cell(step_input, (states[2 * i], states[2 * i + 1]))
            step_input = self.dropout(out)
            new += [h, c]
        out = self.attention_layer(step_input, *self.memory)
        return out, (*new, out)


class _JEncoder(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.embedder = jnn.Embedding(cs.S2S_VOCAB, HID)
        self.lstm = jnn.LSTM(HID, HID, num_layers=LAYERS)

    def forward(self, src, src_len):
        return self.lstm(self.embedder(src), sequence_length=src_len)


class _JDecoder(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.embedder = jnn.Embedding(cs.S2S_VOCAB, HID)
        self.lstm_attention = jnn.RNN(_JDecoderCell())
        self.output_layer = jnn.Linear(HID, cs.S2S_VOCAB, bias_attr=False)

    def forward(self, trg, states):
        out, _ = self.lstm_attention(self.embedder(trg), initial_states=states)
        return self.output_layer(out)


class _JSeq2Seq(jnn.Layer):
    """The JAX package's rendering of ``chip_smoke.seq2seq_model``."""

    def __init__(self):
        super().__init__()
        self.encoder = _JEncoder()
        self.decoder = _JDecoder()

    def encode(self, src, src_len):
        enc_out, (h, c) = self.encoder(src, src_len)
        cell = self.decoder.lstm_attention.cell
        states = tuple(t for i in range(LAYERS) for t in (h[i], c[i]))
        states += (cell.get_initial_states(enc_out),)
        mask = ((src != cs.S2S_EOS).astype("float32") - 1.0) * 1e9
        return enc_out, mask.unsqueeze(1), states

    def forward(self, src, src_len, trg):
        enc_out, mask, states = self.encode(src, src_len)
        cell = self.decoder.lstm_attention.cell
        cell.memory = (enc_out, mask)
        logits = self.decoder(trg, states)
        cell.memory = None
        return logits


def _jax_loss(logits, label):
    n = (label != cs.S2S_EOS).astype("int64").sum(axis=1, keepdim=True)
    mask = (paddle.arange(label.shape[1]) <= n).astype("float32")
    cost = JF.cross_entropy(logits, label.unsqueeze(-1), reduction="none")
    return (cost * mask).mean(axis=0).sum()


def _pairs(base, wmt):
    class Pairs(base):
        """WMT16 as Model.fit reads it: the inputs, then the label."""

        def __len__(self):
            return N

        def __getitem__(self, i):
            return wmt[i][:4]

    return Pairs()


def _recorder(base):
    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

    return Recorder()


@pytest.fixture(scope="module")
def seq2seq_fit():
    paddle.seed(36)
    jm = _JSeq2Seq()
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    model = paddle.Model(jm)
    model.prepare(paddle.optimizer.Adam(
        learning_rate=1e-3, parameters=jm.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(0.5)), _jax_loss)
    rec = _recorder(JCallback)
    model.fit(_pairs(paddle.io.Dataset, jtext.WMT16()), batch_size=B,
              epochs=1, shuffle=False, verbose=0, callbacks=[rec])
    return state, rec.losses, jm


def test_seq2seq_fit_losses_match_jax(seq2seq_fit):
    state, want, jm = seq2seq_fit
    net = cs.seq2seq_model(torch, nn, F, cs.S2S_VOCAB, HID, LAYERS,
                           device="cpu")
    convert.load_paddle_tpu_state(net, state)
    model = pt.Model(net)
    model.prepare(Adam(learning_rate=1e-3, parameters=net.parameters(),
                       grad_clip=nn.ClipGradByGlobalNorm(0.5)),
                  cs.seq2seq_loss(torch, F))
    rec = _recorder(PCallback)
    model.fit(_pairs(pt.io.Dataset, text.WMT16()), batch_size=B, epochs=1,
              shuffle=False, verbose=0, callbacks=[rec])
    assert len(rec.losses) == len(want) == N // B
    np.testing.assert_allclose(rec.losses, want, rtol=1e-5)
    # beam searches (K=3) over the test split agree, with the trained
    # weights and with the initial ones (whose beams run every step)
    src, src_len = (np.stack([text.WMT16("test")[i][k] for i in range(4)])
                    for k in (0, 1))
    net.eval()
    for weights in ("trained", "initial"):
        if weights == "initial":
            jm.set_state_dict({k: paddle.to_tensor(v)
                               for k, v in state.items()})
            convert.load_paddle_tpu_state(net, state)
        enc_out, mask, states = jm.encode(paddle.to_tensor(src),
                                          paddle.to_tensor(src_len))
        cell = jm.decoder.lstm_attention.cell
        cell.memory = (paddle.repeat_interleave(enc_out, 3, axis=0),
                       paddle.repeat_interleave(mask, 3, axis=0))
        jdec = jnn.BeamSearchDecoder(cell, cs.S2S_BOS, cs.S2S_EOS, 3,
                                     embedding_fn=jm.decoder.embedder,
                                     output_fn=jm.decoder.output_layer)
        jseqs, (_, jscores, _), jlens = jnn.dynamic_decode(
            jdec, inits=states, max_step_num=5, return_length=True)
        with torch.no_grad():
            seqs, lens, scores = cs.seq2seq_beam_search(
                nn, net, torch.from_numpy(src), torch.from_numpy(src_len), 3,
                5)
            # the teacher-forced rescoring chip_smoke holds the card's
            # beams to
            forced = cs.beam_scores(torch, net, torch.from_numpy(src),
                                    torch.from_numpy(src_len), seqs)
        np.testing.assert_array_equal(seqs.numpy(), _np(jseqs))
        np.testing.assert_array_equal(lens.numpy(), _np(jlens))
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                                   rtol=1e-5)
        np.testing.assert_allclose(forced.numpy(), scores.numpy(),
                                   rtol=1e-5)
    assert seqs.shape[-1] == 5          # the initial weights' beams run on
