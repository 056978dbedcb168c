"""Recurrent layers: the port of ``paddle_tpu/nn/rnn.py``.

The cells (``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``) take one step;
``RNN`` runs a cell over a sequence one timestep at a time and ``BiRNN``
runs two, forward and reversed; ``LSTM``, ``GRU`` and ``SimpleRNN``
(``_RNNBase``) stack layers of one or two directions.  Every step is torch
ops in the JAX order of arithmetic: gates i, f, g, o for the LSTM and r, z,
g for the GRU; ``x @ W_ih^T + h @ W_hh^T + b_ih + b_hh`` summed left to
right; the GRU's candidate ``tanh(x_g + r * h_g)`` with each bias added to
its own product.  cuDNN's fused RNN (``torch.nn.LSTM``) is not used.
``_RNNBase`` computes a layer's input products for all timesteps in one
matrix product before its time loop (the same values a step would
compute), then adds each step's hidden product to them.

Parameters are created on ``device`` in ``dtype`` from ``generator``
(``nn/common.py``'s rules), each ``Uniform(-1/sqrt(hidden), 1/sqrt(hidden))``
by default, and registered under the JAX names in the JAX order:
``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh`` for a cell, and
``weight_ih_l{k}[_reverse]`` ... for ``_RNNBase``, layer by layer, the
forward direction first.  Weights are ``[gates * hidden, in]`` in both
packages (torch's RNN layout too), so they cross as they are.

What the JAX package does and the port copies (ROADMAP C6, open for a
decision; each is shown in both packages by ``tests/test_torch_rnn.py``):

* ``_RNNBase.forward`` ignores ``initial_states`` (every layer starts from
  zeros in the input's dtype), ``sequence_length`` (padding steps run and
  reach the final states) and ``dropout`` (no dropout between layers).
* ``RNN`` and ``BiRNN`` ignore ``sequence_length``.
* ``LSTMCell`` ignores ``proj_size``.
* A cell's ``get_initial_states`` gives fp32 zeros ``[batch, hidden]``
  whatever ``shape`` and ``dtype`` say.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .common import make_parameter
from .initializer import Uniform


def _uniform(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return Uniform(-k, k)


class RNNCellBase(nn.Module):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0):
        """fp32 ``[batch, hidden_size]`` filled with ``init_value``, on
        ``batch_ref``'s device (``shape`` and ``dtype`` are ignored, as in
        the JAX package)."""
        return torch.full((batch_ref.shape[0], self.hidden_size), init_value,
                          dtype=torch.float32, device=batch_ref.device)


class _Cell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        init = _uniform(hidden_size)
        kw = dict(dtype=dtype, device=device, generator=generator)
        g = self.GATES * hidden_size
        self.weight_ih = make_parameter(weight_ih_attr, init,
                                        (g, input_size), **kw)
        self.weight_hh = make_parameter(weight_hh_attr, init,
                                        (g, hidden_size), **kw)
        for name, attr in (("bias_ih", bias_ih_attr),
                           ("bias_hh", bias_hh_attr)):
            self.register_parameter(
                name, None if attr is False
                else make_parameter(attr, init, (g,), **kw))

    def _gates(self, x, h):
        """``x @ W_ih^T + h @ W_hh^T (+ b_ih + b_hh)``."""
        z = x @ self.weight_ih.T + h @ self.weight_hh.T
        if self.bias_ih is not None:
            z = z + self.bias_ih + self.bias_hh
        return z

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(_Cell):
    """``h' = act(x W_ih^T + h W_hh^T + b_ih + b_hh)``, ``act`` tanh or
    relu; returns ``(h', h')``."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         dtype, generator)
        self.activation = activation

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _simple_update(self._gates(inputs, states), self.activation)
        return h, h


class LSTMCell(_Cell):
    """Gates i, f, g, o; ``c' = f c + i g``, ``h' = o tanh(c')``; returns
    ``(h', (h', c'))``.  ``proj_size`` is ignored (ROADMAP C6)."""

    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         dtype, generator)

    def forward(self, inputs, states=None):
        if states is None:
            h = self.get_initial_states(inputs)
            c = self.get_initial_states(inputs)
        else:
            h, c = states
        h_new, c_new = _lstm_update(self._gates(inputs, h), c)
        return h_new, (h_new, c_new)


class GRUCell(_Cell):
    """Gates r, z and the candidate g: ``r = sigmoid(x_r + h_r)``, ``z =
    sigmoid(x_z + h_z)``, ``g = tanh(x_g + r h_g)`` (each side's bias
    added to its product), ``h' = (1 - z) g + z h``; returns
    ``(h', h')``."""

    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None, dtype=None, generator=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, device,
                         dtype, generator)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        gi = inputs @ self.weight_ih.T
        gh = states @ self.weight_hh.T
        if self.bias_ih is not None:
            gi = gi + self.bias_ih
            gh = gh + self.bias_hh
        h = _gru_update(gi, gh, states)
        return h, h


def _simple_update(z, activation):
    return torch.tanh(z) if activation == "tanh" else torch.relu(z)


def _lstm_update(z, c):
    """The LSTM's new ``(h, c)`` from its gate sums ``z`` (i, f, g, o)."""
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_update(gi, gh, h):
    ir, iz, ig = torch.chunk(gi, 3, dim=-1)
    hr, hz, hg = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    g = torch.tanh(ig + r * hg)
    return (1 - z) * g + z * h


class RNN(nn.Module):
    """Runs ``cell`` over a ``[batch, time, ...]`` sequence (``[time,
    batch, ...]`` with ``time_major``), one ``cell(x_t, states)`` a
    timestep, last to first with ``is_reverse``; returns the stacked
    outputs in time order and the last states.  ``sequence_length`` is
    ignored (ROADMAP C6)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else inputs.transpose(0, 1)
        steps = range(x.shape[0] - 1, -1, -1) if self.is_reverse \
            else range(x.shape[0])
        states, outs = initial_states, []
        for t in steps:
            out, states = self.cell(x[t], states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        stacked = torch.stack(outs, 0)
        if not self.time_major:
            stacked = stacked.transpose(0, 1)
        return stacked, states


class BiRNN(nn.Module):
    """``cell_fw`` forward and ``cell_bw`` reversed over the same sequence,
    outputs concatenated on the last axis; states ``(fw, bw)``.
    ``sequence_length`` is ignored (ROADMAP C6)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, s_fw)
        out_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(nn.Module):
    """Multi-layer, one- or two-direction LSTM / GRU / SimpleRNN.  Returns
    the last layer's outputs and the final states ``[layers * directions,
    batch, hidden]`` (``(h, c)`` for the LSTM).  ``initial_states``,
    ``sequence_length`` and ``dropout`` are ignored (ROADMAP C6)."""

    MODE = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        n_dir = 2 if self.bidirectional else 1
        g = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}[
            self.MODE] * hidden_size
        init = _uniform(hidden_size)
        kw = dict(dtype=dtype, device=device, generator=generator)
        self._weights = []
        for layer in range(num_layers):
            for d in range(n_dir):
                isz = input_size if layer == 0 else hidden_size * n_dir
                sfx = f"_l{layer}" + ("_reverse" if d else "")
                group = (
                    make_parameter(weight_ih_attr, init, (g, isz), **kw),
                    make_parameter(weight_hh_attr, init, (g, hidden_size),
                                   **kw),
                    make_parameter(bias_ih_attr, init, (g,), **kw),
                    make_parameter(bias_hh_attr, init, (g,), **kw))
                for name, p in zip(("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh"), group):
                    self.register_parameter(name + sfx, p)
                self._weights.append(group)

    def _scan(self, seq, wi, wh, bi, bh, h0):
        """One direction of one layer over ``seq`` ``[time, batch, in]``:
        the outputs ``[time, batch, hidden]`` and the final carry."""
        xw = seq @ wi.T                  # every step's input product
        if self.MODE == "GRU":
            xw = xw + bi
        carry = (h0, h0) if self.MODE == "LSTM" else h0
        ys = []
        for t in range(seq.shape[0]):
            if self.MODE == "LSTM":
                h, c = _lstm_update(
                    torch.addmm(xw[t], carry[0], wh.T) + bi + bh, carry[1])
                carry = (h, c)
            elif self.MODE == "GRU":
                h = _gru_update(xw[t], torch.addmm(bh, carry, wh.T), carry)
                carry = h
            else:
                h = _simple_update(torch.addmm(xw[t], carry, wh.T) + bi + bh,
                                   "tanh" if self.MODE == "RNN_TANH"
                                   else "relu")
                carry = h
            ys.append(h)
        return torch.stack(ys, 0), carry

    def forward(self, inputs, initial_states=None, sequence_length=None):
        n_dir = 2 if self.bidirectional else 1
        x = inputs if self.time_major else inputs.transpose(0, 1)
        h0 = torch.zeros(x.shape[1], self.hidden_size, dtype=x.dtype,
                         device=x.device)
        out, final_h, final_c = x, [], []
        for layer in range(self.num_layers):
            dir_outs = []
            for d in range(n_dir):
                seq = out if d == 0 else torch.flip(out, [0])
                ys, carry = self._scan(seq, *self._weights[layer * n_dir + d],
                                       h0)
                dir_outs.append(ys if d == 0 else torch.flip(ys, [0]))
                if self.MODE == "LSTM":
                    final_h.append(carry[0])
                    final_c.append(carry[1])
                else:
                    final_h.append(carry)
            out = torch.cat(dir_outs, dim=-1) if n_dir == 2 else dir_outs[0]
        outputs = out if self.time_major else out.transpose(0, 1)
        if self.MODE == "LSTM":
            return outputs, (torch.stack(final_h), torch.stack(final_c))
        return outputs, torch.stack(final_h)

    def extra_repr(self):
        return (f"{self.input_size}, {self.hidden_size}, "
                f"num_layers={self.num_layers}, direction={self.direction}")


class LSTM(_RNNBase):
    MODE = "LSTM"


class GRU(_RNNBase):
    MODE = "GRU"


class SimpleRNN(_RNNBase):
    """``activation`` is ``"tanh"`` or ``"relu"``."""

    MODE = "RNN_TANH"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        self.MODE = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, **kwargs)
