"""The port's recurrent layers and gradient clipping held to the JAX
package's on the CPU: the same numpy inputs (from a seed) through both,
the JAX layer's weights carried across.

* Every cell (``SimpleRNNCell`` tanh and relu, ``LSTMCell``, ``GRUCell``;
  from given states and from none), ``RNN`` over each cell (forward and
  reversed, batch- and time-major), ``BiRNN``, and ``LSTM``, ``GRU`` and
  ``SimpleRNN`` (tanh and relu) in one and two directions, one and two
  layers, batch- and time-major: outputs and final states within 1e-5,
  and the gradients of the input and of every weight within 1e-5 of the
  tensor's largest entry.
* ROADMAP C6, in both packages: ``_RNNBase`` ignores ``initial_states``,
  ``sequence_length`` and ``dropout``, ``RNN`` and ``BiRNN`` ignore
  ``sequence_length``, ``LSTMCell`` ignores ``proj_size``, and
  ``get_initial_states`` is fp32 whatever ``dtype`` says.
* ``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``
  (``need_clip`` off on one parameter, a missing gradient), and
  ``clip_grad_norm_`` (2, 1.5 and inf) / ``clip_grad_value_`` against the
  JAX ones within 1e-6.
* Adam with ``ClipGradByGlobalNorm`` (a norm small enough that every step
  clips) over 5 steps of a small LSTM regressor: losses within 1e-5
  relative, and the weights after; every optimizer takes ``grad_clip``.
* The same step under ``jit.to_static`` against eager (on the CPU
  ``to_static`` runs eagerly: one cache entry, equal losses).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import convert, jit
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import clip as pclip
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW, Momentum

B, T, IN, H = 2, 4, 3, 5


def _a(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state(jlayer):
    return {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}


def _flat(tree):
    """The tensors of a nested tuple/list of outputs, in order."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _flat(sub)]
    return [tree]


def _close(got, want, tol=1e-5):
    """Within ``tol`` of the reference's largest entry."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _hold(jlayer, player, arrays, call=lambda m, *a: m(*a)):
    """``call(layer, *inputs)`` in both packages, the port's layer loaded
    with the JAX layer's weights: every output within 1e-5, and the
    gradients of ``sum(out_i * probe_i)`` over the inputs and the weights
    within 1e-5 of their largest entries."""
    convert.load_paddle_tpu_state(player, _state(jlayer))
    jin = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    jout = _flat(call(jlayer, *jin))
    probes = [_a(tuple(o.shape), 90 + i) for i, o in enumerate(jout)]
    sum(((o * paddle.to_tensor(p)).sum() for o, p in zip(jout, probes)),
        paddle.to_tensor(np.float32(0))).backward()
    pin = [torch.from_numpy(a).requires_grad_() for a in arrays]
    pout = _flat(call(player, *pin))
    sum((o * torch.from_numpy(p)).sum() for o, p in zip(pout, probes)
        ).backward()
    assert len(pout) == len(jout)
    for po, jo in zip(pout, jout):
        _close(po.detach().numpy(), np.asarray(jo.numpy()))
    for pi, ji in zip(pin, jin):
        _close(pi.grad.numpy(), np.asarray(ji.grad.numpy()))
    jgrads = dict(jlayer.named_parameters())
    for name, p in player.named_parameters():
        _close(p.grad.numpy(), np.asarray(jgrads[name].grad.numpy()))


# --- cells --------------------------------------------------------------------

CELLS = {
    "simple_tanh": lambda m: m.SimpleRNNCell(IN, H),
    "simple_relu": lambda m: m.SimpleRNNCell(IN, H, activation="relu"),
    "lstm": lambda m: m.LSTMCell(IN, H),
    "gru": lambda m: m.GRUCell(IN, H),
}


@pytest.mark.parametrize("with_states", [False, True])
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_matches_jax(kind, with_states):
    paddle.seed(3)
    jcell, pcell = CELLS[kind](jnn), CELLS[kind](nn)
    arrays = [_a((B, IN), 1)]
    if with_states:
        arrays += [_a((B, H), 2)] + ([_a((B, H), 3)] if kind == "lstm"
                                     else [])

    def call(cell, x, *states):
        if not states:
            return cell(x)
        return cell(x, tuple(states) if len(states) == 2 else states[0])

    _hold(jcell, pcell, arrays, call)


@pytest.mark.parametrize("kind, is_reverse, time_major", [
    ("lstm", False, False), ("lstm", True, True), ("gru", True, False),
    ("simple_tanh", False, True)])
def test_rnn_wrapper_matches_jax(kind, is_reverse, time_major):
    paddle.seed(4)
    jrnn = jnn.RNN(CELLS[kind](jnn), is_reverse, time_major)
    prnn = nn.RNN(CELLS[kind](nn), is_reverse, time_major)
    shape = (T, B, IN) if time_major else (B, T, IN)
    _hold(jrnn, prnn, [_a(shape, 5)])


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_birnn_matches_jax(kind):
    paddle.seed(6)
    jb = jnn.BiRNN(CELLS[kind](jnn), CELLS[kind](jnn))
    pb = nn.BiRNN(CELLS[kind](nn), CELLS[kind](nn))
    _hold(jb, pb, [_a((B, T, IN), 7)])


# --- multi-layer RNNs ---------------------------------------------------------

def _rnn_base(m, mode, layers, direction, time_major):
    kw = dict(num_layers=layers, direction=direction, time_major=time_major)
    if mode.startswith("SimpleRNN"):
        return m.SimpleRNN(IN, H, activation=mode.split("_")[1], **kw)
    return getattr(m, mode)(IN, H, **kw)


@pytest.mark.parametrize("mode, layers, direction, time_major", [
    ("LSTM", 1, "forward", False), ("LSTM", 2, "bidirect", True),
    ("LSTM", 2, "forward", True), ("GRU", 1, "bidirect", False),
    ("GRU", 2, "forward", False), ("SimpleRNN_tanh", 2, "bidirect", False),
    ("SimpleRNN_tanh", 1, "forward", True),
    ("SimpleRNN_relu", 1, "bidirect", True)])
def test_rnn_layers_match_jax(mode, layers, direction, time_major):
    paddle.seed(8)
    jl = _rnn_base(jnn, mode, layers, direction, time_major)
    pl = _rnn_base(nn, mode, layers, direction, time_major)
    assert [n for n, _ in pl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    shape = (T, B, IN) if time_major else (B, T, IN)
    _hold(jl, pl, [_a(shape, 9)])


# --- ROADMAP C6: the arguments the JAX package ignores ------------------------

@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_ignored_rnn_arguments(pkg):
    """``_RNNBase`` ignores initial states, sequence lengths and dropout;
    ``RNN`` / ``BiRNN`` ignore sequence lengths; ``LSTMCell`` ignores
    ``proj_size``; initial states are fp32 — in both packages."""
    m = jnn if pkg == "jax" else nn
    wrap = paddle.to_tensor if pkg == "jax" else torch.from_numpy

    def arr(t):
        return np.asarray(t.numpy()) if pkg == "jax" else \
            t.detach().numpy()

    paddle.seed(11)
    torch.manual_seed(11)
    x = wrap(_a((B, T, IN), 12))
    h0 = wrap(_a((2, B, H), 13))
    lens = wrap(np.array([1, 2], np.int64))
    lstm = m.LSTM(IN, H, num_layers=2, dropout=0.5)
    lstm.train()
    base, (bh, bc) = lstm(x)
    for kw in (dict(initial_states=(h0, h0)), dict(sequence_length=lens)):
        out, (h, c) = lstm(x, **kw)
        for a, b in ((out, base), (h, bh), (c, bc)):
            np.testing.assert_array_equal(arr(a), arr(b))
    # the padding steps past a length reach the final state
    np.testing.assert_array_equal(arr(bh)[-1], arr(base)[:, -1])
    cell = m.LSTMCell(IN, H, proj_size=2)
    h, (h2, c2) = cell(x[:, 0])
    assert tuple(h.shape) == tuple(c2.shape) == (B, H)
    for rnn in (m.RNN(m.GRUCell(IN, H)),
                m.BiRNN(m.GRUCell(IN, H), m.GRUCell(IN, H))):
        a, _ = rnn(x)
        b, _ = rnn(x, sequence_length=lens)
        np.testing.assert_array_equal(arr(a), arr(b))
    ref = wrap(np.zeros((B, IN), np.float16))
    init = cell.get_initial_states(ref, shape=[7], dtype="float16")
    assert str(init.dtype).endswith("float32")
    assert tuple(init.shape) == (B, H)


# --- gradient clipping --------------------------------------------------------

def _pairs(pkg, need_clip_off=1):
    shapes = [(3, 4), (5,), (2, 2), (4,)]
    out = []
    for i, s in enumerate(shapes):
        w, g = _a(s, 20 + i), _a(s, 30 + i) * (i + 1)
        if pkg == "jax":
            p = paddle.Parameter(w)
            grad = None if i == 3 else paddle.to_tensor(g)
        else:
            p = torch.nn.Parameter(torch.from_numpy(w))
            grad = None if i == 3 else torch.from_numpy(g)
        if i == need_clip_off:
            p.need_clip = False
        out.append((p, grad))
    return out


def _grads(pairs, pkg):
    return [None if g is None else
            (np.asarray(g.numpy()) if pkg == "jax" else g.numpy())
            for _, g in pairs]


@pytest.mark.parametrize("name, args", [
    ("ClipGradByValue", (0.8,)), ("ClipGradByValue", (0.5, -0.2)),
    ("ClipGradByNorm", (1.0,)), ("ClipGradByNorm", (100.0,)),
    ("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (100.0,))])
def test_clip_classes_match_jax(name, args):
    want = _grads(getattr(jclip, name)(*args)(_pairs("jax")), "jax")
    pairs = _pairs("port")
    got = _grads(getattr(pclip, name)(*args)(pairs), "port")
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    # the need_clip parameter's gradient passes through
    np.testing.assert_array_equal(got[1], pairs[1][1].numpy())


@pytest.mark.parametrize("norm_type", [2.0, 1.5, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    jp, pp = _pairs("jax"), _pairs("port")
    for (p, g) in jp:
        p.grad = g
    for (p, g) in pp:
        p.grad = g
    jt = jclip.clip_grad_norm_([p for p, _ in jp], 2.0, norm_type)
    pt = pclip.clip_grad_norm_((p for p, _ in pp), 2.0, norm_type)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt.numpy()),
                               rtol=1e-6)
    for (a, _), (b, _) in zip(pp, jp):
        if b.grad is None:
            assert a.grad is None
        else:
            np.testing.assert_allclose(a.grad.numpy(),
                                       np.asarray(b.grad.numpy()),
                                       rtol=1e-6, atol=1e-7)
    jclip.clip_grad_value_([p for p, _ in jp], 0.3)
    pclip.clip_grad_value_([p for p, _ in pp], 0.3)
    for (a, _), (b, _) in zip(pp, jp):
        if b.grad is not None:
            np.testing.assert_allclose(a.grad.numpy(),
                                       np.asarray(b.grad.numpy()),
                                       rtol=1e-6, atol=1e-7)
    assert pclip.clip_grad_norm_([torch.nn.Parameter(torch.ones(2))],
                                 1.0) is None


# --- training with grad_clip --------------------------------------------------

class _JaxRegressor(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.lstm = jnn.LSTM(IN, H, num_layers=2)
        self.head = jnn.Linear(H, 1)

    def forward(self, x):
        out, _ = self.lstm(x)
        return self.head(out[:, -1])


class _PortRegressor(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(IN, H, num_layers=2)
        self.head = nn.Linear(H, 1)

    def forward(self, x):
        out, _ = self.lstm(x)
        return self.head(out[:, -1])


CLIP_NORM = 0.05    # below the first steps' global norms: every step clips


def _batches():
    return [(_a((B, T, IN), 40 + i), _a((B, 1), 50 + i)) for i in range(5)]


@pytest.fixture(scope="module")
def jax_run():
    paddle.seed(21)
    model = _JaxRegressor()
    state = _state(model)
    opt = paddle.optimizer.Adam(
        learning_rate=0.01, parameters=model.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(CLIP_NORM))
    losses, norms = [], []
    for x, y in _batches():
        loss = ((model(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2
                ).mean()
        loss.backward()
        norms.append(float(np.sqrt(sum(
            (np.asarray(p.grad.numpy()) ** 2).sum()
            for p in model.parameters()))))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.numpy()))
    return state, losses, norms, _state(model)


def _port_step(model, opt):
    def step(x, y):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def _port_run(state, captured=False):
    model = _PortRegressor()
    convert.load_paddle_tpu_state(model, state)
    opt = Adam(learning_rate=0.01, parameters=model.parameters(),
               grad_clip=nn.ClipGradByGlobalNorm(CLIP_NORM))
    step = _port_step(model, opt)
    if captured:
        step = jit.to_static(step)
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in _batches()]
    return model, step, losses


def test_adam_with_global_norm_clip_matches_jax(jax_run):
    state, want, norms, after = jax_run
    assert min(norms) > CLIP_NORM          # every step clipped
    model, _, got = _port_run(state)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for name, w in convert.to_paddle_tpu(model).items():
        np.testing.assert_allclose(w, after[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_captured_step_matches_eager(jax_run):
    state = jax_run[0]
    _, _, eager = _port_run(state)
    _, step, captured = _port_run(state, captured=True)
    assert captured == eager
    assert len(step.concrete_program_cache) == 1


@pytest.mark.parametrize("opt_cls", [SGD, Momentum, Adam, AdamW])
def test_every_optimizer_takes_grad_clip(opt_cls):
    """``grad_clip`` reaches the update: with a value clip of 0 every
    gradient is zero, so SGD, Momentum and Adam leave the weights as they
    were (AdamW only decays them)."""
    lin = nn.Linear(3, 2)
    before = [p.detach().clone() for p in lin.parameters()]
    opt = opt_cls(learning_rate=0.1, parameters=lin.parameters(),
                  grad_clip=nn.ClipGradByValue(0.0))
    lin(torch.ones(4, 3)).sum().backward()
    opt.step()
    for p, b in zip(lin.parameters(), before):
        if opt_cls is AdamW:
            torch.testing.assert_close(p.detach(), b * (1 - 0.1 * 0.01))
        else:
            assert torch.equal(p.detach(), b)
