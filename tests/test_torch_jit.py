"""The port's ``jit.to_static`` held to the JAX package's on the CPU, as
``tests/test_jit.py`` checks the JAX one: the same numpy inputs (from a
seed) through both.

On the CPU the port runs a break-free key's calls eagerly and keeps the
JAX cache accounting (one entry a signature key); the capture into CUDA
graphs is checked on the card (``tests/test_torch_jit_cuda.py``), the
graph breaks and their segment replay on both
(``tests/test_torch_jit_partial.py`` holds them to the JAX package's).
Here: results against eager and against the JAX ``to_static`` (1e-5), cache
entries by shape and by training mode, live parameters read each call,
BatchNorm statistics, Adam moments and the step counter, and dropout's RNG
threaded through calls (the port's own generator: the masks differ from
the JAX draws, their statistics not), the decorator form, nested
functions, a layer, ``not_to_static``, ``enable_to_static(False)``,
``ignore_module`` and outputs detached as the JAX program's are; reads
of host constants inside the function (no graph break); and a
train step under ``to_static`` with ``Momentum`` and a ``LinearWarmup``
scheduler stepped outside it, against the JAX package's eager steps.
"""

import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import convert, jit
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.optimizer import SGD, Adam, Momentum
from paddle_tpu_torch.optimizer import lr as lr_mod


def _a(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(a)


def _jn(t):
    return np.asarray(t.numpy())


def _pair(jlayer, tlayer):
    convert.load_paddle_tpu_state(tlayer, {k: _jn(v) for k, v in
                                           jlayer.state_dict().items()})
    return jlayer, tlayer


def test_matches_eager_and_the_jax_to_static():
    paddle.seed(0)
    jm, tm = _pair(jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(),
                                  jnn.Linear(8, 2)),
                   nn.Sequential(nn.Linear(4, 8), nn.ReLU(),
                                 nn.Linear(8, 2)))
    x = _a((3, 4))
    fn = jit.to_static(tm.forward)
    out = fn(_t(x))
    np.testing.assert_allclose(out.numpy(), tm(_t(x)).detach().numpy(),
                               rtol=1e-6)
    want = paddle.jit.to_static(jm.forward)(paddle.to_tensor(x))
    np.testing.assert_allclose(out.numpy(), _jn(want), rtol=1e-5,
                               atol=1e-6)
    assert not out.requires_grad      # the JAX program's outputs: no tape


def test_cache_by_shape_counts_as_the_jax_cache():
    jm, tm = _pair(jnn.Linear(4, 2), nn.Linear(4, 2))
    jfn, tfn = paddle.jit.to_static(jm.forward), jit.to_static(tm.forward)
    builds = get_registry().counter("jit_builds_total", "").value
    for shape, seed in (((3, 4), 0), ((5, 4), 1), ((3, 4), 9)):
        x = _a(shape, seed)
        np.testing.assert_allclose(tfn(_t(x)).numpy(),
                                   _jn(jfn(paddle.to_tensor(x))), rtol=1e-5,
                                   atol=1e-6)
        assert len(tfn._cache) == len(jfn._cache)
    assert len(tfn._cache) == 2
    assert get_registry().counter("jit_builds_total", "").value \
        == builds + 2


def test_training_mode_is_part_of_the_key():
    bn = nn.BatchNorm1D(3)
    fn = jit.to_static(bn.forward)
    x = _t(_a((4, 3)))
    fn(x)
    bn.eval()
    fn(x)
    assert len(fn._cache) == 2


def test_param_update_visible():
    """A call reads the LIVE parameters, not a baked copy."""
    tm = nn.Linear(2, 2, bias_attr=False)
    fn = jit.to_static(tm.forward)
    x = torch.eye(2)
    out1 = fn(x)
    with torch.no_grad():
        tm.weight.mul_(2)
    np.testing.assert_allclose(fn(x).numpy(), out1.numpy() * 2, rtol=1e-6)


def _steps(model, opt, xs, ys, loss_fn):
    def step(xv, yv):
        loss = loss_fn(model(xv), yv)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def test_sgd_train_step_matches_jax_to_static():
    paddle.seed(0)
    jm, tm = _pair(jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(),
                                  jnn.Linear(8, 1)),
                   nn.Sequential(nn.Linear(4, 8), nn.Tanh(),
                                 nn.Linear(8, 1)))
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jm.parameters())
    topt = SGD(learning_rate=0.1, parameters=tm.parameters())
    x, y = _a((8, 4)), _a((8, 1), 2)
    jstep = paddle.jit.to_static(_steps(jm, jopt, x, y, JF.mse_loss))
    tstep = jit.to_static(_steps(tm, topt, x, y, F.mse_loss))
    for _ in range(4):
        jl = jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        tl = tstep(_t(x), _t(y))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = convert.to_paddle_tpu(tm)
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(got[k], _jn(v), rtol=1e-5, atol=1e-6)


def test_bn_stats_threaded_like_jax():
    jbn, tbn = _pair(jnn.BatchNorm2D(3), nn.BatchNorm2D(3))
    jfn, tfn = paddle.jit.to_static(jbn.forward), jit.to_static(tbn.forward)
    for seed in range(3):
        x = _a((4, 3, 5, 5), seed) + 1
        jfn(paddle.to_tensor(x))
        tfn(_t(x))
        np.testing.assert_allclose(tbn._mean.numpy(), _jn(jbn._mean),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(tbn._variance.numpy(),
                                   _jn(jbn._variance), rtol=1e-5)


def test_optimizer_state_threaded_like_jax():
    """Adam's moments and step counter evolve across calls as the JAX
    to_static's do (and as eager)."""
    paddle.seed(3)
    jm, tm = _pair(jnn.Linear(4, 4), nn.Linear(4, 4))
    jopt = paddle.optimizer.Adam(learning_rate=0.01,
                                 parameters=jm.parameters())
    topt = Adam(learning_rate=0.01, parameters=tm.parameters())

    jstep = paddle.jit.to_static(
        _steps(jm, jopt, None, None, lambda o, _: o.square().mean()))
    tstep = jit.to_static(
        _steps(tm, topt, None, None, lambda o, _: o.square().mean()))
    for s in range(6):
        x = _a((4, 4), s)
        jl = jstep(paddle.to_tensor(x), None)
        tl = tstep(_t(x), None)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tm.weight.detach().numpy().T,
                               _jn(jm.weight), rtol=1e-5, atol=1e-6)
    assert topt._state[id(tm.weight)]["t"] == 6
    assert int(np.asarray(jopt._state[id(jm.weight)]["t"]._value)) == 6
    assert len(tstep._cache) == 1


def test_momentum_with_a_scheduler_stepped_outside_matches_jax_eager():
    """The scheduler's value reaches every call (the JAX to_static bakes
    the learning rate of its first trace into the program, so the JAX
    reference here is eager)."""
    paddle.seed(4)
    jm, tm = _pair(jnn.Linear(4, 3), nn.Linear(4, 3))
    jsched = paddle.optimizer.lr.LinearWarmup(0.1, 3, 0.0, 0.1)
    tsched = lr_mod.LinearWarmup(0.1, 3, 0.0, 0.1)
    jopt = paddle.optimizer.Momentum(learning_rate=jsched, momentum=0.9,
                                     parameters=jm.parameters(),
                                     weight_decay=1e-4)
    topt = Momentum(learning_rate=tsched, momentum=0.9,
                    parameters=tm.parameters(), weight_decay=1e-4)
    jstep = _steps(jm, jopt, None, None, JF.mse_loss)
    tstep = jit.to_static(_steps(tm, topt, None, None, F.mse_loss))
    for s in range(5):
        x, y = _a((6, 4), s), _a((6, 3), 10 + s)
        jl = jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        tl = tstep(_t(x), _t(y))
        jsched.step()
        tsched.step()
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    got = convert.to_paddle_tpu(tm)
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(got[k], _jn(v), rtol=1e-5, atol=1e-6)


def test_rng_threaded_and_seeded():
    drop = nn.Dropout(0.5)
    fn = jit.to_static(drop.forward)
    x = torch.ones(64)
    a, b = fn(x), fn(x)
    assert not torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0}
    torch.manual_seed(5)
    a = fn(x)
    torch.manual_seed(5)
    assert torch.equal(a, fn(x))


def test_decorator_nested_and_layer_forms():
    @jit.to_static
    def inner(a):
        assert jit.in_to_static_trace()
        return a * 2

    @jit.to_static
    def outer(a):
        return inner(a) + 1

    np.testing.assert_allclose(outer(torch.tensor([2.0])).numpy(), [5.0])
    assert len(inner._cache) == 0        # inlined into the outer call
    assert not jit.in_to_static_trace()
    layer = jit.to_static(nn.Linear(3, 2))
    assert isinstance(layer.forward, jit.StaticFunction)
    layer(torch.ones(1, 3))
    assert len(layer.forward._cache) == 1


def test_bound_method_has_a_cache_per_instance():
    class Net(nn.Linear):
        @jit.to_static
        def run(self, x):
            return self(x)

    a, b = Net(2, 2), Net(2, 2)
    x = torch.ones(1, 2)
    np.testing.assert_allclose(a.run(x).numpy(), a(x).detach().numpy())
    np.testing.assert_allclose(b.run(x).numpy(), b(x).detach().numpy())
    assert a.run is not b.run


def test_not_to_static_and_enable_to_static():
    @jit.not_to_static
    def helper(x):
        return x + 1

    assert helper._not_to_static
    fn = jit.to_static(lambda x: helper(x) * 2)
    jit.enable_to_static(False)
    try:
        np.testing.assert_allclose(fn(torch.ones(2)).numpy(), [4.0, 4.0])
        assert len(fn._cache) == 0
    finally:
        jit.enable_to_static(True)
    fn(torch.ones(2))
    assert len(fn._cache) == 1


def test_ignore_module_direct_and_nested():
    def f(x):
        return x * 2

    fn = jit.to_static(f)
    jit.ignore_module(sys.modules[__name__])
    try:
        np.testing.assert_allclose(fn(torch.ones(3)).numpy(), 2.0)
        assert len(fn._cache) == 0
    finally:
        jit._ignored_modules.discard(__name__)

    def inner(x):
        return x + 1

    inner.__module__ = "fake_vendor_mod"
    inner_s = jit.to_static(inner)
    outer_s = jit.to_static(lambda x: inner_s(x) * 3)
    jit.ignore_module("fake_vendor_mod")
    breaks = get_registry().counter("jit_graph_breaks_total", "").value
    try:
        with pytest.warns(UserWarning, match="graph break"):
            out = outer_s(torch.ones(2))
        np.testing.assert_allclose(out.numpy(), 6.0)
        assert len(outer_s._cache) == 0 and outer_s._eager_keys
        assert get_registry().counter("jit_graph_breaks_total",
                                      "").value == breaks + 1
    finally:
        jit._ignored_modules.discard("fake_vendor_mod")


def test_reads_of_constants_are_no_graph_break():
    """Host arithmetic on tensors made inside the function from constants
    (an optimizer's bias correction, an ``arange``) reads no argument and
    no state: no graph break, one cache entry, as in the JAX package,
    where such values are concrete while tracing."""
    def f(x):
        scale = float(torch.tensor(0.9) ** 2)
        n = int(torch.arange(4).sum())
        return x * scale + n

    fn = jit.to_static(f)
    breaks = get_registry().counter("jit_graph_breaks_total", "").value
    x = torch.ones(3)
    for _ in range(2):
        np.testing.assert_allclose(fn(x).numpy(), f(x).numpy())
    assert len(fn._cache) == 1 and not fn._partial
    assert get_registry().counter("jit_graph_breaks_total",
                                  "").value == breaks
