"""The port's partial-graph replay around ``to_static`` graph breaks
(``paddle_tpu_torch/jit/partial.py``) held to the JAX package's, case for
case with ``tests/test_jit_partial.py``: the same seeded numpy inputs go
through ``paddle_tpu`` and ``paddle_tpu_torch``; results agree within
1e-6 (fp32), and where the JAX test asserts structure the port's counts
equal the JAX package's: traces, segments, Python runs after the
recording, the store going eager after ``_MAX_TRACES`` paths, and the
shape-bucket accounting.

One departure, asserted in both packages: the first call of a broken
signature runs the Python body three times in the JAX package
(discovery, staging up to the break, the recording) and once in the
port, whose recording is that call (``paddle_tpu_torch/jit/api.py``).
Ops are counted per package (an aten op is finer than a ``run_op``).
The traces' captured graphs on the card are in
``tests/test_torch_jit_cuda.py``.
"""

import warnings as _w

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import flags
from paddle_tpu.jit import api as japi
from paddle_tpu.jit.partial import _MAX_TRACES as JAX_MAX_TRACES
from paddle_tpu_torch import convert, jit
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import api
from paddle_tpu_torch.jit.partial import _MAX_TRACES
from paddle_tpu_torch.optimizer import SGD

TOL = dict(rtol=1e-6, atol=1e-6)
SITE = r"test_torch_jit_partial\.py:\d+"


def _make_counted(body):
    """``body`` wrapped to count its Python runs."""
    calls = {"n": 0}

    def f(*a, **k):
        calls["n"] += 1
        return body(*a, **k)

    return f, calls


def _store(fn):
    return next(iter(fn._partial.values()))


def _a(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _linear_pair(seed):
    """A JAX ``Linear(3, 1)`` and the port's with its weights."""
    paddle.seed(seed)
    jl = jnn.Linear(3, 1)
    tl = nn.Linear(3, 1)
    convert.load_paddle_tpu_state(
        tl, {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()})
    return jl, tl


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.numpy()


def _jt(a):
    return paddle.to_tensor(np.asarray(a))


def _tt(a):
    return torch.from_numpy(np.array(a))


class TestPartialGraphReplay:
    def test_matmul_prefix_runs_compiled_after_break(self):
        w = np.eye(4, dtype=np.float32) * 2.0
        x = _a((2, 4), 0) + 1.0

        def run(pkg, to_t, relu, matmul):
            wt = to_t(w)

            def body(x):
                h = relu(matmul(x, wt))
                if float(h.sum()) > 0:
                    return h * 2
                return h - 1

            f, calls = _make_counted(body)
            fn = pkg.to_static(f)
            with pytest.warns(UserWarning, match="graph break"):
                out1 = fn(to_t(x))
            first = calls["n"]
            store = _store(fn)
            with _w.catch_warnings():
                _w.simplefilter("error")
                out2 = fn(to_t(x))
            return (out1.numpy(), out2.numpy(), first, calls["n"] - first,
                    len(store.traces), len(store.traces[0].segments),
                    store.traces[0].n_compiled_ops)

        j = run(paddle.jit, _jt, paddle.nn.functional.relu, paddle.matmul)
        t = run(jit, _tt, torch.relu, torch.matmul)
        np.testing.assert_allclose(t[0], j[0], **TOL)
        np.testing.assert_allclose(t[1], j[1], **TOL)
        np.testing.assert_allclose(t[1], t[0], **TOL)
        assert (j[2], t[2]) == (3, 1)          # first-call runs (docstring)
        assert t[3] == j[3] == 0               # the replay runs no Python
        assert t[4] == j[4] == 1 and t[5] == j[5] == 2
        assert t[6] >= 3 and j[6] >= 3         # matmul, relu, sum, mul

    def test_break_warning_names_the_site(self):
        x = np.ones((3,), np.float32)

        def f(x):
            if float(x.sum()) > 0:  # the breaking line
                return x * 2
            return x

        for pkg, to_t in ((paddle.jit, _jt), (jit, _tt)):
            fn = pkg.to_static(f)
            with pytest.warns(UserWarning, match=SITE):
                out = fn(to_t(x))
            np.testing.assert_allclose(out.numpy(), 2 * x)

    def test_guard_mismatch_records_second_path(self):
        def run(pkg, to_t, relu):
            def body(x):
                s = relu(x)
                if float(s.sum()) > 1:
                    return s * 10
                return s - 5

            f, calls = _make_counted(body)
            fn = pkg.to_static(f)
            hi, lo = to_t(np.ones(3, np.float32)), to_t(np.zeros(3,
                                                                 np.float32))
            outs, traces = [], []
            with pytest.warns(UserWarning, match="graph break"):
                outs.append(fn(hi).numpy())
            traces.append(len(_store(fn).traces))
            outs.append(fn(lo).numpy())
            traces.append(len(_store(fn).traces))
            n = calls["n"]
            with _w.catch_warnings():
                _w.simplefilter("error")
                outs += [fn(hi).numpy(), fn(lo).numpy()]
            return outs, traces, calls["n"] - n

        j = run(paddle.jit, _jt, paddle.nn.functional.relu)
        t = run(jit, _tt, torch.relu)
        for a, b in zip(t[0], j[0]):
            np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(t[0][0], 10 * np.ones(3))
        np.testing.assert_allclose(t[0][1], -5 * np.ones(3))
        assert t[1] == j[1] == [1, 2]
        assert t[2] == j[2] == 0

    def test_unstable_guard_goes_eager_loudly(self):
        assert _MAX_TRACES == JAX_MAX_TRACES == 3

        def run(pkg, to_t, value):
            one = to_t(np.ones((1,), np.float32))
            counter = to_t(np.zeros((1,), np.float32))

            def f(x):
                counter.add_(one)       # tensor state: replay sees it grow
                if float(counter.sum()) > 1e9:
                    return x * 0
                return x + counter

            fn = pkg.to_static(f)
            x = to_t(np.zeros((2,), np.float32))
            outs = []
            with pytest.warns(UserWarning, match="graph break"):
                outs.append(fn(x).numpy())
            with pytest.warns(RuntimeWarning, match="PERFORMANCE"):
                for _ in range(_MAX_TRACES + 1):
                    outs.append(fn(x).numpy())
            dead = _store(fn).dead
            before = value(counter)
            outs.append(fn(x).numpy())
            return outs, dead, before, value(counter)

        j = run(paddle.jit, _jt, lambda c: float(c.numpy()[0]))
        t = run(jit, _tt, lambda c: float(c[0]))
        for a, b in zip(t[0], j[0]):
            np.testing.assert_allclose(a, b, **TOL)
        assert j[1] is not None and t[1] is not None
        assert t[2] == j[2] == 5.0 and t[3] == j[3] == 6.0
        np.testing.assert_allclose(t[0][-1], 6.0 * np.ones(2))

    def test_state_mutation_writes_back_on_replay(self):
        # a tensor made from host data inside the body (paddle.to_tensor;
        # torch.from_numpy): not replayable, stays eager but always correct
        def run(pkg, to_t, host, value):
            counter = to_t(np.zeros((1,), np.float32))

            def f(x):
                counter.add_(host(np.ones((1,), np.float32)))
                if float(x.sum()) > 0:
                    return x + counter
                return x

            fn = pkg.to_static(f)
            x = to_t(np.ones((2,), np.float32))
            with pytest.warns(UserWarning):
                fn(x)
            out = fn(x)
            return out.numpy(), value(counter), _store(fn).dead

        j = run(paddle.jit, _jt, paddle.to_tensor,
                lambda c: float(c.numpy()[0]))
        t = run(jit, _tt, torch.from_numpy, lambda c: float(c[0]))
        np.testing.assert_allclose(t[0], j[0], **TOL)
        assert t[1] == j[1] == 2.0
        np.testing.assert_allclose(t[0], 3.0 * np.ones(2))
        assert t[2] is not None and j[2] is not None

    def test_inplace_mutation_replay(self):
        def run(pkg, to_t, value):
            one = to_t(np.ones((1,), np.float32))
            counter = to_t(np.zeros((1,), np.float32))

            def body(x):
                counter.add_(one)       # pre-existing tensors: replayable
                h = x * 3
                if float(h.sum()) > 0:
                    return h + counter
                return h

            f, calls = _make_counted(body)
            fn = pkg.to_static(f)
            x = to_t(np.ones((2,), np.float32))
            with pytest.warns(UserWarning):
                out1 = fn(x).numpy()
            c1 = value(counter)
            n = calls["n"]
            out2 = fn(x).numpy()          # replay: the mutation lands
            return out1, c1, out2, value(counter), calls["n"] - n

        j = run(paddle.jit, _jt, lambda c: float(c.numpy()[0]))
        t = run(jit, _tt, lambda c: float(c[0]))
        np.testing.assert_allclose(t[0], j[0], **TOL)
        np.testing.assert_allclose(t[2], j[2], **TOL)
        assert t[1] == j[1] == 1.0 and t[3] == j[3] == 2.0
        assert t[4] == j[4] == 0
        np.testing.assert_allclose(t[2], 5.0 * np.ones(2))

    def test_backward_is_not_replayable(self):
        jl, tl = _linear_pair(3)
        x = np.ones((2, 3), np.float32)

        def run(pkg, to_t, lin, opt, weight):
            def f(x):
                loss = lin(x).sum()
                if float(loss) > 1e9:
                    return loss
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss

            fn = pkg.to_static(f)
            with pytest.warns(RuntimeWarning, match="autograd tape"):
                fn(to_t(x))
            dead = _store(fn).dead
            before = weight().copy()
            fn(to_t(x))                   # eager: the weights move
            return dead, before, weight()

        j = run(paddle.jit, _jt, jl, paddle.optimizer.SGD(
            learning_rate=0.1, parameters=jl.parameters()),
            lambda: jl.weight.numpy())
        t = run(jit, _tt, tl, SGD(learning_rate=0.1,
                                  parameters=tl.parameters()),
                lambda: tl.weight.detach().numpy().T)
        assert j[0] is not None and t[0] is not None
        np.testing.assert_allclose(t[1], j[1], **TOL)
        np.testing.assert_allclose(t[2], j[2], **TOL)
        assert not np.allclose(t[2], t[1])

    def test_host_op_is_not_replayed_with_stale_values(self):
        # nonzero's output shape is computed on the host: no stale replay
        a = np.array([1.0, 0.0, 2.0], np.float32)
        b = np.array([1.0, 1.0, 2.0], np.float32)
        for pkg, to_t, nonzero in ((paddle.jit, _jt, paddle.nonzero),
                                   (jit, _tt, torch.nonzero)):
            def f(x, nonzero=nonzero):
                idx = nonzero(x)
                return x * 0 + float(idx.shape[0])

            fn = pkg.to_static(f)
            with pytest.warns(UserWarning):
                np.testing.assert_allclose(fn(to_t(a)).numpy(),
                                           2.0 * np.ones(3))
            np.testing.assert_allclose(fn(to_t(b)).numpy(), 3.0 * np.ones(3))
            assert _store(fn).dead is not None

    def test_rng_consumption_is_not_replayable(self):
        x = np.ones((16,), np.float32)
        for pkg, to_t, drop in ((paddle.jit, _jt, jnn.Dropout(0.5)),
                                (jit, _tt, nn.Dropout(0.5))):
            drop.train()

            def f(x, drop=drop):
                y = drop(x)
                if float(y.sum()) > 1e9:
                    return y * 0
                return y

            fn = pkg.to_static(f)
            with pytest.warns(RuntimeWarning, match="RNG"):
                fn(to_t(x))
            assert _store(fn).dead is not None
            o1, o2 = fn(to_t(x)).numpy(), fn(to_t(x)).numpy()
            assert not np.array_equal(o1, o2)   # fresh masks, eagerly
            assert set(np.unique(o1)) <= {0.0, 2.0}

    def test_flag_disables_partial(self):
        x = np.ones((2,), np.float32)

        def body(x):
            if float(x.sum()) > 0:
                return x * 2
            return x

        got = []
        for pkg, to_t, switch in (
                (paddle.jit, _jt,
                 lambda on: flags.set_flags({"jit_partial_graph": on})),
                (jit, _tt, jit.enable_partial_graph)):
            switch(False)
            try:
                f, calls = _make_counted(body)
                fn = pkg.to_static(f)
                with pytest.warns(UserWarning):
                    fn(to_t(x))
                n = calls["n"]
                out = fn(to_t(x)).numpy()
                got.append((out, calls["n"] - n, len(fn._partial)))
            finally:
                switch(True)
        np.testing.assert_allclose(got[1][0], got[0][0], **TOL)
        assert got[1][1:] == got[0][1:] == (1, 0)   # plain eager


class TestInplaceMutationEvents:
    def test_fill_zero_are_recorded_and_replayed(self):
        def run(pkg, to_t):
            state = to_t(np.full((3,), 9.0, np.float32))

            def body(x):
                state.fill_(2.0)
                h = x + state
                if float(h.sum()) > 0:
                    state.zero_()
                    return h * 2
                return h

            f, calls = _make_counted(body)
            fn = pkg.to_static(f)
            x = to_t(np.ones((3,), np.float32))
            with pytest.warns(UserWarning, match="graph break"):
                out1 = fn(x).numpy()
            s1 = np.array(state.numpy())
            store = _store(fn)
            state.fill_(9.0)              # perturbed: the replay re-mutates
            n = calls["n"]
            out2 = fn(x).numpy()
            return (out1, s1, store.dead, len(store.traces), out2,
                    np.array(state.numpy()), calls["n"] - n)

        j = run(paddle.jit, _jt)
        t = run(jit, _tt)
        for i in (0, 1, 4, 5):
            np.testing.assert_allclose(t[i], j[i], **TOL)
        np.testing.assert_allclose(t[4], 6.0 * np.ones(3))
        np.testing.assert_allclose(t[5], np.zeros(3))
        assert t[2] is None and j[2] is None
        assert t[3] == j[3] == 1 and t[6] == j[6] == 0

    def test_set_value_rejects_trace_loudly(self):
        # the JAX set_value(numpy) is copy_ from a tensor over host data
        def run(pkg, to_t, set_value):
            state = to_t(np.zeros((2,), np.float32))
            feed = {"v": np.ones((2,), np.float32)}

            def f(x):
                set_value(state, feed["v"])     # untracked host data
                if float(x.sum()) > 0:
                    return x + state
                return x

            fn = pkg.to_static(f)
            x = to_t(np.ones((2,), np.float32))
            with pytest.warns(RuntimeWarning, match="set_value"):
                fn(x)
            dead = _store(fn).dead
            feed["v"] = np.full((2,), 5.0, np.float32)
            return fn(x).numpy(), dead

        j = run(paddle.jit, _jt, lambda s, v: s.set_value(v))
        t = run(jit, _tt, lambda s, v: s.copy_(torch.from_numpy(v)))
        np.testing.assert_allclose(t[0], j[0], **TOL)
        np.testing.assert_allclose(t[0], 6.0 * np.ones(2))
        assert t[1] is not None and j[1] is not None

    def test_copy_from_host_rejects_trace(self):
        deads = []
        for pkg, to_t, host in ((paddle.jit, _jt, lambda a: a),
                                (jit, _tt, torch.tensor)):
            state = to_t(np.zeros((2,), np.float32))

            def f(x, state=state, host=host):
                state.copy_(host(np.ones((2,), np.float32)))
                if float(x.sum()) > 0:
                    return x + state
                return x

            fn = pkg.to_static(f)
            with pytest.warns(RuntimeWarning, match="set_value"):
                out = fn(to_t(np.ones((2,), np.float32)))
            np.testing.assert_allclose(out.numpy(), 2.0 * np.ones(2))
            deads.append(_store(fn).dead)
        assert all(d is not None for d in deads)


class TestDifferentiableReturns:
    def test_differentiable_return_rejected_at_record_time(self):
        jl, tl = _linear_pair(5)
        x = _a((2, 3), 6)

        def run(pkg, to_t, lin, grad_of):
            def f(x):
                h = lin(x).sum()
                if float(h) > 1e9:
                    return h * 0
                return h          # differentiable: an outer backward()

            fn = pkg.to_static(f)
            with pytest.warns(RuntimeWarning, match="differentiable"):
                out = fn(to_t(x))
            dead = _store(fn).dead
            out2 = fn(to_t(x))
            out2.backward()
            return float(_np(out)), dead, grad_of(out2), grad_of(None)

        j = run(paddle.jit, _jt, jl,
                lambda o: (not o.stop_gradient) if o is not None
                else jl.weight.grad.numpy())
        t = run(jit, _tt, tl,
                lambda o: o.requires_grad if o is not None
                else tl.weight.grad.numpy().T)
        np.testing.assert_allclose(t[0], j[0], **TOL)
        assert j[1] is not None and t[1] is not None
        assert j[2] and t[2]                  # the eager result keeps a tape
        np.testing.assert_allclose(t[3], j[3], **TOL)

    def test_no_grad_returns_still_replay(self):
        jl, tl = _linear_pair(7)
        x = _a((2, 3), 8)

        def run(pkg, to_t, lin, no_grad, stops):
            def body(x):
                with no_grad():
                    h = lin(x).sum()
                if float(h) > 1e9:
                    return h * 0
                return h

            f, calls = _make_counted(body)
            fn = pkg.to_static(f)
            with pytest.warns(UserWarning, match="graph break"):
                out1 = fn(to_t(x))
            n = calls["n"]
            out2 = fn(to_t(x))    # replays
            return (float(out1.numpy()), float(out2.numpy()),
                    calls["n"] - n, stops(out2))

        j = run(paddle.jit, _jt, jl, paddle.no_grad, lambda o: o.stop_gradient)
        t = run(jit, _tt, tl, torch.no_grad, lambda o: not o.requires_grad)
        np.testing.assert_allclose(t[:2], j[:2], **TOL)
        assert t[0] == t[1]
        assert t[2:] == j[2:] == (0, True)


class TestShapeBucketedBreaks:
    def test_pow2_bucket(self):
        ns = (0, 1, 2, 3, 4, 5, 127, 128, 129)
        assert [api._pow2_bucket(n) for n in ns] \
            == [japi._pow2_bucket(n) for n in ns] \
            == [0, 1, 2, 4, 4, 8, 128, 128, 256]

    def test_same_bucket_skips_doomed_staging(self):
        def run(pkg, to_t):
            def body(x):
                n = int(x.sum())
                return x + n

            f, calls = _make_counted(body)
            fn = pkg.to_static(f)
            with pytest.warns(UserWarning, match="graph break"):
                fn(to_t(np.ones((130,), np.float32)))
            first = calls["n"]
            out = fn(to_t(np.ones((140,), np.float32)))   # same bucket
            return (first, calls["n"] - first, len(fn._eager_buckets),
                    len(fn._eager_keys), fn._eager_all, out.numpy())

        j = run(paddle.jit, _jt)
        t = run(jit, _tt)
        assert j[0] >= 2 and t[0] == 1       # first-call runs (docstring)
        assert t[1:5] == j[1:5] == (1, 1, 1, False)
        np.testing.assert_allclose(t[5], j[5], **TOL)

    def test_cap_counts_buckets_not_shapes(self):
        got = []
        for pkg, to_t in ((paddle.jit, _jt), (jit, _tt)):
            def f(x):
                n = int(x.sum())
                return x + n

            fn = pkg.to_static(f)
            with pytest.warns(UserWarning):
                for n in range(129, 129 + 20):  # 20 shapes, all bucket 256
                    fn(to_t(np.ones((n,), np.float32)))
            got.append((len(fn._eager_buckets), fn._eager_all,
                        len(fn._partial)))
        assert got[1] == got[0] == (1, False, 20)

    def test_cap_on_distinct_buckets_warns_permanently(self):
        limit = api._EAGER_KEYS_LIMIT
        assert limit == japi._EAGER_KEYS_LIMIT
        got = []
        for pkg, to_t in ((paddle.jit, _jt), (jit, _tt)):
            def f(x):
                n = int(x.sum())
                return x + n

            fn = pkg.to_static(f)
            with pytest.warns(UserWarning, match="PERMANENTLY"):
                for i in range(limit):               # distinct buckets
                    fn(to_t(np.ones((1 << i,), np.float32)))
            got.append((fn._eager_all, len(fn._eager_buckets)))
        assert got[1] == got[0] == (True, limit)


class TestPrimitiveSignature:
    def test_non_tensor_arg_specializes_the_cache(self):
        x = np.ones((2,), np.float32)
        for pkg, to_t in ((paddle.jit, _jt), (jit, _tt)):
            def f(x, k):
                return x * k

            fn = pkg.to_static(f)
            np.testing.assert_allclose(fn(to_t(x), 2).numpy(), 2 * x)
            np.testing.assert_allclose(fn(to_t(x), 5).numpy(), 5 * x)
            assert len(fn._cache) == 2

    def test_bucket_key_buckets_int_primitives(self):
        jk1 = ((((130,), "float32"),), None, (3,))
        jk2 = ((((140,), "float32"),), None, (4,))
        tk1 = ((((130,), "torch.float32", "cpu"),), None, (3,))
        tk2 = ((((140,), "torch.float32", "cpu"),), None, (4,))
        tk3 = ((((140,), "torch.float32", "cpu"),), None, (5,))
        assert japi._bucket_key(jk1) == japi._bucket_key(jk2)
        assert api._bucket_key(tk1) == api._bucket_key(tk2)
        assert api._bucket_key(tk1) != api._bucket_key(tk3)
