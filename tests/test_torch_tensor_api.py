"""The port's ``paddle.tensor`` (``paddle_tpu_torch/tensor/``) held to the
JAX package's on the CPU, function by function, on the same seeded numpy
inputs: the cases of ``tests/test_op_battery.py`` (its binary and unary
tables, the matmul family, reductions, manipulation, the NN ops it calls)
and of ``tests/test_tensor_ops.py``, merged into one table that reaches
every ported function.

* Forward: each result equal to the JAX one within rtol 1e-5 / atol 1e-6
  (the JAX ``op_test.check_output`` defaults), integer and bool results
  exactly, with the same dtype.
* Gradients through torch's autograd against the JAX tape, within 1e-4
  relative to the largest, for the differentiable cases.
* The in-place variants write their result into the input; the random
  ops keep shapes, dtypes, ranges and seeded repeats.
* ``x[np.int64(0)]`` is a write-back view (the contract ROADMAP C3 (a)
  says the JAX ``Tensor`` documents and fails).
* Importing the port adds exactly the JAX ``Tensor``'s names that
  ``torch.Tensor`` lacks, and replaces no attribute (in a subprocess).
* A method both have keeps torch's meaning (ROADMAP C10).
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu.core.tensor import Tensor as JaxTensor
from torch_tensor_cases import (
    CASES,
    FACTORIES,
    A,
    B,
    BL,
    I4,
    M,
    PA,
    SPD,
    T,
    X3,
    _rand,
)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    yield
    pt.set_device(None)


def _np(x):
    if isinstance(x, JaxTensor):
        return np.asarray(x.numpy())
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    return np.asarray(x)


def _build(args, pkg, leaves):
    out = []
    for a in args:
        if isinstance(a, T):
            if pkg is paddle:
                t = paddle.to_tensor(a.a)
                if a.grad:
                    t.stop_gradient = False
            else:
                t = torch.tensor(a.a, requires_grad=a.grad)
            if a.grad:
                leaves.append(t)
            out.append(t)
        elif isinstance(a, list) and a and isinstance(a[0], T):
            out.append(_build(a, pkg, leaves))
        else:
            out.append(a)
    return out


def _flat(res):
    if isinstance(res, (list, tuple)):
        out = []
        for r in res:
            out.extend(_flat(r))
        return out
    return [res]


def _run(pkg, fname, args, kwargs):
    leaves = []
    fn = getattr(pkg.tensor, fname)
    return fn(*_build(args, pkg, leaves), **kwargs), leaves


def _dtype(x):
    return str(_np(x).dtype)


def _check(got, want, name):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        gn, wn = _np(g), _np(w)
        assert gn.shape == wn.shape, (name, gn.shape, wn.shape)
        assert str(gn.dtype) == str(wn.dtype), (name, gn.dtype, wn.dtype)
        if np.issubdtype(wn.dtype, np.inexact):
            np.testing.assert_allclose(gn, wn, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gn, wn, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    fname, args, kwargs = CASES[case]
    want, _ = _run(paddle, fname, args, kwargs)
    got, _ = _run(pt, fname, args, kwargs)
    _check(got, want, case)


@pytest.mark.parametrize("case", sorted(FACTORIES))
def test_factories_match_jax(case):
    fname, args, kwargs = FACTORIES[case]
    want = getattr(paddle.tensor, fname)(*args, **kwargs)
    got = getattr(pt.tensor, fname)(*args, **kwargs)
    _check(got, want, case)
    assert all(t.device.type == "cpu" for t in _flat(got)
               if isinstance(t, torch.Tensor))


GRAD_CASES = sorted(c for c, (_, args, _) in CASES.items()
                    if any(isinstance(a, T) and a.grad for a in _flat(args)))


def _weights(outs):
    return [np.random.default_rng(i).standard_normal(_np(o).shape)
            .astype("float32") for i, o in enumerate(outs)]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_jax(case):
    """The gradient of ``sum(w * out)`` (fixed random ``w``) with respect
    to each differentiable input: torch's autograd against the JAX tape,
    within 1e-4 of the largest entry."""
    fname, args, kwargs = CASES[case]
    jout, jleaves = _run(paddle, fname, args, kwargs)
    pout, pleaves = _run(pt, fname, args, kwargs)
    jo = [o for o in _flat(jout) if np.issubdtype(_np(o).dtype,
                                                  np.floating)]
    po = [o for o in _flat(pout) if isinstance(o, torch.Tensor)
          and o.is_floating_point()]
    ws = _weights(jo)
    jl = None
    for o, w in zip(jo, ws):
        term = (o * paddle.to_tensor(w)).sum()
        jl = term if jl is None else jl + term
    jl.backward()
    pl = sum((o * torch.from_numpy(w)).sum() for o, w in zip(po, ws))
    grads = torch.autograd.grad(pl, pleaves, allow_unused=True)
    for jt, g in zip(jleaves, grads):
        want = (np.zeros_like(_np(jt)) if jt.grad is None
                else _np(jt.grad))
        got = np.zeros_like(want) if g is None else _np(g)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(
            np.abs(want).max(), 1e-6), err_msg=case)


def test_every_ported_function_is_held():
    """Each function of the port's ``tensor`` modules is in a table above,
    among the in-place or random checks, or a host helper named here."""
    mods = [pt.tensor.creation, pt.tensor.math, pt.tensor.manipulation,
            pt.tensor.linalg, pt.tensor.logic, pt.tensor.search,
            pt.tensor.random]
    names = {n for m in mods for n in dir(m)
             if not n.startswith("_") and callable(getattr(m, n))
             and getattr(getattr(m, n), "__module__", "").startswith(
                 "paddle_tpu_torch.tensor")}
    held = ({f for f, _, _ in CASES.values()}
            | {f for f, _, _ in FACTORIES.values()}
            | set(RANDOM) | {"svd", "qr", "eigh", "eig", "eigvals",
                             "lstsq", "lu_unpack", "svd_lowrank",
                             "pca_lowrank", "tolist", "is_tensor",
                             "increment", "create_parameter",
                             "top_p_sampling", "bernoulli_", "uniform_",
                             "normal_", "exponential_", "cauchy_",
                             "geometric_"})
    assert names - held == set()


@pytest.mark.parametrize("name", ["svd", "qr", "eigh", "svd_lowrank",
                                  "pca_lowrank", "lstsq", "eig"])
def test_decompositions_reconstruct_as_jax(name):
    """Decompositions are unique up to signs: the reconstruction and the
    values against the JAX ones."""
    a = _rand(4, 3, seed=13)
    if name == "svd":
        u, s, vh = pt.tensor.svd(torch.from_numpy(a))
        _, js, _ = paddle.tensor.linalg.svd(paddle.to_tensor(a))
        np.testing.assert_allclose(_np(s), _np(js), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(u * s @ vh), a, atol=1e-5)
    elif name == "qr":
        q, r = pt.tensor.qr(torch.from_numpy(a))
        jq, jr = paddle.tensor.linalg.qr(paddle.to_tensor(a))
        np.testing.assert_allclose(np.abs(_np(r)), np.abs(_np(jr)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(q @ r), a, atol=1e-5)
    elif name == "eigh":
        w, v = pt.tensor.eigh(torch.from_numpy(SPD))
        jw, _ = paddle.tensor.linalg.eigh(paddle.to_tensor(SPD))
        np.testing.assert_allclose(_np(w), _np(jw), rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(_np(v @ torch.diag(w) @ v.T), SPD,
                                   atol=1e-4)
    elif name in ("svd_lowrank", "pca_lowrank"):
        fn = getattr(pt.tensor, name)
        u, s, v = fn(torch.from_numpy(a), 2)
        _, js, _ = getattr(paddle.tensor.linalg, name)(paddle.to_tensor(a),
                                                       2)
        np.testing.assert_allclose(_np(s), _np(js), rtol=RTOL, atol=1e-5)
        assert tuple(u.shape) == (4, 2) and tuple(v.shape) == (3, 2)
    elif name == "lstsq":
        sol = pt.tensor.lstsq(torch.from_numpy(a), torch.from_numpy(
            _rand(4, 2)))[0]
        jsol = paddle.tensor.linalg.lstsq(paddle.to_tensor(a),
                                          paddle.to_tensor(_rand(4, 2)))[0]
        np.testing.assert_allclose(_np(sol), _np(jsol), rtol=1e-4,
                                   atol=1e-5)
    else:
        w, _ = pt.tensor.eig(torch.from_numpy(M))
        jw, _ = paddle.tensor.linalg.eig(paddle.to_tensor(M))
        np.testing.assert_allclose(np.sort_complex(_np(w)),
                                   np.sort_complex(_np(jw)), rtol=1e-5)
        np.testing.assert_allclose(
            np.sort_complex(_np(pt.tensor.eigvals(torch.from_numpy(M)))),
            np.sort_complex(_np(w)), rtol=1e-5)


def test_lu_unpack_reconstructs():
    lu, piv = pt.tensor.lu(torch.from_numpy(M))
    p, l, u = pt.tensor.lu_unpack(lu, piv)
    jlu, jpiv = paddle.tensor.linalg.lu(paddle.to_tensor(M))
    jp, jl, ju = paddle.tensor.linalg.lu_unpack(jlu, jpiv)
    for g, w in ((p, jp), (l, jl), (u, ju)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(p @ l @ u), M, atol=1e-5)


INPLACE = ["abs", "add", "clip", "exp", "sqrt", "scale", "floor", "tanh",
           "multiply", "reshape", "flatten", "cast", "t", "tril",
           "masked_fill", "put_along_axis", "unsqueeze", "squeeze"]
INPLACE_ARGS = {"add": [T(B)], "clip": [-0.5, 0.5], "scale": [2.0, 1.0],
                "multiply": [T(B)], "reshape": [[4, 3]], "flatten": [],
                "cast": ["float64"], "masked_fill": [T(BL), 0.25],
                "put_along_axis": [T(np.array([[0], [3], [1]])),
                                   T(np.array([[9.0]], "f4")), 1],
                "unsqueeze": [0], "squeeze": []}


@pytest.mark.parametrize("name", INPLACE)
def test_inplace_variants_write_their_input(name):
    a = PA if name == "sqrt" else A
    extra = INPLACE_ARGS.get(name, [])
    want = getattr(paddle.tensor, name + "_")(
        *_build([T(a)] + extra, paddle, []))
    x = torch.tensor(a)
    ret = getattr(pt.tensor, name + "_")(x, *_build(extra, pt, []))
    assert ret is x
    _check(x, want, name)


def test_inplace_method_forms_and_rebinds():
    x = pt.to_tensor(np.array([1.0, 4.0], "float32"))
    assert pt.tensor.sqrt_(x) is x
    np.testing.assert_allclose(x.numpy(), [1.0, 2.0])
    y = pt.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], "float32"))
    pt.tensor.t_(y)
    np.testing.assert_allclose(y.numpy(), [[1.0, 3.0], [2.0, 4.0]])
    z = pt.to_tensor(np.zeros(4, "float32"))
    assert z.reshape_([2, 2]) is z and tuple(z.shape) == (2, 2)
    w = pt.to_tensor(np.ones(3, "float32"), stop_gradient=False)
    pt.tensor.scale_(w, 3.0)             # a leaf that requires grad
    np.testing.assert_allclose(w.detach().numpy(), [3.0, 3.0, 3.0])
    f = pt.to_tensor(np.zeros((3, 3), "float32"))
    pt.tensor.fill_diagonal_(f, 5.0, offset=1)
    jf = paddle.to_tensor(np.zeros((3, 3), "float32"))
    paddle.tensor.fill_diagonal_(jf, 5.0, offset=1)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf.numpy()))
    g = pt.to_tensor(np.zeros(8, "float32"))
    pt.tensor.gaussian_(g, seed=3)
    assert g.abs().sum() > 0


RANDOM = {
    "rand": lambda: pt.tensor.rand([2, 3]),
    "randn": lambda: pt.tensor.randn([2, 3]),
    "standard_normal": lambda: pt.tensor.standard_normal([2, 3]),
    "standard_gamma": lambda: pt.tensor.standard_gamma(
        pt.to_tensor(np.full(6, 2.0, "f4"))),
    "standard_exponential": lambda: pt.tensor.standard_exponential([6]),
    "uniform": lambda: pt.tensor.uniform([2, 3], min=-2.0, max=2.0),
    "normal": lambda: pt.tensor.normal(1.0, 2.0, [2, 3]),
    "gaussian": lambda: pt.tensor.gaussian([2, 3], seed=5),
    "randint": lambda: pt.tensor.randint(0, 10, [100]),
    "randint_like": lambda: pt.tensor.randint_like(
        pt.to_tensor(I4), 0, 5),
    "randperm": lambda: pt.tensor.randperm(10),
    "bernoulli": lambda: pt.tensor.bernoulli(
        pt.to_tensor(np.full((50,), 0.5, "f4"))),
    "poisson": lambda: pt.tensor.poisson(pt.to_tensor(np.full(8, 3.0, "f4"))),
    "binomial": lambda: pt.tensor.binomial(
        pt.to_tensor(np.full(8, 10, "int64")), 0.5),
    "multinomial": lambda: pt.tensor.multinomial(
        pt.to_tensor(np.full((2, 6), 1 / 6, "f4")), 3),
    "rand_like": lambda: pt.tensor.rand_like(pt.to_tensor(A)),
    "randn_like": lambda: pt.tensor.randn_like(pt.to_tensor(A)),
    "shuffle": lambda: pt.tensor.shuffle(pt.to_tensor(np.arange(10))),
}
RANDOM_JAX = {
    "standard_gamma": lambda: paddle.tensor.standard_gamma(
        paddle.to_tensor(np.full(6, 2.0, "f4"))),
    "randint_like": lambda: paddle.tensor.randint_like(
        paddle.to_tensor(I4), 0, 5),
    "bernoulli": lambda: paddle.tensor.bernoulli(
        paddle.to_tensor(np.full((50,), 0.5, "f4"))),
    "poisson": lambda: paddle.tensor.poisson(
        paddle.to_tensor(np.full(8, 3.0, "f4"))),
    "binomial": lambda: paddle.tensor.binomial(
        paddle.to_tensor(np.full(8, 10, "int64")), 0.5),
    "multinomial": lambda: paddle.tensor.multinomial(
        paddle.to_tensor(np.full((2, 6), 1 / 6, "f4")), 3),
    "rand_like": lambda: paddle.tensor.rand_like(paddle.to_tensor(A)),
    "randn_like": lambda: paddle.tensor.randn_like(paddle.to_tensor(A)),
    "shuffle": lambda: paddle.tensor.shuffle(paddle.to_tensor(np.arange(10))),
}


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_ops_shape_dtype_and_seeded_repeat(name):
    """The JAX key and torch's generators draw differently: the shape and
    dtype match the JAX op's, and a seed repeats the port's draw."""
    pt.seed(7)
    a = RANDOM[name]()
    pt.seed(7)
    b = RANDOM[name]()
    np.testing.assert_array_equal(_np(a), _np(b))
    paddle.seed(7)
    want = RANDOM_JAX.get(name, lambda: getattr(paddle.tensor, name)(
        *RANDOM_ARGS.get(name, ([2, 3],))))()
    assert _np(a).shape == _np(want).shape
    assert _dtype(a) == _dtype(want), (name, _dtype(a), _dtype(want))
    if name == "randperm" or name == "shuffle":
        np.testing.assert_array_equal(np.sort(_np(a)), np.arange(10))
    if name in ("randint", "randint_like"):
        assert _np(a).min() >= 0 and _np(a).max() < 10


RANDOM_ARGS = {"standard_exponential": ([6],), "randint": (0, 10, [100]),
               "randperm": (10,), "normal": (1.0, 2.0, [2, 3])}


def test_in_place_random_fills():
    x = pt.to_tensor(np.zeros(100, "float32"))
    pt.seed(0)
    x.cauchy_() if hasattr(x, "cauchy_") else pt.tensor.cauchy_(x)
    assert x.abs().sum() > 0
    for fill in (pt.tensor.uniform_, pt.tensor.normal_,
                 pt.tensor.exponential_, pt.tensor.bernoulli_):
        y = pt.to_tensor(np.zeros(64, "float32"))
        assert fill(y) is y and y.abs().sum() > 0
    z = pt.to_tensor(np.zeros(64, "float32"))
    pt.tensor.geometric_(z, 0.3)
    assert z.min() >= 1


def test_top_p_sampling_keeps_the_nucleus():
    probs = np.array([[0.5, 0.3, 0.15, 0.05]] * 64, "float32")
    vals, ids = pt.tensor.top_p_sampling(pt.to_tensor(probs),
                                         pt.to_tensor(np.full(64, 0.7, "f4")),
                                         seed=1)
    jv, jids = paddle.tensor.top_p_sampling(
        paddle.to_tensor(probs), paddle.to_tensor(np.full(64, 0.7, "f4")),
        seed=1)
    assert tuple(ids.shape) == _np(jids).shape == (64, 1)
    assert _dtype(ids) == _dtype(jids) == "int64"
    assert set(_np(ids).ravel()) <= {0, 1} and set(_np(jids).ravel()) <= {0,
                                                                           1}
    np.testing.assert_allclose(_np(vals), probs[0][_np(ids)[:, 0]][:, None])


def test_creation_parameter_and_helpers():
    p = pt.tensor.create_parameter([3, 2], "float32")
    assert isinstance(p, torch.nn.Parameter) and tuple(p.shape) == (3, 2)
    b = pt.tensor.create_parameter([4], "float32", is_bias=True)
    assert float(b.abs().sum()) == 0.0
    x = pt.to_tensor(np.array([1.0, 2.0], "float32"))
    assert pt.tensor.increment(x, 2.0) is x
    np.testing.assert_allclose(x.numpy(), [3.0, 4.0])
    assert pt.tensor.tolist(x) == [3.0, 4.0]
    assert pt.tensor.is_tensor(x) and not pt.tensor.is_tensor(1.0)
    assert int(pt.rank(pt.to_tensor(X3))) == 3
    assert pt.shape(pt.to_tensor(X3)).tolist() == [2, 3, 4]
    assert int(pt.numel(pt.to_tensor(X3))) == 24
    assert pt.is_floating_point(x) and not pt.is_integer(x)
    assert pt.is_integer(pt.to_tensor(I4)) and not pt.is_complex(x)
    np.testing.assert_array_equal(
        pt.reverse(x, 0).numpy(), np.asarray(paddle.reverse(
            paddle.to_tensor(np.array([3.0, 4.0], "f4")), 0).numpy()))


def test_to_tensor_as_the_jax_one():
    for data, dtype in ((1.5, None), ([1, 2, 3], None), ([True], None),
                        (np.ones((2, 2)), None), ([1, 2], "float16"),
                        (np.arange(3, dtype=np.int32), None)):
        got = pt.to_tensor(data, dtype=dtype)
        want = paddle.to_tensor(data, dtype=dtype)
        assert _dtype(got) == _dtype(want)
        np.testing.assert_array_equal(_np(got), _np(want))
    buf = np.ones((2, 2), np.float32)
    t = pt.to_tensor(buf, stop_gradient=False)
    buf[...] = 7.0                      # the data is copied
    assert float(t.sum()) == 4.0 and t.requires_grad and not t.stop_gradient
    assert pt.to_tensor(t).device.type == "cpu"
    assert pt.to_tensor(buf, place="cpu").device.type == "cpu"


def test_reshape_keeps_a_dim_where_the_shape_says_zero():
    """Paddle's ``reshape`` reads 0 as "keep this dim" (the JAX function
    passes the shape to ``jnp.reshape``, which divides by the 0)."""
    x = pt.to_tensor(X3)
    assert tuple(pt.reshape(x, [0, -1]).shape) == (2, 12)
    assert tuple(pt.reshape(x, [0, 0, 2, 2]).shape) == (2, 3, 2, 2)


def test_numpy_integer_index_is_a_write_back_view():
    """ROADMAP C3 (a): ``x[np.int64(0)]`` is a view, and an in-place op on
    it writes into ``x`` — the contract the JAX ``Tensor`` documents."""
    x = pt.to_tensor(np.zeros((2, 3), "float32"))
    v = x[np.int64(0)]
    v.add_(1.0)
    np.testing.assert_allclose(x.numpy()[0], 1.0)
    pt.tensor.add_(x[np.int64(1)], pt.to_tensor(np.full(3, 2.0, "f4")))
    np.testing.assert_allclose(x.numpy()[1], 2.0)
    assert pt.tensor.getitem(x, np.int64(1))._base is x


def test_clashing_methods_keep_torch_meaning():
    """ROADMAP C10: where both have the name, the method is torch's and the
    module function Paddle's."""
    x = pt.to_tensor(X3)
    assert tuple(x.transpose(0, 2).shape) == (4, 3, 2)
    assert tuple(pt.transpose(x, [2, 0, 1]).shape) == (4, 2, 3)
    m = x.max(1)
    assert isinstance(m, tuple) and len(m) == 2          # torch: values, idx
    np.testing.assert_allclose(pt.max(x, axis=1).numpy(), X3.max(1))
    assert len(x.split(1, 0)) == 2                        # torch: sizes
    assert len(pt.split(x, 3, axis=1)) == 3               # Paddle: a count
    assert x.astype("float64").dtype == torch.float64     # Paddle's name
    assert x.stop_gradient and not x.requires_grad
    x.stop_gradient = False
    assert x.requires_grad
    assert x.place == x.device and x.rank == 3 and x.item_size == 4


_SUBPROCESS = textwrap.dedent("""
    import json, torch
    names, own = set(dir(torch.Tensor)), dict(vars(torch.Tensor))
    import paddle_tpu_torch  # noqa: F401
    now = vars(torch.Tensor)
    added = sorted(set(dir(torch.Tensor)) - names)
    # a name torch had (its own or inherited) now set to another object
    replaced = sorted(n for n in names if n in now
                      and (n not in own or now[n] is not own[n]))
    print(json.dumps({"added": added, "replaced": replaced}))
""")


def test_import_adds_exactly_the_absent_jax_tensor_names():
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS],
                         capture_output=True, text=True, check=True,
                         cwd=str(pt.__path__[0] + "/.."))
    res = json.loads(out.stdout.strip().splitlines()[-1])
    public = {n for n in dir(JaxTensor) if not n.startswith("_")}
    absent = sorted(n for n in public if not hasattr(torch.Tensor, n)
                    or n in pt.tensor._PADDLE_METHODS)
    assert res["replaced"] == []
    assert res["added"] == absent
    assert len(absent) == 121
