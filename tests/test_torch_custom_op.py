"""The custom-op extension path of the PyTorch port, held to the JAX package.

Case for case with ``tests/test_custom_op.py``: the same seeded numpy
inputs go through ``paddle_tpu.utils`` and ``paddle_tpu_torch.utils``.

* ``register_custom_op``: a torch composition differentiated by autograd
  (outputs and gradients within 1e-6 of the jnp composition), the custom
  VJP (``bwd`` once, the registry, the unknown-name ``KeyError``), the rule
  that ``bwd`` gets only the ``nondiff_argnames`` passed as keywords, and
  re-registration.
* ``ops/scaled.py``: the twin of the example kernel against the JAX Pallas
  kernel run as ``tests/test_custom_op.py`` runs it (interpret mode on the
  CPU), fp32 and bf16: bit for bit (tolerance 0), gradients too.  The
  naive ``bf16(float(x) * alpha)`` fails that check at ``alpha=0.1``.
* ``cpp_extension.load``: ``my_relu6`` and its gradient against the JAX
  extension built from the same source, the grad-less ``my_square``, the
  build cache, and g++'s message on a source that does not compile.
* Under ``jit.to_static``: a registered composition
  (``test_custom_op.py:93``) and a host op (``:152``), against the JAX
  package's ``to_static`` of the same; a host op inside a graph-broken
  function keeps it eager (the port's recorder cannot see it).
* ``host_build`` onto the CPU (the only device here): every parameter,
  buffer and tensor lands there with its value unchanged.

The tests marked ``cuda`` run the CUDA kernel and a host op on the card and
skip elsewhere.  JAX is imported inside the tests that use it, so this file
also runs on a machine without JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_custom_op.py``).
"""

import functools
import os
import textwrap

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit, utils
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import scaled as sc
from paddle_tpu_torch.utils import cpp_extension, extension, host_build


@pytest.fixture
def registry():
    """Restore the port's op registry after a test that registers names of
    its own (``my_scaled`` among them)."""
    saved = dict(extension._REGISTRY)
    yield extension._REGISTRY
    extension._REGISTRY.clear()
    extension._REGISTRY.update(saved)


def _jax():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.utils import cpp_extension as jcpp
    from paddle_tpu.utils import extension as jext

    return paddle, jext, jcpp


# --- register_custom_op -------------------------------------------------------

def test_composition_autodiff_matches_jax(registry):
    import jax.numpy as jnp

    paddle, jext, _ = _jax()
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)

    @extension.register_custom_op
    def my_softsign(x):
        return x / (1.0 + torch.abs(x))

    @jext.register_custom_op
    def my_softsign_jax(x):
        return x / (1.0 + jnp.abs(x))

    xt = torch.from_numpy(x).requires_grad_()
    y = my_softsign(xt)
    y.sum().backward()
    xj = paddle.to_tensor(x)
    xj.stop_gradient = False
    yj = my_softsign_jax(xj)
    yj.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), yj.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), xj.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), 1.0 / (1.0 + np.abs(x)) ** 2,
                               rtol=1e-5)


def test_custom_vjp_used_once_and_registered(registry):
    paddle, jext, _ = _jax()
    calls = {"port": 0, "jax": 0}

    def make(key):
        def kern(x, alpha=2.0):
            return x * alpha

        def fwd(x, alpha=2.0):
            return x * alpha, None

        def bwd(alpha, res, g):
            calls[key] += 1
            return (g * alpha,)

        return kern, fwd, bwd

    kern, fwd, bwd = make("port")
    my_scaled = extension.register_custom_op(
        kern, name="my_scaled", vjp=(fwd, bwd), nondiff_argnames=("alpha",))
    x = torch.ones(4, requires_grad=True)
    y = my_scaled(x, alpha=3.0)
    y.sum().backward()

    kern, fwd, bwd = make("jax")
    jop = jext.register_custom_op(kern, name="my_scaled", vjp=(fwd, bwd),
                                  nondiff_argnames=("alpha",))
    xj = paddle.to_tensor(np.ones(4, "float32"))
    xj.stop_gradient = False
    yj = jop(xj, alpha=3.0)
    yj.sum().backward()

    np.testing.assert_array_equal(y.detach().numpy(), yj.numpy())
    np.testing.assert_array_equal(x.grad.numpy(), xj.grad.numpy())
    np.testing.assert_array_equal(x.grad.numpy(), np.full(4, 3.0))
    assert calls == {"port": 1, "jax": 1}
    assert extension.get_custom_op("my_scaled") is my_scaled
    assert extension.registered_ops()["my_scaled"] is my_scaled

    messages = []
    for get in (extension.get_custom_op, jext.get_custom_op):
        with pytest.raises(KeyError) as e:
            get("no_such_op")
        messages.append(e.value.args[0])
    ours, theirs = messages
    assert ours == (f"no custom op 'no_such_op' registered "
                    f"(have: {sorted(extension.registered_ops())})")
    assert theirs == (f"no custom op 'no_such_op' registered "
                      f"(have: {sorted(jext.registered_ops())})")


@pytest.mark.parametrize("passed", [True, False], ids=["keyword", "default"])
def test_bwd_gets_only_the_nondiff_kwargs_passed(registry, passed):
    """``bwd``'s configuration holds the ``nondiff_argnames`` passed as
    keywords, in their order; a default left unpassed is not in it
    (``paddle_tpu/utils/extension.py:103``)."""
    paddle, jext, _ = _jax()
    seen = {}

    def make(key):
        def kern(x, alpha=2.0, beta=1.0):
            return x * alpha + beta

        def fwd(x, alpha=2.0, beta=1.0):
            return x * alpha + beta, None

        def bwd(*args):
            *cfg, _, g = args
            seen[key] = tuple(cfg)
            return (g * (cfg[0] if len(cfg) == 2 else 2.0),)

        return kern, fwd, bwd

    kw = {"alpha": 3.0, "beta": 0.5} if passed else {"beta": 0.5}
    kern, fwd, bwd = make("port")
    op = extension.register_custom_op(kern, name="cfg_op", vjp=(fwd, bwd),
                                      nondiff_argnames=("alpha", "beta"))
    x = torch.ones(3, requires_grad=True)
    op(x, **kw).sum().backward()
    kern, fwd, bwd = make("jax")
    jop = jext.register_custom_op(kern, name="cfg_op", vjp=(fwd, bwd),
                                  nondiff_argnames=("alpha", "beta"))
    xj = paddle.to_tensor(np.ones(3, "float32"))
    xj.stop_gradient = False
    jop(xj, **kw).sum().backward()
    assert seen["port"] == seen["jax"] == ((3.0, 0.5) if passed else (0.5,))
    np.testing.assert_array_equal(x.grad.numpy(), xj.grad.numpy())


def test_custom_op_under_to_static(registry):
    import jax.numpy as jnp

    paddle, jext, _ = _jax()
    x = np.array([0.0, 3.0], "float32")

    @extension.register_custom_op(name="squareplus")
    def squareplus(x):
        return 0.5 * (x + torch.sqrt(x * x + 4.0))

    @jext.register_custom_op(name="squareplus")
    def squareplus_jax(x):
        return 0.5 * (x + jnp.sqrt(x * x + 4.0))

    f = jit.to_static(lambda x: squareplus(x) * 2.0)
    jf = paddle.jit.to_static(lambda x: squareplus_jax(x) * 2.0)
    got = f(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jf(paddle.to_tensor(x)).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(got, x + np.sqrt(x ** 2 + 4.0), rtol=1e-6)
    assert len(f._cache) == 1


def test_registering_a_name_again_replaces_it(registry):
    first = extension.register_custom_op(lambda x: x + 1, name="twice")
    second = extension.register_custom_op(lambda x: x + 2, name="twice")
    assert extension.get_custom_op("twice") is second is not first
    assert float(extension.get_custom_op("twice")(torch.zeros(1))) == 2.0


def test_residuals_tuple_and_no_grad_take_the_primal(registry):
    """Residual tensors reach ``bwd`` as ``fwd`` returned them (here the
    output itself and a number), and without a gradient to take the op
    runs ``fn`` (the primal), as a ``custom_vjp`` function does outside a
    transformation."""
    calls = []

    def kern(x):
        calls.append("fn")
        return torch.exp(x)

    def fwd(x):
        calls.append("fwd")
        y = torch.exp(x)
        return y, (y, 2)

    def bwd(res, g):
        y, two = res
        return (g * y * two / 2,)

    op = extension.register_custom_op(kern, name="my_exp", vjp=(fwd, bwd))
    x = torch.linspace(-1, 1, 5, requires_grad=True)
    op(x).sum().backward()
    torch.testing.assert_close(x.grad, torch.exp(x.detach()), atol=0, rtol=0)
    with torch.no_grad():
        op(x)
    op(x.detach())
    assert calls == ["fwd", "fn", "fn"]


def test_profiler_shows_the_op_by_name(registry):
    op = extension.register_custom_op(lambda x: x * 2, name="named_op")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        op(torch.ones(8))
    assert "named_op" in {e.key for e in prof.key_averages()}


def test_no_range_is_opened_without_a_profiler(registry, monkeypatch):
    """Outside a profiler the op opens no ``record_function`` range (it
    would cost more host time than a small kernel's launch)."""
    op = extension.register_custom_op(lambda x: x * 2, name="quiet_op")

    def refuse(name):
        raise AssertionError(f"a range {name!r} was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert torch.equal(op(torch.ones(4)), torch.full((4,), 2.0))


def test_non_tensor_arguments_follow_the_first_tensor(registry, monkeypatch):
    op = extension.register_custom_op(lambda a, b: a + b, name="add2")
    out = op(torch.ones(3, dtype=torch.float32), np.arange(3.0))
    assert out.device.type == "cpu" and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), [1.0, 2.0, 3.0])
    # no tensor argument: the card, which raises where there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        op(np.ones(3), [1.0, 2.0, 3.0])


# --- ops/scaled.py: kernel B6's twin against the JAX Pallas kernel ------------

def _jax_scaled_op():
    """The runnable twin of the JAX docstring example
    (``tests/test_custom_op.py::test_pallas_kernel_registration``),
    registered in the JAX package."""
    import jax
    from jax.experimental import pallas as pl

    _, jext, _ = _jax()

    def _kernel(x_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha

    def scaled(x, alpha=2.0):
        return pl.pallas_call(
            functools.partial(_kernel, alpha=alpha),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=jax.default_backend() == "cpu")(x)

    def fwd(x, alpha=2.0):
        return scaled(x, alpha), None

    def bwd(alpha, res, g):
        return (g * alpha,)

    return jext.register_custom_op(scaled, name="pallas_scaled",
                                   vjp=(fwd, bwd),
                                   nondiff_argnames=("alpha",))


def _bits(a):
    """The raw bits of a float array or tensor (bit-for-bit comparison)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _jax_run(x, g, alpha, dtype):
    paddle, _, _ = _jax()
    op = _jax_scaled_op()
    xj = paddle.to_tensor(x, dtype=dtype)
    xj.stop_gradient = False
    y = op(xj, alpha=alpha)
    y.backward(paddle.to_tensor(g, dtype=dtype))
    return _bits(y._value), _bits(xj.grad._value)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("alpha", [2.0, 3.0, 0.1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scaled_is_bit_exact_with_the_pallas_kernel(registry, dtype, alpha):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    g = rng.standard_normal((64, 64)).astype(np.float32)
    want_y, want_gx = _jax_run(x, g, alpha, dtype)

    xt = torch.from_numpy(x).to(DTYPES[dtype]).requires_grad_()
    y = sc.my_scaled(xt, alpha=alpha)
    assert sc.last_path == "reference" and y.dtype == DTYPES[dtype]
    y.backward(torch.from_numpy(g).to(DTYPES[dtype]))
    np.testing.assert_array_equal(_bits(y), want_y)
    np.testing.assert_array_equal(_bits(xt.grad), want_gx)


def test_naive_bf16_rounding_fails_the_bit_check(registry):
    """``bf16(float(x) * alpha)`` — PyTorch's own ``x * alpha`` on bf16 —
    keeps alpha in fp32 and differs from the JAX kernel at alpha=0.1,
    where the twin (alpha rounded to bf16 first) does not."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    want, _ = _jax_run(x, x, 0.1, "bfloat16")
    xt = torch.from_numpy(x).bfloat16()
    naive = (xt.float() * 0.1).bfloat16()
    assert (_bits(naive) != want).sum() > 0
    assert (_bits(xt * 0.1) != want).sum() > 0
    np.testing.assert_array_equal(_bits(sc.scaled_reference(xt, 0.1)), want)


def test_scaled_fp16_twin_rounds_alpha_first():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(512)
                         .astype(np.float32)).half()
    a = torch.tensor(0.1, dtype=torch.float16)
    torch.testing.assert_close(sc.scaled_reference(x, 0.1),
                               (x.float() * a.float()).half(), atol=0, rtol=0)
    assert sc.rounded_alpha(0.1, torch.float16) == float(a)


def test_scaled_on_a_cpu_tensor_cannot_force_the_kernel():
    """The device decides: a CPU tensor takes the twin through ``scaled``,
    and the kernel's wrapper refuses it without counting a launch."""
    x = torch.ones(4)
    launches = sc.launches
    with pytest.raises(ValueError, match="CUDA device"):
        sc.scaled_kernel(x, 2.0)
    assert sc.launches == launches
    assert torch.equal(sc.scaled(x, 2.0), torch.full((4,), 2.0))
    assert sc.last_path == "reference"
    assert sc.launches == launches
    assert extension.get_custom_op("my_scaled") is sc.my_scaled


# --- cpp_extension ------------------------------------------------------------

CPP_SOURCE = textwrap.dedent("""
    #include <cstdint>
    #include <cmath>
    extern "C" void my_relu6(const float* x, float* y, int64_t n) {
        for (int64_t i = 0; i < n; ++i) {
            float v = x[i] < 0.f ? 0.f : x[i];
            y[i] = v > 6.f ? 6.f : v;
        }
    }
    extern "C" void my_relu6_grad(const float* x, const float* gy,
                                  float* gx, int64_t n) {
        for (int64_t i = 0; i < n; ++i)
            gx[i] = (x[i] > 0.f && x[i] < 6.f) ? gy[i] : 0.f;
    }
    extern "C" void my_square(const float* x, float* y, int64_t n) {
        for (int64_t i = 0; i < n; ++i) y[i] = x[i] * x[i];
    }
""")


@pytest.fixture(scope="module")
def ext(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_custom_op")
    src = d / "my_ops.cc"
    src.write_text(CPP_SOURCE)
    return cpp_extension.load(name="my_ops", sources=[str(src)],
                              functions=["my_relu6", "my_square"],
                              build_directory=str(d / "build"))


@pytest.fixture(scope="module")
def jax_ext(tmp_path_factory):
    _, _, jcpp = _jax()
    d = tmp_path_factory.mktemp("jax_custom_op")
    src = d / "my_ops.cc"
    src.write_text(CPP_SOURCE)
    return jcpp.load(name="my_ops", sources=[str(src)],
                     functions=["my_relu6", "my_square"],
                     build_directory=str(d / "build"))


def test_host_op_output_and_grad_match_jax(ext, jax_ext):
    paddle, _, _ = _jax()
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(256) * 5).astype(np.float32)
    g = rng.standard_normal(256).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = ext.my_relu6(xt)
    y.backward(torch.from_numpy(g))
    xj = paddle.to_tensor(x)
    xj.stop_gradient = False
    yj = jax_ext.my_relu6(xj)
    yj.backward(paddle.to_tensor(g))
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    np.testing.assert_array_equal(y.detach().numpy(), yj.numpy())
    np.testing.assert_array_equal(xt.grad.numpy(), xj.grad.numpy())
    np.testing.assert_array_equal(y.detach().numpy(), np.clip(x, 0, 6))


def test_gradless_host_op_forward_only(ext, jax_ext):
    paddle, _, _ = _jax()
    x = np.array([3.0, -1.5], "float32")
    np.testing.assert_array_equal(ext.my_square(torch.from_numpy(x)).numpy(),
                                  jax_ext.my_square(paddle.to_tensor(x))
                                  .numpy())
    # bf16 in, fp32 out, as the JAX op's v.astype(float32)
    out = ext.my_square(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.float32
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(RuntimeError, match="my_square_grad"):
        ext.my_square(xt).sum().backward()


def test_host_op_works_under_to_static(ext, jax_ext):
    paddle, _, _ = _jax()
    x = np.array([-2.0, 3.0], "float32")
    f = jit.to_static(lambda x: ext.my_relu6(x) + 1.0)
    jf = paddle.jit.to_static(lambda x: jax_ext.my_relu6(x) + 1.0)
    for _ in range(2):
        got = f(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, jf(paddle.to_tensor(x)).numpy())
        np.testing.assert_array_equal(got, [1.0, 4.0])


def test_host_op_keeps_a_broken_function_eager(ext):
    """The host op writes its output through a pointer the dispatcher
    never sees: a partial-graph trace would replay an empty tensor, so
    the signature runs eagerly."""
    def f(x):
        y = ext.my_relu6(x)
        if float(y.sum()) > 1e9:
            return y * 0
        return y + 1.0

    fn = jit.to_static(f)
    with pytest.warns(RuntimeWarning, match="dispatcher"):
        fn(torch.tensor([-2.0, 3.0]))
    assert fn._partial[next(iter(fn._partial))].dead is not None
    np.testing.assert_array_equal(fn(torch.tensor([4.0, 9.0])).numpy(),
                                  [5.0, 7.0])


def test_build_cache_reused(ext, tmp_path):
    src = tmp_path / "my_ops.cc"
    src.write_text(CPP_SOURCE)
    bdir = os.path.dirname(ext.__so_path__)
    again = cpp_extension.load(name="my_ops", sources=[str(src)],
                               functions=["my_square"], build_directory=bdir)
    assert again.__so_path__ == ext.__so_path__
    assert os.listdir(bdir) == [os.path.basename(ext.__so_path__)]


def test_bad_source_raises_with_the_compiler_message(tmp_path):
    src = tmp_path / "broken.cc"
    src.write_text('extern "C" void broken(const float* x, float* y, '
                   'long n) { y[0] = undefined_name; }\n')
    with pytest.raises(cpp_extension.ExtensionBuildError,
                       match="(?s)g\\+\\+ failed for broken.*undefined_name"):
        cpp_extension.load(name="broken", sources=[str(src)],
                           build_directory=str(tmp_path / "build"))


def test_build_directory_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_EXTENSION_DIR", str(tmp_path))
    assert cpp_extension.get_build_directory() == str(tmp_path)
    monkeypatch.delenv("PADDLE_EXTENSION_DIR")
    assert os.path.normpath(cpp_extension.get_build_directory()).endswith(
        os.path.join("paddle_tpu_torch", "_build", "extensions"))
    with pytest.raises(NotImplementedError, match="load"):
        cpp_extension.setup(name="x")
    assert cpp_extension.CUDAExtension(["a.cc"]).sources == ["a.cc"]


# --- host_build and the package surface ---------------------------------------

def test_host_build_moves_everything_with_values_unchanged():
    before = {}

    def build():
        gen = torch.Generator().manual_seed(0)
        model = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=2),
                                 device="cpu", generator=gen)
        extra = torch.arange(6.0).reshape(2, 3)   # no device: the context
        out = {"model": model, "misc": (extra, [torch.ones(2)]), "n": 3}
        before.update({k: v.clone() for k, v in model.state_dict().items()})
        before["extra"] = extra.clone()
        return out

    logs = []
    out = host_build(build, log=logs.append, device="cpu")
    model = out["model"]
    tensors = [*model.parameters(), *model.buffers(), out["misc"][0],
               out["misc"][1][0]]
    assert {t.device for t in tensors} == {torch.device("cpu")}
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(out["misc"][0], before["extra"]) and out["n"] == 3
    assert len(logs) == 1 and "moving to cpu" in logs[0]


def test_host_build_without_a_card_raises_before_building(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        host_build(lambda: built.append(1))
    assert built == []
    with pytest.warns(RuntimeWarning, match="nothing was moved"):
        assert host_build(lambda: {"n": 1}, device="cpu") == {"n": 1}


def test_utils_exports_match_the_jax_package():
    _jax()
    import paddle_tpu.utils as jutils

    names = {n for n in dir(jutils) if not n.startswith("_")}
    assert names <= set(dir(utils))
    assert utils.require_version("2.0.0")
    with pytest.raises(Exception, match="required"):
        utils.require_version("9.0.0")
    assert utils.try_import("no_such_module_here") is None
    with pytest.warns(DeprecationWarning, match="since 1.0"):
        assert utils.deprecated(since="1.0")(lambda: 5)() == 5
    utils.run_check(device="cpu")


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 4097, 1_000_003])
@pytest.mark.parametrize("alpha", [2.0, 3.0, 0.1, -3.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_cuda_kernel_is_bit_exact_with_the_twin(cuda, dtype, alpha, n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n + 3)
                         .astype(np.float32)).to(cuda).to(dtype)
    for view in (x[:n], x[3:]):   # aligned, then at storage offset 3
        launches = sc.launches
        out = sc.scaled(view, alpha)
        torch.cuda.synchronize()
        assert sc.last_path == "cuda" and sc.launches == launches + 1
        assert out.dtype == dtype and out.shape == view.shape
        assert torch.equal(out, sc.scaled_reference(view, alpha))


@pytest.mark.cuda
def test_cuda_kernel_takes_a_strided_view(cuda):
    x = torch.randn(64, 96, device=cuda, dtype=torch.bfloat16)
    view = x.t()[::2]
    assert not view.is_contiguous()
    out = sc.scaled(view, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(out, sc.scaled_reference(view, 0.1))


@pytest.mark.cuda
def test_cuda_registered_op_launches_once_a_call(cuda):
    x = torch.randn(4096, device=cuda, dtype=torch.bfloat16,
                    requires_grad=True)
    launches = sc.launches
    y = sc.my_scaled(x, alpha=3.0)
    y.sum().backward()
    torch.cuda.synchronize()
    assert sc.launches == launches + 1
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


@pytest.mark.cuda
def test_cuda_host_op_returns_on_the_card(cuda, ext):
    x = torch.from_numpy((np.random.default_rng(3).standard_normal(512) * 5)
                         .astype(np.float32))
    xc = x.to(cuda).requires_grad_()
    y = ext.my_relu6(xc)
    y.sum().backward()
    assert y.device.type == "cuda" and xc.grad.device.type == "cuda"
    torch.testing.assert_close(y.cpu(), ext.my_relu6(x), atol=0, rtol=0)
    torch.testing.assert_close(xc.grad.cpu(),
                               ((x > 0) & (x < 6)).float(), atol=0, rtol=0)
