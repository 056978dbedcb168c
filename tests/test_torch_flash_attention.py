"""Flash attention in the PyTorch port, held to the JAX package.

On the CPU (fp32, inputs from numpy seeds):

* the three plain twins of ``paddle_tpu_torch.ops.flash`` against the
  Pallas kernels run in interpret mode (``pallas_flash._flash_fwd`` and
  ``_flash_bwd``): out and lse within 1e-5, dq / dk / dv normalised by
  their max within 2e-4 — causal on and off, GQA 4:1 and 2:1, head dim 64
  and 128, S from 128 to 512, as ``tests/test_pallas_flash.py`` runs them;
* ``FlashAttention`` gradients through ``torch.autograd`` against
  ``jax.grad`` of ``pallas_flash.flash_attention``;
* the port's ``chunked_attention`` and ``_reference_attention`` against the
  JAX ones, forward within 1e-5 and gradients normalised within 2e-4;
* ``flash_attention_fwd`` takes the JAX package's off-TPU path for each
  shape, and ``use_pallas=True`` raises on a CPU tensor;
* ``flash.rowwise_error``, the measure of the card's checks, passes bf16
  rounding and fails a zeroed last tile at a causal shape;
* ``flash.route``, the wrappers' rule, as a pure function of device, dtype,
  head dim, pointer alignment and strides: aligned bf16 takes the TMA
  kernels, unaligned bf16 a contiguous copy and then the TMA kernels, fp32
  the FMA kernels, a CPU tensor the twins;
* ``flash_attention.takes_kernels``, the dispatcher's rule, as a pure
  function of device, dtype, head dim, heads and lengths: a GQA group of
  more than 128 query heads a KV head goes to the composite, as causal
  Sq != Sk does, and a direct kernel call on it raises ``ValueError``
  naming the limit before anything is built.

The tests marked ``cuda`` hold the three CUDA kernels to the twins on the
card by ``flash.rowwise_error`` (fp32 within 1e-4; bf16 within 2e-2 of the
twins run in fp32 on the same bf16 inputs), including lengths that are not
a multiple of the kernels' 64- and 128-row tiles (130, 4000), GQA groups of
1, 2, 4 and 8 heads at head dims 64 and 128, strided and unaligned inputs
(the unaligned bf16 ones counted on the copy route) and the launch
counters; they skip elsewhere.  JAX is
imported inside the tests that use it, so this file also runs on a machine
without JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``).
"""

import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import chunked_attention as ca
from paddle_tpu_torch.ops import flash
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel.ring_attention import ring_flash_attention


def _qkv(B, Sq, H, Hkv, D, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sq if Sk is None else Sk
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    return q, k, v, do


def _normalised_close(a, b, tol):
    scale = np.abs(np.asarray(b)).max() + 1e-9
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               rtol=tol, atol=tol)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


# (B, S, H, Hkv, D): GQA 4:1 and 2:1, MHA, head dims 64 and 128, S 128-512
TWIN_CASES = [(1, 256, 4, 1, 128), (1, 128, 4, 2, 128), (2, 128, 2, 2, 64),
              (1, 512, 2, 1, 64)]


@pytest.mark.parametrize("case", TWIN_CASES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
def test_twins_match_the_pallas_kernels(case, causal):
    """fwd/dq/dkv twins against the interpret-mode Pallas kernels."""
    jax, jnp = _jax()
    from paddle_tpu.ops import pallas_flash

    B, S, H, Hkv, D = case
    q, k, v, do = _qkv(B, S, H, Hkv, D, seed=S + H + D)
    scale = 1.0 / math.sqrt(D)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, jlse = pallas_flash._flash_fwd(jq, jk, jv, np.float32(scale),
                                         causal, 128, 128)
    jdq, jdk, jdv = pallas_flash._flash_bwd(
        (jq, jk, jv, jout, jlse), jdo, scale=np.float32(scale),
        causal=causal, block_q=128, block_k=128)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash.fwd_reference(tq, tk, tv, scale, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               rtol=1e-5, atol=1e-5)
    # the backward twins from the JAX forward's residuals, as _flash_bwd
    tout = torch.from_numpy(np.array(jout))
    tlse = torch.from_numpy(np.array(jlse))
    delta = torch.einsum("bshd,bshd->bhs", tdo, tout)
    dq = flash.bwd_dq_reference(tq, tk, tv, tdo, tlse, delta, scale, causal)
    dk, dv = flash.bwd_dkv_reference(tq, tk, tv, tdo, tlse, delta, scale,
                                     causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.shape == tuple(want.shape)
        _normalised_close(got.numpy(), want, 2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_jax_grad(causal):
    """FlashAttention (twins on the CPU) through torch.autograd against
    jax.grad of pallas_flash.flash_attention, GQA 2:1."""
    jax, jnp = _jax()
    from paddle_tpu.ops import pallas_flash

    q, k, v, w = _qkv(1, 128, 4, 2, 64, seed=11)

    def loss(q, k, v):
        return jnp.sum(pallas_flash.flash_attention(q, k, v, causal)
                       * jnp.asarray(w))

    jl, jg = jax.value_and_grad(loss, (0, 1, 2))(*map(jnp.asarray,
                                                     (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash.flash_attention(tq, tk, tv, causal)
    assert flash.last_path == "reference"
    tl = (out * torch.from_numpy(w)).sum()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for t, want in zip((tq, tk, tv), jg):
        _normalised_close(t.grad.numpy(), want, 2e-4)


# (B, Sq, Sk, H, Hkv, D): square and rectangular, GQA
COMPOSITE_CASES = [(1, 64, 64, 4, 2, 16), (2, 48, 80, 4, 1, 32),
                   (1, 96, 40, 2, 2, 16)]


@pytest.mark.parametrize("case", COMPOSITE_CASES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("which", ["chunked", "reference"])
def test_composite_paths_match_jax(case, causal, which):
    """chunked_attention (block_k 32, several chunks and a padded one) and
    _reference_attention against the JAX functions: forward within 1e-5,
    gradients normalised within 2e-4.  The composite masks bottom-right;
    rows with no valid key (causal, Sq > Sk) are left out for the
    reference, which gives NaN there in both packages (and NaN gradients,
    so only its forward is compared there)."""
    jax, jnp = _jax()
    from paddle_tpu.ops import chunked_attention as jca
    from paddle_tpu.ops import flash_attention as jfa

    B, Sq, Sk, H, Hkv, D = case
    q, k, v, w = _qkv(B, Sq, H, Hkv, D, seed=Sq + Sk, Sk=Sk)
    rows = slice(None)
    if which == "chunked":
        def jf(q, k, v):
            return jca.chunked_attention(q, k, v, causal, 32)

        def tf(q, k, v):
            return ca.chunked_attention(q, k, v, causal, 32)
    else:
        jf = lambda q, k, v: jfa._reference_attention(q, k, v, causal)
        tf = lambda q, k, v: fa._reference_attention(q, k, v, causal)
        if causal and Sq > Sk:
            rows = slice(Sq - Sk, None)
    jout = np.asarray(jf(*map(jnp.asarray, (q, k, v))))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tf(tq, tk, tv)
    np.testing.assert_allclose(out.detach().numpy()[:, rows], jout[:, rows],
                               rtol=1e-5, atol=1e-5)
    if rows != slice(None):
        return
    jg = jax.grad(lambda q, k, v: jnp.sum(jf(q, k, v) * w),
                  (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    (out * torch.from_numpy(w)).sum().backward()
    for t, want in zip((tq, tk, tv), jg):
        _normalised_close(t.grad.numpy(), want, 2e-4)


@pytest.mark.parametrize("shape, causal", [
    ((1, 256, 4, 64), True),       # small: the composite
    ((1, 1024, 2, 64), True),      # Sq * Sk = 1024^2: the chunked path
    ((1, 1024, 2, 96), False),
    ((2, 128, 4, 128), False),
])
def test_cpu_dispatch_takes_the_jax_off_tpu_path(shape, causal):
    jax, jnp = _jax()
    from paddle_tpu.ops import flash_attention as jfa

    B, S, H, D = shape
    q, k, v, _ = _qkv(B, S, H, H // 2, D, seed=S)
    jout = jfa.flash_attention_fwd(*map(jnp.asarray, (q, k, v)), causal)
    out = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    names = {"xla": "reference", "xla_chunked": "chunked"}
    assert fa.last_path == names[jfa.last_path]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensor_cannot_force_the_kernels():
    tq, tk, tv, _ = map(torch.from_numpy, _qkv(1, 64, 2, 1, 64, seed=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.flash_attention_fwd(tq, tk, tv, True, use_pallas=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ring_flash_attention(tq, tk, tv, use_pallas=True)
    out = ring_flash_attention(tq, tk, tv, use_pallas=False)
    assert fa.last_path == "reference" and out.shape == tq.shape
    # the autograd function has no switch: a CPU tensor takes the twins
    counts = (flash.fwd_launches, flash.dq_launches, flash.dkv_launches)
    flash.flash_attention(tq, tk, tv, True)
    assert flash.last_path == "reference"
    assert (flash.fwd_launches, flash.dq_launches,
            flash.dkv_launches) == counts


def test_rowwise_error_sees_a_missing_causal_tail():
    """The card's measure on the twins, causal, S=512: the twins on bf16
    inputs (the rounding the bf16 kernels add) stay within 2e-2 of the fp32
    twins on the same values; the same outputs with their last 64-row tile
    zeroed, queries for out / dQ and keys for dK / dV, read above 2e-2.  A
    late key's dK/dV is small, so this is what a tensor-wide normalisation
    cannot see."""
    B, S, H, Hkv, D = 1, 512, 2, 1, 64
    xs = [torch.from_numpy(a).to(torch.bfloat16)
          for a in _qkv(B, S, H, Hkv, D, seed=13)]
    f32 = [t.float() for t in xs]
    scale = 1.0 / math.sqrt(D)

    def run(q, k, v, do):
        out, lse = flash.fwd_reference(q, k, v, scale, True)
        delta = torch.einsum("bshd,bshd->bhs", do.float(), out.float())
        dq = flash.bwd_dq_reference(q, k, v, do, lse, delta, scale, True)
        dk, dv = flash.bwd_dkv_reference(q, k, v, do, lse, delta, scale,
                                         True)
        return out, dq, dk, dv

    for got, want in zip(run(*xs), run(*f32)):
        assert flash.rowwise_error(got, want) <= 2e-2
        tail = got.clone()
        tail[:, -64:] = 0
        assert flash.rowwise_error(tail, want) > 2e-2
    # with one key the gradients of q and k are 0: the floor holds rows of
    # fp32 rounding noise to 0.1 instead of dividing them by themselves
    noise = torch.full((1, 1, 2, 64), 1e-6)
    assert flash.rowwise_error(noise, torch.zeros_like(noise)) <= 1e-4


def test_kernel_wrappers_reject_cpu_tensors_before_building():
    tq, tk, tv, tdo = map(torch.from_numpy, _qkv(1, 64, 2, 1, 64, seed=2))
    stats = torch.zeros(1, 2, 64)
    counts = (flash.fwd_launches, flash.dq_launches, flash.dkv_launches)
    with pytest.raises(ValueError, match="CUDA device"):
        flash.fwd_kernel(tq, tk, tv, True)
    with pytest.raises(ValueError, match="CUDA device"):
        flash.bwd_dq_kernel(tq, tk, tv, tdo, stats, stats, True)
    with pytest.raises(ValueError, match="CUDA device"):
        flash.bwd_dkv_kernel(tq, tk, tv, tdo, stats, stats, True)
    assert (flash.fwd_launches, flash.dq_launches,
            flash.dkv_launches) == counts


def _layout(shape, elem_strides=None, ptr=4096):
    """(data_ptr, shape, stride) of a [B, S, heads, D] tensor, contiguous
    unless strides are given."""
    if elem_strides is None:
        B, S, n, D = shape
        elem_strides = (S * n * D, n * D, D, 1)
    return ptr, shape, elem_strides


@pytest.mark.parametrize("device, dtype, layouts, want", [
    # a CPU tensor takes the twins, whatever its layout
    ("cpu", torch.bfloat16, [_layout((2, 130, 4, 128), ptr=2)], "reference"),
    ("cpu", torch.float32, [_layout((2, 130, 4, 128))], "reference"),
    # fp32 takes the FMA kernels, which read any strides
    ("cuda", torch.float32, [_layout((2, 130, 4, 128), ptr=4)], "fma"),
    # aligned bf16: contiguous, and views into a packed [B, S, 4, H, D]
    ("cuda", torch.bfloat16, [_layout((2, 130, 4, 128)),
                              _layout((2, 130, 1, 128))], "tma"),
    ("cuda", torch.bfloat16,
     [_layout((2, 130, 4, 128), (130 * 4 * 4 * 128, 4 * 4 * 128, 128, 1),
              ptr=4096 + 2 * 4 * 128 * 2)], "tma"),
    # a dim of extent 1 is never stepped over: its stride does not matter
    ("cuda", torch.bfloat16,
     [_layout((1, 130, 1, 64), (3, 64, 5, 1))], "tma"),
    # unaligned bf16: a base off 16 bytes, or rows D + 1 apart
    ("cuda", torch.bfloat16, [_layout((2, 130, 4, 128)),
                              _layout((2, 130, 1, 128), ptr=4098)], "copy"),
    ("cuda", torch.bfloat16,
     [_layout((2, 130, 4, 128), (130 * 4 * 129, 4 * 129, 129, 1))], "copy"),
    ("cuda", torch.bfloat16,
     [_layout((2, 130, 4, 64), (130 * 4 * 64 + 4, 4 * 64, 64, 1))], "copy"),
])
def test_route_rule(device, dtype, layouts, want):
    D = layouts[0][1][-1]
    assert flash.route(device, dtype, D, layouts) == want


@pytest.mark.parametrize("H, Hkv, want", [
    (1, 1, True), (8, 2, True), (28, 4, True), (128, 1, True),
    (256, 2, True), (256, 1, False), (129, 1, False), (512, 2, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dispatch_sends_large_groups_to_the_composite(H, Hkv, want, dtype):
    """A block packs a GQA group into its 128 rows: ratios 1-128 take the
    kernels on a CUDA tensor, larger ones the composite, on the branch that
    causal Sq != Sk takes; a CPU tensor never takes the kernels."""
    args = (dtype, 64, H, Hkv, False, 256, 256)
    assert fa.takes_kernels("cuda", *args) is want
    assert fa.takes_kernels("cpu", *args) is False
    assert flash.kernels_take("cuda", H, Hkv) is want
    assert flash.kernels_take("cpu", H, Hkv) is False
    assert fa.takes_kernels("cuda", dtype, 64, H, Hkv, True, 256, 200) \
        is False
    assert fa.takes_kernels("cuda", dtype, 96, H, Hkv, False, 256, 256) \
        is False


def test_kernel_wrappers_refuse_a_group_over_the_limit():
    """A direct kernel call with 256 query heads on one KV head raises
    ValueError naming the limit before any device check or build."""
    tq, tk, tv, tdo = map(torch.from_numpy, _qkv(1, 8, 256, 1, 64, seed=3))
    stats = torch.zeros(1, 256, 8)
    counts = (flash.fwd_launches, flash.dq_launches, flash.dkv_launches)
    with pytest.raises(ValueError, match="limit of 128"):
        flash.fwd_kernel(tq, tk, tv, True)
    with pytest.raises(ValueError, match="limit of 128"):
        flash.bwd_dq_kernel(tq, tk, tv, tdo, stats, stats, True)
    with pytest.raises(ValueError, match="limit of 128"):
        flash.bwd_dkv_kernel(tq, tk, tv, tdo, stats, stats, True)
    assert (flash.fwd_launches, flash.dq_launches,
            flash.dkv_launches) == counts


def test_route_rule_raises_on_what_no_kernel_takes():
    lay = [_layout((1, 64, 2, 96))]
    with pytest.raises(ValueError, match="head dim 96"):
        flash.route("cuda", torch.bfloat16, 96, lay)
    with pytest.raises(TypeError, match="float16"):
        flash.route("cuda", torch.float16, 64, [_layout((1, 64, 2, 64))])
    # on the CPU the twins take any head dim and dtype
    assert flash.route("cpu", torch.float16, 96, lay) == "reference"


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (B, Sq, Sk, H, Hkv, D): tile-aligned, ragged edges (S not a multiple of
# the 64- and 128-row tiles: 70, 100, 130, 200, 4000), rectangular, GQA
# 8:1 / 4:1 / 2:1 / 1:1 at head dims 64 and 128, and 7:1 and 3:1, groups
# that do not divide a block's 128 rows (126 rows in use)
CUDA_CASES = [(1, 128, 128, 4, 1, 128), (2, 100, 100, 4, 2, 64),
              (1, 70, 70, 2, 2, 128), (1, 1, 1, 2, 1, 64),
              (2, 200, 200, 8, 2, 128), (1, 96, 160, 4, 2, 64),
              (1, 130, 130, 8, 1, 128), (1, 200, 200, 16, 2, 64),
              (1, 130, 130, 2, 2, 64), (1, 4000, 4000, 4, 1, 64),
              (1, 200, 200, 28, 4, 128), (1, 130, 130, 6, 2, 64)]


def _cuda_inputs(dev, case, dtype, seed=0):
    B, Sq, Sk, H, Hkv, D = case
    return [torch.from_numpy(a).to(dev).to(dtype)
            for a in _qkv(B, Sq, H, Hkv, D, seed=seed, Sk=Sk)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_twins(cuda, case, causal, dtype):
    """Each kernel against its twin on the same inputs; the twins run in
    fp32 on the same (possibly bf16-rounded) inputs."""
    q, k, v, do = _cuda_inputs(cuda, case, dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    counts = (flash.fwd_launches, flash.dq_launches, flash.dkv_launches)
    out, lse = flash.fwd_kernel(q, k, v, causal)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, do)]
    ref_out, ref_lse = flash.fwd_reference(*f32[:3], scale, causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert flash.rowwise_error(out, ref_out) <= tol
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)

    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         out.float()).contiguous()
    dq = flash.bwd_dq_kernel(q, k, v, do, lse, delta, causal)
    dk, dv = flash.bwd_dkv_kernel(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    ref_dq = flash.bwd_dq_reference(*f32, lse, delta, scale, causal)
    ref_dk, ref_dv = flash.bwd_dkv_reference(*f32, lse, delta, scale,
                                             causal)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        err = flash.rowwise_error(got, want)
        assert err <= tol, err
    assert (flash.fwd_launches, flash.dq_launches,
            flash.dkv_launches) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_read_through_strides(cuda, dtype, layout):
    """q/k/v/dO as views (no copy) into one packed [B, S, 4, H, D] buffer,
    or with rows that do not start on 16 bytes: all three kernels give what
    they give on contiguous copies, bit for bit.  TMA reads the packed bf16
    views in place; the unaligned bf16 ones take the counted copy route,
    once for each of the three kernels."""
    B, S, H, D = 2, 130, 4, 128
    if layout == "packed":
        buf = torch.randn(B, S, 4, H, D, device=cuda).to(dtype)
        views = [buf[:, :, i] for i in range(4)]
    else:
        buf = torch.randn(4, B, S, H, D + 1, device=cuda).to(dtype)
        views = [buf[i, ..., 1:] for i in range(4)]
    assert not any(t.is_contiguous() for t in views)
    results, routes = [], []
    for q, k, v, do in (views, [t.contiguous() for t in views]):
        copies = flash.copy_launches
        out, lse = flash.fwd_kernel(q, k, v, True)
        route = flash.last_route
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             out.float()).contiguous()
        dq = flash.bwd_dq_kernel(q, k, v, do, lse, delta, True)
        dk, dv = flash.bwd_dkv_kernel(q, k, v, do, lse, delta, True)
        assert flash.last_route == route
        routes.append((route, flash.copy_launches - copies))
        results.append((out, lse, dq, dk, dv))
    if dtype == torch.float32:
        assert routes == [("fma", 0), ("fma", 0)]
    elif layout == "packed":
        assert routes == [("tma", 0), ("tma", 0)]
    else:
        assert routes == [("copy", 3), ("tma", 0)]
    torch.cuda.synchronize()
    for got, want in zip(*results):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_autograd_and_dispatch(cuda, dtype):
    """flash_attention_fwd on the card launches each kernel once per call
    and gives the twins' gradients; use_pallas=False pins the composite
    path and launches nothing."""
    case = (2, 100, 100, 4, 2, 128)
    q, k, v, w = _cuda_inputs(cuda, case, dtype, seed=5)
    grads = {}
    for route in (None, False):
        counts = (flash.fwd_launches, flash.dq_launches, flash.dkv_launches)
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention_fwd(*xs, causal=True, use_pallas=route)
        (out.float() * w.float()).sum().backward()
        torch.cuda.synchronize()
        grads[route] = [out.detach().float()] + [t.grad.float() for t in xs]
        added = [c - c0 for c, c0 in zip(
            (flash.fwd_launches, flash.dq_launches, flash.dkv_launches),
            counts)]
        if route is None:
            assert fa.last_path == "cuda" and added == [1, 1, 1]
        else:
            assert fa.last_path == "reference" and added == [0, 0, 0]
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, want in zip(grads[None], grads[False]):
        norm = want.abs().max() + 1e-9
        assert float(((got - want) / norm).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_large_group_takes_the_composite(cuda):
    """bf16 at a GQA ratio of 256 on the card computes through the
    composite (the JAX package computes it too) and launches nothing; the
    autograd function takes the twins there."""
    q, k, v, _ = _cuda_inputs(cuda, (1, 64, 64, 256, 1, 64), torch.bfloat16)
    counts = (flash.fwd_launches, flash.dq_launches, flash.dkv_launches)
    out = fa.flash_attention_fwd(q, k, v, True)
    assert fa.last_path == "reference"
    want = fa._reference_attention(q, k, v, True)
    assert torch.equal(out, want)
    xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    flash.flash_attention(*xs, True).float().sum().backward()
    assert flash.last_path == "reference"
    assert all(torch.isfinite(t.grad.float()).all() for t in xs)
    assert (flash.fwd_launches, flash.dq_launches,
            flash.dkv_launches) == counts


@pytest.mark.cuda
def test_cuda_dispatch_rules(cuda):
    """Head dims the kernels do not take, and causal with Sq != Sk, follow
    the JAX off-TPU rule on the card; use_pallas=True raises there."""
    q, k, v, _ = _cuda_inputs(cuda, (1, 64, 64, 2, 1, 96), torch.float32)
    fa.flash_attention_fwd(q, k, v, True)
    assert fa.last_path == "reference"
    with pytest.raises(RuntimeError, match="do not take"):
        fa.flash_attention_fwd(q, k, v, True, use_pallas=True)
    q, k, v, _ = _cuda_inputs(cuda, (1, 32, 64, 2, 1, 64), torch.float32)
    fa.flash_attention_fwd(q, k, v, True)
    assert fa.last_path == "reference"
    fa.flash_attention_fwd(q, k, v, False)
    assert fa.last_path == "cuda"
