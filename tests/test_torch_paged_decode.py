"""Paged decode and chunk attention in the PyTorch port, held to the JAX
package.

On the CPU, ``paddle_tpu_torch.ops.paged_decode.decode_reference`` (the
plain version, ``_xla_paged_attention``) must agree with the JAX
``decode_oracle`` and with the JAX Pallas ``_decode_kernel`` run in
interpret mode, over the decode buckets B×W ∈ {1,2,4,8}² of
``test_numerics_audit.py`` and one GQA case at Llama's head width (the
shapes of ``test_serving.py``).  ``paged_prefill_attention`` must agree with
the JAX version with a scalar and a per-row chunk start.  fp32 throughout;
tolerance 1e-5 (the three differ only in summation order).

The tests marked ``cuda`` hold the CUDA kernel to the plain version on the
card and skip elsewhere.  JAX is imported inside the tests that use it, so
this file also runs on a machine without JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_paged_decode.py``).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops import paged_decode as pd


def _bucket_case(B, W, bs=4, Hkv=2, H=4, D=16, seed=None):
    """numpy (q, k, v, tables, lens) as the decode bucket tests of the JAX
    package build them: each row owns 1..W distinct pages, 0-padded."""
    rng = np.random.default_rng(B * 16 + W if seed is None else seed)
    num_blocks = W * B + 2
    k = rng.standard_normal((num_blocks, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((num_blocks, bs, Hkv, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    tables = np.zeros((B, W), np.int32)
    lens = np.zeros((B,), np.int32)
    blocks = iter(range(1, num_blocks))
    for i in range(B):
        owned = rng.integers(1, W + 1)
        tables[i, :owned] = [next(blocks) for _ in range(owned)]
        lens[i] = rng.integers(1, owned * bs + 1)
    return q, k, v, tables, lens


def _gqa_case():
    """``test_serving.py::TestPallasPagedKernel``'s GQA shapes at D=128."""
    rng = np.random.default_rng(0)
    B, H, Hkv, D, bs, nb = 3, 8, 2, 128, 8, 16
    q = rng.standard_normal((B, H, D)).astype("float32")
    k = rng.standard_normal((nb, bs, Hkv, D)).astype("float32")
    v = rng.standard_normal((nb, bs, Hkv, D)).astype("float32")
    tables = rng.integers(1, nb, (B, 4)).astype(np.int32)
    lens = np.array([5, 20, 32], np.int32)
    return q, k, v, tables, lens


def _jax_decode(args):
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops import pallas_paged

    jargs = [jnp.asarray(a) for a in args]
    return (np.asarray(pallas_paged.decode_oracle(*jargs)),
            np.asarray(pallas_paged.paged_attention_decode(*jargs)))


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("W", [1, 2, 4, 8])
def test_reference_matches_jax_oracle_and_pallas_kernel(B, W):
    args = _bucket_case(B, W)
    ours = pa.paged_attention(*map(torch.from_numpy, args)).numpy()
    assert pa.last_path == pd.last_path == "reference"
    oracle, pallas = _jax_decode(args)
    np.testing.assert_allclose(ours, oracle, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)


def test_reference_matches_jax_gqa_head_dim_128():
    args = _gqa_case()
    ours = pd.decode_reference(*map(torch.from_numpy, args)).numpy()
    oracle, pallas = _jax_decode(args)
    np.testing.assert_allclose(ours, oracle, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("per_row_start", [False, True])
def test_chunk_attention_matches_jax(per_row_start):
    """A 5-token chunk per row resuming after a cached prefix, with one
    row's chunk ending in pad tokens (lens stops short of them)."""
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops import paged_attention as jpa

    rng = np.random.default_rng(5)
    B, S, H, Hkv, D, bs, nb = 2, 5, 4, 2, 16, 4, 12
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    tables = np.array([[3, 7, 1, 0], [5, 9, 2, 11]], np.int32)
    starts = np.array([6, 6], np.int32) if not per_row_start else \
        np.array([3, 8], np.int32)
    lens = starts + np.array([S, S - 2], np.int32)
    q_start = starts if per_row_start else np.int32(6)
    ours = pa.paged_prefill_attention(
        *map(torch.from_numpy, (q, k, v, tables, lens)),
        torch.as_tensor(q_start)).numpy()
    ref = np.asarray(jpa.paged_prefill_attention(
        *(jnp.asarray(a) for a in (q, k, v, tables, lens, q_start))))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_bf16_reference_keeps_q_dtype_and_computes_in_fp32():
    q, k, v, tables, lens = map(torch.from_numpy, _gqa_case())
    out = pd.decode_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                              tables, lens)
    assert out.dtype == torch.bfloat16
    ref = pd.decode_reference(q.bfloat16().float(), k.bfloat16().float(),
                              v.bfloat16().float(), tables, lens)
    # the only difference is the final rounding to bf16
    torch.testing.assert_close(out.float(), ref.bfloat16().float(),
                               atol=0, rtol=0)


def test_cpu_tensor_cannot_force_the_kernel():
    args = list(map(torch.from_numpy, _bucket_case(2, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        pa.paged_attention(*args, use_pallas=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        pd.paged_attention_decode(*args, use_pallas=True)
    pa.paged_attention(*args, use_pallas=False)
    assert pa.last_path == "reference"


def test_kernel_wrapper_rejects_cpu_tensors_before_building():
    launches = pd.launches
    with pytest.raises(ValueError, match="CUDA device"):
        pd.decode_kernel(*map(torch.from_numpy, _bucket_case(2, 2)))
    assert pd.launches == launches


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _to(dev, args, dtype):
    q, k, v, tables, lens = [torch.from_numpy(np.asarray(a)).to(dev)
                             for a in args]
    return q.to(dtype), k.to(dtype), v.to(dtype), tables, lens


CUDA_CASES = [(B, W) for B in (1, 2, 4, 8) for W in (1, 2, 4, 8)] + ["gqa"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_reference(cuda, case, dtype):
    """The kernel against the plain version on the same inputs: fp32 within
    1e-4; bf16 within 2e-2 of the plain version run in fp32 on the same
    bf16 inputs (the kernel rounds only its output to bf16)."""
    raw = _gqa_case() if case == "gqa" else _bucket_case(*case)
    q, k, v, tables, lens = _to(cuda, raw, dtype)
    launches = pd.launches
    out = pa.paged_attention(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert pa.last_path == "cuda" and pd.launches == launches + 1
    assert out.dtype == dtype
    ref = pd.decode_reference(q.float(), k.float(), v.float(), tables, lens)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    plain = pa.paged_attention(q, k, v, tables, lens, use_pallas=False)
    assert pa.last_path == "reference" and pd.launches == launches + 1
    assert plain.dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_reads_no_page_past_the_length(cuda, dtype):
    """Tables padded far past each row's length (as a burst's are) point
    at pages full of NaN: the kernel never reads them, so its output is
    finite, equals the plain version on the unpadded tables, and is
    bit-identical to its own output on a narrower padding.  A pad row
    (len 1, all-null table) gives finite output too."""
    rng = np.random.default_rng(11)
    B, H, Hkv, D, bs, nb, W = 5, 32, 8, 128, 16, 64, 32
    k32 = torch.from_numpy(rng.standard_normal((nb, bs, Hkv, D))
                           .astype(np.float32)).to(cuda)
    v32 = torch.from_numpy(rng.standard_normal((nb, bs, Hkv, D))
                           .astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((B, H, D))
                         .astype(np.float32)).to(cuda).to(dtype)
    lens = np.array([1, 17, 40, 100, 1], np.int32)   # the last is a pad row
    live = np.zeros((B, 8), np.int32)
    pages = iter(range(1, 40))
    for i in range(B - 1):
        n = -(-int(lens[i]) // bs)
        live[i, :n] = [next(pages) for _ in range(n)]
    nan_pages = np.arange(40, nb, dtype=np.int32)
    wide = np.zeros((B, W), np.int32)
    wide[:, :8] = live
    for i in range(B - 1):
        n = -(-int(lens[i]) // bs)
        wide[i, n:] = np.resize(nan_pages, W - n)
    k, v = k32.to(dtype), v32.to(dtype)
    k_nan, v_nan = k.clone(), v.clone()
    k_nan[40:] = float("nan")
    v_nan[40:] = float("nan")
    lens_t = torch.from_numpy(lens).to(cuda)
    out_wide = pd.decode_kernel(q, k_nan, v_nan,
                                torch.from_numpy(wide).to(cuda), lens_t)
    out_live = pd.decode_kernel(q, k, v, torch.from_numpy(live).to(cuda),
                                lens_t)
    torch.cuda.synchronize()
    assert torch.isfinite(out_wide.float()).all()
    assert torch.equal(out_wide, out_live)
    ref = pd.decode_reference(q.float(), k.float(), v.float(),
                              torch.from_numpy(live).to(cuda), lens_t)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out_wide.float(), ref, atol=tol, rtol=tol)
