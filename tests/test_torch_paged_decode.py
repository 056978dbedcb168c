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

from paddle_tpu_torch.ops import flash
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


@pytest.mark.parametrize("case", [(B, W) for B in (1, 2, 4, 8)
                                  for W in (1, 2, 4, 8)] + ["gqa"], ids=str)
def test_split_reference_matches_reference_and_jax(case):
    """The split twin at spans of 1 to 4 pages and the default span (one
    span at these lengths) against the plain version, the JAX oracle and
    the interpret-mode Pallas kernel."""
    args = _gqa_case() if case == "gqa" else _bucket_case(*case)
    bs = args[1].shape[1]
    tensors = list(map(torch.from_numpy, args))
    plain = pd.decode_reference(*tensors).numpy()
    oracle, pallas = _jax_decode(args)
    for span in (bs, 2 * bs, 3 * bs, 4 * bs, None):
        ours = pd.decode_split_reference(*tensors, span=span).numpy()
        for want in (plain, oracle, pallas):
            np.testing.assert_allclose(ours, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pages", [1, 2, 3, 4])
def test_span_plan_covers_each_row_once_in_order(pages):
    bs, W = 4, 8
    span = pages * bs
    lens = list(range(W * bs + 1))           # every length 0 .. W * bs
    items = pd.span_plan(lens, span)
    assert items == pd.span_plan(tuple(lens), span)   # pure
    assert lens == list(range(W * bs + 1))
    by_row = {}
    for row, j, a, b in items:
        by_row.setdefault(row, []).append((j, a, b))
    assert sorted(by_row) == list(range(len(lens)))
    assert [r for r, *_ in items] == sorted(r for r, *_ in items)
    for row, spans in by_row.items():
        assert [j for j, _, _ in spans] == list(range(len(spans)))
        assert spans[0][1] == 0 and spans[-1][2] == lens[row]
        for (_, a, b), (_, a2, _) in zip(spans, spans[1:]):
            assert b == a2                    # no gap, no overlap
        for j, a, b in spans:
            assert a == j * span and a % bs == 0
            assert 0 < b - a <= span or lens[row] == 0 == a == b
        assert len(spans) == max(1, -(-lens[row] // span))


def test_span_tokens_and_launch_plan_are_pure():
    assert [pd.span_tokens(bs) for bs in (1, 3, 16, 48, 64)] == \
        [128, 129, 128, 144, 128]
    for bs in range(1, 65):
        span = pd.span_tokens(bs)
        assert span % bs == 0 and span // bs <= pd.MAX_SPAN_PAGES
        if pd.route("cuda", torch.bfloat16, torch.bfloat16, 128, bs) == "mma":
            assert span == pd.MMA_SPAN
    assert pd.head_groups(32, 8, "mma") == (8, 4)
    assert pd.head_groups(64, 2, "mma") == (4, 16)
    assert pd.head_groups(28, 4, "simple") == (8, 4)
    assert pd.head_groups(24, 8, "simple") == (8, 3)
    # one span per row: no scratch
    assert pd.launch_plan(16, 32, 8, 128, 16, 8, 128, "mma") == (16, 0)
    # the serving shape: 16 rows, 8 groups, 32 spans, 4 heads of 130 floats
    for way in ("mma", "simple"):
        assert pd.launch_plan(16, 32, 8, 128, 16, 256, 128, way) == \
            (16, 16 * 8 * 32 * 4 * 130)
    # 16 heads an mma block, 4 a simple one
    assert pd.launch_plan(2, 64, 2, 64, 16, 16, 128, "mma") == \
        (2, 2 * 4 * 2 * 16 * 66)
    assert pd.launch_plan(2, 64, 2, 64, 16, 16, 128, "simple") == \
        (2, 2 * 16 * 2 * 4 * 66)
    # a partial is padded to 4 floats: 3 heads of 66 take 200
    assert pd.launch_plan(1, 6, 2, 64, 16, 16, 128, "simple") == \
        (1, 2 * 2 * 200)
    # slices hold 64 MB of partials at most
    rows, scratch = pd.launch_plan(512, 64, 8, 128, 16, 512, 128, "mma")
    assert rows < 512 and scratch * 4 <= 1 << 26
    assert pd.launch_plan(512, 64, 8, 128, 16, 512, 128, "mma") == \
        (rows, scratch)


@pytest.mark.parametrize("head_dim", [16, 64, 128, 256])
@pytest.mark.parametrize("block_size", [1, 3, 16, 48, 64])
def test_route_is_pure(head_dim, block_size):
    """bf16 q and pools at head dim 64 or 128 with pages that divide 128
    tokens take the mma route; every other pairing and shape the simple
    one; a CPU tensor the reference."""
    f32, bf16 = torch.float32, torch.bfloat16
    mma = head_dim in (64, 128) and 128 % block_size == 0
    assert pd.route("cuda", bf16, bf16, head_dim, block_size) == \
        ("mma" if mma else "simple")
    for pair in ((f32, f32), (f32, bf16), (bf16, f32)):
        assert pd.route("cuda", *pair, head_dim, block_size) == "simple"
    assert pd.route("cpu", bf16, bf16, head_dim, block_size) == "reference"


def test_split_reference_gives_zeros_for_an_empty_row():
    q, k, v, tables, lens = map(torch.from_numpy, _gqa_case())
    lens[1] = 0
    out = pd.decode_split_reference(q, k, v, tables, lens, span=8)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    ref = pd.decode_reference(q, k, v, tables, lens)
    torch.testing.assert_close(out[[0, 2]], ref[[0, 2]], atol=1e-5,
                               rtol=1e-5)


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
    assert flash.rowwise_error(out, ref) <= tol
    twin = pd.decode_split_reference(q.float(), k.float(), v.float(), tables,
                                     lens)
    assert flash.rowwise_error(out, twin) <= tol
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


def _long_rows(dev, lens, W, H=32, Hkv=8, D=128, bs=16, seed=0,
               q_dtype=torch.bfloat16, kv_dtype=torch.bfloat16):
    """Rows of the given lengths over distinct random pages of a pool,
    tables ``W`` pages wide (0-padded)."""
    rng = np.random.default_rng(seed)
    need = [-(-int(n) // bs) for n in lens]
    nb = sum(need) + 1
    pages = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((len(lens), W), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = pages[at:at + n]
        at += n
    gen = torch.Generator().manual_seed(seed)
    k = torch.randn(nb, bs, Hkv, D, generator=gen).to(dev, kv_dtype)
    v = torch.randn(nb, bs, Hkv, D, generator=gen).to(dev, kv_dtype)
    q = torch.randn(len(lens), H, D, generator=gen).to(dev, q_dtype)
    return (q, k, v, torch.from_numpy(tables).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


LONG_CASES = {
    # name: (H, Hkv, D, bs, lens)
    "8b": (32, 8, 128, 16, [1, 16, 17, 127, 128, 129, 500, 1857, 2112]),
    "gqa7": (28, 4, 128, 16, [3, 300, 1000]),
    "gqa8 d64": (64, 8, 64, 32, [40, 700, 1500]),
    "mha d256": (8, 8, 256, 16, [5, 257, 900]),
    "bs1": (8, 2, 64, 1, [1, 128, 129, 400]),
    "bs3": (8, 2, 64, 3, [2, 129, 130, 500]),
    "bs64": (16, 4, 128, 64, [63, 64, 65, 1000]),
    "gqa32 d128": (64, 2, 128, 16, [129, 640]),
}
PAIRINGS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(LONG_CASES))
@pytest.mark.parametrize("pairing", PAIRINGS, ids=lambda p: "-".join(
    str(t).split(".")[-1] for t in p))
def test_cuda_rows_match_twins_over_many_spans(cuda, name, pairing):
    """Rows of one to many spans: each (row, head) against its twin row in
    the plain version and in the split twin (fp32 within 1e-4; with a bf16
    operand within 2e-2 of the twins run in fp32 on the same inputs)."""
    H, Hkv, D, bs, lens = LONG_CASES[name]
    W = -(-max(lens) // bs) + 3
    q, k, v, tables, lens_t = _long_rows(cuda, lens, W, H, Hkv, D, bs,
                                         q_dtype=pairing[0],
                                         kv_dtype=pairing[1])
    launches = pd.launches
    out = pd.decode_kernel(q, k, v, tables, lens_t)
    torch.cuda.synchronize()
    assert pd.launches == launches + 1 and out.dtype == q.dtype
    assert pd.last_route == pd.route("cuda", q.dtype, k.dtype, D, bs)
    ref = pd.decode_reference(q.float(), k.float(), v.float(), tables, lens_t)
    twin = pd.decode_split_reference(q.float(), k.float(), v.float(), tables,
                                     lens_t)
    tol = 1e-4 if pairing == (torch.float32, torch.float32) else 2e-2
    assert torch.isfinite(out.float()).all()
    assert flash.rowwise_error(out, ref) <= tol
    assert flash.rowwise_error(out, twin) <= tol
    # the same check fails a walk without each row's last span
    span = pd.span_tokens(bs)
    cut = torch.clamp((lens_t - 1) // span * span, min=0).int()
    bad = pd.decode_split_reference(q.float(), k.float(), v.float(), tables,
                                    cut)
    assert flash.rowwise_error(bad, ref) > tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_row_is_bit_equal_alone_in_a_batch_and_wider(cuda, dtype):
    """A row's output depends on its own length and data only: alone
    (B=1), inside B=16 and with its table width doubled, the same bits."""
    lens = [1857, 5, 300, 2112, 17, 128, 129, 1000, 64, 700, 1, 256, 900,
            1500, 33, 400]
    q, k, v, tables, lens_t = _long_rows(cuda, lens, 140, q_dtype=dtype,
                                         kv_dtype=dtype)
    batch = pd.decode_kernel(q, k, v, tables, lens_t)
    wide = torch.zeros(16, 280, dtype=torch.int32, device=cuda)
    wide[:, :140] = tables
    doubled = pd.decode_kernel(q, k, v, wide, lens_t)
    torch.cuda.synchronize()
    assert torch.equal(batch, doubled)
    for i in (0, 3, 6, 15):
        alone = pd.decode_kernel(q[i:i + 1].contiguous(), k, v,
                                 tables[i:i + 1].contiguous(),
                                 lens_t[i:i + 1].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(alone[0], batch[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_two_runs_are_bit_equal(cuda, dtype):
    lens = [2112, 1, 1857, 640, 129] * 3
    args = _long_rows(cuda, lens, 133, q_dtype=dtype, kv_dtype=dtype)
    first = pd.decode_kernel(*args)
    again = [pd.decode_kernel(*args) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, a) for a in again)


@pytest.mark.cuda
def test_cuda_empty_row_gives_zeros(cuda):
    q, k, v, tables, lens = _long_rows(cuda, [0, 300, 0, 1], 20)
    out = pd.decode_kernel(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert torch.equal(out[[0, 2]], torch.zeros_like(out[[0, 2]]))
    ref = pd.decode_reference(q.float(), k.float(), v.float(), tables, lens)
    assert flash.rowwise_error(out[[1, 3]], ref[[1, 3]]) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_other_spans_keep_the_function(cuda, dtype, monkeypatch):
    """Other span lengths (whole pages, up to 128 tokens on the mma route
    and 128 pages on the simple one) compute the same function."""
    q, k, v, tables, lens = _long_rows(cuda, [1857, 3, 700], 120,
                                       q_dtype=dtype, kv_dtype=dtype)
    ref = pd.decode_reference(q.float(), k.float(), v.float(), tables, lens)
    spans = (16, 32, 64) if dtype == torch.bfloat16 else (16, 64, 256, 2048)
    for span in spans:
        monkeypatch.setattr(pd, "SPAN_TOKENS", span)
        out = pd.decode_kernel(q, k, v, tables, lens)
        torch.cuda.synchronize()
        assert flash.rowwise_error(out, ref) <= 2e-2
