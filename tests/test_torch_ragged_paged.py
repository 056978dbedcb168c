"""Ragged paged attention in the PyTorch port, held to the JAX package.

On the CPU, ``paddle_tpu_torch.ops.ragged_paged.ragged_reference`` (the
plain PyTorch version) must agree with the JAX ``ragged_oracle`` and with
the JAX Pallas kernel run in interpret mode, over the decode-only,
chunk-only, mixed and padded packings of ``test_unified_ragged.py`` at two
table widths, plus one case at Llama's head width (D=128, bs=16).  fp32
throughout; tolerance 1e-5 (the three differ only in summation order).

Also on the CPU: the route rule and the launch shape as pure functions of
dtype and shape, the plain twin of the device work list (every token in
exactly one item, no item across two rows, at most 128 / rep tokens an
item) over these packings and the serving ones, and the row-by-row
measure of the card's checks (``flash.rowwise_error``), which passes bf16
rounding and fails an output with a row's last page dropped.

The tests marked ``cuda`` compare the CUDA kernels with the plain version
on the card, row by row, on both routes (the tma route at GQA 4:1 and 7:1,
a chunk starting mid-page, decode-only steps, the serving packings), check
that two launches agree bit for bit, that a row's output does not move when
its table bucket doubles, and that the device work list is the twin's; they
skip elsewhere.  JAX is imported inside the tests that use it,
so this file also runs on a machine without JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_ragged_paged.py``).
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash
from paddle_tpu_torch.ops import ragged_paged as rp


def _pack(rows, Tb, W):
    """Packed metadata from ``rows`` = [(pages, kv_len, q_positions)] — the
    packing the engine does, with row arrays padded to ``Tb`` rows."""
    tables = np.zeros((Tb, W), np.int32)
    lens = np.ones((Tb,), np.int32)
    R = len(rows)
    seg = np.full((Tb,), min(R, Tb - 1), np.int32)
    pos = np.zeros((Tb,), np.int32)
    cursor = 0
    for i, (pages, kv_len, q_positions) in enumerate(rows):
        tables[i, :len(pages)] = pages
        lens[i] = kv_len
        n = len(q_positions)
        seg[cursor:cursor + n] = i
        pos[cursor:cursor + n] = q_positions
        cursor += n
    assert cursor <= Tb
    return tables, lens, seg, pos


def _case(case, width, seed=3):
    """numpy inputs (q, k, v, tables, lens, seg, pos) for one packing."""
    rng = np.random.default_rng(seed)
    if case == "head_dim_128":
        H, Hkv, D, bs, num_blocks = 8, 2, 128, 16, 12
        rows = [([3, 7, 1], 40, [39]),
                ([5, 9], 20, list(range(12, 20))),
                ([2], 5, [4]),
                ([11, 4, 6, 8], 64, list(range(60, 64)))]
        Tb = 16
    else:
        H, Hkv, D, bs, num_blocks = 4, 2, 8, 4, 16
        if case == "decode_only":
            rows = [([1 + 2 * i, 2 + 2 * i][:max(1, -(-L // bs))], L, [L - 1])
                    for i, L in enumerate((3, 6, 8, 5))]
            Tb = 4
        elif case == "chunk_only":
            rows = [([3, 7], 7, [4, 5, 6]), ([5, 9], 5, [0, 1, 2, 3, 4])]
            Tb = 8
        elif case == "mixed":
            rows = [([3, 7], 6, [5]), ([5, 9], 5, [2, 3, 4]),
                    ([2, 11], 8, [7])]
            Tb = 8
        else:  # padded: pad tokens AND pad rows route through the null page
            rows = [([3], 2, [1]), ([5, 9], 5, [3, 4])]
            Tb = 8
    width = max(width, max(len(r[0]) for r in rows))
    k = rng.normal(size=(num_blocks, bs, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(num_blocks, bs, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(Tb, H, D)).astype(np.float32)
    return (q, k, v) + _pack(rows, Tb, width)


CASES = ["decode_only", "chunk_only", "mixed", "padded"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("width", [2, 4])
def test_reference_matches_jax_oracle_and_pallas_kernel(case, width):
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops import ragged_paged as jrp

    args = _case(case, width)
    ours = rp.ragged_paged_attention(*map(torch.from_numpy, args)).numpy()
    assert rp.last_path == "reference"
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jrp.ragged_oracle(*jargs))
    pallas = np.asarray(jrp.ragged_paged_attention(*jargs, use_pallas=True))
    assert jrp.last_path == "pallas"
    # pad tokens included: they attend the null page's first column in all
    # three, so their (finite) outputs agree too
    np.testing.assert_allclose(ours, oracle, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)
    assert np.isfinite(ours).all()


def test_reference_matches_jax_at_llama_head_width():
    jnp = pytest.importorskip("jax.numpy")
    from paddle_tpu.ops import ragged_paged as jrp

    args = _case("head_dim_128", 4)
    ours = rp.ragged_reference(*map(torch.from_numpy, args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(ours, np.asarray(jrp.ragged_oracle(*jargs)),
                               atol=1e-5, rtol=1e-5)
    pallas = np.asarray(jrp.ragged_paged_attention(*jargs, use_pallas=True))
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)


def test_bf16_reference_keeps_q_dtype_and_computes_in_fp32():
    q, k, v, *meta = map(torch.from_numpy, _case("mixed", 4))
    out = rp.ragged_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), *meta)
    assert out.dtype == torch.bfloat16
    ref = rp.ragged_reference(q.bfloat16().float(), k.bfloat16().float(),
                              v.bfloat16().float(), *meta)
    # the only difference is the final rounding to bf16
    torch.testing.assert_close(out.float(), ref.bfloat16().float(),
                               atol=0, rtol=0)


def test_cpu_tensor_cannot_force_the_kernel():
    args = map(torch.from_numpy, _case("mixed", 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        rp.ragged_paged_attention(*args, use_pallas=True)


def test_kernel_wrapper_rejects_cpu_tensors_before_building():
    launches = rp.launches
    with pytest.raises(ValueError, match="CUDA device"):
        rp.ragged_kernel(*map(torch.from_numpy, _case("mixed", 2)))
    assert rp.launches == launches


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["head_dim_128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_reference(cuda, case, dtype):
    """The kernel against the plain version on the same inputs: fp32 within
    1e-4; bf16 within 2e-2 of the plain version run in fp32 on the same
    bf16 inputs (the kernel rounds only its output to bf16)."""
    q, k, v, *meta = [torch.from_numpy(a).to(cuda)
                      for a in _case(case, 4)]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    launches = rp.launches
    out = rp.ragged_paged_attention(q, k, v, *meta)
    torch.cuda.synchronize()
    assert rp.last_path == "cuda" and rp.launches == launches + 1
    ref = rp.ragged_reference(q.float(), k.float(), v.float(), *meta)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    plain = rp.ragged_paged_attention(q, k, v, *meta, use_pallas=False)
    assert rp.last_path == "reference" and rp.launches == launches + 1
    assert plain.dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
def test_cuda_engine_kernel_matches_plain(cuda, pool_dtype):
    """A tiny fp32 Llama served with the kernel and with the plain version
    on the card gives the same greedy tokens, and the kernel launched once
    per layer per engine step."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (EngineConfig, EngineCore,
                                          SamplingParams, SchedulerConfig)

    cfg = LlamaConfig.tiny(num_hidden_layers=2, hidden_size=256,
                           num_attention_heads=4, num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 17, 40, 23)]
    outs = {}
    for route in (None, False):
        eng = EngineCore(model, config=EngineConfig(
            num_blocks=64, block_size=16, dtype=pool_dtype,
            unified_step=True, use_pallas_paged=route,
            scheduler=SchedulerConfig(max_num_seqs=4,
                                      max_tokens_per_step=16)))
        rp.launches = 0
        reqs = [eng.add_request(p, SamplingParams(max_new_tokens=6))
                for p in prompts]
        eng.run(max_steps=400)
        outs[route] = [r.output_tokens for r in reqs]
        assert rp.launches == (eng.ragged_launches * 2 if route is None
                               else 0)
    assert outs[None] == outs[False]


# --- route, launch shape and work list (CPU) ----------------------------------

@pytest.mark.parametrize("device, q_dtype, kv_dtype, D, bs, want", [
    ("cpu", torch.bfloat16, torch.bfloat16, 128, 16, "reference"),
    ("cuda", torch.bfloat16, torch.bfloat16, 128, 16, "tma"),
    ("cuda", torch.bfloat16, torch.bfloat16, 64, 8, "tma"),
    ("cuda", torch.bfloat16, torch.bfloat16, 128, 64, "tma"),
    ("cuda", torch.float32, torch.float32, 128, 16, "simple"),
    ("cuda", torch.bfloat16, torch.float32, 128, 16, "simple"),
    ("cuda", torch.float32, torch.bfloat16, 128, 16, "simple"),
    ("cuda", torch.bfloat16, torch.bfloat16, 16, 4, "simple"),
    ("cuda", torch.bfloat16, torch.bfloat16, 256, 16, "simple"),
    ("cuda", torch.bfloat16, torch.bfloat16, 128, 4, "simple"),
    ("cuda", torch.bfloat16, torch.bfloat16, 128, 24, "simple"),
])
def test_route_rule(device, q_dtype, kv_dtype, D, bs, want):
    assert rp.route(device, q_dtype, kv_dtype, D, bs) == want


@pytest.mark.parametrize("T, H, Hkv", [(8, 32, 8), (64, 32, 8), (512, 32, 8),
                                        (8192, 32, 8), (16, 28, 4),
                                        (3, 8, 8), (40, 256, 1)])
def test_launch_shape_is_bounded_by_shapes(T, H, Hkv):
    """A chunk block's rows hold an item's tokens times the group's heads;
    the split count and grids come from T, H, Hkv and the SM count alone
    (no table width enters), and the split partials stay within 64 MB."""
    D = 128
    shape = rp.launch_shape(T, H, Hkv, D, 132)
    assert 1 <= shape["per"] <= max(1, 128 // (H // Hkv))
    assert shape["per"] * (H // Hkv) <= 128 or shape["per"] == 1
    assert shape["per"] <= T
    assert 1 <= shape["nsplit"] <= 8
    assert T * H * shape["nsplit"] * D * 4 <= 1 << 26 or shape["nsplit"] == 1
    assert 1 <= shape["chunk_blocks"] <= max(1, T // 2)
    assert 1 <= shape["decode_blocks"] <= T
    assert rp.launch_shape(T, H, Hkv, D, 132) == shape


def _serve_seg(rng, Tb, n_decode, chunks):
    """seg_ids of a serving packing as the engine builds it: decode rows
    first, then the prefill chunks, each contiguous, then pad tokens routed
    to a pad row."""
    seg = []
    for i, n in enumerate([1] * n_decode + list(chunks)):
        seg += [i] * n
    pad = min(len(seg) and seg[-1] + 1, Tb - 1)
    return np.array(seg + [pad] * (Tb - len(seg)), np.int32)


# (Tb, decode rows, chunk sizes) of the serve step's token buckets
SERVE_PACKINGS = {8: (8, []), 64: (32, [29]), 256: (16, [120, 119]),
                  512: (16, [248, 247])}


def _packings():
    rng = np.random.default_rng(0)
    out = {f"tiny {c}": _case(c, 4)[5] for c in CASES}
    out.update({f"serve T={T}": _serve_seg(rng, T, *p)
                for T, p in SERVE_PACKINGS.items()})
    return out


@pytest.mark.parametrize("name", sorted(_packings()))
@pytest.mark.parametrize("H, Hkv", [(4, 2), (32, 8), (28, 4), (8, 1)])
def test_work_items_cover_every_token_once(name, H, Hkv):
    seg = _packings()[name]
    T = len(seg)
    per = rp.tokens_per_item(T, H, Hkv)
    assert per == min(128 // (H // Hkv), T)
    chunks, decodes = rp.work_items(seg, per)
    items = [(t0, n) for t0, n in chunks] + [(t, 1) for t in decodes]
    seen = np.zeros(T, np.int32)
    for t0, n in items:
        assert 1 <= n <= per
        seen[t0:t0 + n] += 1
        assert len(set(seg[t0:t0 + n].tolist())) == 1   # one row
    assert (seen == 1).all()
    assert all(n > 1 for _, n in chunks)
    assert [t for t, _ in chunks] == sorted(t for t, _ in chunks)
    assert decodes == sorted(decodes)
    # items are aligned to their row's first token
    for t0, n in items:
        first = t0
        while first > 0 and seg[first - 1] == seg[t0]:
            first -= 1
        assert (t0 - first) % per == 0


def test_work_items_of_a_serve_step():
    """T=512, GQA 4:1: 16 decode rows, then chunks of 248 and 247 cut into
    items of 32 tokens from each chunk's first token, then the pad tokens
    (here none: 16 + 248 + 247 = 511 and one pad)."""
    seg = _serve_seg(np.random.default_rng(0), 512, 16, [248, 247])
    chunks, decodes = rp.work_items(seg, 32)
    assert decodes == list(range(16)) + [511]
    assert chunks[0] == (16, 32) and chunks[7] == (16 + 224, 24)
    assert chunks[8] == (264, 32) and chunks[-1] == (264 + 224, 23)
    assert len(chunks) == 16


def _dropped_last_page(lens, bs, rows):
    """kv_lens with the last page of each of ``rows`` dropped: what a kernel
    that skipped those pages would attend over."""
    lens = lens.copy()
    for r in rows:
        pages = -(-int(lens[r]) // bs)
        lens[r] = max(1, (pages - 1) * bs)
    return lens


def test_rowwise_check_sees_a_dropped_last_page():
    """The card's measure, ``flash.rowwise_error`` (each (token, head) row
    over its twin row's largest value, floored at 1e-2 of the tensor's and
    at 0.1): bf16 rounding of the inputs and the output passes 2e-2; an
    output whose chunk row lost its last page (16 of 128 keys) fails it,
    though its largest absolute error is small."""
    rng = np.random.default_rng(5)
    H, Hkv, D, bs, nb = 8, 2, 128, 16, 16
    rows = [([3, 7, 1], 40, [39]),
            ([5, 9, 2, 11, 4, 6, 8, 10], 128, list(range(64, 128)))]
    tables, lens, seg, pos = _pack(rows, 72, 8)
    q = rng.normal(size=(72, H, D)).astype(np.float32)
    k = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    meta = [torch.from_numpy(a) for a in (tables, lens, seg, pos)]
    bf = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    want = rp.ragged_reference(*[t.float() for t in bf], *meta)
    got = rp.ragged_reference(*bf, *meta)
    assert flash.rowwise_error(got, want) <= 2e-2
    dropped = torch.from_numpy(_dropped_last_page(lens, bs, [1]))
    bad = rp.ragged_reference(*[t.float() for t in bf], meta[0], dropped,
                              *meta[2:])
    assert flash.rowwise_error(bad, want) > 2e-2
    assert float((bad - want).abs().max()) < 0.5


# --- the tma route on the card ------------------------------------------------

def _serve_case(dev, rng, Tb, n_decode, chunks, H=32, Hkv=8, D=128, bs=16,
                W=64, num_blocks=2048, starts=None):
    """bf16 inputs of a serving packing: decode rows and chunk rows with
    random KV lengths up to W * bs over distinct random pages; ``starts``
    pins the first position of each chunk."""
    rows = []
    for i, n in enumerate([1] * n_decode + list(chunks)):
        kv = int(rng.integers(n, W * bs + 1))
        if starts is not None and i >= n_decode:
            kv = starts[i - n_decode] + n
        pages = rng.choice(np.arange(1, num_blocks), -(-kv // bs),
                           replace=False)
        rows.append((pages, kv, list(range(kv - n, kv))))
    meta = [torch.from_numpy(a).to(dev) for a in _pack(rows, Tb, W)]
    q = torch.randn(Tb, H, D, device=dev).bfloat16()
    k = torch.randn(num_blocks, bs, Hkv, D, device=dev).bfloat16()
    v = torch.randn(num_blocks, bs, Hkv, D, device=dev).bfloat16()
    return q, k, v, meta


def _hold(out, q, k, v, meta):
    """The kernel against the plain version in fp32 on the same bf16
    inputs, row by row and absolutely, both within 2e-2."""
    ref = rp.ragged_reference(q.float(), k.float(), v.float(), *meta)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert flash.rowwise_error(out, ref) <= 2e-2
    assert float((out.float() - ref).abs().max()) <= 2e-2
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("T", sorted(SERVE_PACKINGS))
@pytest.mark.parametrize("H, Hkv", [(32, 8), (28, 4)])
def test_cuda_tma_route_matches_reference_at_serve_packings(cuda, T, H, Hkv):
    rng = np.random.default_rng(T + H)
    q, k, v, meta = _serve_case(cuda, rng, T, *SERVE_PACKINGS[T], H=H,
                                Hkv=Hkv)
    counts = (rp.launches, rp.tma_launches, rp.simple_launches)
    out = rp.ragged_kernel(q, k, v, *meta)
    torch.cuda.synchronize()
    assert rp.last_route == "tma"
    assert (rp.launches, rp.tma_launches, rp.simple_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2])
    _hold(out, q, k, v, meta)


@pytest.mark.cuda
@pytest.mark.parametrize("D, bs", [(128, 16), (64, 8), (128, 64), (64, 32)])
def test_cuda_tma_route_chunk_starting_mid_page(cuda, D, bs):
    """Chunks whose first token sits inside a page, whose KV length is no
    multiple of 64 or of bs, next to decode rows, at GQA 7:1."""
    rng = np.random.default_rng(D + bs)
    q, k, v, meta = _serve_case(cuda, rng, 128, 3, [37, 50, 19], H=28,
                                Hkv=4, D=D, bs=bs, W=512 // bs,
                                num_blocks=64 * 64 // bs,
                                starts=[bs + 5, 3 * bs - 1, 7])
    out = rp.ragged_kernel(q, k, v, *meta)
    torch.cuda.synchronize()
    assert rp.last_route == "tma"
    _hold(out, q, k, v, meta)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 16])
def test_cuda_tma_route_decode_only(cuda, B):
    rng = np.random.default_rng(B)
    q, k, v, meta = _serve_case(cuda, rng, B, B, [])
    out = rp.ragged_kernel(q, k, v, *meta)
    torch.cuda.synchronize()
    assert rp.last_route == "tma"
    _hold(out, q, k, v, meta)


@pytest.mark.cuda
def test_cuda_tma_route_is_deterministic_and_ignores_the_table_bucket(cuda):
    """Two launches agree bit for bit; doubling the table bucket W (more
    zero-padded table columns) leaves every output bit where it was: the
    split count and the tiles depend on T, H, Hkv and the lengths only."""
    rng = np.random.default_rng(11)
    q, k, v, meta = _serve_case(cuda, rng, 256, *SERVE_PACKINGS[256])
    a = rp.ragged_kernel(q, k, v, *meta)
    b = rp.ragged_kernel(q, k, v, *meta)
    tables = meta[0]
    wide = torch.zeros(tables.shape[0], 2 * tables.shape[1],
                       dtype=tables.dtype, device=cuda)
    wide[:, :tables.shape[1]] = tables
    c = rp.ragged_kernel(q, k, v, wide, *meta[1:])
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("T", sorted(SERVE_PACKINGS))
@pytest.mark.parametrize("H, Hkv", [(32, 8), (28, 4), (4, 2)])
def test_cuda_work_list_matches_its_twin(cuda, T, H, Hkv):
    seg = _serve_seg(np.random.default_rng(T), T, *SERVE_PACKINGS[T])
    per = rp.tokens_per_item(T, H, Hkv)
    got = rp.worklist_kernel(torch.from_numpy(seg).to(cuda), per)
    assert got == rp.work_items(seg, per)


@pytest.mark.cuda
def test_cuda_row_check_sees_a_dropped_page(cuda):
    """The planted fault of chip_smoke.py's ragged phase at a smaller
    shape: the kernel's own output with the last page of each chunk
    token's walk dropped fails the row check that the true output passes."""
    rng = np.random.default_rng(12)
    q, k, v, meta = _serve_case(cuda, rng, 256, *SERVE_PACKINGS[256])
    ref = _hold(rp.ragged_kernel(q, k, v, *meta), q, k, v, meta)
    pos, seg = meta[3].cpu().numpy(), meta[2].cpu().numpy()
    for t in np.flatnonzero(np.isin(seg, [16, 17])):   # the chunk rows
        if pos[t] >= 16:
            pos[t] = pos[t] // 16 * 16 - 1
    bad = rp.ragged_kernel(q, k, v, *meta[:3], torch.from_numpy(pos).to(cuda))
    torch.cuda.synchronize()
    assert flash.rowwise_error(bad, ref) > 2e-2
