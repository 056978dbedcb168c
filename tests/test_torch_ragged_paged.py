"""Ragged paged attention in the PyTorch port, held to the JAX package.

On the CPU, ``paddle_tpu_torch.ops.ragged_paged.ragged_reference`` (the
plain PyTorch version) must agree with the JAX ``ragged_oracle`` and with
the JAX Pallas kernel run in interpret mode, over the decode-only,
chunk-only, mixed and padded packings of ``test_unified_ragged.py`` at two
table widths, plus one case at Llama's head width (D=128, bs=16).  fp32
throughout; tolerance 1e-5 (the three differ only in summation order).

The tests marked ``cuda`` compare the CUDA kernel with the plain version on
the card and skip elsewhere.  JAX is imported inside the tests that use it,
so this file also runs on a machine without JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_ragged_paged.py``).
"""

import numpy as np
import pytest
import torch

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
