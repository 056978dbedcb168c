#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA device and the
CUDA toolkit (``nvcc``)::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``paddle_tpu_torch/csrc/`` and runs
these phases, printing one JSON line for each:

``device``   the card (``nvidia-smi`` name and power limit, torch's name).
``build``    the four kernel sources in one build (one nvcc each, started
             together); nvcc's ptxas report goes to standard error.
``custom_op`` the custom-op path: the scale kernel (``csrc/scaled.cu``)
             against its twin bit for bit (``torch.equal``) over fp32, bf16
             and fp16, alpha in {2, 3, 0.1, -3.5}, 1 to 1,000,003
             elements, aligned and at storage offset 3, plus a planted
             fault the check must refuse; the JAX docstring example,
             ``ops/scaled.py::my_scaled``, called 3 times on a [8192,
             4096] bf16 tensor with its backward (launches = 3, gradient
             exactly 9: three runs of the custom bwd); one call under
             torch.profiler, whose ``my_scaled`` range must hold the
             kernel; the kernel, the op, its twin and ``torch.mul`` timed
             at that shape by CUDA events, the kernel and ``torch.mul``
             also by profiler device time, beside the bound, and the two
             in turns (40 rounds of 5 calls each, order reversed every
             round; medians and spread by both clocks); a
             ``cpp_extension.load`` host op on a CUDA tensor.
``kernels``  the ragged kernel against its plain PyTorch version on the same
             inputs, each (token, head) row against its twin row by
             ``flash.rowwise_error`` and absolutely (fp32 within 1e-4; bf16
             within 2e-2 of the plain version run in fp32 on the same bf16
             inputs), over the packings of the CPU tests at tiny shapes (the
             simple route) and over Llama-3-8B's attention shapes (H=32,
             Hkv=8, D=128, bs=16, T in {8, 64, 256, 512}, tables of up to 64
             pages; bf16 takes the tma route, fp32 the simple one), plus GQA
             7:1 (H=28, Hkv=4), a chunk starting mid-page and decode-only
             steps on the tma route; the device work list against its twin
             at each packing; a planted fault, the kernel's output with the
             last page of each chunk token's walk dropped, which the row
             check must refuse at T=512; the launches of each route.  Times
             from CUDA events: the kernel, the plain version, one PyTorch
             library call computing the same function
             (``scaled_dot_product_attention`` over the K/V gathered to a
             dense context beforehand, a yardstick the port never calls)
             and the bound, the larger of the operations over the card's
             peak rate and the bytes over its memory rate; at T=512 bf16
             also the profiler's device time of every device function of
             the call (work list, chunk, decode and combine kernels).
``decode_kernels``  the paged decode kernel against its plain version,
             each (row, head) row against its twin row by
             ``flash.rowwise_error`` and absolutely (fp32 within 1e-4, bf16
             within 2e-2 of the plain version in fp32 on the same bf16
             inputs), over the CPU tests' decode buckets B x W in {1,2,4,8}^2
             and Llama-3-8B's decode shapes (H=32, Hkv=8, D=128, bs=16, B in
             {1, 4, 16}, random lengths up to 2112 tokens in tables padded
             to 256 pages; bf16 takes the mma route, fp32 the simple one);
             a planted fault, the twin with each row's last span dropped,
             which the row check must refuse at B=16; each row's bits alone
             (B=1), inside B=16, at table width 2W and on a second run;
             timed like the ragged kernel, plus the kernel's device time per
             call read from torch.profiler (walk and combine), the host's
             cost a call (event time minus device time, and the wrapper's
             own CPU time by time.perf_counter), the span plan's work items
             and, at B=1 and 16 bf16, the device time at spans of 32 and 64
             tokens beside the 128 the kernel uses; the launches of each
             route.
``identity`` Llama-3-8B at full width cut to 4 layers, fp32, random weights
             from a seeded generator: 8 prompts sharing a 64-token prefix
             through the engine with the kernel and with the plain version;
             the greedy tokens must be identical and the kernel must have
             launched once per layer per engine step, on the simple route.
``serve``    Llama-3-8B at full width and depth, bf16 weights and pools:
             16 prompts of 256-2048 tokens, 64 greedy tokens each, through
             ``LLM.generate``; output tokens/s, mean TTFT, mean inter-token
             latency, engine steps, kernel launches (= steps x layers, every
             one on the tma route) and peak device memory.
``profile``  torch.profiler over a short window of the same engine: device
             time by kernel, the ragged kernel's and the matrix products'
             shares, and the device's idle share.
``identity_legacy``  the identity model and prompts through the JAX
             package's default serving call, ``LLM(model, num_blocks=...,
             block_size=16, max_num_seqs=8)`` (the legacy prefill / chunk /
             decode families) with a 256-token prefill budget: the decode
             kernel and the plain version give identical greedy tokens, so
             do decode bursts of 8 with strictly fewer host round trips, and
             the decode kernel launched (decode steps + burst iterations) x
             layers times, all on the simple route (fp32).
``serve_legacy``  the serve model and prompts through the legacy ``LLM``
             in bf16, without and with decode bursts of 8: the serve
             numbers, the steps of each family and the mean wall time of
             one launch of each, the launch rule (every launch on the mma
             route) and peak memory.  Then a
             profile window on each of the two engines: the decode
             kernel's, the matrix products' and the idle shares.
``flash_kernels``  the three flash kernels (forward, dQ, dK/dV) against
             their twins on the same inputs by ``flash.rowwise_error``,
             each output row against its twin row (fp32 within 1e-4; bf16
             within 2e-2 of the twins run in fp32 on the same bf16 inputs;
             lse within 1e-4), at the CPU tests' shapes, at the edges of
             the bf16 TMA kernels' tiles (S = 130 and 4000, GQA groups of
             1, 2, 4 and 8 heads, head dims 64 and 128, and groups of 7 and
             3 heads, which fill 126 of a block's 128 rows), on unaligned
             bf16 views that must take the counted copy route (3 copies,
             results bit-equal to contiguous inputs), and at Llama-3-8B's
             training shape (H=32, Hkv=8, D=128, causal, B=2, S=4096),
             where each output with its last tile zeroed must fail the
             same check; timed there like the other kernels, with the
             achieved TFLOP/s and the bound's share of the time; the
             library yardsticks are ``scaled_dot_product_attention``
             (causal, GQA) and its autograd backward, which computes dQ,
             dK and dV in one.
``train_identity``  Llama-3-8B widths cut to 2 layers, fp32, B=1, S=1024:
             4 AdamW steps with the kernels and with
             ``use_flash_attention=False``; the losses agree within 1e-4
             relative and each kernel launched 4 x 2 times.
``train``    the training path at full Llama-3-8B width cut to 4 layers
             (full depth needs ~128 GB of weights, gradients and AdamW
             state), bf16 with fp32 master weights, AdamW under a cosine
             schedule, B=2, S=4096 on examples/pretrain_llama.py's
             synthetic corpus: 2 warm-up and 8 timed steps of
             ``model(ids) -> criterion -> backward -> step -> clear_grad``;
             losses (finite, falling), ms a step, tokens/s, MFU against
             989 TFLOP/s with PaLM's count (and without the input
             embedding in N), peak memory, and launches =
             steps x layers for each kernel.
``train_profile``  torch.profiler over 2 more train steps: each flash
             kernel's and the matrix products' share of device time, each
             flash kernel's device time a launch, the top kernels and the
             idle share; on a line before it (``train_clocks``), the card's
             SM clock, power draw and temperature sampled by nvidia-smi
             before and after the window.  The ``kernels`` line's flash
             rows take their ``device_ms`` from this window.

Then a line ``{"kernels": [...]}`` summarising each kernel at its main
path's shapes (the ragged kernel at the unified serve step, the decode
kernel at B=16 bf16, the flash kernels at the train shape in bf16, the
scale kernel at [8192, 4096] bf16, with the launches of the serve, the
burst-free serve_legacy, the train and the custom_op runs), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any
failure raises and the script exits nonzero without that last line; so
does a machine without a CUDA device, and a directory that holds this
script without the package.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                  # H100 SXM HBM3
KERNEL_NAME = "ragged_paged_attention"
DECODE_NAME = "paged_decode_attention"
FLASH_NAME = "flash_attention"
SCALED_NAME = "scaled"
# the device functions of each kernel, as a profiler names them
KERNEL_MARKS = ("ragged_",)   # work list, chunk, decode, combine, simple
DECODE_MARKS = ("paged_decode_",)   # the walks (simple, mma), the combine
# (flash_fwd_kernel for fp32 inputs, flash_fwd_tma_kernel for bf16, ...)
FLASH_MARKS = {"fwd": ("flash_fwd_",), "dq": ("flash_bwd_dq_",),
               "dkv": ("flash_bwd_dkv_",)}
MATMUL_MARKS = ("gemm", "xmma", "cutlass", "nvjet", "matmul")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_sample() -> dict:
    """The card's SM clock, power draw and temperature, as nvidia-smi reads
    them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    clock, power, temp = (x.strip() for x in
                          out.stdout.strip().splitlines()[0].split(","))
    return {"clocks_sm": clock, "power_draw": power, "temperature": temp}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --- kernel phase -------------------------------------------------------------

def packing(rng, Tb, n_decode, chunks, W, bs, num_blocks):
    """Packed metadata as the engine builds it: ``n_decode`` decode rows and
    one prefill chunk row per entry of ``chunks`` (its token count), with
    random KV lengths up to ``W * bs`` over distinct random pages; tokens
    past the real ones are pads routed to a pad row."""
    rows = []
    for n in [1] * n_decode + list(chunks):
        kv = int(rng.integers(n, W * bs + 1))
        pages = rng.choice(np.arange(1, num_blocks), -(-kv // bs),
                           replace=False)
        rows.append((pages, kv, list(range(kv - n, kv))))
    return pack_rows(rows, Tb, W)


def tiny_packings():
    """The decode-only / chunk-only / mixed / padded packings of
    tests/test_torch_ragged_paged.py (H=4, Hkv=2, bs=4)."""
    return {
        "decode_only": ([([1 + 2 * i, 2 + 2 * i][:max(1, -(-L // 4))], L,
                          [L - 1]) for i, L in enumerate((3, 6, 8, 5))], 4),
        "chunk_only": ([([3, 7], 7, [4, 5, 6]),
                        ([5, 9], 5, [0, 1, 2, 3, 4])], 8),
        "mixed": ([([3, 7], 6, [5]), ([5, 9], 5, [2, 3, 4]),
                   ([2, 11], 8, [7])], 8),
        "padded": ([([3], 2, [1]), ([5, 9], 5, [3, 4])], 8),
    }


def pack_rows(rows, Tb, W):
    """Packed metadata from ``rows`` = [(pages, kv_len, q_positions)], with
    the row arrays padded to ``Tb`` rows."""
    tables = np.zeros((Tb, W), np.int32)
    lens = np.ones((Tb,), np.int32)
    seg = np.full((Tb,), min(len(rows), Tb - 1), np.int32)
    pos = np.zeros((Tb,), np.int32)
    cursor = 0
    for i, (pages, kv, positions) in enumerate(rows):
        tables[i, :len(pages)] = pages
        lens[i] = kv
        seg[cursor:cursor + len(positions)] = i
        pos[cursor:cursor + len(positions)] = positions
        cursor += len(positions)
    if cursor > Tb:
        raise ValueError(f"{cursor} tokens do not fit a bucket of {Tb}")
    return tables, lens, seg, pos


def work(q, k_cache, tables, lens, seg, pos):
    """Operations and unique bytes the function needs on these inputs:
    4 * limit_t * H * D flops per token; q and out once, each used row's
    K/V pages once, and the routing arrays."""
    T, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    limit = np.minimum(lens[seg], pos + 1)
    flops = float(4 * limit.sum() * H * D)
    row_limit = {}
    for r, lim in zip(seg.tolist(), limit.tolist()):
        row_limit[r] = max(row_limit.get(r, 0), lim)
    pages = sum(-(-lim // bs) for lim in row_limit.values())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * pages * bs * Hkv * D * k_cache.element_size()
              + 4 * (tables.size + lens.size + seg.size + pos.size))
    return flops, nbytes


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters, marks):
    """Device time per call of ``fn`` in each kernel whose name holds one of
    ``marks``, from torch.profiler: {function name: ms}.  Unlike
    :func:`time_ms` it leaves out the host's cost of issuing each call,
    which sets the pace of back-to-back calls when the kernels are shorter
    than that cost.  Raises when it records none in those kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for k, us in device_kernels(prof).items():
        if any(m in k.lower() for m in marks):
            name = re.search(r"(\w+)(<[^>(]*>)?\(", k.split("::")[-1])
            key = name.group(0)[:-1] if name else k[:60]
            times[key] = times.get(key, 0.0) + us / iters / 1e3
    if not times:
        raise AssertionError(f"the profiler recorded no device time in "
                             f"kernels named {marks}")
    return times


def device_ms(fn, iters, marks):
    """The device time per call of ``fn`` summed over the kernels whose
    names hold one of ``marks`` (:func:`device_times`)."""
    return sum(device_times(fn, iters, marks).values())


def library_call(q, k_cache, v_cache, tables, seg, lens, pos):
    """scaled_dot_product_attention over each token's pages gathered to a
    dense masked context beforehand: returns the timed call (the gather
    stays outside it)."""
    import torch
    import torch.nn.functional as F

    T, H, D = q.shape
    bs, Hkv = k_cache.shape[1], k_cache.shape[2]
    W = tables.shape[1]
    bt = tables.long()[seg.long()]
    k = k_cache[bt].reshape(T, W * bs, Hkv, D).transpose(1, 2).contiguous()
    v = v_cache[bt].reshape(T, W * bs, Hkv, D).transpose(1, 2).contiguous()
    limit = torch.minimum(lens.long()[seg.long()], pos.long() + 1)
    mask = (torch.arange(W * bs, device=q.device)[None, :]
            < limit[:, None])[:, None, None, :]
    qd = q[:, :, None, :].to(k.dtype)
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            qd, k, v, attn_mask=mask, enable_gqa=True)
    k, v = (t.repeat_interleave(H // Hkv, dim=1) for t in (k, v))
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask)


def dropped_last_page(pos, seg, rows, bs):
    """q_pos with the last page of each walk of the tokens of ``rows``
    dropped: each such token then attends up to the start of the page that
    holds its own position (the row's last tokens lose the row's last
    page); tokens of a row's first page keep their walk.  What a kernel
    that skipped each walk's last page would compute."""
    pos = pos.copy()
    for t in np.flatnonzero(np.isin(seg, list(rows))):
        if pos[t] >= bs:
            pos[t] = pos[t] // bs * bs - 1
    return pos


def kernel_phase(torch, rp, flash):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checks = []
    rp.simple_launches = rp.tma_launches = 0

    def check(label, q32, k32, v32, meta, dtype, route):
        q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
        out = rp.ragged_kernel(q, k, v, *meta)
        torch.cuda.synchronize()
        ref = rp.ragged_reference(q.float(), k.float(), v.float(), *meta)
        err = float((out.float() - ref).abs().max())
        row = flash.rowwise_error(out, ref)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        if not (err <= tol and row <= tol and torch.isfinite(out).all()
                and rp.last_route == route):
            raise AssertionError(f"ragged kernel disagrees with the plain "
                                 f"version on {label} {dtype}: max abs err "
                                 f"{err}, row err {row} (tol {tol}), route "
                                 f"{rp.last_route} (due {route})")
        checks.append({"case": label, "dtype": str(dtype).split(".")[-1],
                       "route": route, "max_abs_err": err,
                       "max_row_err": row, "tol": tol})
        return q, k, v, err, row, ref

    for D in (8, 16):
        for name, (rows, Tb) in tiny_packings().items():
            meta = [torch.from_numpy(a).to(dev)
                    for a in pack_rows(rows, Tb, 4)]
            q = torch.randn(Tb, 4, D, device=dev)
            k = torch.randn(16, 4, 2, D, device=dev)
            v = torch.randn(16, 4, 2, D, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                check(f"tiny {name} D={D}", q, k, v, meta, dtype, "simple")

    H, Hkv, D, bs, W, num_blocks = 32, 8, 128, 16, 64, 4096
    shapes = {8: (8, []), 64: (32, [29]), 256: (16, [120, 119]),
              512: (16, [248, 247])}   # Tb: (decode rows, chunk sizes)
    timings = []
    summary = None
    work_lists = {}
    planted = None
    k32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    v32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    for Tb, (n_decode, chunks) in shapes.items():
        arrays = packing(rng, Tb, n_decode, chunks, W, bs, num_blocks)
        meta = [torch.from_numpy(a).to(dev) for a in arrays]
        q32 = torch.randn(Tb, H, D, device=dev)
        # the device work list against its plain twin
        per = rp.tokens_per_item(Tb, H, Hkv)
        items = rp.worklist_kernel(meta[2], per)
        if items != rp.work_items(arrays[2], per):
            raise AssertionError(f"ragged work list at T={Tb} differs from "
                                 f"its twin")
        work_lists[Tb] = {"chunk_items": len(items[0]),
                          "decode_items": len(items[1]), "per": per}
        for dtype in (torch.float32, torch.bfloat16):
            label = f"8b T={Tb} decode={n_decode} chunks={chunks}"
            route = "tma" if dtype == torch.bfloat16 else "simple"
            q, k, v, err, row_err, ref = check(label, q32, k32, v32, meta,
                                               dtype, route)
            flops, nbytes = work(q, k, *arrays)
            name = str(dtype).split(".")[-1]
            library = library_call(q, k, v, *[meta[i] for i in (0, 2, 1, 3)])
            library_err = float((library()[:, :, 0].float() - ref).abs().max())
            if not library_err <= 2e-2:
                raise AssertionError(f"the library yardstick computes another "
                                     f"function: max abs err {library_err}")
            if Tb == 512 and dtype == torch.bfloat16:
                # the planted fault: the last page of each chunk token's
                # walk dropped must fail the row check
                pos = dropped_last_page(
                    arrays[3], arrays[2],
                    range(n_decode, n_decode + len(chunks)), bs)
                bad = rp.ragged_kernel(q, k, v, *meta[:3],
                                       torch.from_numpy(pos).to(dev))
                planted = {"row": flash.rowwise_error(bad, ref),
                           "abs": float((bad.float() - ref).abs().max()),
                           "tol": 2e-2}
                if not planted["row"] > 2e-2:
                    raise AssertionError(f"ragged: the dropped last pages "
                                         f"passed the row check: {planted}")
                del bad
            del ref
            t_flops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            row = {
                "T": Tb, "dtype": name, "route": route,
                "decode_rows": n_decode, "chunks": chunks,
                "max_abs_err": err, "max_row_err": row_err,
                "ms": time_ms(lambda: rp.ragged_kernel(q, k, v, *meta), 20),
                "plain_ms": time_ms(
                    lambda: rp.ragged_reference(q, k, v, *meta), 5, 1),
                "library_ms": time_ms(library, 10),
                "library_max_abs_err": library_err,
                "bound_ms": max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops > t_bytes else "bytes",
                "flops": flops, "bytes": nbytes,
            }
            if Tb == 512 and dtype == torch.bfloat16:
                parts = device_times(
                    lambda: rp.ragged_kernel(q, k, v, *meta), 20,
                    KERNEL_MARKS)
                row["device_ms"] = sum(parts.values())
                row["device_ms_by_kernel"] = parts
                summary = row   # the serve phase's step shape and types
            timings.append(row)
            del library
            torch.cuda.empty_cache()
    del k32, v32
    torch.cuda.empty_cache()

    # the tma route at GQA 7:1, a chunk starting mid-page, decode-only steps
    extra = {
        "gqa 7:1 T=256": (28, 4, 256, 16, [120, 119], None),
        "chunks from mid-page T=128": (32, 8, 128, 3, [37, 50, 19],
                                       [bs + 5, 3 * bs - 1, 7]),
        "decode only T=16": (32, 8, 16, 16, [], None),
        "gqa 7:1 decode only T=8": (28, 4, 8, 8, [], None),
    }
    for label, (h, hkv, Tb, n_decode, chunks, starts) in extra.items():
        rows = []
        for i, n in enumerate([1] * n_decode + chunks):
            kv = int(rng.integers(n, W * bs + 1))
            if starts is not None and i >= n_decode:
                kv = starts[i - n_decode] + n
            pages = rng.choice(np.arange(1, 1024), -(-kv // bs),
                               replace=False)
            rows.append((pages, kv, list(range(kv - n, kv))))
        meta = [torch.from_numpy(a).to(dev)
                for a in pack_rows(rows, Tb, W)]
        check(label, torch.randn(Tb, h, D, device=dev),
              torch.randn(1024, bs, hkv, D, device=dev),
              torch.randn(1024, bs, hkv, D, device=dev), meta,
              torch.bfloat16, "tma")
    routes = {"simple": rp.simple_launches, "tma": rp.tma_launches}
    emit("kernels", name=KERNEL_NAME, checks=len(checks),
         worst=max(checks, key=lambda c: max(c["max_abs_err"],
                                             c["max_row_err"]) / c["tol"]),
         planted_dropped_pages=planted, work_lists=work_lists,
         route_launches=routes, timings=timings,
         note="max_row_err is flash.rowwise_error over (token, head) rows; "
              "planted: the kernel's output at T=512 bf16 with the last "
              "page of each chunk token's walk dropped, read by it (must "
              "exceed tol) and absolutely; route_launches counts every "
              "launch of this phase, checks and timing loops included")
    return summary


# --- decode kernel phase ------------------------------------------------------

def decode_bucket_case(rng, B, W, bs=4, Hkv=2, H=4, D=16):
    """tests/test_torch_paged_decode.py's decode bucket: each row owns 1..W
    distinct pages, 0-padded, with a random length inside them."""
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


def decode_tables(rng, lens, W, bs, num_blocks):
    """A [B, W] table over distinct random pages, live pages only."""
    need = [-(-int(n) // bs) for n in lens]
    pages = rng.choice(np.arange(1, num_blocks), sum(need), replace=False)
    tables = np.zeros((len(lens), W), np.int32)
    at = 0
    for i, n in enumerate(need):
        tables[i, :n] = pages[at:at + n]
        at += n
    return tables


def decode_kernel_phase(torch, pd, flash):
    """The decode kernel against decode_reference, each (row, head) against
    its twin row: the CPU tests' bucket lattice, then Llama-3-8B's decode
    shapes with times.  At the 8B shapes each timed launch takes the next of
    several table sets over distinct pages of a large pool, so the pages
    come from device memory and not from L2, as they do for a decode step
    that walks all the layers."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    checks = []
    pd.launches = pd.simple_launches = pd.mma_launches = 0

    def check(label, q, k, v, tables, lens):
        out = pd.decode_kernel(q, k, v, tables, lens)
        torch.cuda.synchronize()
        ref = pd.decode_reference(q.float(), k.float(), v.float(), tables,
                                  lens)
        err = float((out.float() - ref).abs().max())
        row = flash.rowwise_error(out, ref)
        tol = 1e-4 if q.dtype == torch.float32 else 2e-2
        way = pd.route("cuda", q.dtype, k.dtype, q.shape[2], k.shape[1])
        if not (err <= tol and row <= tol and pd.last_route == way
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"decode kernel disagrees with the plain "
                                 f"version on {label} {q.dtype}: max abs "
                                 f"err {err}, row err {row} (tol {tol}), "
                                 f"route {pd.last_route} (due {way})")
        checks.append({"case": label, "dtype": str(q.dtype).split(".")[-1],
                       "route": way, "max_abs_err": err, "max_row_err": row,
                       "tol": tol})
        return out, ref, err

    for B in (1, 2, 4, 8):
        for W in (1, 2, 4, 8):
            arrays = [torch.from_numpy(a).to(dev)
                      for a in decode_bucket_case(rng, B, W)]
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (t.to(dtype) for t in arrays[:3])
                check(f"tiny B={B} W={W}", q, k, v, *arrays[3:])

    H, Hkv, D, bs, W, max_len, n_sets = 32, 8, 128, 16, 256, 2112, 12
    span = pd.span_tokens(bs)
    num_blocks = n_sets * 16 * (max_len // bs) + 1
    k32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    v32 = torch.randn(num_blocks, bs, Hkv, D, device=dev)
    timings = []
    summary = planted = None
    bit_equal = {}
    for B in (1, 4, 16):
        lens = rng.integers(1, max_len + 1, B).astype(np.int32)
        sets = [decode_tables(rng, lens, W, bs, num_blocks)
                for _ in range(n_sets)]
        lens_t = torch.from_numpy(lens).to(dev)
        tables = [torch.from_numpy(t).to(dev) for t in sets]
        q32 = torch.randn(B, H, D, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            name = str(dtype).split(".")[-1]
            label = f"8b B={B}"
            out, ref, err = check(label, q, k, v, tables[0], lens_t)
            err = max(err, check(label, q, k, v, tables[1], lens_t)[2])
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            if B == 16:
                # the planted fault: each row's walk without its last span
                # (the twin with the last span dropped) must fail the check
                cut = torch.clamp((lens_t - 1) // span * span, min=0).int()
                bad = pd.decode_split_reference(q.float(), k.float(),
                                                v.float(), tables[0], cut)
                planted = {"dtype": name, "tol": tol,
                           "row": flash.rowwise_error(bad, ref),
                           "abs": float((bad - ref).abs().max())}
                if not planted["row"] > tol:
                    raise AssertionError(f"decode: each row without its last "
                                         f"span passed the row check: "
                                         f"{planted}")
                # a row's bits alone (B=1), inside B=16 and at width 2W
                wide = torch.zeros(B, 2 * W, dtype=torch.int32, device=dev)
                wide[:, :W] = tables[0]
                doubled = pd.decode_kernel(q, k, v, wide, lens_t)
                alone = [pd.decode_kernel(q[i:i + 1].contiguous(), k, v,
                                          tables[0][i:i + 1].contiguous(),
                                          lens_t[i:i + 1].contiguous())[0]
                         for i in range(B)]
                again = pd.decode_kernel(q, k, v, tables[0], lens_t)
                torch.cuda.synchronize()
                bit_equal[name] = {
                    "width_2W": bool(torch.equal(doubled, out)),
                    "alone_B1": all(torch.equal(a, out[i])
                                    for i, a in enumerate(alone)),
                    "rerun": bool(torch.equal(again, out))}
                if not all(bit_equal[name].values()):
                    raise AssertionError(f"decode: rows moved across B, W or "
                                         f"runs: {bit_equal[name]}")
                del bad, wide, doubled, alone, again
            del out, ref
            flops, nbytes = work(q, k, sets[0], lens, np.arange(B),
                                 lens - 1)
            # one query token per row, at position len - 1
            rows = torch.arange(B, device=dev)
            library = [library_call(q, k, v, t, rows, lens_t, lens_t - 1)
                       for t in tables]
            ref = pd.decode_reference(q.float(), k.float(), v.float(),
                                      tables[0], lens_t)
            library_err = float((library[0]()[:, :, 0].float() - ref)
                                .abs().max())
            if not library_err <= 2e-2:
                raise AssertionError(f"the library yardstick computes another "
                                     f"function: max abs err {library_err}")
            del ref

            def cycle(fn):
                state = {"i": 0}

                def call():
                    fn(state["i"] % n_sets)
                    state["i"] += 1
                return call

            t_flops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            kernel = cycle(lambda i: pd.decode_kernel(q, k, v, tables[i],
                                                      lens_t))
            ms = time_ms(kernel, 4 * n_sets)
            parts = device_times(kernel, 2 * n_sets, DECODE_MARKS)
            device = sum(parts.values())
            row = {
                "B": B, "dtype": name, "lens": lens.tolist(), "W": W,
                "max_abs_err": err,
                "ms": ms, "device_ms": device,
                "device_ms_by_kernel": parts,   # the walk and the combine
                # the host's cost of a call that the device does not hide:
                # CUDA-event time of back-to-back calls minus device time
                "host_gap_ms": ms - device,
                # the wrapper's own CPU time a call, its launch included
                "wrapper_cpu_ms": wrapper_cpu_ms(torch, kernel, 200),
                "plain_ms": time_ms(cycle(lambda i: pd.decode_reference(
                    q, k, v, tables[i], lens_t)), n_sets, 1),
                "library_ms": time_ms(cycle(lambda i: library[i]()),
                                      2 * n_sets),
                "library_max_abs_err": library_err,
                "bound_ms": max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops > t_bytes else "bytes",
                "flops": flops, "bytes": nbytes,
                "route": pd.last_route, "span": span,
                # work items: (row, head group, span)
                "items": len(pd.span_plan(lens, span))
                * pd.head_groups(H, Hkv, pd.last_route)[0],
            }
            if dtype == torch.bfloat16 and B in (1, 16):
                # the span's choice: device time at shorter spans
                row["device_ms_by_span"] = {}
                for sp in (32, 64, pd.SPAN_TOKENS):
                    chosen, pd.SPAN_TOKENS = pd.SPAN_TOKENS, sp
                    try:
                        row["device_ms_by_span"][str(sp)] = device_ms(
                            kernel, 2 * n_sets, DECODE_MARKS)
                    finally:
                        pd.SPAN_TOKENS = chosen
            timings.append(row)
            if B == 16 and dtype == torch.bfloat16:
                summary = row   # the serve_legacy decode step's shape
            del library, q, k, v
            torch.cuda.empty_cache()
    del k32, v32
    torch.cuda.empty_cache()
    emit("decode_kernels", name=DECODE_NAME, checks=len(checks),
         worst=max(checks, key=lambda c: max(c["max_abs_err"],
                                             c["max_row_err"]) / c["tol"]),
         planted_dropped_span=planted, bit_equal=bit_equal,
         launches=pd.launches,
         route_launches={"simple": pd.simple_launches,
                         "mma": pd.mma_launches},
         timings=timings,
         note="max_row_err is flash.rowwise_error over (row, head) rows; "
              "planted: the twin with each row's last span dropped at B=16, "
              "read by the row check (must exceed tol); launches and "
              "route_launches count every launch of this phase, checks and "
              "timing loops included")
    return summary


def wrapper_cpu_ms(torch, fn, n):
    """The host's time a call of ``fn`` by time.perf_counter over ``n``
    calls, with no synchronisation inside (the device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


# --- engine phases ------------------------------------------------------------

def prompts_with_prefix(rng, n, lo, hi, prefix_len, vocab):
    prefix = rng.integers(0, vocab, prefix_len).tolist()
    return [prefix + rng.integers(0, vocab, int(rng.integers(lo, hi + 1))
                                  - prefix_len).tolist() for _ in range(n)]


def identity_phase(torch, rp, serving, LlamaConfig, LlamaForCausalLM):
    layers = 4
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32,
                             generator=gen)
    rng = np.random.default_rng(1)
    prompts = prompts_with_prefix(rng, 8, 100, 700, 64, cfg.vocab_size)
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    results = {}
    for route in (None, False):
        eng = serving.EngineCore(model, config=serving.EngineConfig(
            num_blocks=need + 16, block_size=16, dtype=torch.float32,
            unified_step=True, use_pallas_paged=route,
            scheduler=serving.SchedulerConfig(max_num_seqs=8,
                                              max_tokens_per_step=256)))
        rp.launches = rp.simple_launches = rp.tma_launches = 0
        reqs = [eng.add_request(p, serving.SamplingParams(max_new_tokens=16))
                for p in prompts]
        t0 = time.perf_counter()
        eng.run(max_steps=2000)
        torch.cuda.synchronize()
        results[route] = {
            "tokens": [list(r.output_tokens) for r in reqs],
            "launches": rp.launches, "steps": eng.ragged_launches,
            "route_launches": {"simple": rp.simple_launches,
                               "tma": rp.tma_launches},
            "seconds": time.perf_counter() - t0,
            "prefix_hit_tokens": eng.metrics.counters[
                "prefix_cache_hit_tokens"],
            "buckets": sorted(eng.ragged_buckets)}
        if eng.kv.occupancy() != 0.0:
            raise AssertionError("identity: the pool is not empty at the end")
    kern, plain = results[None], results[False]
    if kern["tokens"] != plain["tokens"]:
        raise AssertionError("identity: kernel and plain engines emitted "
                             "different greedy tokens")
    if (kern["launches"] != kern["steps"] * layers or plain["launches"]
            or kern["route_launches"]["simple"] != kern["launches"]):
        raise AssertionError(f"identity: {kern['launches']} kernel launches "
                             f"for {kern['steps']} steps x {layers} layers, "
                             f"by route {kern['route_launches']} (fp32: all "
                             f"simple; plain run: {plain['launches']})")
    if kern["prefix_hit_tokens"] <= 0:
        raise AssertionError("identity: no prefix fork happened")
    if any(len(t) != 16 or not all(0 <= x < cfg.vocab_size for x in t)
           for t in kern["tokens"]):
        raise AssertionError("identity: malformed token streams")
    emit("identity", layers=layers, dtype="float32",
         prompt_lens=[len(p) for p in prompts],
         greedy_identical=True, kernel_launches=kern["launches"],
         route_launches=kern["route_launches"],
         ragged_launches=kern["steps"], plain_launches=plain["launches"],
         prefix_hit_tokens=kern["prefix_hit_tokens"],
         buckets=kern["buckets"], kernel_s=kern["seconds"],
         plain_s=plain["seconds"], first_tokens=kern["tokens"][0][:8])
    return model, prompts, kern["tokens"]


def legacy_counts(eng):
    """Steps of each legacy family, bursts and decode-kernel launches due
    so far: the decode kernel runs once per layer per decode step and per
    burst iteration."""
    m = eng.metrics
    chunks = m.counters["chunked_prefill_steps"]
    decode_steps = m.histogram("decode_step").count
    burst_iters = int(eng._burst_counters["length"].sum)
    return {"prefill_steps": m.histogram("prefill_step").count - chunks,
            "chunk_steps": chunks, "decode_steps": decode_steps,
            "bursts": int(eng._burst_counters["launches"].value),
            "burst_iterations": burst_iters,
            "roundtrips": int(eng._burst_counters["roundtrips"].value),
            "decode_launches_due": (decode_steps + burst_iters)
            * eng.model.config.num_hidden_layers}


def identity_legacy_phase(torch, pd, serving, model, prompts,
                          unified_tokens):
    """The identity model and prompts through the JAX package's default
    serving call, the keyword form of LLM, which builds the legacy
    families.  Its prefill budget is set on the scheduler's config: the
    keyword form takes max_num_seqs only."""
    layers = model.config.num_hidden_layers
    need = sum(-(-(len(p) + 16) // 16) for p in prompts) + 1
    budget = 256
    results = {}
    for name in ("kernel", "plain", "burst"):
        if name == "burst":
            llm = serving.LLM(model, config=serving.EngineConfig(
                num_blocks=need + 16, block_size=16, burst_steps=8,
                scheduler=serving.SchedulerConfig(
                    max_num_seqs=8, max_prefill_tokens_per_step=budget)))
        else:
            llm = serving.LLM(model, num_blocks=need + 16, block_size=16,
                              max_num_seqs=8,
                              use_pallas_paged=None if name == "kernel"
                              else False)
            llm.engine.scheduler.config.max_prefill_tokens_per_step = budget
        eng = llm.engine
        if eng._unified:
            raise AssertionError("identity_legacy: LLM(model, ...) did not "
                                 "build the legacy families")
        pd.launches = pd.simple_launches = pd.mma_launches = 0
        t0 = time.perf_counter()
        outs = llm.generate(prompts, serving.SamplingParams(
            max_new_tokens=16))
        torch.cuda.synchronize()
        counts = legacy_counts(eng)
        results[name] = dict(
            counts, tokens=[o.token_ids for o in outs],
            launches=pd.launches, seconds=time.perf_counter() - t0,
            route_launches={"simple": pd.simple_launches,
                            "mma": pd.mma_launches},
            prefix_hit_tokens=eng.metrics.counters["prefix_cache_hit_tokens"],
            buckets={"decode": sorted(eng.decode_buckets),
                     "prefill": sorted(eng.prefill_buckets),
                     "burst": sorted(eng.burst_buckets)})
        if eng.kv.occupancy() != 0.0:
            raise AssertionError(f"identity_legacy {name}: the pool is not "
                                 f"empty at the end")
        del llm, eng
    kern, plain, burst = results["kernel"], results["plain"], results["burst"]
    if kern["tokens"] != plain["tokens"]:
        raise AssertionError("identity_legacy: the decode kernel and the "
                             "plain version emitted different greedy tokens")
    if burst["tokens"] != kern["tokens"]:
        raise AssertionError("identity_legacy: decode bursts changed the "
                             "greedy tokens")
    if not burst["roundtrips"] < kern["roundtrips"] or burst["bursts"] == 0:
        raise AssertionError(f"identity_legacy: {burst['bursts']} bursts, "
                             f"{burst['roundtrips']} round trips against "
                             f"{kern['roundtrips']} without bursts")
    for name in ("kernel", "burst"):
        r = results[name]
        if (r["launches"] != r["decode_launches_due"]
                or r["route_launches"]["simple"] != r["launches"]):
            raise AssertionError(
                f"identity_legacy {name}: {r['launches']} decode-kernel "
                f"launches, not (decode steps {r['decode_steps']} + burst "
                f"iterations {r['burst_iterations']}) x {layers} layers, or "
                f"not all on the simple route (fp32): "
                f"{r['route_launches']}")
    if plain["launches"]:
        raise AssertionError("identity_legacy: the plain run launched the "
                             "decode kernel")
    if kern["chunk_steps"] <= 0 or kern["prefix_hit_tokens"] <= 0:
        raise AssertionError("identity_legacy: the chunk family or the "
                             "prefix fork did not run")
    if any(len(t) != 16 or not all(0 <= x < model.config.vocab_size
                                   for x in t) for t in kern["tokens"]):
        raise AssertionError("identity_legacy: malformed token streams")
    agree = sum(a == b for ta, tb in zip(kern["tokens"], unified_tokens)
                for a, b in zip(ta, tb))
    emit("identity_legacy", layers=layers, dtype="float32",
         prefill_budget=budget, greedy_identical=True,
         burst_identical=True,
         tokens_agreeing_with_unified=agree,
         tokens_total=sum(map(len, unified_tokens)),
         **{name: {k: v for k, v in r.items() if k != "tokens"}
            for name, r in results.items()})


def serve_phase(torch, rp, serving, LlamaConfig, LlamaForCausalLM):
    cfg = LlamaConfig.llama3_8b()
    layers = cfg.num_hidden_layers
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(256, 2049))).tolist()
               for _ in range(16)]
    new_tokens = 64
    warm = [rng.integers(0, cfg.vocab_size, 48).tolist()]
    need = sum(-(-(len(p) + new_tokens) // 16) for p in prompts + warm) + 1
    llm = serving.LLM(model, config=serving.EngineConfig(
        num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
        unified_step=True,
        scheduler=serving.SchedulerConfig(max_num_seqs=16,
                                          max_tokens_per_step=512)))
    eng = llm.engine
    llm.generate(warm, serving.SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.ragged_launches
    hists = [eng.metrics.histogram(n) for n in ("time_to_first_token",
                                                 "inter_token_latency")]
    before = [(h.count, h.sum) for h in hists]
    rp.launches = rp.simple_launches = rp.tma_launches = 0
    t0 = time.perf_counter()
    outs = llm.generate(prompts, serving.SamplingParams(
        max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rp.launches
    routes = {"simple": rp.simple_launches, "tma": rp.tma_launches}
    steps = eng.ragged_launches - steps0
    if launches != steps * layers or routes["tma"] != launches:
        raise AssertionError(f"serve: {launches} kernel launches for "
                             f"{steps} steps x {layers} layers, by route "
                             f"{routes} (every one due on the tma route)")
    out_tokens = sum(len(o.token_ids) for o in outs)
    if out_tokens != 16 * new_tokens or not all(
            0 <= t < cfg.vocab_size for o in outs for t in o.token_ids):
        raise AssertionError("serve: malformed token streams")
    if eng.kv.occupancy() != 0.0:
        raise AssertionError("serve: the pool is not empty at the end")
    # means over this run's observations only (the warm-up's are excluded)
    ttft, itl = ((h.sum - s0) / (h.count - c0)
                 for h, (c0, s0) in zip(hists, before))
    emit("serve", model="llama3_8b", layers=layers, dtype="bfloat16",
         prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
         new_tokens_each=new_tokens, seconds=wall,
         output_tokens_per_s=out_tokens / wall,
         total_tokens_per_s=(out_tokens + sum(map(len, prompts))) / wall,
         mean_ttft_s=ttft, mean_itl_s=itl,
         engine_steps=steps, kernel_launches=launches,
         route_launches=routes,
         buckets=sorted({b for b in eng.ragged_buckets}),
         preemptions=eng.metrics.counters["preemptions"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         model_build_s=build_s, num_blocks=eng.num_blocks)
    return launches, llm, prompts, warm, new_tokens


def serve_legacy_phase(torch, pd, serving, model, prompts, warm,
                       new_tokens):
    """The serve model and prompts through the legacy LLM in bf16, without
    and with decode bursts of 8.  Returns the decode-kernel launches of the
    burst-free run and the two LLMs."""
    layers = model.config.num_hidden_layers
    need = sum(-(-(len(p) + new_tokens) // 16) for p in prompts + warm) + 1
    rows, llms = {}, {}
    for name, burst in (("legacy", 0), ("legacy_burst", 8)):
        kw = {}
        if burst:
            kw["config"] = serving.EngineConfig(
                num_blocks=need + 16, block_size=16, dtype=torch.bfloat16,
                burst_steps=burst,
                scheduler=serving.SchedulerConfig(max_num_seqs=16))
        llm = serving.LLM(model, num_blocks=need + 16, block_size=16,
                          dtype=torch.bfloat16, max_num_seqs=16, **kw)
        eng = llm.engine
        llm.generate(warm, serving.SamplingParams(max_new_tokens=2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = legacy_counts(eng)
        hists = [eng.metrics.histogram(n) for n in ("time_to_first_token",
                                                     "inter_token_latency")]
        seen = [(h.count, h.sum) for h in hists]
        families = {n: eng.metrics.histogram(n) for n in (
            "prefill_step", "decode_step", "burst_step")}
        fam_seen = {n: (h.count, h.sum) for n, h in families.items()}
        pd.launches = pd.simple_launches = pd.mma_launches = 0
        t0 = time.perf_counter()
        outs = llm.generate(prompts, serving.SamplingParams(
            max_new_tokens=new_tokens))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pd.launches
        routes = {"simple": pd.simple_launches, "mma": pd.mma_launches}
        after = legacy_counts(eng)
        steps = {k: after[k] - before[k] for k in after}
        if launches != steps["decode_launches_due"] or \
                routes["mma"] != launches:
            raise AssertionError(
                f"serve_legacy {name}: {launches} decode-kernel launches, "
                f"not (decode steps {steps['decode_steps']} + burst "
                f"iterations {steps['burst_iterations']}) x {layers} layers, "
                f"or not all on the mma route (bf16): {routes}")
        out_tokens = sum(len(o.token_ids) for o in outs)
        if out_tokens != len(prompts) * new_tokens or not all(
                0 <= t < model.config.vocab_size
                for o in outs for t in o.token_ids):
            raise AssertionError(f"serve_legacy {name}: malformed token "
                                 f"streams")
        if eng.kv.occupancy() != 0.0:
            raise AssertionError(f"serve_legacy {name}: the pool is not "
                                 f"empty at the end")
        if burst and steps["bursts"] == 0:
            raise AssertionError("serve_legacy: no burst launched")
        ttft, itl = ((h.sum - s0) / (h.count - c0)
                     for h, (c0, s0) in zip(hists, seen))
        # mean wall time of one launch of each family in this run (the
        # host's work included: each ends when its tokens reach the host)
        step_ms = {n: (h.sum - fam_seen[n][1]) / (h.count - fam_seen[n][0])
                   * 1e3 for n, h in families.items()
                   if h.count > fam_seen[n][0]}
        rows[name] = dict(
            mean_step_ms=step_ms,
            burst_steps=burst, seconds=wall,
            output_tokens_per_s=out_tokens / wall,
            total_tokens_per_s=(out_tokens + sum(map(len, prompts))) / wall,
            mean_ttft_s=ttft, mean_itl_s=itl, decode_kernel_launches=launches,
            route_launches=routes,
            tokens=[o.token_ids for o in outs],
            preemptions=eng.metrics.counters["preemptions"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            num_blocks=eng.num_blocks,
            buckets={"decode": sorted(eng.decode_buckets),
                     "prefill": sorted(eng.prefill_buckets),
                     "burst": sorted(eng.burst_buckets)}, **steps)
        llms[name] = llm
    legacy, bursty = rows["legacy"], rows["legacy_burst"]
    if not bursty["roundtrips"] < legacy["roundtrips"]:
        raise AssertionError("serve_legacy: bursts did not cut the host "
                             "round trips")
    agree = sum(a == b for ta, tb in zip(legacy.pop("tokens"),
                                         bursty.pop("tokens"))
                for a, b in zip(ta, tb))
    emit("serve_legacy", model="llama3_8b", layers=layers, dtype="bfloat16",
         prompts=len(prompts), prompt_tokens=sum(map(len, prompts)),
         new_tokens_each=new_tokens, burst_tokens_agreeing=agree, **rows)
    return legacy["decode_kernel_launches"], llms


def profile_phase(torch, serving, llm, vocab, window_name="unified",
                  label="ragged", marks=KERNEL_MARKS, new_tokens=8):
    """torch.profiler over a short window of a warm serve engine (4
    prompts of 1024 tokens, ``new_tokens`` new tokens each): device time by
    kernel and the shares of the attention kernel and of the matrix
    products.  The same window runs once without the profiler first; its
    wall time against the profiled device time gives the device's idle
    share (the profiler's own host cost would inflate it)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)

    def window():
        # fresh prompts each time: no prefix-cache hits
        prompts = [rng.integers(0, vocab, 1024).tolist() for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        llm.generate(prompts, serving.SamplingParams(
            max_new_tokens=new_tokens))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    wall_us = window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_us = window()
    kernels = device_kernels(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", window=window_name, new_tokens=new_tokens,
         window_wall_us=wall_us, profiled_wall_us=profiled_us,
         device_busy_us=busy, idle_share=(1 - busy / wall_us) if busy else None,
         **{f"{label}_kernel_share": share(kernels, marks)},
         matmul_share=share(kernels, MATMUL_MARKS),
         top_kernels=[{"name": k[:120], "us": us} for k, us in top])


def device_kernels(prof):
    """Device microseconds by kernel name in a profile.  Device rows only:
    an operator row also carries the device time of the kernels it
    launched, which would count them twice."""
    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
    return kernels


def share(kernels, marks):
    """The share of device time in kernels whose names hold a mark."""
    busy = sum(kernels.values())
    return (sum(us for k, us in kernels.items()
                if any(m in k.lower() for m in marks)) / busy
            if busy else None)


# --- training phases ----------------------------------------------------------

# (B, Sq, Sk, H, Hkv, D) of the flash checks at small shapes: those of
# tests/test_torch_flash_attention.py, on the card and against the Pallas
# kernels (ragged edges, one token, rectangular, GQA 8:1 / 4:1 / 2:1 / 1:1
# at head dims 64 and 128, S up to 512), the edges of the TMA kernels'
# 64- and 128-row tiles (S = 130 and 4000), and GQA 7:1 and 3:1, groups
# that fill 126 of a block's 128 rows
FLASH_TINY = [(1, 128, 128, 4, 1, 128), (2, 100, 100, 4, 2, 64),
              (1, 70, 70, 2, 2, 128), (1, 1, 1, 2, 1, 64),
              (2, 200, 200, 8, 2, 128), (1, 96, 160, 4, 2, 64),
              (1, 256, 256, 4, 1, 128), (2, 128, 128, 2, 2, 64),
              (1, 512, 512, 2, 1, 64), (1, 130, 130, 8, 1, 128),
              (1, 200, 200, 16, 2, 64), (1, 130, 130, 2, 2, 64),
              (1, 4000, 4000, 4, 1, 64), (1, 4000, 4000, 8, 2, 128),
              (1, 200, 200, 28, 4, 128), (1, 130, 130, 6, 2, 64)]
TRAIN_B, TRAIN_S = 2, 4096     # the train phase's batch and sequence


def flash_counts(flash):
    return {"fwd": flash.fwd_launches, "dq": flash.dq_launches,
            "dkv": flash.dkv_launches}


def reset_flash_counts(flash):
    flash.fwd_launches = flash.dq_launches = flash.dkv_launches = 0


def flash_work(q, k, causal):
    """Operations of each flash kernel on these shapes (an S x Sk x D
    product is 2·S·Sk·D per head, halved under the causal mask: forward 2,
    dQ 3, dK/dV 4 products) and the bytes each must move, each input read
    once and each output written once."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    unit = 2.0 * B * H * S * Sk * D * (0.5 if causal else 1.0)
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    stat = B * H * S * 4          # lse or delta, fp32
    return {"fwd": (2 * unit, 2 * qb + 2 * kb + stat),
            "dq": (3 * unit, 3 * qb + 2 * kb + 2 * stat),
            "dkv": (4 * unit, 2 * qb + 4 * kb + 2 * stat)}


def tensor_wide_err(got, want):
    """Max abs error over the twin's largest value, floored at 1: the
    measure these checks used before flash.rowwise_error, read beside it on
    the planted faults."""
    return (float((got.float() - want).abs().max())
            / max(float(want.abs().max()), 1.0))


def tail_zeroed(t, rows=64):
    """``t`` with its last tile of rows along dim 1 (queries or keys)
    zeroed: what a kernel that skipped its last tile would write."""
    t = t.clone()
    t[:, -rows:] = 0
    return t


def flash_check(torch, flash, label, q, k, v, do, causal, plant=False):
    """The three kernels in the order of a training step, each against its
    twin run in fp32 on the same inputs (the backward twins take the
    kernel's lse and delta), by flash.rowwise_error: each row of out, dQ,
    dK and dV is held to its own twin row, so that a wrong tail of a causal
    sequence, where the rows are small, shows.  With ``plant``, the measure
    is also read on each output with its last 64-row tile zeroed, and must
    fail there.  Returns a record of the errors (per row and absolute), the
    twin's largest value and smallest row, the planted reads, the
    tolerance, and the kernel's lse and delta; raises on a disagreement."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = flash.fwd_kernel(q, k, v, causal)
    delta = torch.einsum("bshd,bshd->bhs", do.float(),
                         out.float()).contiguous()
    dq = flash.bwd_dq_kernel(q, k, v, do, lse, delta, causal)
    dk, dv = flash.bwd_dkv_kernel(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, do)]
    rec = {"row": {}, "abs": {}, "twin_max": {}, "twin_least_row": {},
           "planted": {}}

    def hold(name, got, want):
        rec["row"][name] = flash.rowwise_error(got, want)
        rec["abs"][name] = float((got.float() - want).abs().max())
        rec["twin_max"][name] = float(want.abs().max())
        rec["twin_least_row"][name] = float(want.abs().amax(-1).min())
        if plant:
            bad = tail_zeroed(got)
            rec["planted"][name] = {
                "row": flash.rowwise_error(bad, want),
                "tensor_wide": tensor_wide_err(bad, want)}

    ref_out, ref_lse = flash.fwd_reference(*f32[:3], scale, causal)
    hold("out", out, ref_out)
    rec["lse"] = float((lse - ref_lse).abs().max())
    del ref_out, ref_lse
    hold("dq", dq, flash.bwd_dq_reference(*f32, lse, delta, scale, causal))
    ref_dk, ref_dv = flash.bwd_dkv_reference(*f32, lse, delta, scale, causal)
    hold("dk", dk, ref_dk)
    hold("dv", dv, ref_dv)
    del ref_dk, ref_dv, f32
    tol = 1e-4 if q.dtype == torch.float32 else 2e-2
    rec["tol"] = tol
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out, lse, dq, dk, dv))
    bad = {n: e for n, e in rec["row"].items() if not e <= tol}
    if not rec["lse"] <= 1e-4:
        bad["lse"] = rec["lse"]
    unseen = {n: r["row"] for n, r in rec["planted"].items()
              if not r["row"] > tol}
    if bad or not finite or unseen:
        raise AssertionError(f"flash kernels disagree with their twins on "
                             f"{label} {q.dtype}: {bad} (tol {tol}), "
                             f"finite={finite}; planted faults read within "
                             f"tolerance: {unseen}")
    return rec, lse, delta


def kernel_err(rec, kind, key):
    """A kernel's error from a flash_check record: out for the forward, dQ,
    and the larger of dK and dV."""
    names = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}[key]
    return max(rec[kind][n] for n in names)


def flash_library(torch, q, k, v, do):
    """The yardsticks, which the port never calls: scaled_dot_product_
    attention (causal, GQA) on [B, H, S, D] copies made beforehand, and the
    autograd backward of that call, which computes dQ, dK and dV in one."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    g = do.transpose(1, 2).contiguous()

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True)

    return fwd, bwd


def flash_copy_route_check(torch, flash, checks):
    """bf16 q, k, v and dO as views whose rows start off 16 bytes (rows D + 1
    apart), which TMA cannot read: the three wrappers must copy them to
    contiguous tensors first (route "copy", counted once a launch), hold the
    twins, and give what contiguous inputs give, bit for bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    B, S, H, Hkv, D = 2, 130, 8, 2, 128
    bufs = [torch.randn(B, S, n, D + 1, device=dev, generator=gen)
            .bfloat16() for n in (H, Hkv, Hkv, H)]
    views = [t[..., 1:] for t in bufs]
    copies = flash.copy_launches
    rec, _, _ = flash_check(torch, flash, "unaligned views", *views, True)
    routed = {"copies": flash.copy_launches - copies,
              "route": flash.last_route}
    checks.append({"case": "unaligned views (2, 130, 130, 8, 2, 128) "
                           "causal=True", "dtype": "bfloat16", **rec})
    outs = []
    for q, k, v, do in (views, [t.contiguous() for t in views]):
        out, lse = flash.fwd_kernel(q, k, v, True)
        delta = torch.einsum("bshd,bshd->bhs", do.float(),
                             out.float()).contiguous()
        outs.append((out, lse,
                     flash.bwd_dq_kernel(q, k, v, do, lse, delta, True),
                     *flash.bwd_dkv_kernel(q, k, v, do, lse, delta, True)))
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    if routed != {"copies": 3, "route": "copy"} or not same:
        raise AssertionError(f"flash copy route: {routed} (due 3 copies on "
                             f"route 'copy'), bit-equal to contiguous: "
                             f"{same}")
    return {**routed, "bit_equal_to_contiguous": same}


def flash_kernel_phase(torch, flash):
    """The three flash kernels against their twins at the CPU tests' shapes
    and at Llama-3-8B's training shape (H=32, Hkv=8, D=128, causal, B=2,
    S=4096), fp32 and bf16; at the training shape the kernel's CUDA-event
    and profiler device times, the twin's, the library's and the bound."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    checks = []

    def inputs(B, Sq, Sk, H, Hkv, D):
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                .to(dev) for s in ((B, Sq, H, D), (B, Sk, Hkv, D),
                                   (B, Sk, Hkv, D), (B, Sq, H, D))]

    for case in FLASH_TINY:
        q32, k32, v32, do32 = inputs(*case)
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                rec, _, _ = flash_check(
                    torch, flash, f"tiny {case} causal={causal}",
                    *(t.to(dtype) for t in (q32, k32, v32, do32)), causal)
                checks.append({"case": f"tiny {case} causal={causal}",
                               "dtype": str(dtype).split(".")[-1], **rec})

    copy_route = flash_copy_route_check(torch, flash, checks)

    B, S, H, Hkv, D = TRAIN_B, TRAIN_S, 32, 8, 128
    q32, k32, v32, do32 = inputs(B, S, S, H, Hkv, D)
    timings, summary = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, do = (t.to(dtype) for t in (q32, k32, v32, do32))
        # the planted faults: each output with its last tile zeroed must
        # fail the check at the shape where rows are smallest
        rec, lse, delta = flash_check(torch, flash, "8b train shape",
                                      q, k, v, do, True, plant=True)
        checks.append({"case": "8b train shape", "dtype": name, **rec})
        scale = 1.0 / np.sqrt(D)
        kernels = {
            "fwd": lambda: flash.fwd_kernel(q, k, v, True),
            "dq": lambda: flash.bwd_dq_kernel(q, k, v, do, lse, delta, True),
            "dkv": lambda: flash.bwd_dkv_kernel(q, k, v, do, lse, delta,
                                                True)}
        plains = {
            "fwd": lambda: flash.fwd_reference(q, k, v, scale, True),
            "dq": lambda: flash.bwd_dq_reference(q, k, v, do, lse, delta,
                                                 scale, True),
            "dkv": lambda: flash.bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   scale, True)}
        lib_fwd, lib_bwd = flash_library(torch, q, k, v, do)
        # the yardstick computes this function: its output against the
        # twin's (its gradients are the pair's yardstick, checked loosely:
        # it rounds elsewhere than the kernels do)
        ref_out, _ = flash.fwd_reference(*(t.float() for t in (q, k, v)),
                                         scale, True)
        lib_err = float((lib_fwd().transpose(1, 2).float() - ref_out)
                        .abs().max())
        del ref_out
        lib_grads = lib_bwd()
        ref_dk, ref_dv = flash.bwd_dkv_reference(
            *(t.float() for t in (q, k, v, do)), lse, delta, scale, True)
        lib_grad_err = max(tensor_wide_err(lib_grads[1].transpose(1, 2),
                                           ref_dk),
                           tensor_wide_err(lib_grads[2].transpose(1, 2),
                                           ref_dv))
        del ref_dk, ref_dv, lib_grads
        if not (lib_err <= 2e-2 and lib_grad_err <= 5e-2):
            raise AssertionError(f"the library yardstick computes another "
                                 f"function: forward err {lib_err}, "
                                 f"gradient err {lib_grad_err}")
        library = {"fwd": time_ms(lib_fwd, 5), "dq": time_ms(lib_bwd, 5)}
        library["dkv"] = library["dq"]
        for key, (flops, nbytes) in flash_work(q, k, True).items():
            t_flops = flops / PEAK_FLOPS[name] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            ms = time_ms(kernels[key], 5)
            row = {
                "kernel": key, "dtype": name, "B": B, "S": S, "H": H,
                "Hkv": Hkv, "D": D, "causal": True,
                "max_abs_err": kernel_err(rec, "abs", key),
                "max_row_err": kernel_err(rec, "row", key),
                "ms": ms, "tflops": flops / ms / 1e9,
                "plain_ms": time_ms(plains[key], 2, 1),
                "library_ms": library[key],
                "library_max_abs_err": lib_err if key == "fwd"
                else lib_grad_err,
                "bound_ms": max(t_flops, t_bytes),
                "bound_by": "operations" if t_flops > t_bytes else "bytes",
                "bound_share": max(t_flops, t_bytes) / ms,
                "flops": flops, "bytes": nbytes,
            }
            timings.append(row)
            if dtype == torch.bfloat16:
                summary[key] = row     # the train phase's shape and type
            torch.cuda.empty_cache()
        del q, k, v, do, lse, delta, kernels, plains, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    worst = max(checks, key=lambda c: max(max(c["row"].values()) / c["tol"],
                                          c["lse"] / 1e-4))
    emit("flash_kernels", name=FLASH_NAME, checks=len(checks), worst=worst,
         train_shape=[c for c in checks if c["planted"]], timings=timings,
         copy_route=copy_route,
         note="max_row_err is flash.rowwise_error (each row over its twin "
              "row's max, floored at 1e-2 of the twin's max and at 0.1); "
              "planted: the "
              "same outputs with their last 64-row tile zeroed, read by it "
              "and by the tensor-wide measure (error over the twin's max, "
              "floored at 1); library_ms of dq and dkv is one autograd "
              "backward of scaled_dot_product_attention, which computes "
              "both; library_max_abs_err of dq/dkv is tensor-wide")
    return summary


def corpus(rng, B, S):
    """examples/pretrain_llama.py's synthetic corpus: shifted arithmetic
    sequences mod 17, token ids [B, S]."""
    start = rng.integers(0, 17, (B, 1))
    return (start + np.arange(S)) % 17


def train_steps(model, criterion, opt, batches, sched=None):
    """``model(ids) -> criterion -> backward -> step -> clear_grad`` for
    each batch; the losses stay on the device, read after the run."""
    losses = []
    for ids in batches:
        loss = criterion(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        losses.append(loss.detach())
    return losses


def train_identity_phase(torch, flash, fa, port):
    """Llama-3-8B widths cut to 2 layers, fp32, B=1, S=1024: 4 AdamW steps
    with the kernels and 4 with ``use_flash_attention=False`` (the composite
    paths), from the same seeded weights and batches.  The losses agree
    within 1e-4 relative and each kernel launched steps x layers times."""
    layers, S, steps = 2, 1024, 4
    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(corpus(rng, 1, S)).cuda()
               for _ in range(steps)]
    runs = {}
    for use_flash in (True, False):
        cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=layers,
                                         use_flash_attention=use_flash)
        gen = torch.Generator(device="cuda").manual_seed(3)
        model = port.LlamaForCausalLM(cfg, device="cuda",
                                      dtype=torch.float32, generator=gen)
        opt = port.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                         weight_decay=0.01)
        reset_flash_counts(flash)
        t0 = time.perf_counter()
        losses = train_steps(model, port.LlamaPretrainingCriterion(cfg), opt,
                             batches)
        torch.cuda.synchronize()
        runs[use_flash] = {"losses": [float(x) for x in losses],
                           "launches": flash_counts(flash),
                           "path": fa.last_path,
                           "seconds": time.perf_counter() - t0}
        del model, opt, losses
        gc.collect()
        torch.cuda.empty_cache()
    kern, plain = runs[True], runs[False]
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(kern["losses"], plain["losses"]))
    if not (np.isfinite(kern["losses"]).all() and rel <= 1e-4):
        raise AssertionError(f"train_identity: kernel losses "
                             f"{kern['losses']} against composite "
                             f"{plain['losses']} (rel {rel})")
    due = {k: steps * layers for k in FLASH_MARKS}
    if (kern["launches"] != due or any(plain["launches"].values())
            or kern["path"] != "cuda"):
        raise AssertionError(f"train_identity: launches {kern['launches']} "
                             f"(due {due}), composite run "
                             f"{plain['launches']}, path {kern['path']}")
    emit("train_identity", layers=layers, dtype="float32", batch=1, seq=S,
         steps=steps, max_rel_loss_diff=rel, kernel=kern, composite=plain)


def train_phase(torch, flash, fa, port):
    """The main path: Llama-3-8B at full width cut to 4 layers, bf16
    parameters, AdamW with fp32 master weights under a cosine schedule, B=2
    and S=4096 on the synthetic corpus; 2 warm-up steps, then 8 timed."""
    layers, warm, timed = 4, 2, 8
    B, S = TRAIN_B, TRAIN_S
    cfg = port.LlamaConfig.llama3_8b(num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(4)
    t0 = time.perf_counter()
    model = port.LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                                  generator=gen)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    criterion = port.LlamaPretrainingCriterion(cfg)
    sched = port.CosineAnnealingDecay(1e-4, T_max=10)
    opt = port.AdamW(learning_rate=sched, parameters=model.parameters(),
                     weight_decay=0.01, multi_precision=True)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(corpus(rng, B, S)).cuda()
               for _ in range(warm + timed)]
    reset_flash_counts(flash)
    losses = train_steps(model, criterion, opt, batches[:warm], sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += train_steps(model, criterion, opt, batches[warm:], sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_counts(flash)
    losses = [float(x) for x in losses]
    due = {k: (warm + timed) * layers for k in FLASH_MARKS}
    if launches != due or fa.last_path != "cuda":
        raise AssertionError(f"train: kernel launches {launches}, due {due} "
                             f"(path {fa.last_path})")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses {losses} are not finite or do "
                             f"not fall")
    n_params = sum(p.numel() for p in model.parameters())
    # PaLM's count, as bench.py's train_flops_per_token: 6N + 12·L·S·hidden
    attn_flops = 12.0 * layers * S * cfg.hidden_size
    flops_per_token = 6.0 * n_params + attn_flops
    # N holds the input embedding, a lookup with no product (27% of N at 4
    # layers): the count without it says how much that flatters the MFU
    lookup = (model.llama.embed_tokens.weight.numel()
              if model.lm_head is not None else 0)
    tokens_per_s = B * S * timed / wall
    emit("train", model="llama3_8b", layers=layers, dtype="bfloat16",
         batch=B, seq=S, warmup_steps=warm, timed_steps=timed,
         losses=losses, ms_per_step=wall / timed * 1e3,
         tokens_per_s=tokens_per_s, params=n_params,
         flops_per_token=flops_per_token,
         mfu=flops_per_token * tokens_per_s / PEAK_FLOPS["bfloat16"],
         embedding_params=lookup,
         mfu_without_embedding=(6.0 * (n_params - lookup) + attn_flops)
         * tokens_per_s / PEAK_FLOPS["bfloat16"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         kernel_launches=launches, model_build_s=build_s)
    return launches, (model, criterion, opt, sched)


def train_profile_phase(torch, trainer, steps=2):
    """torch.profiler over 2 train steps: the device-time share of each
    flash kernel and its device time a launch, the matrix products' share,
    the top kernels, and the idle share against the wall time of 2
    unprofiled steps."""
    from torch.profiler import ProfilerActivity, profile

    model, criterion, opt, sched = trainer
    rng = np.random.default_rng(9)
    batches = [torch.from_numpy(corpus(rng, TRAIN_B, TRAIN_S)).cuda()
               for _ in range(2 * steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_steps(model, criterion, opt, batches[:steps], sched)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    before = gpu_sample()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train_steps(model, criterion, opt, batches[steps:], sched)
        torch.cuda.synchronize()
    emit("train_clocks", before=before, after=gpu_sample(),
         note="nvidia-smi before and after the profiled window")
    kernels = device_kernels(prof)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    flash_shares = {key: share(kernels, marks)
                    for key, marks in FLASH_MARKS.items()}
    # each flash kernel launches once a layer a step
    launches = steps * model.config.num_hidden_layers
    flash_device_ms = {key: busy * s / launches / 1e3 if s else None
                       for key, s in flash_shares.items()}
    emit("train_profile", steps=steps, window_wall_us=wall_us,
         device_busy_us=busy, idle_share=(1 - busy / wall_us) if busy else None,
         flash_shares=flash_shares, flash_device_ms=flash_device_ms,
         flash_share=sum(v or 0.0 for v in flash_shares.values()),
         matmul_share=share(kernels, MATMUL_MARKS),
         top_kernels=[{"name": k[:120], "us": us} for k, us in top])
    return flash_device_ms


# --- custom-op phase ----------------------------------------------------------

# tests/test_custom_op.py's host ops, built by cpp_extension.load
RELU6_SOURCE = """
#include <cstdint>
extern "C" void my_relu6(const float* x, float* y, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        float v = x[i] < 0.f ? 0.f : x[i];
        y[i] = v > 6.f ? 6.f : v;
    }
}
extern "C" void my_relu6_grad(const float* x, const float* gy, float* gx,
                              int64_t n) {
    for (int64_t i = 0; i < n; ++i)
        gx[i] = (x[i] > 0.f && x[i] < 6.f) ? gy[i] : 0.f;
}
"""
# a Llama-3-8B activation at the train phase's B=2, S=4096: [B*S, hidden]
SCALED_SHAPE = (TRAIN_B * TRAIN_S, 4096)


def scaled_sweep(torch, sc):
    """The kernel against its twin, bit for bit (torch.equal), over fp32,
    bf16 and fp16, alpha in {2, 3, 0.1, -3.5}, 1 to 1,000,003 elements,
    each aligned and as a view at storage offset 3 (not 16-byte aligned:
    the scalar path); then one planted fault, the twin with its last
    element changed, which the same check must refuse."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    checks, worst = 0, 0.0

    def same(out, ref):
        return out.shape == ref.shape and out.dtype == ref.dtype and \
            torch.equal(out, ref)

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for alpha in (2.0, 3.0, 0.1, -3.5):
            for n in (1, 7, 4097, 1_000_003):
                base = torch.randn(n + 3, device=dev, generator=gen).to(dtype)
                for label, x in (("aligned", base[:n]), ("offset 3", base[3:])):
                    if (label == "offset 3") != bool(x.data_ptr() % 16):
                        raise AssertionError(f"custom_op: the {label} view "
                                             f"has the wrong alignment")
                    out = sc.scaled_kernel(x, alpha)
                    torch.cuda.synchronize()
                    ref = sc.scaled_reference(x, alpha)
                    worst = max(worst, float((out.float() - ref.float())
                                             .abs().max()))
                    if not same(out, ref):
                        raise AssertionError(
                            f"scaled kernel differs from its twin: {dtype}, "
                            f"alpha={alpha}, n={n}, {label}")
                    checks += 1
    x = torch.randn(4097, device=dev, generator=gen).bfloat16()
    out = sc.scaled_kernel(x, 0.1)
    planted = sc.scaled_reference(x, 0.1)
    planted[-1] = planted[-1] * 2 + 1
    if same(out, planted):
        raise AssertionError("custom_op: the planted fault passed the check")
    return checks, worst


def spread(values):
    """Median, 10th and 90th percentiles and extremes of ``values``."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return {"n": int(v.size), "median": float(np.median(v)),
            "p10": float(np.percentile(v, 10)),
            "p90": float(np.percentile(v, 90)),
            "min": float(v[0]), "max": float(v[-1])}


def interleaved_times(torch, fns, rounds, calls):
    """The functions of ``fns`` ({name: (fn, kernel mark)}) timed in turns
    on one card, the order reversed every round (A B, B A, ...).  By CUDA
    events: ``calls`` back-to-back calls of each a turn, ms a call.  By the
    profiler, in a second pass of the same turns: each launch's device time
    in the kernels whose names hold the function's mark.  Returns each
    name's :func:`spread` by both clocks; raises when the profiler records
    no launch of one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = list(fns)
    for name in names:
        fns[name][0]()
    torch.cuda.synchronize()
    events = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[name][0]()
            end.record()
            end.synchronize()
            events[name].append(start.elapsed_time(end) / calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for r in range(rounds):
            for name in names if r % 2 == 0 else names[::-1]:
                for _ in range(calls):
                    fns[name][0]()
        torch.cuda.synchronize()
    device = {name: [] for name in names}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in names:
            if fns[name][1] in e.name:
                device[name].append(e.time_range.elapsed_us() / 1e3)
    if not all(device.values()):
        raise AssertionError(f"interleaved timing: the profiler recorded "
                             f"{ {n: len(v) for n, v in device.items()} } "
                             f"launches")
    return {name: {"event_ms": spread(events[name]),
                   "device_ms": spread(device[name])} for name in names}


def custom_op_phase(torch, sc, cpp_extension, build_dir):
    """The custom-op path: the sweep, then the JAX docstring example as a
    user imports it, ``ops/scaled.py::my_scaled`` (``register_custom_op(
    scaled, name="my_scaled", vjp=(scaled_fwd, scaled_bwd),
    nondiff_argnames=("alpha",))``), called on a [8192, 4096] bf16 tensor on
    the card three times with its backward (launches counted from 0 over
    those calls), one call under torch.profiler, times at that shape (CUDA
    events and profiler device time, for the kernel and for torch.mul),
    and a g++ host op on a CUDA tensor."""
    import os

    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    checks, sweep_err = scaled_sweep(torch, sc)

    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(SCALED_SHAPE, device=dev, generator=gen) \
        .bfloat16().requires_grad_()
    calls = 3
    sc.launches = 0
    for _ in range(calls):
        y = sc.my_scaled(x, alpha=3.0)
        y.sum().backward()
    torch.cuda.synchronize()
    launches = sc.launches
    if launches != calls or sc.last_path != "cuda":
        raise AssertionError(f"custom_op: {launches} launches for {calls} "
                             f"calls (path {sc.last_path})")
    # the gradient of 3 calls, accumulated: 9 everywhere (exact in bf16),
    # which only 3 runs of the custom bwd (g * 3 each) give
    if not (torch.equal(x.grad, torch.full_like(x, 9.0))
            and torch.equal(y, sc.scaled_reference(x.detach(), 3.0))):
        raise AssertionError("custom_op: wrong output or gradient")
    x = x.detach()
    del y

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sc.my_scaled(x, alpha=3.0)
        torch.cuda.synchronize()
    kernel_names = [k for k in device_kernels(prof) if "scaled_kernel" in k]

    def subtree(e):
        return [e] + [d for c in e.cpu_children for d in subtree(c)]

    # kernels launched inside the my_scaled range: those the profiler
    # attached to it or to an op under it, and the device events whose
    # correlation id is that of a runtime call under it (cudaLaunchKernel)
    from torch.autograd import DeviceType

    inside = [d for e in prof.events() if e.name == "my_scaled"
              for d in subtree(e)]
    ids = {d.id for d in inside}
    under = [k.name for d in inside for k in d.kernels] + [
        e.name for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.id in ids]
    if not kernel_names or not set(kernel_names) & set(under):
        raise AssertionError(f"custom_op: the profile shows kernels "
                             f"{kernel_names}, and under my_scaled {under}")

    alpha = 3.0   # exact in bf16, so torch.mul computes the same function
    library = torch.mul(x, alpha)
    if not torch.equal(library, sc.scaled_kernel(x, alpha)):
        raise AssertionError("custom_op: torch.mul computes another function")
    del library
    nbytes = 2 * x.numel() * x.element_size()
    # one fp32 multiply an element, on the CUDA cores
    t_flops = x.numel() / PEAK_FLOPS["float32"] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    timing = {
        "shape": list(SCALED_SHAPE), "dtype": "bfloat16", "alpha": alpha,
        "max_abs_err": sweep_err,
        # CUDA events of back-to-back calls (the host's issue included)
        "ms": time_ms(lambda: sc.scaled_kernel(x, alpha), 50),
        "op_ms": time_ms(lambda: sc.my_scaled(x, alpha=alpha), 50),
        "plain_ms": time_ms(lambda: sc.scaled_reference(x, alpha), 20),
        "library_ms": time_ms(lambda: torch.mul(x, alpha), 50),
        # profiler device time a launch, the same for both
        "device_ms": device_ms(lambda: sc.scaled_kernel(x, alpha), 20,
                               ("scaled_kernel",)),
        "library_device_ms": device_ms(lambda: torch.mul(x, alpha), 20,
                                       ("elementwise_kernel",)),
        "bound_ms": max(t_flops, t_bytes),
        "bound_by": "operations" if t_flops > t_bytes else "bytes",
        "flops": float(x.numel()), "bytes": nbytes,
        # the kernel and torch.mul in turns, each call by both clocks
        "interleaved": interleaved_times(torch, {
            "kernel": (lambda: sc.scaled_kernel(x, alpha), "scaled_kernel"),
            "torch_mul": (lambda: torch.mul(x, alpha), "elementwise_kernel"),
        }, rounds=40, calls=5),
    }

    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "my_relu6.cc")
    with open(src, "w") as f:
        f.write(RELU6_SOURCE)
    ext = cpp_extension.load(name="my_relu6", sources=[src],
                             build_directory=build_dir)
    xh = torch.randn(4096, generator=torch.Generator().manual_seed(13)) * 5
    xd = xh.to(dev).requires_grad_()
    yd = ext.my_relu6(xd)
    yd.sum().backward()
    host_ok = (yd.device.type == "cuda" and xd.grad.device.type == "cuda"
               and torch.equal(yd.cpu(), ext.my_relu6(xh))
               and torch.equal(xd.grad.cpu(), ((xh > 0) & (xh < 6)).float()))
    if not host_ok:
        raise AssertionError("custom_op: the host op on a CUDA tensor gave "
                             "another result than on the CPU")
    emit("custom_op", name="scaled", sweep_checks=checks,
         sweep_bit_exact=True, planted_fault_caught=True, calls=calls,
         kernel_launches=launches, grad=9.0,
         profile_kernels=kernel_names, under_my_scaled=sorted(set(under)),
         host_op={"device": "cuda", "equal_to_cpu": True, "grad_ok": True},
         timing=timing)
    return launches, timing


def main() -> int:
    try:
        import torch

        from paddle_tpu_torch import serving
        from paddle_tpu_torch.models import (
            LlamaConfig,
            LlamaForCausalLM,
            LlamaPretrainingCriterion,
        )
        from paddle_tpu_torch.ops import _build, flash
        from paddle_tpu_torch.ops import flash_attention as fa
        from paddle_tpu_torch.ops import paged_decode as pd
        from paddle_tpu_torch.ops import ragged_paged as rp
        from paddle_tpu_torch.ops import scaled as sc
        from paddle_tpu_torch.optimizer import AdamW
        from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay
        from paddle_tpu_torch.utils import cpp_extension
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is not here ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    # the plain versions are references: full fp32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = [KERNEL_NAME, DECODE_NAME, FLASH_NAME, SCALED_NAME]
    _build.build(built)
    for name, log in _build.build_logs.items():
        print(f"--- nvcc {name} ---\n{log}", file=sys.stderr)
    emit("build", kernels=built, seconds=time.perf_counter() - t0)

    scaled_launches, scaled_summary = custom_op_phase(
        torch, sc, cpp_extension,
        str(_build.BUILD_DIR / "extensions"))

    summary = kernel_phase(torch, rp, flash)
    decode_summary = decode_kernel_phase(torch, pd, flash)
    model, prompts, unified_tokens = identity_phase(
        torch, rp, serving, LlamaConfig, LlamaForCausalLM)
    identity_legacy_phase(torch, pd, serving, model, prompts, unified_tokens)
    del model
    torch.cuda.empty_cache()
    launches, llm, prompts, warm, new_tokens = serve_phase(
        torch, rp, serving, LlamaConfig, LlamaForCausalLM)
    model = llm.engine.model
    vocab = model.config.vocab_size
    profile_phase(torch, serving, llm, vocab)
    del llm   # frees the unified engine's pools; the model stays
    torch.cuda.empty_cache()
    decode_launches, llms = serve_legacy_phase(torch, pd, serving, model,
                                               prompts, warm, new_tokens)
    for name in llms:
        profile_phase(torch, serving, llms[name], vocab, window_name=name,
                      label="decode", marks=DECODE_MARKS, new_tokens=32)
    del llms, model
    gc.collect()
    torch.cuda.empty_cache()

    flash_summary = flash_kernel_phase(torch, flash)
    port = SimpleNamespace(
        LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
        LlamaPretrainingCriterion=LlamaPretrainingCriterion, AdamW=AdamW,
        CosineAnnealingDecay=CosineAnnealingDecay)
    train_identity_phase(torch, flash, fa, port)
    train_launches, trainer = train_phase(torch, flash, fa, port)
    # the flash kernels' device time a launch, read by the profiler inside
    # a training step (a back-to-back window of the flash phase recorded
    # no flash kernel: PERF.md section 7)
    flash_device = train_profile_phase(torch, trainer)
    flash_rows = [{
        "name": f"flash_attention_{key}", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"paddle_tpu/ops/pallas_flash.py:{line}",
        "launches": train_launches[key], "device_ms": flash_device[key],
        **{f: flash_summary[key][f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}}
        for key, line in (("fwd", 52), ("dq", 153), ("dkv", 195))]

    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/ragged_paged.py:111",
        "launches": launches, "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"], "device_ms": summary["device_ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"], "bound_by": summary["bound_by"],
        "library_ms": summary["library_ms"]}, {
        "name": DECODE_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "paddle_tpu/ops/pallas_paged.py:45",
        "launches": decode_launches,
        "max_abs_err": decode_summary["max_abs_err"],
        "ms": decode_summary["ms"], "device_ms": decode_summary["device_ms"],
        "plain_ms": decode_summary["plain_ms"],
        "bound_ms": decode_summary["bound_ms"],
        "bound_by": decode_summary["bound_by"],
        "library_ms": decode_summary["library_ms"]}, *flash_rows, {
        "name": SCALED_NAME, "route": "cuda",
        "source": "paddle_tpu_torch/csrc/scaled.cu",
        "replaces": "paddle_tpu/utils/extension.py:18",
        "launches": scaled_launches,
        **{f: scaled_summary[f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms")}}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
