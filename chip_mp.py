#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s three tensor-parallel phases alone on the card.

From the root of a checkout on a machine with CUDA cards and ``nvcc``::

    python3 chip_mp.py

It builds the flash kernels, takes the ``train`` phase's first loss
(``chip_smoke.train_first_loss``: the seed-4 Llama-3-8B-width model at 4
layers, bf16, at mp=1, on the first batch of its corpus, before any
update), then calls ``chip_smoke.mp_phases``: the flash kernels at a rank's
shapes, then ``mp_collectives``, ``mp_identity`` and ``mp_train`` in rank
processes started by the port's ``spawn``, two over gloo on one card or
four at dp2 x mp2 over NCCL where four cards are present.  It prints the
card line, the phase lines and the phases' seconds, and exits nonzero when
a phase fails.

``python3 chip_mp.py --fleet`` runs ``chip_smoke``'s tensor-parallel
serving phases alone, on one card: it builds B1, B2 and the flash kernels
(B1 and B2 also in a kernel directory for the worker processes), takes
the mp=1 identity
references (``identity_phase``, ``identity_legacy_phase``), then runs
``mp_serve_phases`` (``mp_serve_shape``, ``mp_serve_identity``,
``mp_serve``, ``mp_fleet_identity``, ``mp_disagg_identity``,
``mp_server``) and ``mp_procfleet``, and prints their lines and seconds.

``python3 chip_mp.py --serve`` runs ``chip_smoke``'s ``mp_serve`` instead,
at full depth (32 layers) over NCCL with a card a rank (two cards at
least): it builds B1 and B2, starts 2 ranks through the port's ``spawn``,
each runs ``chip_smoke.mp_serve_rank`` on the serve phase's 16 prompts of
256-2048 tokens (64 greedy tokens each), and prints one ``mp_serve_nccl``
line: tokens/s, mean TTFT and ITL, each rank's peak memory, launches and
collectives, the collectives' share of a synchronised window.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

import chip_smoke as cs

SERVE_LAYERS = 32    # the serve phase's depth


def serve_rank_main(spec):
    """One NCCL rank of ``--serve``: ``chip_smoke.mp_serve_rank`` at full
    depth; rank 0 writes both ranks' rows to ``{out}/rank{r}.json``."""
    import torch

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.distributed import collective, topology
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import paged_decode as pd
    from paddle_tpu_torch.ops import ragged_paged as rp

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env()
    rank = dist.get_rank()
    topology.init_mesh(mp=cs.MP_DEGREE)
    port = SimpleNamespace(serving=serving, LlamaConfig=LlamaConfig,
                           LlamaForCausalLM=LlamaForCausalLM)
    row, _ = cs.mp_serve_rank(torch, port, rp, pd, collective, spec, rank,
                              layers=SERVE_LAYERS)
    row.update(backend=dist.get_backend(),
               device=str(dist.env.rank_device()))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(row, f)
    dist.destroy_process_group()


def serve_main(torch) -> int:
    """``--serve``: mp_serve at full depth over NCCL, a card a rank."""
    from paddle_tpu_torch.distributed.spawn import spawn
    from paddle_tpu_torch.ops import _build

    if torch.cuda.device_count() < cs.MP_DEGREE:
        print("chip_mp --serve: NCCL needs a card a rank", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build([cs.KERNEL_NAME, cs.DECODE_NAME])
    cs.emit("build", kernels=[cs.KERNEL_NAME, cs.DECODE_NAME],
            seconds=time.perf_counter() - t0)
    rng = np.random.default_rng(2)     # the serve phase's prompts
    prompts = [rng.integers(0, 128256, int(rng.integers(256, 2049)))
               .tolist() for _ in range(16)]
    out = tempfile.mkdtemp(prefix="mp_serve_nccl_")
    try:
        t0 = time.perf_counter()
        spawn(serve_rank_main, args=({"out": out, "serve_prompts": prompts},),
              nprocs=cs.MP_DEGREE, backend="nccl", pg_timeout=300,
              timeout=1200)
        ranks = [json.load(open(os.path.join(out, f"rank{r}.json")))
                 for r in range(cs.MP_DEGREE)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    r0 = ranks[0]
    cs.emit("mp_serve_nccl", model="llama3_8b", layers=SERVE_LAYERS,
            dtype="bfloat16", backend=r0["backend"],
            devices=[r["device"] for r in ranks], prompts=len(prompts),
            prompt_tokens=sum(map(len, prompts)), new_tokens_each=64,
            **{k: r0[k] for k in ("seconds", "output_tokens_per_s",
                                  "mean_ttft_s", "mean_itl_s",
                                  "unified_step_mean_ms", "steps")},
            peak_memory_bytes=[r["peak_memory_bytes"] for r in ranks],
            share_window=[r["share_window"] for r in ranks],
            rules=[r["rule"] for r in ranks],
            legacy_burst8=[r["legacy_burst8"]["rule"] for r in ranks],
            spawn_s=time.perf_counter() - t0)
    return 0


def fleet_main(torch) -> int:
    """``--fleet``: the tensor-parallel serving phases, dp x mp included,
    on one card."""
    import subprocess

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import _build, flash
    from paddle_tpu_torch.ops import paged_decode as pd
    from paddle_tpu_torch.ops import ragged_paged as rp
    from paddle_tpu_torch.serving import graphs

    t0 = time.perf_counter()
    # B1 and B2 for the workers' directory; here the flash kernels too
    # (the mp=1 reference model's dense-cache forward)
    kernels = [cs.KERNEL_NAME, cs.DECODE_NAME]
    cache = tempfile.mkdtemp(prefix="procfleet_kernels_")
    workers = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from paddle_tpu_torch.ops import _build; "
         "_build.set_build_dir(sys.argv[1]); _build.build(sys.argv[2:])",
         cache, *kernels])
    _build.build(kernels + [cs.FLASH_NAME])
    if workers.wait(timeout=900):
        return 1
    cs.emit("build", kernels=kernels, seconds=time.perf_counter() - t0)
    try:
        model, prompts, tokens, buckets = cs.identity_phase(
            torch, rp, serving, graphs, LlamaConfig, LlamaForCausalLM)
        ref = cs.identity_legacy_phase(torch, pd, serving, graphs, model,
                                       prompts, tokens)
        ref.update(unified=(tokens, sorted(buckets)),
                   identity_prompts=prompts)
        del model
        cs.free(torch)
        _, ref["serve_prompts"] = cs.serve_prompts(128256)
        t0 = time.perf_counter()
        cs.mp_serve_phases(torch, rp, pd, flash, ref)
        t1 = time.perf_counter()
        cs.mp_procfleet_phase(torch, serving, ref["serve_prompts"], cache)
        cs.emit("budget", mp_serve_s=t1 - t0,
                mp_procfleet_s=time.perf_counter() - t1)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return 0


def main() -> int:
    import torch

    from paddle_tpu_torch.models import (
        LlamaConfig,
        LlamaForCausalLM,
        LlamaPretrainingCriterion,
    )
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.ops import _build, flash
    from paddle_tpu_torch.optimizer import AdamW

    if not torch.cuda.is_available():
        print("chip_mp: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    if sys.argv[1:] == ["--serve"]:
        return serve_main(torch)
    if sys.argv[1:] == ["--fleet"]:
        return fleet_main(torch)
    t0 = time.perf_counter()
    _build.build([cs.FLASH_NAME])
    cs.emit("build", kernels=[cs.FLASH_NAME],
            seconds=time.perf_counter() - t0)
    port = SimpleNamespace(
        LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
        LlamaPretrainingCriterion=LlamaPretrainingCriterion, AdamW=AdamW,
        ClipGradByGlobalNorm=ClipGradByGlobalNorm)
    loss0 = cs.train_first_loss(torch, port)
    t0 = time.perf_counter()
    cs.mp_phases(torch, flash, port, loss0)
    cs.emit("budget", train_first_loss=loss0,
            mp_phases_s=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
