#!/usr/bin/env python3
"""Compare the serving and training paths of two checkouts of the port on
one NVIDIA GPU, in one call, so that both run on the same card.

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR]

``CHANGE_DIR`` defaults to this script's directory.  Each run is a process
of its own that puts one checkout first on the path, builds its kernels
and runs that checkout's own ``chip_smoke.py`` phases:

``decode_kernels``             the paged decode kernel at the CPU tests'
                               buckets and Llama-3-8B's decode shapes, with
                               its times;
``serve`` + ``profile``        Llama-3-8B at full width and depth, bf16, 16
                               prompts of 256-2048 tokens through the
                               unified ragged step, then a profiled window;
``serve_legacy`` + ``profile`` the same model and prompts through the legacy
                               families, without and with decode bursts of
                               8, then a profiled window of each;
``train`` + ``train_profile``  the training step at 8B width cut to 4
                               layers, B=2, S=4096, then a profiled window.

The runs go parent, change, change, parent, so that a drift of the card
over the call shows as a difference between the two runs of one checkout.
Every JSON line of a run is printed with ``checkout`` and ``run`` fields
added; the last line is a summary of each run's output tokens/s, serve
seconds, idle shares, the decode kernel's device ms at B=16 bf16, the
legacy path's tokens/s, idle and decode-kernel shares, ms a train step and
MFU.  Exits nonzero when a run fails or there is no CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = r"""
import gc, inspect, json, os, sys
from types import SimpleNamespace
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     LlamaPretrainingCriterion)
from paddle_tpu_torch.ops import _build, flash
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_decode as pd
from paddle_tpu_torch.ops import ragged_paged as rp
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import CosineAnnealingDecay

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["ragged_paged_attention", "paged_decode_attention",
              "flash_attention"])
# a checkout's own phase: (torch, pd) before the row check took flash
decode_args = (torch, pd, flash)[:len(inspect.signature(
    cs.decode_kernel_phase).parameters)]
cs.decode_kernel_phase(*decode_args)
_, llm, prompts, warm, new_tokens = cs.serve_phase(
    torch, rp, serving, LlamaConfig, LlamaForCausalLM)
model = llm.engine.model
vocab = model.config.vocab_size
cs.profile_phase(torch, serving, llm, vocab)
del llm
torch.cuda.empty_cache()
_, llms = cs.serve_legacy_phase(torch, pd, serving, model, prompts, warm,
                                new_tokens)
for name in llms:
    cs.profile_phase(torch, serving, llms[name], vocab, window_name=name,
                     label="decode", marks=cs.DECODE_MARKS, new_tokens=32)
del llms, model
gc.collect()
torch.cuda.empty_cache()
port = SimpleNamespace(
    LlamaConfig=LlamaConfig, LlamaForCausalLM=LlamaForCausalLM,
    LlamaPretrainingCriterion=LlamaPretrainingCriterion, AdamW=AdamW,
    CosineAnnealingDecay=CosineAnnealingDecay)
_, trainer = cs.train_phase(torch, flash, fa, port)
cs.train_profile_phase(torch, trainer)
"""


def run(checkout: str, label: str, index: int) -> dict:
    """One run of the child in ``checkout``; returns its phases by name."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=checkout,
                          capture_output=True, text=True, timeout=1500)
    phases = {}
    for line in proc.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict) and "phase" in rec:
            rec.update(checkout=label, run=index)
            key = rec["phase"]
            if key == "profile":   # one a window: unified, legacy, ...
                key = f"profile:{rec['window']}"
            phases[key] = rec
            print(json.dumps(rec), flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit(f"chip_ab: the {label} run {index} failed "
                         f"(exit {proc.returncode})")
    return phases


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    dirs = {"parent": os.path.abspath(sys.argv[1]),
            "change": os.path.abspath(sys.argv[2] if len(sys.argv) == 3
                                      else here)}
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(json.dumps({"phase": "device", "nvidia_smi": smi}), flush=True)
    summary = []
    for i, label in enumerate(("parent", "change", "change", "parent")):
        p = run(dirs[label], label, i)
        decode_b16 = next(t for t in p["decode_kernels"]["timings"]
                          if t["B"] == 16 and t["dtype"] == "bfloat16")
        legacy = p["serve_legacy"]
        summary.append({
            "checkout": label, "run": i,
            "output_tokens_per_s": p["serve"]["output_tokens_per_s"],
            "serve_s": p["serve"]["seconds"],
            "mean_itl_s": p["serve"]["mean_itl_s"],
            "serve_idle_share": p["profile:unified"]["idle_share"],
            "ragged_share": p["profile:unified"]["ragged_kernel_share"],
            "decode_b16_device_ms": decode_b16["device_ms"],
            "decode_b16_ms": decode_b16["ms"],
            "legacy_tokens_per_s": legacy["legacy"]["output_tokens_per_s"],
            "legacy_burst_tokens_per_s":
                legacy["legacy_burst"]["output_tokens_per_s"],
            "legacy_idle_share": p["profile:legacy"]["idle_share"],
            "legacy_decode_share": p["profile:legacy"]["decode_kernel_share"],
            "legacy_burst_idle_share":
                p["profile:legacy_burst"]["idle_share"],
            "train_ms_per_step": p["train"]["ms_per_step"],
            "mfu": p["train"]["mfu"],
            "train_idle_share": p["train_profile"]["idle_share"],
            "dq_device_ms": p["train_profile"]["flash_device_ms"]["dq"]})
    print(json.dumps({"summary": summary, "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
