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
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import chip_smoke as cs


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
