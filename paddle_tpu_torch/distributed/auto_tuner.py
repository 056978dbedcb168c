"""The training FLOP count of ``paddle_tpu/distributed/auto_tuner.py``,
the port's own copy: ``train_flops_per_token``, the one MFU denominator
shared by the train-step telemetry and ``chip_smoke.py``.  The auto-tuner
itself (its search and cost model) waits for ROADMAP A11."""

from __future__ import annotations


def train_flops_per_token(n_params: float, num_layers: int = 0,
                          seq_len: int = 0, hidden: int = 0) -> float:
    """PaLM-style training FLOPs per token: ``6N`` for the parameter ops
    (fwd 2N + bwd 4N) plus ``12·L·S·H`` for the attention score/context
    matmuls when the geometry is given."""
    return 6.0 * n_params + 12.0 * num_layers * seq_len * hidden
