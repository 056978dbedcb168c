"""The part of ``paddle_tpu/observability/audit.py`` the unified step
returns: :func:`logit_stats`.  The numerics auditor itself is ROADMAP A8."""

from __future__ import annotations

import torch


def logit_stats(logits):
    """Per-row logit reductions: ``[rows, 3]`` float32 of (non-finite
    count, max |logit|, argmax margin = top1 - top2).  Non-finite entries
    are masked to 0 before the max/top-k so absmax/margin stay finite; the
    non-finite count carries the alarm.  A 1-D ``[vocab]`` row is one
    row."""
    l = logits.to(torch.float32)
    if l.dim() == 1:
        l = l[None, :]
    finite = torch.isfinite(l)
    nonfinite = torch.sum(~finite, dim=-1).to(torch.float32)
    safe = torch.where(finite, l, torch.zeros_like(l))
    absmax = torch.amax(torch.abs(safe), dim=-1)
    top2 = torch.topk(safe, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    return torch.stack([nonfinite, absmax, margin], dim=-1)
