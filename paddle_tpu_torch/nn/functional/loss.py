"""Loss functions: the port of ``paddle_tpu/nn/functional/loss.py::
cross_entropy``.

Plain torch ops (XLA code in the JAX package).  Dtypes follow the JAX
function: ``log_softmax`` runs in the logits' dtype (bf16 logits give a
bf16 loss), the hard-label mean divides by the count of labels that are not
``ignore_index``, and a weighted mean divides by the summed weights.
"""

from __future__ import annotations

import torch


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over ``axis``.

    Hard labels (integer class ids, or a float ``[..., 1]`` tensor cast to
    ids) skip ``ignore_index``; soft labels (``soft_label=True``, or float
    labels shaped like ``input``) are class distributions.  ``weight`` is a
    per-class weight; ``label_smoothing`` mixes in the uniform
    distribution; ``reduction`` is ``"mean"``, ``"sum"`` or ``"none"``."""
    logits = input
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-30))
    ax = axis % logits.dim()
    is_soft = soft_label or (label.is_floating_point()
                             and label.dim() == logits.dim()
                             and label.shape[ax] == logits.shape[ax]
                             and label.shape[ax] != 1)
    if is_soft:
        soft = label
        if label_smoothing > 0:
            k = logits.shape[ax]
            soft = soft * (1 - label_smoothing) + label_smoothing / k
        loss = -torch.sum(soft * logp, dim=ax)
        if weight is not None:
            # per-sample weight = expected class weight under the soft label
            wt = torch.sum(soft * weight, dim=ax)
            loss = loss * wt
            if reduction == "mean":
                return torch.sum(loss) / torch.clamp(torch.sum(wt), min=1e-12)
        return _reduce(loss, reduction)

    lab = label.to(torch.int32)
    if lab.dim() == logits.dim():
        lab = lab.squeeze(ax)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, ax, safe.long().unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0:
        smooth_loss = -torch.mean(logp, dim=ax)
        loss = -(1 - label_smoothing) * picked + label_smoothing * smooth_loss
    else:
        loss = -picked
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if weight is not None:
        wt = weight[safe.long()]
        wt = torch.where(valid, wt, torch.zeros_like(wt))
        loss = loss * wt
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(torch.sum(wt), min=1e-12)
    elif reduction == "mean":
        denom = torch.clamp(torch.sum(valid.to(loss.dtype)), min=1.0)
        return torch.sum(loss) / denom
    return _reduce(loss, reduction)
