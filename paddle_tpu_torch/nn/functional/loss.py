"""Loss functions: the port of ``paddle_tpu/nn/functional/loss.py``.

Plain torch ops (XLA code in the JAX package), each the JAX function's
formula in its order of operations.  Dtypes follow the JAX functions:
``cross_entropy``'s ``log_softmax`` runs in the logits' dtype (bf16 logits
give a bf16 loss; under ``amp.auto_cast`` it is on the black list, so
nothing is cast), the hard-label mean divides by the count of labels that
are not ``ignore_index``, and a weighted mean divides by the summed
weights.

Three reach past plain elementwise code: ``ctc_loss`` is
``torch.nn.functional.ctc_loss`` on the log-softmax of its input (the JAX
package's ``optax.ctc_loss`` normalises its input the same way);
``rnnt_loss`` is the JAX function's alpha recursion over the (T, U)
lattice, step by step; ``class_center_sample`` draws its negatives from
``generator`` (torch's default generator when None), so which negatives
differ from the JAX package's draw, not the rule.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.dispatch import op


def _reduce(v, reduction):
    if reduction == "mean":
        return torch.mean(v)
    if reduction == "sum":
        return torch.sum(v)
    return v


@op("cross_entropy")
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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def base_softmax_with_cross_entropy(logits, label, soft_label=False,
                                    ignore_index=-100,
                                    numeric_stable_mode=True,
                                    return_softmax=False, axis=-1):
    return softmax_with_cross_entropy(
        logits, label, soft_label=soft_label, ignore_index=ignore_index,
        return_softmax=return_softmax, axis=axis)


@op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    lab = label.to(torch.int64)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    if input.dim() == lab.dim() + 1:
        # the class axis is 1 ([N, C] and spatial [N, C, d1, ...])
        picked = torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    else:
        picked = torch.gather(input, 0, safe)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if weight is not None:
        wt = weight[safe] * valid.to(input.dtype)
        loss = loss * wt
        if reduction == "mean":
            return torch.sum(loss) / torch.clamp(torch.sum(wt), min=1e-12)
    return _reduce(loss, reduction)


@op("mse_loss")
def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


@op("l1_loss")
def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


@op("smooth_l1_loss")
def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = torch.abs(input - label)
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss * delta, reduction)


@op("huber_loss")
def huber_loss(input, label, delta=1.0, reduction="mean", name=None):
    d = torch.abs(input - label)
    return _reduce(torch.where(d <= delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


@op("binary_cross_entropy")
def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p = torch.clamp(input, 1e-12, 1 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op("bce_with_logits")
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z = logit
    max_val = torch.clamp(-z, min=0)
    soft = torch.log(torch.exp(-max_val) + torch.exp(-z - max_val))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * z + log_w * (soft + max_val)
    else:
        loss = (1 - label) * z + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


@op("kl_div")
def kl_div(input, label, reduction="mean", log_target=False, name=None):
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


@op("margin_ranking_loss")
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0),
                   reduction)


@op("hinge_embedding_loss")
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0))
    return _reduce(loss, reduction)


@op("cosine_embedding_loss")
def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = torch.sum(input1 * input2, -1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin, min=0))
    return _reduce(loss, reduction)


def _p_dist(a, b, p, epsilon):
    return torch.sum(torch.abs(a - b + epsilon) ** p, -1) ** (1 / p)


@op("triplet_margin_loss")
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = _p_dist(input, positive, p, epsilon)
    dn = _p_dist(input, negative, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _p_dist(positive, negative, p, epsilon))
    return _reduce(torch.clamp(dp - dn + margin, min=0), reduction)


@op("multi_label_soft_margin_loss")
def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    loss = -(label * TF.logsigmoid(input)
             + (1 - label) * TF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(torch.mean(loss, -1), reduction)


@op("soft_margin_loss")
def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


@op("square_error_cost")
def square_error_cost(input, label):
    return (input - label) ** 2


@op("log_loss")
def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


@op("sigmoid_focal_loss")
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z = logit
    p = torch.sigmoid(z)
    ce = ((1 - label) * z + torch.clamp(-z, min=0)
          + torch.log(torch.exp(-torch.abs(z)) + 1))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


@op("ctc_loss")
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over ``log_probs`` ``[T, B, K]`` (normalised by a log-softmax
    first) and padded ``labels`` ``[B, L]``; ``"mean"`` divides each
    sequence's loss by its label length, then averages."""
    lp = torch.log_softmax(log_probs, dim=-1)
    per_seq = TF.ctc_loss(lp, labels.to(torch.int64),
                          input_lengths.to(torch.int64),
                          label_lengths.to(torch.int64), blank=blank,
                          reduction="none")
    if reduction == "mean":
        return torch.mean(per_seq / label_lengths.to(per_seq.dtype))
    if reduction == "sum":
        return torch.sum(per_seq)
    return per_seq


@op("poisson_nll_loss")
def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = (label * torch.log(label + epsilon) - label
                    + 0.5 * torch.log(2 * np.pi * (label + epsilon)))
        loss = loss + torch.where(label > 1, stirling,
                                  torch.zeros_like(stirling))
    return _reduce(loss, reduction)


@op("gaussian_nll_loss")
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    loss = 0.5 * (torch.log(var) + (label - input) ** 2 / var)
    if full:
        loss = loss + 0.5 * np.log(2 * np.pi)
    return _reduce(loss, reduction)


@op("dice_loss")
def dice_loss(input, label, epsilon=1e-5, name=None):
    lab_oh = TF.one_hot(label.squeeze(-1).to(torch.int64),
                        input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = torch.sum(input * lab_oh, dim=dims)
    union = torch.sum(input, dim=dims) + torch.sum(lab_oh, dim=dims)
    return torch.mean(1 - (2 * inter + epsilon) / (union + epsilon))


@op("npair_loss")
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    eq = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    target = eq / torch.sum(eq, dim=1, keepdim=True)
    xent = -torch.sum(target * torch.log_softmax(sim, dim=1), dim=1)
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, 1))
                    + torch.mean(torch.sum(positive * positive, 1))) * 0.25
    return torch.mean(xent) + reg


@op("multi_margin_loss")
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean", name=None):
    """``mean_j max(0, margin - x_y + x_j)^p`` over ``j != y``."""
    C = input.shape[1]
    y = label.reshape(-1).to(torch.int64)
    xy = torch.gather(input, 1, y[:, None])
    hinge = torch.clamp(margin - xy + input, min=0.0)
    if p != 1:
        hinge = hinge ** p
    if weight is not None:
        w = torch.as_tensor(weight, device=input.device)
        hinge = hinge * w[y][:, None]
    hinge = hinge * (1 - TF.one_hot(y, C).to(input.dtype))
    per = torch.sum(hinge, 1) / C
    return _reduce(per, reduction)


@op("triplet_margin_with_distance_loss")
def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    def pairwise_l2(u, v):
        return torch.sqrt(torch.sum((u - v) ** 2, -1))

    dist = distance_function or pairwise_l2
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


@op("margin_cross_entropy")
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean", name=None):
    """The ArcFace family's combined margin: the target logit ``cos t``
    becomes ``cos(m1 t + m2) - m3``, then every logit is scaled (one
    group: the class dim is not split)."""
    x = logits
    y = label.reshape(-1).to(torch.int64)
    cos_t = torch.clamp(torch.gather(x, 1, y[:, None]), -1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos_t) + margin2) - margin3
    onehot = TF.one_hot(y, x.shape[1]).to(x.dtype)
    logp = torch.log_softmax((x * (1 - onehot) + target * onehot) * scale,
                             -1)
    per = -torch.gather(logp, 1, y[:, None])[:, 0]
    if reduction == "mean":
        loss = torch.mean(per)
    elif reduction == "sum":
        loss = torch.sum(per)
    else:
        loss = per[:, None]
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def _default_tree(C):
    """The complete binary tree over ``C`` classes (0-based heap: internal
    nodes ``0 .. C-2``, leaves ``C-1 .. 2C-2``): each class's path of
    internal nodes from the root, the branch bit at each, and which of the
    ``ceil(log2 C)`` levels the path uses."""
    D = max(1, int(np.ceil(np.log2(max(C, 2)))))
    table = np.zeros((C, D), np.int64)
    code = np.zeros((C, D), np.float32)
    lens = np.zeros((C,), np.int64)
    for c in range(C):
        node, path = c + C - 1, []
        while node > 0:
            parent = (node - 1) // 2
            path.append((parent, float(node == 2 * parent + 2)))
            node = parent
        path.reverse()
        lens[c] = len(path)
        for d, (nid, bit) in enumerate(path[:D]):
            table[c, d] = nid
            code[c, d] = bit
    return table, code, np.arange(D)[None, :] < lens[:, None]


@op("hsigmoid_loss")
def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid: the mean over the batch of ``sum over the
    path of softplus(z) - code * z``, ``z = w_node . x + b_node``, on the
    default complete binary tree or a custom ``path_table`` /
    ``path_code``; returns shape ``[1]``."""
    dev = input.device
    if path_table is None:
        table, code, valid = _default_tree(num_classes)
    else:
        table = np.asarray(torch.as_tensor(path_table).cpu())
        code = np.asarray(torch.as_tensor(path_code).cpu(), np.float32)
        valid = np.ones(table.shape, bool)
    y = label.reshape(-1).to(torch.int64).cpu()
    nodes = torch.as_tensor(table, device=dev)[y.to(dev)]
    codes = torch.as_tensor(code, device=dev)[y.to(dev)].to(input.dtype)
    vmask = torch.as_tensor(valid, device=dev)[y.to(dev)]
    z = torch.einsum("bdf,bf->bd", weight[nodes], input)
    if bias is not None:
        z = z + bias[nodes].reshape(z.shape)
    per = torch.sum(torch.where(vmask, TF.softplus(z) - codes * z,
                                torch.zeros_like(z)), -1)
    return torch.mean(per)[None]


@op("rnnt_loss")
def rnnt_loss(input, label, input_lengths, label_lengths, blank=0,
              fastemit_lambda=0.0, reduction="mean", name=None):
    """RNN-Transducer loss over logits ``[B, T, U + 1, V]``: the JAX
    function's log-domain alpha recursion, a row of the lattice a time
    step and a prefix along U.  A nonzero ``fastemit_lambda`` raises, as
    in the JAX package."""
    if fastemit_lambda:
        raise NotImplementedError(
            "fastemit_lambda != 0 is not supported; pass 0.0 (the warprnnt "
            "FastEmit gradient scaling is not implemented)")
    B, T, U1, _ = input.shape
    U = U1 - 1
    logp = torch.log_softmax(input, -1)
    lab = label.to(torch.int64)
    blank_lp = logp[..., blank]                                # [B, T, U1]
    emit_lp = torch.gather(logp[:, :, :U, :], -1,
                           lab[:, None, :, None].expand(B, T, U, 1))[..., 0]
    tin = torch.as_tensor(input_lengths, device=input.device).to(torch.int64)
    uin = torch.as_tensor(label_lengths, device=input.device).to(torch.int64)
    cols = [torch.zeros(B, dtype=torch.float32, device=input.device)]
    for u in range(1, U1):
        cols.append(cols[-1] + emit_lp[:, 0, u - 1])
    alpha = torch.stack(cols, 1)
    alpha = torch.where(torch.arange(U1, device=input.device)[None, :]
                        <= uin[:, None], alpha, torch.full_like(alpha, -1e30))
    for t in range(1, T):
        horiz = alpha + blank_lp[:, t - 1, :]
        cols = [horiz[:, 0]]
        for u in range(1, U1):
            cols.append(torch.logaddexp(horiz[:, u],
                                        cols[-1] + emit_lp[:, t, u - 1]))
        alpha = torch.where((t < tin)[:, None], torch.stack(cols, 1), alpha)
    idx_t = torch.clamp(tin - 1, 0, T - 1)
    final_alpha = torch.gather(alpha, 1, uin[:, None])[:, 0]
    final_blank = blank_lp[torch.arange(B, device=input.device), idx_t, uin]
    nll = -(final_alpha + final_blank)
    return _reduce(nll, reduction)


def class_center_sample(label, num_classes, num_samples, group=None,
                        generator=None):
    """Partial-FC sampling: every positive class kept (even past
    ``num_samples``), then random negatives up to ``num_samples``; returns
    ``(label remapped into the sorted sample, the sorted sample)`` as int64
    tensors on the label's device."""
    y = label.reshape(-1).to(torch.int64).cpu()
    pos = torch.unique(y)
    need = max(0, num_samples - len(pos))
    keep = torch.ones(num_classes, dtype=torch.bool)
    keep[pos] = False
    rest = torch.nonzero(keep)[:, 0]
    if need > 0 and len(rest) > 0:
        perm = torch.randperm(len(rest), generator=generator)[:need]
        sampled = torch.cat([pos, rest[perm]])
    else:
        sampled = pos
    sampled = torch.sort(sampled).values
    remap = torch.full((num_classes,), -1, dtype=torch.int64)
    remap[sampled] = torch.arange(len(sampled))
    return remap[y].to(label.device), sampled.to(label.device)
