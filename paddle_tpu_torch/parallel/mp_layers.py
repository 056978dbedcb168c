"""The tensor-parallel (Megatron) layers: the port of
``paddle_tpu/parallel/mp_layers.py``.

Parameter names match the JAX package's (``weight``, ``bias``) so state
dicts map one to one, but the layout is PyTorch's: a linear weight is
``[out, in]`` here and ``[in, out]`` there (``convert.py`` transposes).
Parameters are created uninitialised on ``device``; the model initialises
them (:meth:`init_normal_` draws the full tensor and keeps the rank's
slice, so every mp degree starts from the same weights).

At mp=1 (no topology, or an mp group of one) each layer is the plain
layer.  At mp > 1 each rank holds its slice over the mp group and issues
by hand the collectives GSPMD inserts for the JAX layers (the reference
Paddle's ``mp_ops``), as autograd functions:

* ``c_identity``: identity forward, all-reduce of the gradient backward
  (the input of a column-parallel layer);
* ``mp_allreduce``: all-reduce forward, identity backward (the output of
  a row-parallel layer, of the vocab-parallel lookup);
* ``c_concat``: all-gather along the last dim forward, the rank's slice
  of the gradient backward (``gather_output``);
* ``c_split``: the rank's slice of the last dim forward, all-gather of the
  gradient backward (a row-parallel layer's full-width input).

Layouts at mp > 1: ``ColumnParallelLinear`` holds ``[out/mp, in]`` and
its bias ``[out/mp]``; ``RowParallelLinear`` ``[out, in/mp]`` and the full
bias, added after the reduce; ``VocabParallelEmbedding`` the rows
``[rank*V/mp, (rank+1)*V/mp)``.  ``ParallelCrossEntropy`` takes
vocab-sliced logits: the softmax's max and sum are all-reduced over the
group, and so is the target logit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dispatch import run_op
from ..distributed import collective
from ..nn.functional.common import embedding
from ..nn.functional.loss import cross_entropy
from .utils import axis_group, full_shape, is_sharded, local_shard, \
    mark_sharded, param_shard


def _mp_group(mp_group) -> collective.Group:
    return mp_group if mp_group is not None else axis_group("mp")


def _gather_last(x, group):
    parts = []
    collective.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _slice_last(x, group):
    return local_shard(x, x.dim() - 1, group.rank, group.nranks).contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective.all_reduced(g, ctx.group), None


class _MpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective.all_reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CConcat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _slice_last(g, ctx.group), None


class _CSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _slice_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


def c_identity(x, group):
    return _CIdentity.apply(x, group) if group.nranks > 1 else x


def mp_allreduce(x, group):
    return _MpAllReduce.apply(x, group) if group.nranks > 1 else x


def c_concat(x, group):
    return _CConcat.apply(x, group) if group.nranks > 1 else x


def c_split(x, group):
    return _CSplit.apply(x, group) if group.nranks > 1 else x


def parallel_matmul(x, weight, group):
    """``x @ weight.T`` with ``weight`` this rank's vocab rows (a tied LM
    head over a vocab-parallel embedding): the rank's logits, gathered
    over ``group``."""
    return c_concat(c_identity(x, group) @ weight.T, group)


class _MpLayer(nn.Module):
    def init_normal_(self, std: float, generator=None):
        """Draw the full weight from N(0, std) with ``generator`` and keep
        this rank's slice (at mp=1, the weight itself)."""
        w = self.weight
        with torch.no_grad():
            if not is_sharded(w):
                w.normal_(0.0, std, generator=generator)
                return
            full = torch.empty(full_shape(w), device=w.device, dtype=w.dtype)
            full.normal_(0.0, std, generator=generator)
            w.copy_(param_shard(w, full))
            del full


class VocabParallelEmbedding(_MpLayer):
    """Token embedding, ``weight`` ``[num_embeddings/mp, embedding_dim]``:
    ids outside the rank's rows look up zeros, and the ranks' lookups are
    all-reduced."""

    def __init__(self, num_embeddings, embedding_dim, device=None,
                 dtype=None, mp_group=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.group = _mp_group(mp_group)
        mp = self.group.nranks
        if num_embeddings % mp:
            raise ValueError(f"num_embeddings {num_embeddings} is not "
                             f"divisible by the mp degree {mp}")
        self.per_rank = num_embeddings // mp
        self.vocab_start = self.group.rank * self.per_rank if mp > 1 else 0
        self.weight = nn.Parameter(torch.empty(
            self.per_rank, embedding_dim, device=device, dtype=dtype))
        if mp > 1:
            mark_sharded(self.weight, 0, self.group)

    def forward(self, x):
        if self.group.nranks == 1:
            return embedding(x, self.weight)
        local = x - self.vocab_start
        outside = (local < 0) | (local >= self.per_rank)
        out = embedding(torch.where(outside, torch.zeros_like(local), local),
                        self.weight)
        out = torch.where(outside[..., None], torch.zeros_like(out), out)
        return mp_allreduce(out, self.group)


class ColumnParallelLinear(_MpLayer):
    """``x @ W.T + b`` with the output features split over the mp group.
    ``gather_output=False`` leaves the activation sliced on its last dim
    (the column-to-row pairing); ``fused_blocks=k`` splits each of ``k``
    equal output blocks over the ranks (a fused QKV projection is 3)."""

    def __init__(self, in_features, out_features, has_bias=True, device=None,
                 dtype=None, gather_output=True, mp_group=None,
                 fused_blocks: int = 1):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.group = _mp_group(mp_group)
        mp = self.group.nranks
        if out_features % (mp * fused_blocks):
            raise ValueError(f"out_features {out_features} is not divisible "
                             f"by the mp degree {mp}"
                             + (f" in {fused_blocks} blocks"
                                if fused_blocks > 1 else ""))
        out_local = out_features // mp
        self.weight = nn.Parameter(torch.empty(
            out_local, in_features, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_local, device=device,
                                              dtype=dtype))
                     if has_bias else None)
        if mp > 1:
            mark_sharded(self.weight, 0, self.group, fused_blocks)
            if self.bias is not None:
                mark_sharded(self.bias, 0, self.group, fused_blocks)

    def forward(self, x):
        if self.group.nranks == 1:
            return run_op("linear", F.linear, x, self.weight, self.bias)
        out = run_op("linear", F.linear, c_identity(x, self.group),
                     self.weight, self.bias)
        return c_concat(out, self.group) if self.gather_output else out


class RowParallelLinear(_MpLayer):
    """``x @ W.T + b`` with the input features split over the mp group:
    the ranks' partial products are all-reduced, then the (whole) bias is
    added.  ``input_is_parallel=False`` slices a full-width input first."""

    def __init__(self, in_features, out_features, has_bias=True, device=None,
                 dtype=None, input_is_parallel=False, mp_group=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self.group = _mp_group(mp_group)
        mp = self.group.nranks
        if in_features % mp:
            raise ValueError(f"in_features {in_features} is not divisible by "
                             f"the mp degree {mp}")
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features // mp, device=device, dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if has_bias else None)
        if mp > 1:
            mark_sharded(self.weight, 1, self.group)

    def forward(self, x):
        if self.group.nranks == 1:
            return run_op("linear", F.linear, x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = c_split(x, self.group)
        out = mp_allreduce(run_op("linear", F.linear, x, self.weight),
                           self.group)
        return out if self.bias is None else out + self.bias


class _ParallelCE(torch.autograd.Function):
    """Per-token cross-entropy over vocab-sliced logits ``[N, V/mp]``."""

    @staticmethod
    def forward(ctx, logits, labels, start, group, ignore_index):
        x = logits.float()
        m = x.max(dim=-1).values
        collective.all_reduce(m, collective.ReduceOp.MAX, group=group)
        x = x - m[:, None]
        e = torch.exp(x)
        s = e.sum(dim=-1)
        collective.all_reduce(s, group=group)
        local = labels - start
        valid = labels != ignore_index
        here = valid & (local >= 0) & (local < x.shape[-1])
        idx = torch.where(here, local, torch.zeros_like(local))
        target = torch.where(here, x.gather(-1, idx[:, None])[:, 0],
                             torch.zeros_like(m))
        collective.all_reduce(target, group=group)
        loss = torch.where(valid, torch.log(s) - target, torch.zeros_like(s))
        ctx.save_for_backward(e / s[:, None], idx, here, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, idx, here, valid = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, idx[:, None], -here.float()[:, None])
        grad = grad * (g * valid.float())[:, None]
        return grad.to(ctx.dtype), None, None, None, None


class ParallelCrossEntropy(nn.Module):
    """Softmax cross-entropy, the mean over the tokens whose label is not
    ``ignore_index`` (the JAX layer's ``F.cross_entropy(reduction="mean")``).
    At mp > 1 the logits are this rank's vocab slice (a column-parallel
    head with ``gather_output=False``) and the labels are global ids."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.group = _mp_group(mp_group)

    def forward(self, logits, labels):
        if self.group.nranks == 1:
            return cross_entropy(logits, labels, reduction="mean",
                                 ignore_index=self.ignore_index)
        lab = labels.long()
        if lab.dim() == logits.dim():
            lab = lab.squeeze(-1)
        flat = logits.reshape(-1, logits.shape[-1])
        lab = lab.reshape(-1)
        start = self.group.rank * flat.shape[-1]
        loss = _ParallelCE.apply(flat, lab, start, self.group,
                                 self.ignore_index)
        count = torch.clamp((lab != self.ignore_index).sum(), min=1)
        return (loss.sum() / count).to(logits.dtype)
