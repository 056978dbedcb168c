"""Helpers of the hybrid-parallel layer: the port of
``paddle_tpu/parallel/utils.py``.

The JAX helpers steer GSPMD: a parameter carries a ``PartitionSpec`` and
``sharding_constraint`` pins an activation's layout, and XLA moves only
each device's shard.  With one process a rank there is no global array to
constrain; what each rank needs is its own slice of a parameter and the
group of an axis, so those are the helpers here:

* :func:`axis_size`, :func:`axis_rank`, :func:`axis_group` read the hybrid
  topology (``distributed/topology.py``): degree 1, rank 0 and a group of
  one without one;
* :func:`local_shard` cuts a rank's slice out of a full tensor (torch or
  numpy) along one dimension, in ``blocks`` equal blocks each split over
  the ranks (a fused QKV weight is three blocks: each rank takes its heads
  of Q, of K and of V);
* :func:`mark_sharded` records on a parameter how it was cut
  (``split_axis``, ``split_blocks``, ``mp_group``; :func:`is_sharded`
  reads it), so the clipping, the converters and the initialisers can find
  its full shape and its group.  (Paddle's flag is ``is_distributed``;
  torch tensors have a method of that name.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributed import collective, topology


def axis_size(axis: str) -> int:
    """The degree of the hybrid topology's ``axis`` (1 without one)."""
    hcg = topology.get_hybrid_communicate_group()
    return 1 if hcg is None else hcg.topology()[axis]


def axis_rank(axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a topology)."""
    hcg = topology.get_hybrid_communicate_group()
    return 0 if hcg is None else hcg.axis_rank(axis)


def axis_group(axis: str) -> collective.Group:
    """This rank's group along ``axis`` (a group of one without a
    topology)."""
    hcg = topology.get_hybrid_communicate_group()
    if hcg is None:
        return collective.Group([collective.env.get_rank()], None)
    return hcg.axis_group(axis)


def local_shard(full, dim: int, rank: int, degree: int, blocks: int = 1):
    """Rank ``rank``'s slice of ``full`` (a torch tensor or numpy array)
    along ``dim`` over ``degree`` ranks: ``full`` is cut into ``blocks``
    equal blocks along ``dim``, each block into ``degree`` equal parts, and
    the rank's part of every block is concatenated in block order."""
    if degree == 1:
        return full
    n = full.shape[dim]
    if n % (blocks * degree):
        raise ValueError(f"dimension {dim} of size {n} does not split into "
                         f"{blocks} block(s) over {degree} ranks")
    step = n // blocks
    part = step // degree
    index = [slice(None)] * full.ndim
    parts = []
    for b in range(blocks):
        lo = b * step + rank * part
        index[dim] = slice(lo, lo + part)
        parts.append(full[tuple(index)])
    if isinstance(full, torch.Tensor):
        return parts[0] if blocks == 1 else torch.cat(parts, dim)
    return parts[0] if blocks == 1 else np.concatenate(parts, dim)


def mark_sharded(param, dim: int, group: collective.Group, blocks: int = 1):
    """Record that ``param`` is this rank's slice along ``dim`` over
    ``group`` (:func:`local_shard`'s cut)."""
    param.split_axis = dim
    param.split_blocks = blocks
    param.mp_group = group
    return param


def is_sharded(param) -> bool:
    """Whether ``param`` is a rank's slice (:func:`mark_sharded`)."""
    return getattr(param, "mp_group", None) is not None


def full_shape(param):
    """The shape of the parameter ``param`` is a slice of."""
    shape = list(param.shape)
    if is_sharded(param):
        shape[param.split_axis] *= param.mp_group.nranks
    return tuple(shape)


def param_shard(param, full):
    """``param``'s slice of ``full``, a tensor or array of
    :func:`full_shape` in ``param``'s layout."""
    if not is_sharded(param):
        return full
    g = param.mp_group
    return local_shard(full, param.split_axis, g.rank, g.nranks,
                       param.split_blocks)
