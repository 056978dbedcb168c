"""Data parallelism: ``paddle.DataParallel``, the port of
``paddle_tpu/distributed/parallel.py``.

In the JAX package the batch is sharded over the mesh's dp axis and the
gradient all-reduce is the ``psum`` GSPMD puts under the loss.  Here each
dp rank runs the whole model on its part of the batch, and torch's
``DistributedDataParallel`` reducer all-reduces the gradients over the dp
group's process group during the backward, as the reference's
``EagerReducer`` does:

* at construction the parameters and buffers are broadcast from the
  group's first rank, so every rank starts from the same weights;
* the gradients go in buckets of about ``comm_buffer_size`` MB, each
  bucket's all-reduce started when the backward has produced its last
  gradient; the all-reduce is this package's ``collective.all_reduce`` (a
  communication hook), so its calls and bytes count in
  ``collective.stats``;
* each ``.grad`` receives the mean over the group;
* inside ``no_sync()`` gradients only accumulate; the next backward
  outside it all-reduces what they accumulated to.

The mean makes a dp step's gradient the gradient of the mean loss over the
global batch when each rank's loss is the mean over an equal share, the
JAX package's gradient; ``scale_loss`` returns the loss as it is.  torch's
reducer gives the first bucket the cap of the others, so
``last_comm_buffer_size`` is accepted for Paddle's signature only.  As in
Paddle, every parameter must receive a gradient in every backward unless
``find_unused_parameters`` is set.
"""

from __future__ import annotations

import contextlib

from torch import nn
from torch.nn.parallel import DistributedDataParallel

from . import collective, topology


def _dp_group():
    hcg = topology.get_hybrid_communicate_group()
    return (hcg.get_data_parallel_group() if hcg is not None
            else collective.world_group())


def _mean_hook(group, bucket):
    """DDP's communication hook: the bucket's mean over ``group`` through
    this package's all-reduce."""
    flat = bucket.buffer().div_(group.nranks)
    task = collective.all_reduce(flat, group=group, sync_op=False)
    return task.get_future().then(lambda _: flat)


class DataParallel(nn.Module):
    """``paddle.DataParallel(layers, ...)``: ``layers`` run as they are;
    their gradients are averaged over ``group`` (the topology's dp group,
    else the world).  Over a group of one rank it is ``layers`` alone."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group if group is not None else _dp_group()
        ddp = None
        if self.group.nranks > 1:
            ddp = DistributedDataParallel(
                layers, process_group=self.group.process_group,
                bucket_cap_mb=comm_buffer_size,
                find_unused_parameters=find_unused_parameters,
                broadcast_buffers=False)
            ddp.register_comm_hook(self.group, _mean_hook)
        # not a submodule: its module is ``_layers``
        object.__setattr__(self, "_ddp", ddp)

    def forward(self, *inputs, **kwargs):
        net = self._ddp if self._ddp is not None else self._layers
        return net(*inputs, **kwargs)

    def no_sync(self):
        """Accumulate gradients without all-reducing them."""
        return (self._ddp.no_sync() if self._ddp is not None
                else contextlib.nullcontext())

    def scale_loss(self, loss):
        return loss

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        if hasattr(self._layers, "set_state_dict"):
            return self._layers.set_state_dict(state_dict, *args, **kwargs)
        return self._layers.load_state_dict(state_dict, *args, **kwargs)
