"""``paddle.distributed.communication.stream``: every collective with
Paddle's explicit ``sync_op`` / ``use_calc_stream``.  Each returns the
collective's :class:`~paddle_tpu_torch.distributed.collective.Task`.
``use_calc_stream=True`` is Paddle's "run on the compute stream": the
call then completes before it returns, as with ``sync_op=True`` (torch
orders a completed collective on the caller's stream)."""

from __future__ import annotations

from .. import collective as _c


def _sync(sync_op, use_calc_stream):
    return sync_op or use_calc_stream


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op=op, group=group,
                         sync_op=_sync(sync_op, use_calc_stream))


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_or_tensor_list, tensor, group=group,
                         sync_op=_sync(sync_op, use_calc_stream))


def reduce_scatter(tensor, tensor_or_tensor_list, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_or_tensor_list, op=op,
                             group=group,
                             sync_op=_sync(sync_op, use_calc_stream))


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _c.broadcast(tensor, src=src, group=group,
                        sync_op=_sync(sync_op, use_calc_stream))


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst=dst, op=op, group=group,
                     sync_op=_sync(sync_op, use_calc_stream))


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    return _c.scatter(tensor, tensor_or_tensor_list, src=src, group=group,
                      sync_op=_sync(sync_op, use_calc_stream))


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    return _c.alltoall(out_tensor_list, in_tensor_list, group=group,
                       sync_op=_sync(sync_op, use_calc_stream))


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _c.alltoall_single(out_tensor, in_tensor, in_split_sizes,
                              out_split_sizes, group=group,
                              sync_op=_sync(sync_op, use_calc_stream))


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst=dst, group=group,
                   sync_op=_sync(sync_op, use_calc_stream))


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src=src, group=group,
                   sync_op=_sync(sync_op, use_calc_stream))
