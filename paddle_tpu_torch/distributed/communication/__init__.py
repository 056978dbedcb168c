"""``paddle.distributed.communication``: the package shape of the
reference (per-op modules and their ``stream`` variants); the
implementations live in :mod:`paddle_tpu_torch.distributed.collective`."""

from ..collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    broadcast,
    irecv,
    isend,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from . import stream  # noqa: F401
