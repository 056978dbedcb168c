"""``paddle_tpu_torch.distributed``: the port of ``paddle_tpu/distributed``
for dp x mp training, one process a rank over ``torch.distributed``.

* :mod:`env` — ``init_parallel_env`` (NCCL on the card, gloo on the CPU
  or by choice), ``get_rank`` / ``get_world_size`` per rank;
* :mod:`collective` and :mod:`communication` — the collectives with
  Paddle's in-place semantics and ``sync_op`` tasks;
* :mod:`topology` — ``init_mesh`` and ``HybridCommunicateGroup``: a
  process group a rank along each of the axes (dp, pp, sharding, sep, mp);
* :mod:`spawn` and :mod:`launch` — one process a rank;
* :mod:`parallel` — ``DataParallel`` (bucketed gradient all-reduce);
* :mod:`fleet` — ``init``, ``distributed_model``, ``distributed_optimizer``
  at dp x mp;
* the step watchdog (``watchdog.py``) and the auto-tuner's FLOP count
  (``auto_tuner.py``).

Pipelines, sharding stages, sequence parallel, MoE, ``store.py``,
``elastic.py``, ``rpc.py``, ``checkpoint.py``, ``auto_parallel.py`` and
the rest are ROADMAP A11.
"""

from . import env, collective, topology  # noqa: F401  (order: no cycles)
from . import communication, launch  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    ReduceOp,
    all_gather,
    all_reduce,
    alltoall,
    alltoall_single,
    barrier,
    broadcast,
    irecv,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    wait,
)
from .env import (  # noqa: F401
    destroy_process_group,
    get_backend,
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
)
from .parallel import DataParallel  # noqa: F401
from .spawn import spawn  # noqa: F401
from .topology import (  # noqa: F401
    HybridCommunicateGroup,
    get_hybrid_communicate_group,
    get_mesh,
    init_mesh,
)
from .watchdog import StepWatchdog  # noqa: F401
from . import fleet  # noqa: F401,E402
