"""Tensor-parallel serving across processes: a controller rank and its
follower ranks (it has no JAX counterpart).

Why this module exists: the JAX engine is ONE controller driving every
device of its ``mp`` mesh axis through one SPMD program (its step
families run mesh-spanning, the ragged kernel through ``shard_map``).  The
port runs one process a rank (ROADMAP C12), so the engine's host side —
scheduler, block pool, requests, metrics, the server — lives on the mp
group's first rank, the **controller**, and the others are **followers**
that own only their slice of the weights and their head-sharded KV pools
(``[num_blocks, block_size, Hkv/mp, D]`` a layer).

For every step-program launch the controller broadcasts the step — the
program name, its bucket, ``any_sampled``, the number of in-place
iterations (a burst's length) and the launch's packed host arrays, the
sampling pack's included — and then launches it itself; each follower
receives it and launches the same family on its own shard
(:func:`follow`).  Block ids come from the controller's pool, so prefix
forks, preemption and recompute act on every rank's pools alike with no
other traffic.  Inside the family the model's own collectives (an
all-reduce after the embedding and after each layer's ``o_proj`` and
``down_proj``, one all-gather of the vocabulary-parallel logits) keep the
ranks in step and give every rank bit-equal logits; every rank samples
from the broadcast keys, so a burst, which feeds its sampled tokens back
on the device, stays identical across ranks.

The control plane is a **gloo side group** over the mp group's ranks,
whatever the backend of the mp group itself (as vLLM's CPU group is), so
a follower learns what to do from CPU tensors alone.  It waits for the
next step with no deadline of its own (a server's followers idle between
requests); a dead peer closes its sockets, which fails the waiting side
at once, and a peer that stops answering fails the next collective of
the mp group within that group's timeout.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# how long a follower waits for the controller's next step: a server idles
# between requests, so effectively without end (a dead controller closes
# its sockets and fails the wait at once)
_CONTROL_TIMEOUT = datetime.timedelta(days=30)


def control_group(mp_group):
    """The gloo side group of ``mp_group``'s ranks.  torch's ``new_group``
    is collective over the world, so every rank creates one for every mp
    group of the hybrid topology, in one order, once; the groups are kept
    on the topology object."""
    from ..distributed import topology

    hcg = topology.get_hybrid_communicate_group()
    groups = getattr(hcg, "_serving_control", None)
    if groups is None:
        mesh = hcg.mesh
        a = topology.AXES.index("mp")
        rows = np.moveaxis(mesh.ranks, a, -1).reshape(-1, mesh.ranks.shape[a])
        groups = {}
        for row in rows.tolist():
            groups[tuple(row)] = dist.new_group(
                row, backend="gloo", timeout=_CONTROL_TIMEOUT)
        hcg._serving_control = groups
    return groups[tuple(mp_group.ranks)]


class StepChannel:
    """One engine's control plane over its mp group: the controller's
    :meth:`send_step` / :meth:`release`, a follower's :meth:`receive`, and
    :meth:`share` for a result every rank returns.  ``programs`` counts
    the model forwards this rank ran through the channel by step program
    (a burst of n iterations counts n): what its kernel launches and its
    collectives are held against."""

    def __init__(self, mp_group):
        self.mp = mp_group.nranks
        self.index = mp_group.rank            # 0 = the controller
        self.controller = mp_group.ranks[0]   # its global rank
        self.is_controller = self.index == 0
        self._pg = control_group(mp_group)
        self.programs = Counter()

    @property
    def forwards(self) -> int:
        """Model forwards run through the channel, every program's."""
        return sum(self.programs.values())

    def _broadcast(self, msg=None):
        box = [msg]
        dist.broadcast_object_list(box, src=self.controller, group=self._pg)
        return box[0]

    def send_step(self, program: str, bucket, sampled: bool, steps: int,
                  arrays: dict, pack_arrays) -> None:
        """The controller's half of one launch: ``arrays`` are the
        launch's host inputs by name (device state such as a burst's
        last-logits buffer stays behind: each rank keeps its own)."""
        host = {n: v for n, v in arrays.items()
                if not isinstance(v, torch.Tensor)}
        self._broadcast(("step", program, tuple(bucket), bool(sampled),
                         int(steps), host, list(pack_arrays)))
        self.programs[program] += int(steps)

    def release(self) -> None:
        """End the followers' :func:`follow` loop (the controller)."""
        self._broadcast(("stop",))

    def receive(self):
        """A follower's next message: ``("step", program, bucket, sampled,
        steps, host arrays, sampling arrays)`` or ``("stop",)``."""
        return self._broadcast()

    def share(self, value=None):
        """``value`` of the controller, returned on every rank."""
        return self._broadcast(value if self.is_controller else None)


def follow(engine) -> int:
    """A follower's loop: launch every step the controller broadcasts on
    this rank's shard, until the controller's :meth:`StepChannel.release`.
    Returns the number of launches."""
    ch = engine.tp
    if ch is None or ch.is_controller:
        raise RuntimeError("follow() runs on a follower rank of an engine "
                           "at mp > 1")
    n = 0
    while True:
        msg = ch.receive()
        if msg[0] == "stop":
            return n
        _, program, bucket, sampled, steps, host, pack_arrays = msg
        engine.follow_step(program, bucket, sampled, steps, host,
                           pack_arrays)
        ch.programs[program] += steps
        n += 1


def launch_followers(mp: int, func, args, backend: Optional[str] = None,
                     pg_timeout: Optional[float] = None):
    """Make this process rank 0 of a world of ``mp`` ranks and start ranks
    1..mp-1 running ``func(*args)`` through the port's ``spawn``; the
    caller then joins the world with ``init_parallel_env()``.  Returns the
    :class:`~paddle_tpu_torch.distributed.spawn.SpawnContext` (``join``
    it after :meth:`StepChannel.release`).  The followers are daemonic:
    a controller that dies before its release takes them down at its
    exit instead of waiting on them."""
    from ..distributed.env import free_port
    from ..distributed.spawn import rank_env, spawn

    master = f"127.0.0.1:{free_port()}"
    os.environ.update(rank_env(0, mp, master, backend, pg_timeout))
    return spawn(func, args=args, nprocs=mp - 1, join=False, daemon=True,
                 master=master, backend=backend, pg_timeout=pg_timeout,
                 first_rank=1, world_size=mp)


def world_backend(mp: int, device) -> Optional[str]:
    """The mp group's backend for ranks on ``device``: the caller's
    ``PADDLE_DISTRI_BACKEND`` if set, gloo on the CPU, NCCL when the cards
    number at least the ranks (one a rank), else gloo on shared cards."""
    chosen = os.environ.get("PADDLE_DISTRI_BACKEND")
    if chosen:
        return chosen
    if torch.device(device or "cuda").type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= mp else "gloo"
