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

**Replicas at dp x mp.**  Several engines may span one mp group's ranks
(the in-process fleet of ``server --dp N --mp M``): the fleet's process is
the controller of every replica, and each follower process holds its shard
of every replica and runs one :func:`follow` loop a replica, on a thread of
its own.  Two replicas' collectives on one shared group, issued from two
threads in an order that differs between processes, would deadlock or mix
their tensors, so each replica has its own mp group and its own gloo
control group (:func:`replica_groups`, created by every rank in one order
before any engine), and its model and engine are built inside
:func:`replica`.

**Beyond a launch** the channel carries a replica's KV hand-off — the
controller gathers every rank's head slice of the listed blocks
(:meth:`StepChannel.gather_pages`) and scatters a run's slices into the
ranks' pools (:meth:`StepChannel.scatter_pages`) — the ranks' launch
counters (:meth:`StepChannel.report`), and a rebuild
(:meth:`StepChannel.rebuild`): a supervisor rebuilding a crashed replica
tells its followers to rebuild their shards from the same seed, and waits
for them within a deadline.  A follower that is dead or does not answer
fails the rebuild with :class:`FollowerLost`: such a replica cannot be
rebuilt in process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from collections import Counter
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# how long a follower waits for the controller's next step: a server idles
# between requests, so effectively without end (a dead controller closes
# its sockets and fails the wait at once)
_CONTROL_TIMEOUT = datetime.timedelta(days=30)
# how long a controller waits for its followers to rebuild a replica
REBUILD_TIMEOUT_S = 300.0


class FollowerLost(RuntimeError):
    """A replica's follower rank is dead or does not answer: the replica
    cannot be rebuilt in this process."""


def control_group(mp_group):
    """The gloo side group of ``mp_group``'s ranks: a replica's own, made
    with it by :func:`replica_groups`; else one of those made once for
    every mp group of the hybrid topology (torch's ``new_group`` is
    collective over the world, so every rank creates them all, in one
    order), kept on the topology object."""
    own = getattr(mp_group, "control", None)
    if own is not None:
        return own
    from ..distributed import topology

    hcg = topology.get_hybrid_communicate_group()
    groups = getattr(hcg, "_serving_control", None)
    if groups is None:
        groups = {}
        for row in topology.axis_rows(hcg.mesh, "mp"):
            groups[tuple(row)] = dist.new_group(
                row, backend="gloo", timeout=_CONTROL_TIMEOUT)
        hcg._serving_control = groups
    return groups[tuple(mp_group.ranks)]


def replica_groups(count: int) -> list:
    """``count`` mp groups over this rank's mp ranks, one a serving
    replica, each with a gloo control group of its own (its ``control``).
    Collective over the world: every rank calls it once, with the same
    count, before any replica's engine is built."""
    from ..distributed import topology

    hcg = topology.get_hybrid_communicate_group()
    if hcg is None:
        raise ValueError("replica_groups needs the hybrid topology: call "
                         "distributed.topology.init_mesh(mp=...) first")
    groups = hcg.more_groups("mp", count)
    controls = hcg.more_groups("mp", count, backend="gloo",
                               timeout=_CONTROL_TIMEOUT)
    for g, c in zip(groups, controls):
        g.control = c.process_group
    return groups


@contextlib.contextmanager
def replica(group):
    """Build one replica's model and engine inside: they take ``group``
    (one of :func:`replica_groups`) as their mp group."""
    from ..distributed import topology

    with topology.get_hybrid_communicate_group().using_group("mp", group):
        yield group


def launch_counts() -> dict:
    """This process's kernel launches by route since their last reset."""
    from ..ops import paged_decode as pd
    from ..ops import ragged_paged as rp

    return {"ragged": {"all": rp.launches, "simple": rp.simple_launches,
                       "tma": rp.tma_launches},
            "decode": {"all": pd.launches, "simple": pd.simple_launches,
                       "mma": pd.mma_launches}}


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor's bytes as uint8 (gloo moves bytes of any dtype)."""
    return t.contiguous().view(-1).view(torch.uint8)


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
        steps, host arrays, sampling arrays)``, ``("export", blocks)``,
        ``("import", blocks)``, ``("report",)``, ``("rebuild",)`` or
        ``("stop",)``."""
        return self._broadcast()

    def share(self, value=None):
        """``value`` of the controller, returned on every rank."""
        return self._broadcast(value if self.is_controller else None)

    # --- the KV hand-off across the ranks ----------------------------------
    def gather_pages(self, blocks: Sequence[int],
                     mine: torch.Tensor) -> torch.Tensor:
        """The controller's half of an export: every rank's head slice of
        ``blocks`` (``mine``: this rank's, a CPU tensor ``[2, layers,
        blocks, block_size, Hkv/mp, D]``), joined along the head axis in
        rank order: the global pages."""
        self._broadcast(("export", [int(b) for b in blocks]))
        parts = [torch.empty_like(_as_bytes(mine)) for _ in range(self.mp)]
        dist.gather(_as_bytes(mine), parts, dst=self.controller,
                    group=self._pg)
        return torch.cat([p.view(mine.dtype).view(mine.shape)
                          for p in parts], dim=4)

    def send_pages(self, mine: torch.Tensor) -> None:
        """A follower's half of :meth:`gather_pages`."""
        dist.gather(_as_bytes(mine), None, dst=self.controller,
                    group=self._pg)

    def scatter_pages(self, blocks: Sequence[int],
                      pages: torch.Tensor) -> torch.Tensor:
        """The controller's half of an import: send each follower its head
        slice of the global ``pages`` (a CPU tensor ``[2, layers, blocks,
        block_size, Hkv, D]``) for ``blocks`` of its pools; returns this
        rank's slice."""
        self._broadcast(("import", [int(b) for b in blocks]))
        slices = pages.chunk(self.mp, dim=4)
        parts = [_as_bytes(p) for p in slices]
        dist.scatter(torch.empty_like(parts[0]), parts, src=self.controller,
                     group=self._pg)
        return slices[0]

    def receive_pages(self, like: torch.Tensor) -> torch.Tensor:
        """A follower's half of :meth:`scatter_pages`: its slice, shaped
        and typed as ``like``."""
        buf = torch.empty_like(_as_bytes(like))
        dist.scatter(buf, None, src=self.controller, group=self._pg)
        return buf.view(like.dtype).view(like.shape)

    # --- the ranks' counters ------------------------------------------------
    def report(self, mine: dict) -> List[dict]:
        """Every rank's ``mine`` (the controller's first), gathered on the
        controller; a follower answers through :func:`follow`."""
        self._broadcast(("report",))
        out = [None] * self.mp
        dist.gather_object(mine, out, dst=self.controller, group=self._pg)
        return out

    # --- a replica's rebuild ------------------------------------------------
    def rebuild(self) -> None:
        """Tell the followers to rebuild their shards of this replica and
        wait until each has (within REBUILD_TIMEOUT_S);
        :class:`FollowerLost` when one is dead or silent."""
        try:
            self._broadcast(("rebuild",))
            self.barrier()
        except RuntimeError as e:
            raise FollowerLost(
                f"a follower of this replica's mp group {self._ranks()} "
                f"did not rebuild its shard: {str(e).splitlines()[0]}"
            ) from e

    def barrier(self) -> None:
        """Every rank of the group here, within REBUILD_TIMEOUT_S."""
        dist.monitored_barrier(group=self._pg, timeout=datetime.timedelta(
            seconds=REBUILD_TIMEOUT_S), wait_all_ranks=True)

    def _ranks(self):
        return dist.get_process_group_ranks(self._pg)


def follow(engine, rebuild: Optional[Callable[[], object]] = None) -> int:
    """A follower's loop: launch every step the controller broadcasts on
    this rank's shard, and serve its hand-offs, counters and rebuilds
    (``rebuild()`` returns this rank's new engine of the replica), until
    the controller's :meth:`StepChannel.release`.  Returns the number of
    launches."""
    from . import handoff

    ch = engine.tp
    if ch is None or ch.is_controller:
        raise RuntimeError("follow() runs on a follower rank of an engine "
                           "at mp > 1")
    n = 0
    while True:
        msg = ch.receive()
        kind = msg[0]
        if kind == "stop":
            return n
        if kind == "step":
            _, program, bucket, sampled, steps, host, pack_arrays = msg
            engine.follow_step(program, bucket, sampled, steps, host,
                               pack_arrays)
            ch.programs[program] += steps
            n += 1
        elif kind == "export":
            ch.send_pages(handoff.rank_pages(engine, msg[1]))
        elif kind == "import":
            handoff.write_pages(engine, msg[1], ch.receive_pages(
                handoff.rank_pages_like(engine, len(msg[1]))))
        elif kind == "report":
            dist.gather_object(rank_report(engine), None,
                               dst=ch.controller, group=ch._pg)
        elif kind == "rebuild":
            if rebuild is None:
                raise RuntimeError("the controller rebuilds a replica this "
                                   "follower cannot rebuild (no rebuild "
                                   "function)")
            engine = rebuild()
            ch = engine.tp
            ch.barrier()
        else:
            raise RuntimeError(f"unknown control message {kind!r}")


def rank_report(engine) -> dict:
    """This rank's process id, kernel launches by route, its engine's
    forwards by program (what the launches are held against) and, on a
    card, the card memory this process has held at its peak."""
    peak = (torch.cuda.max_memory_allocated(engine.device)
            if engine.device.type == "cuda" else 0)
    return {"pid": os.getpid(), **launch_counts(),
            "programs": dict(engine.tp.programs),
            "peak_memory_bytes": int(peak)}


class ReplicaFactory:
    """The controller's ``engine_factory(i, registry)`` of a fleet whose
    replica ``i`` spans ``groups[i]`` (:func:`replica_groups`): it runs
    ``build(i, registry)`` inside :func:`replica`.  A later call for the
    same ``i`` — a supervisor's rebuild of a crashed replica — first has
    the replica's followers rebuild their shards
    (:meth:`StepChannel.rebuild`; :class:`FollowerLost` when one cannot).
    On a follower it only builds (its :func:`follow` loop asks for the
    rebuild).  ``built`` maps each index to its live engine."""

    def __init__(self, groups: list, build: Callable):
        self.groups = groups
        self.build = build
        self.built = {}

    def __call__(self, i: int, registry=None):
        old = self.built.get(i)
        if old is not None and old.tp.is_controller:
            old.tp.rebuild()
        with replica(self.groups[i]):
            eng = self.build(i, registry)
        self.built[i] = eng
        return eng


def follow_replicas(engines: list, rebuild: Callable[[int], object]):
    """A follower rank of a fleet: one :func:`follow` loop a replica, each
    on its own thread (``rebuild(i)`` returns replica ``i``'s new engine
    on this rank).  Returns each loop's launch count once every replica's
    controller released it; raises the first loop's error."""
    import threading

    counts: List[Optional[int]] = [None] * len(engines)
    errors: List[BaseException] = []

    def loop(i):
        try:
            counts[i] = follow(engines[i], rebuild=lambda: rebuild(i))
        except BaseException as e:      # re-raised below, on this thread
            errors.append(e)

    threads = [threading.Thread(target=loop, args=(i,),
                                name=f"follow-replica-{i}", daemon=True)
               for i in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return counts


def launch_followers(mp: int, func, args, backend: Optional[str] = None,
                     pg_timeout: Optional[float] = None,
                     master: Optional[str] = None):
    """Make this process rank 0 of a world of ``mp`` ranks and start ranks
    1..mp-1 running ``func(*args)`` through the port's ``spawn``; the
    caller then joins the world with ``init_parallel_env()``.  ``master``
    is the world's rendezvous ``host:port`` (a free local port when
    None).  Returns the
    :class:`~paddle_tpu_torch.distributed.spawn.SpawnContext` (``join``
    it after :meth:`StepChannel.release`).  The followers are daemonic
    and exit with this process: a controller that dies, even by
    ``kill -9``, leaves no follower holding its share of the card."""
    from ..distributed.env import free_port
    from ..distributed.spawn import rank_env, spawn

    master = master or f"127.0.0.1:{free_port()}"
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
