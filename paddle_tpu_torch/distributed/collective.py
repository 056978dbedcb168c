"""The collective API: the port of ``paddle_tpu/distributed/collective.py``.

The JAX package runs its collectives as ``jax.lax`` collectives over named
mesh axes inside ``shard_map``; here each rank is a process and each
function is the ``torch.distributed`` collective over a :class:`Group`'s
process group, with Paddle's semantics:

* results land in the caller's tensors in place (``all_reduce``,
  ``broadcast``, ``reduce``, ``reduce_scatter``, ``scatter``,
  ``alltoall_single``, ``recv``), or fill the caller's list
  (``all_gather``, ``alltoall``: an empty list is extended, a full one is
  written element by element);
* every call returns a :class:`Task`; with ``sync_op=True`` it has
  completed when the call returns, with ``sync_op=False`` ``task.wait()``
  completes it (and only then is the caller's list filled);
* ``group=None`` is the world; a rank outside ``group`` does nothing; a
  group of one rank (every group before ``init_parallel_env``) computes
  the one-rank result locally, with no backend.

A collective that the backend has no implementation of for the tensor's
device raises ``NotImplementedError`` naming the backend: NCCL takes CUDA
tensors only, and gloo lacks some collectives on CUDA tensors in some
torch versions.  Nothing is copied through the host behind the caller's
back (gloo's own CUDA collectives stage through the host; that is the
backend the caller chose).

:data:`stats` counts the calls and bytes of each collective this process
issued; inside :func:`timed` each call also synchronises the device before
and after itself and adds its wall seconds, which is what a profiled
step's collective share reads.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
import time
from collections import Counter
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from . import env


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.AVG}

# what torch says when a backend has no kernel for a collective on a device
_UNSUPPORTED = ("unsupported", "not supported", "does not support",
                "cannot use", "no backend type associated")


class Group:
    """``paddle.distributed.collective.Group``: the global ranks of a
    group, this process's index in it (``rank``, -1 outside it) and the
    torch process group its collectives run on (None for a group of one
    rank, which runs none)."""

    _next_id = 0

    def __init__(self, ranks: Sequence[int], process_group=None,
                 name: Optional[str] = None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.process_group = process_group
        me = env.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1
        self.id = Group._next_id
        Group._next_id += 1
        self.name = name or f"group_{self.id}"

    @property
    def world_size(self) -> int:
        return self.nranks

    def is_member(self) -> bool:
        return self.rank >= 0

    def get_group_rank(self, global_rank: int) -> int:
        return self.ranks.index(global_rank) if global_rank in self.ranks \
            else -1

    @property
    def backend(self) -> Optional[str]:
        if self.process_group is None:
            return None
        return dist.get_backend(self.process_group)

    def __deepcopy__(self, memo):
        return self     # a copied module or parameter shares its group

    def __repr__(self):
        return (f"Group(name={self.name}, ranks={self.ranks}, "
                f"rank={self.rank}, backend={self.backend})")


_world: List[Optional[Group]] = [None]


def world_group() -> Group:
    """Every rank of the job (one rank, this process, before
    ``init_parallel_env``)."""
    if not dist.is_initialized():
        return Group([env.get_rank()], None, name="world")
    g = _world[0]
    if g is None or g.nranks != dist.get_world_size():
        pg = dist.group.WORLD if dist.get_world_size() > 1 else None
        g = _world[0] = Group(range(dist.get_world_size()), pg, name="world")
    return g


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None) -> Group:
    """A group over the global ``ranks`` (all when None).  As in torch,
    every rank of the world calls it, in the same order, for every group;
    a rank outside ``ranks`` gets a group it is not a member of."""
    world = env.get_world_size()
    ranks = sorted(set(range(world) if ranks is None else ranks))
    if any(r < 0 or r >= world for r in ranks):
        raise ValueError(f"new_group: ranks {ranks} outside a world of "
                         f"{world}")
    if len(ranks) < 2 or not dist.is_initialized():
        return Group(ranks, None)
    if timeout is None:
        timeout = env._state.get("timeout")
    kw = {}
    if timeout is not None:
        kw["timeout"] = (timeout if isinstance(timeout, datetime.timedelta)
                         else datetime.timedelta(seconds=float(timeout)))
    return Group(ranks, dist.new_group(ranks, backend=backend, **kw))


# --- counters -----------------------------------------------------------------

stats = {"calls": Counter(), "bytes": Counter(), "seconds": Counter()}
_timing = [0]
# serving replicas at mp > 1 issue collectives from several threads at
# once: a counter's increment is not atomic
_stats_lock = threading.Lock()


def reset_stats() -> None:
    for c in stats.values():
        c.clear()


@contextlib.contextmanager
def timed():
    """Inside: each collective synchronises the device before and after
    itself and adds its wall seconds to ``stats["seconds"]``."""
    _timing[0] += 1
    try:
        yield
    finally:
        _timing[0] -= 1


def _sync(tensors):
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class Task:
    """``ProcessGroup::Task``: ``wait()`` blocks until the collective is
    done and its results are in the caller's tensors."""

    def __init__(self, works=(), post=None):
        self._works = [w for w in works if w is not None]
        self._post = post
        self._done = False

    def wait(self, timeout=None) -> bool:
        if not self._done:
            for w in self._works:
                w.wait()
            if self._post is not None:
                self._post()
            self._done = True
        return True

    synchronize = wait

    def get_future(self) -> torch.futures.Future:
        """A future of the collective (of ``sync_op=False``), as torch's
        ``Work.get_future``."""
        work, = self._works
        return work.get_future()

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)


def _resolve(group) -> Group:
    return world_group() if group is None else group


def _check_device(name: str, g: Group, tensors) -> None:
    backend = g.backend
    if backend == "nccl":
        for t in tensors:
            if isinstance(t, torch.Tensor) and not t.is_cuda:
                raise NotImplementedError(
                    f"{name}: the nccl backend runs on CUDA tensors and got "
                    f"a {t.device} tensor; move it to the rank's card or "
                    f"use a gloo group")


def _issue(name: str, g: Group, tensors, call, sync_op: bool, post=None):
    """Run ``call(process_group, async_op)`` as the collective ``name``."""
    tensors = [t for t in tensors if isinstance(t, torch.Tensor)]
    _check_device(name, g, tensors)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    with _stats_lock:
        stats["calls"][name] += 1
        stats["bytes"][name] += nbytes
    timing = _timing[0] > 0
    if timing:
        _sync(tensors)
        t0 = time.perf_counter()
    try:
        work = call(g.process_group, not sync_op)
    except RuntimeError as e:
        msg = str(e)
        if any(p in msg.lower() for p in _UNSUPPORTED):
            dev = tensors[0].device if tensors else "these"
            raise NotImplementedError(
                f"{name}: the {g.backend} backend has no {name} for "
                f"{dev} tensors ({msg.splitlines()[0]})") from e
        raise
    task = Task([work] if not sync_op else (), post)
    if sync_op:
        task.wait()
        if timing:
            _sync(tensors)
            with _stats_lock:
                stats["seconds"][name] += time.perf_counter() - t0
    return task


def _done(post=None) -> Task:
    t = Task((), post)
    t.wait()
    return t


def _fill(dst: list, values: list) -> None:
    """Paddle's output-list contract: extend an empty list, else write
    element by element."""
    if not dst:
        dst.extend(values)
        return
    if len(dst) != len(values):
        raise ValueError(f"output list holds {len(dst)} tensors, the group "
                         f"gives {len(values)}")
    for d, v in zip(dst, values):
        d.copy_(v)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    g = _resolve(group)
    if not g.is_member() or g.nranks == 1:
        return _done()
    return _issue("all_reduce", g, [tensor], lambda pg, a: dist.all_reduce(
        tensor, op=_TORCH_OPS[op], group=pg, async_op=a), sync_op)


def all_reduced(x, group=None, op=ReduceOp.SUM):
    """A new tensor holding ``x`` all-reduced over ``group`` (``x`` is
    left as it is): the form autograd functions take."""
    y = x.contiguous().clone()
    all_reduce(y, op=op, group=group)
    return y


def all_gather(tensor_list: list, tensor, group=None, sync_op=True):
    g = _resolve(group)
    if not g.is_member():
        return _done()
    if g.nranks == 1:
        return _done(lambda: _fill(tensor_list, [tensor.clone()]))
    src = tensor.contiguous()
    out = [torch.empty_like(src) for _ in range(g.nranks)]
    return _issue("all_gather", g, [src], lambda pg, a: dist.all_gather(
        out, src, group=pg, async_op=a), sync_op,
        post=lambda: _fill(tensor_list, out))


def reduce_scatter(tensor, tensor_or_tensor_list, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """``tensor`` gets this rank's block of the reduction: the rank-th
    element of the list, or the rank-th of ``nranks`` equal blocks along
    dim 0 of a tensor."""
    g = _resolve(group)
    if not g.is_member():
        return _done()
    src = tensor_or_tensor_list
    parts = (list(src) if isinstance(src, (list, tuple))
             else list(src.contiguous().chunk(g.nranks, dim=0)))
    if len(parts) != g.nranks:
        raise ValueError(f"reduce_scatter: {len(parts)} blocks for "
                         f"{g.nranks} ranks")
    if g.nranks == 1:
        return _done(lambda: tensor.copy_(parts[0]))
    parts = [p.contiguous() for p in parts]
    return _issue("reduce_scatter", g, parts,
                  lambda pg, a: dist.reduce_scatter(
                      tensor, parts, op=_TORCH_OPS[op], group=pg,
                      async_op=a), sync_op)


def broadcast(tensor, src: int = 0, group=None, sync_op=True):
    """``tensor`` on every rank of ``group`` takes the value it has on the
    global rank ``src``."""
    g = _resolve(group)
    if not g.is_member() or g.nranks == 1:
        return _done()
    return _issue("broadcast", g, [tensor], lambda pg, a: dist.broadcast(
        tensor, src, group=pg, async_op=a), sync_op)


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reduction lands in ``tensor`` on the global rank ``dst``."""
    g = _resolve(group)
    if not g.is_member() or g.nranks == 1:
        return _done()
    return _issue("reduce", g, [tensor], lambda pg, a: dist.reduce(
        tensor, dst, op=_TORCH_OPS[op], group=pg, async_op=a), sync_op)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op=True):
    """The global rank ``src`` sends the i-th tensor of its list to the
    group's i-th rank, into ``tensor``."""
    g = _resolve(group)
    if not g.is_member():
        return _done()
    if g.nranks == 1:
        return _done(lambda: tensor.copy_(tensor_list[0]))
    parts = ([t.contiguous() for t in tensor_list]
             if env.get_rank() == src else None)
    return _issue("scatter", g, [tensor] + (parts or []),
                  lambda pg, a: dist.scatter(tensor, parts, src=src,
                                             group=pg, async_op=a), sync_op)


def alltoall(out_tensor_list: list, in_tensor_list, group=None,
             sync_op=True):
    """Rank i's j-th input goes to rank j's i-th output."""
    g = _resolve(group)
    if not g.is_member():
        return _done()
    ins = [t.contiguous() for t in in_tensor_list]
    if g.nranks == 1:
        return _done(lambda: _fill(out_tensor_list, [ins[0].clone()]))
    out = [torch.empty_like(t) for t in ins]
    return _issue("alltoall", g, ins, lambda pg, a: dist.all_to_all(
        out, ins, group=pg, async_op=a), sync_op,
        post=lambda: _fill(out_tensor_list, out))


def alltoall_single(out_tensor, in_tensor, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """``alltoall`` over dim-0 blocks of one tensor (equal blocks unless
    the split sizes say otherwise)."""
    g = _resolve(group)
    if not g.is_member():
        return _done()
    if g.nranks == 1:
        return _done(lambda: out_tensor.copy_(in_tensor))
    src = in_tensor.contiguous()
    return _issue("alltoall_single", g, [src],
                  lambda pg, a: dist.all_to_all_single(
                      out_tensor, src, output_split_sizes=out_split_sizes,
                      input_split_sizes=in_split_sizes, group=pg,
                      async_op=a), sync_op)


def _p2p(name, fn_sync, fn_async, tensor, peer, group, sync_op):
    g = _resolve(group)
    if g.nranks == 1:
        raise ValueError(f"{name}: a group of one rank has no peer")
    if not g.is_member():
        return _done()

    def call(pg, a):
        if a:
            return fn_async(tensor, peer, group=pg)
        fn_sync(tensor, peer, group=pg)
        return None

    return _issue(name, g, [tensor], call, sync_op)


def send(tensor, dst: int = 0, group=None, sync_op=True):
    return _p2p("send", dist.send, dist.isend, tensor, dst, group, sync_op)


def recv(tensor, src: int = 0, group=None, sync_op=True):
    return _p2p("recv", dist.recv, dist.irecv, tensor, src, group, sync_op)


def isend(tensor, dst: int = 0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src: int = 0, group=None):
    return recv(tensor, src, group, sync_op=False)


def barrier(group=None):
    g = _resolve(group)
    if g.is_member() and g.nranks > 1:
        stats["calls"]["barrier"] += 1
        dist.barrier(group=g.process_group)


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work queued on ``tensor``'s device is done (the
    collectives of this module have completed when they return, unless
    called with ``sync_op=False``: wait on their task)."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
