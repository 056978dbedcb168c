"""``paddle.distributed.spawn``: the port of
``paddle_tpu/distributed/spawn.py``.

``spawn(func, args, nprocs)`` starts ``nprocs`` fresh Python processes
(the ``spawn`` start method: no forked CUDA state), sets each one's
launcher environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_MASTER``, ``MASTER_ADDR``/``MASTER_PORT``,
``PADDLE_RANK_IN_NODE``, ``PADDLE_LOCAL_SIZE``) and calls ``func(*args)``
there; ``func`` calls ``distributed.init_parallel_env()`` as a Paddle
script does.  ``func`` must be importable by name (a module-level
function).

Options: ``backend`` (``PADDLE_DISTRI_BACKEND`` for the ranks),
``pg_timeout`` (seconds, ``PADDLE_DISTRI_TIMEOUT``: a collective waiting
longer fails), ``timeout`` (seconds :meth:`SpawnContext.join` waits for
every rank), ``master`` (``host:port``, default a free local port), and
``first_rank`` / ``world_size`` for processes that are only part of a
world (the ranks ``first_rank..first_rank+nprocs-1`` of ``world_size``:
a serving controller starts its followers so, being rank 0 itself).
Each rank exits at once when the process that spawned it dies, even by
``kill -9``: no orphan keeps its share of a card.

``join`` returns when every rank exits 0.  When one rank fails, the others
are stopped and ``join`` raises :class:`ProcessRaisedException` with the
exit code and traceback of the rank that raised first; when the timeout passes first,
every rank is stopped and it raises :class:`SpawnTimeout`.  No rank
outlives ``join``.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import time
import traceback
from typing import Optional, Tuple

from .env import free_port


class ProcessRaisedException(RuntimeError):
    """A spawned rank failed: ``rank``, ``exitcode`` and the rank's
    traceback (``error``, empty when it died without raising)."""

    def __init__(self, rank: int, exitcode: int, error: str):
        self.rank, self.exitcode, self.error = rank, exitcode, error
        super().__init__(f"spawned rank {rank} failed with exit code "
                         f"{exitcode}" + (f":\n{error}" if error else ""))


class SpawnTimeout(TimeoutError):
    """``join``'s timeout passed with ranks still running (they were
    stopped)."""


def rank_env(rank: int, nprocs: int, master: str, backend: Optional[str],
             pg_timeout: Optional[float]) -> dict:
    """The launcher environment of rank ``rank`` of ``nprocs`` ranks."""
    host, port = master.rsplit(":", 1)
    env = {"PADDLE_TRAINER_ID": str(rank),
           "PADDLE_TRAINERS_NUM": str(nprocs),
           "PADDLE_MASTER": master, "MASTER_ADDR": host, "MASTER_PORT": port,
           "PADDLE_RANK_IN_NODE": str(rank), "PADDLE_LOCAL_SIZE": str(nprocs)}
    if backend:
        env["PADDLE_DISTRI_BACKEND"] = backend
    if pg_timeout is not None:
        env["PADDLE_DISTRI_TIMEOUT"] = str(pg_timeout)
    return env


def _exit_with_parent() -> None:
    """Exit this process as soon as its parent process is gone."""
    import threading

    parent = mp.parent_process()

    def watch():
        parent.join()
        os._exit(1)

    threading.Thread(target=watch, name="exit-with-parent",
                     daemon=True).start()


def _worker(func, args: Tuple, rank_env: dict, errors) -> None:
    _exit_with_parent()
    os.environ.update(rank_env)
    try:
        func(*args)
    except BaseException:
        errors.put((int(rank_env["PADDLE_TRAINER_ID"]),
                    traceback.format_exc()))
        raise SystemExit(1)


class SpawnContext:
    """The spawned ranks: ``processes`` in rank order from ``first_rank``,
    and :meth:`join`."""

    def __init__(self, processes, errors, timeout: Optional[float],
                 first_rank: int = 0):
        self.processes = processes
        self.first_rank = first_rank
        self._errors = errors
        self._timeout = timeout

    def stop(self) -> None:
        """Stop every rank still running (terminate, then kill after 5 s)."""
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        deadline = time.monotonic() + 5
        for p in self.processes:
            p.join(max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()

    def _first_error(self):
        """The rank that raised first and its traceback (ranks put them in
        the order they fail: the others often fail after it, in a
        collective it left), or None when none raised."""
        return self._errors.get() if not self._errors.empty() else None

    def join(self, timeout: Optional[float] = None) -> bool:
        timeout = self._timeout if timeout is None else timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = {p.sentinel: (self.first_rank + i, p)
                   for i, p in enumerate(self.processes)}
        while pending:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ready = mpc.wait(list(pending), timeout=left)
            if not ready:
                ranks = sorted(r for r, _ in pending.values())
                self.stop()
                raise SpawnTimeout(f"spawned ranks {ranks} still ran after "
                                   f"{timeout} s; all ranks were stopped")
            for s in ready:
                rank, p = pending.pop(s)
                p.join()
                if p.exitcode != 0:
                    self.stop()
                    first = self._first_error()
                    if first is not None:
                        rank = first[0]
                    raise ProcessRaisedException(
                        rank,
                        self.processes[rank - self.first_rank].exitcode,
                        first[1] if first is not None else "")
        return True


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options) -> SpawnContext:
    """Run ``func(*args)`` in ``nprocs`` rank processes (``-1``: one a
    card, or one on a machine without cards) and, with ``join``, wait for
    them; returns the :class:`SpawnContext`."""
    if nprocs == -1:
        import torch

        nprocs = max(1, torch.cuda.device_count())
    master = options.get("master") or f"127.0.0.1:{free_port()}"
    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    procs = []
    first = options.get("first_rank", 0)
    world = options.get("world_size") or first + nprocs
    for rank in range(first, first + nprocs):
        env = rank_env(rank, world, master, options.get("backend"),
                       options.get("pg_timeout"))
        p = ctx.Process(target=_worker, args=(func, tuple(args), env, errors),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs, errors, options.get("timeout"), first)
    if join:
        context.join()
    return context
