"""The multi-process DataLoader's worker pool over the shared-memory ring:
the port of ``paddle_tpu/io/worker_pool.py``.

Worker processes forked from the consumer (``get_context("fork")``, as in
the JAX package: the dataset and the collate function are inherited, not
pickled) fetch and collate batches and push them through
:class:`~.shm_ring.ShmRing`; the consumer reorders them by sequence number,
so the order is the sampler's whatever the workers' timing.  Small control
messages (tasks, errors, batches larger than a slot) ride an
``mp.Queue``; only the arrays' bytes take the ring.

What the port adds to the JAX pool, none of which changes a batch:

* Each worker calls ``torch.set_num_threads(1)`` before its first task (a
  worker forked after the parent's intra-op pool started can hang in it)
  and never touches CUDA: it fetches, transforms and collates on the host.
* Workers are seeded as the JAX pool seeds them, not at all: each starts
  from the parent's numpy generator state at the fork, so worker w's k-th
  random draw equals worker w''s (ROADMAP C5).
* ``/dev/shm`` is checked before the ring is made, and a ring larger than
  its free space raises ``OSError`` naming both sizes (a ring past it
  would die of ``SIGBUS`` at a push, not at creation).
* The consumer never waits forever: while it waits it checks that every
  worker is alive, and a worker that died raises.  An exception that
  cannot be pickled comes back as a ``RuntimeError`` carrying its
  traceback.
* The ring unpacks straight into page-locked tensors when ``pin``
  (``shm_ring.unpack_tensors``), so leaves come back as torch tensors.
* Every worker and the ring's segment are gone after :meth:`shutdown`,
  after a worker's error, after an epoch left unfinished and at
  interpreter exit.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import pickle
import queue
import struct
import traceback
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .shm_ring import ShmRing, _pack, unpack_tensors

_ARRAY = "__nd__"
_live_pools: "weakref.WeakSet[ShmWorkerPool]" = weakref.WeakSet()


def _tree_flatten(obj, arrays: List[np.ndarray]):
    if isinstance(obj, torch.Tensor):
        obj = obj.numpy()
    if isinstance(obj, np.ndarray):
        arrays.append(obj)
        return (_ARRAY, len(arrays) - 1)
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, [_tree_flatten(o, arrays) for o in obj])
    if isinstance(obj, dict):
        return ("dict", {k: _tree_flatten(v, arrays) for k, v in obj.items()})
    return ("leaf", obj)


def _tree_unflatten(desc, arrays: List[Any]):
    tag, val = desc
    if tag == _ARRAY:
        return arrays[val]
    if tag in ("list", "tuple"):
        seq = [_tree_unflatten(d, arrays) for d in val]
        return seq if tag == "list" else tuple(seq)
    if tag == "dict":
        return {k: _tree_unflatten(d, arrays) for k, d in val.items()}
    return val


def _frame(seq: int, batch) -> bytes:
    arrays: List[np.ndarray] = []
    desc = _tree_flatten(batch, arrays)
    payload = pickle.dumps((seq, desc))
    body = _pack(arrays)
    return struct.pack("<I", len(payload)) + payload + body


def _unframe(buf: memoryview, pin: bool = False) -> Tuple[int, Any]:
    """A frame's sequence number and batch, its arrays as torch tensors
    (page-locked when ``pin``), copied out of ``buf``."""
    (plen,) = struct.unpack_from("<I", buf, 0)
    seq, desc = pickle.loads(buf[4:4 + plen])
    arrays = unpack_tensors(buf[4 + plen:], pin)
    return seq, _tree_unflatten(desc, arrays)


def _pickled_error(e: BaseException) -> bytes:
    try:
        return pickle.dumps(e)
    except Exception:
        return pickle.dumps(RuntimeError(
            "DataLoader worker raised an exception that cannot be pickled:\n"
            + "".join(traceback.format_exception(e))))


def _worker_loop(dataset, collate_fn, task_q, ctrl_q, ring_name,
                 worker_id, num_workers, worker_init_fn):
    from . import dataloader as dl_mod

    torch.set_num_threads(1)
    dl_mod._worker_info = dl_mod.WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    ring = ShmRing(ring_name, create=False)
    while True:
        task = task_q.get()
        if task is None:
            break
        seq, indices = task
        try:
            batch = collate_fn([dataset[i] for i in indices])
            data = _frame(seq, batch)
            try:
                ring.push_bytes(data)
            except OSError:
                # oversize for the ring slot — fall back to the control queue
                ctrl_q.put(("big", seq, data))
                continue
            ctrl_q.put(("ring", seq, None))
        except Exception as e:  # propagate to the consumer
            ctrl_q.put(("err", seq, _pickled_error(e)))


class ShmWorkerPool:
    """Ordered multi-process fetch pool (consumer side)."""

    _counter = 0
    POLL_S = 0.5   # how often a waiting consumer checks its workers

    def __init__(self, dataset, collate_fn, num_workers: int,
                 n_slots: int = 8, slot_size: int = 64 * 1024 * 1024,
                 worker_init_fn: Optional[Callable] = None,
                 pin: bool = False):
        ShmWorkerPool._counter += 1
        # the JAX pool's names start "pt_dl_": a port's ring never shares
        # one with a JAX ring of the same process
        self.name = f"ptt_dl_{os.getpid()}_{ShmWorkerPool._counter}"
        self.pin = pin
        self._closed = True
        self.ring = ShmRing(self.name, n_slots=n_slots, slot_size=slot_size)
        ctx = mp.get_context("fork")
        self.task_q = ctx.Queue()
        self.ctrl_q = ctx.Queue()
        self.workers = [
            ctx.Process(target=_worker_loop,
                        args=(dataset, collate_fn, self.task_q, self.ctrl_q,
                              self.name, w, num_workers, worker_init_fn),
                        daemon=True)
            for w in range(num_workers)
        ]
        self._closed = False
        _live_pools.add(self)
        for w in self.workers:
            w.start()

    def submit(self, seq: int, indices):
        self.task_q.put((seq, indices))

    def _next_message(self):
        while True:
            try:
                return self.ctrl_q.get(timeout=self.POLL_S)
            except queue.Empty:
                dead = [(i, w.exitcode) for i, w in enumerate(self.workers)
                        if not w.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"DataLoader worker(s) exited unexpectedly "
                        f"(worker, exit code): {dead}")

    def results(self, total: int):
        """Yield batches for seq 0..total-1 in order.  The pool shuts
        down when a worker raised or died, or when the caller stops
        before the last batch (its tasks and frames would otherwise reach
        the next epoch)."""
        ready: Dict[int, Any] = {}
        next_seq = 0
        done = False
        try:
            while next_seq < total:
                while next_seq in ready:
                    yield ready.pop(next_seq)
                    next_seq += 1
                if next_seq >= total:
                    break
                kind, seq, payload = self._next_message()
                if kind == "err":
                    raise pickle.loads(payload)
                if kind == "big":
                    got_seq, batch = _unframe(memoryview(payload), self.pin)
                else:
                    got_seq, batch = _unframe(self.ring.pop_view(), self.pin)
                ready[got_seq] = batch
            done = True
        finally:
            if not done:
                self.shutdown()

    def shutdown(self):
        if self._closed:
            return
        self._closed = True
        for _ in self.workers:
            self.task_q.put(None)
        for w in self.workers:
            w.join(timeout=2)
            if w.is_alive():
                w.terminate()
                w.join(timeout=2)
        for q in (self.task_q, self.ctrl_q):
            q.cancel_join_thread()
            q.close()
        self.ring.close()
        _live_pools.discard(self)

    def __del__(self):
        try:
            self.shutdown()
        except Exception:
            pass


@atexit.register
def _shutdown_live_pools():
    for pool in list(_live_pools):
        pool.shutdown()
