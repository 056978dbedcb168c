"""Compile-once step programs: one captured CUDA graph per bucket key.

The counterpart of the ``jax.jit`` wrappers of
``paddle_tpu/serving/engine.py``.  The JAX engine traces each bucketed step
family once per shape bucket and runs the compiled program from then on;
here each family is captured once per bucket key as a CUDA graph and
replayed from then on.  :class:`StepGraphs` is the cache of those
programs, one per engine.

* **The first call of a key** copies the host inputs into static buffers
  it allocates, runs the family EAGERLY on them — that run is this step's
  result, and it warms the kernels' one-time setup (library load,
  shared-memory opt-in, occupancy queries) outside the capture — and then
  captures the family into a graph.  A capture executes nothing, so no
  step runs twice on the live state.
* **Later calls** copy the host inputs into the same static buffers and
  replay the graph.
* **Counting.**  A capture is what the JAX engine's trace is: the engine's
  ``*_trace_count`` attributes and ``*_jit_traces`` metrics move once per
  capture, through ``on_capture``.  The kernel wrappers count launches in
  Python, which a replay does not run, so the counters' change over the
  first (eager) run is recorded and added again on every replay:
  ``launches`` stays "steps × layers" through replays.
* **One memory pool for all graphs** (``torch.cuda.graph_pool_handle()``).
  The engine replays one graph at a time, so one pool is enough; a pool
  per graph would hold a ``[Tb, vocab]`` fp32 logits buffer (263 MB at Tb =
  512 for Llama-3's vocabulary) for every unified bucket.  Because the pool
  is shared, a graph's outputs live in it and the next replay of ANY graph
  may overwrite them: the caller reads the outputs back before its next
  call, as every engine call site does.
* **On a CPU device** the same cache runs the same static-buffer path
  without a graph: copy in, call, copy the results into the static
  outputs (so outputs alias across calls as they do on the card), add the
  recorded counter change.  That is the CPU's own path, tested like the
  JAX trace counters are on the CPU, not a fallback: on a CUDA device a
  failure to capture or to replay raises.
* **Several engines in one process** (the replicas of an in-process
  fleet, each stepping on its own thread) share the kernel wrappers'
  launch counters and the card.  One process-wide lock is held across a
  whole :meth:`StepGraphs.run` (first run, capture, copy-in, replay and
  the counter bookkeeping), so a capture never races another engine's
  step program and the counters stay exact; a capture records in
  ``thread_local`` mode, so another thread's host work outside a step
  program (reading outputs back, a KV hand-off) neither fails nor
  invalidates it.  That host work calls no counted kernel, so no launch
  lands between a first run's counter reads or is folded into a replay's
  delta; ``tests/test_torch_fleet.py`` checks that every wrapper call of
  a fleet holds the lock.  Every step family runs here, the prefill
  families included, so one replica's prefill waits on the others'
  steps.  The garbage collector runs just before a capture and not
  during it: collecting a dead engine's graph on the capturing thread
  would invalidate the capture.  Inside :func:`capture_batch` (a warm's
  back-to-back captures on one thread) it runs once, at the start.
* :func:`disable_graphs` — the counterpart of ``jax.disable_jit()`` — runs
  the families eagerly on fresh tensors and leaves the counters alone; the
  identity checks hold graphs against it.
* **Eager at mp > 1** (:attr:`StepGraphs.eager_reason`, set by a
  tensor-parallel engine): a step family's collectives run over the mp
  group between its kernels, and over gloo they go through the host,
  which no captured graph can hold (collectives inside captured graphs
  are ROADMAP A11 item 7).  Every family then runs as under
  :func:`disable_graphs` on every rank: no capture, so the trace counters
  stay 0, while the bucket keys are those of mp = 1.  Such a run takes
  **no process-wide lock**: the replicas of a fleet at dp x mp step on
  threads of their own on every rank, and a step waits inside its
  collectives for the same replica's step on the other ranks.  A lock
  held across that wait would deadlock as soon as two ranks ran two
  replicas' steps in opposite orders (rank 0 in replica A's all-reduce
  holding its lock while rank 1 holds its own in replica B's).  With no
  capture there is nothing to race, and the kernel wrappers' counters
  take a lock of their own.
* **Sealed to an AOT artifact** (:meth:`StepGraphs.seal`, by
  ``EngineCore.bind_aot``): a key outside the artifact's saved universe
  raises ``AotBucketMissing`` and is never captured, graphs on or off.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dispatch
from ..ops import counters
from ..ops.counters import COUNTERS  # noqa: F401 (the counters replays advance)

_local = threading.local()
# held across every StepGraphs.run of the process (see the docstring)
_RUN_LOCK = threading.RLock()


@contextlib.contextmanager
def disable_graphs():
    """Run every step family eagerly inside this block (on this thread):
    no capture, no replay, no counter moves."""
    prev = graphs_enabled()
    _local.enabled = False
    try:
        yield
    finally:
        _local.enabled = prev


def graphs_enabled() -> bool:
    return getattr(_local, "enabled", True)


@contextlib.contextmanager
def capture_batch():
    """Back-to-back captures on this thread (``AotArtifact.warm``): the
    garbage collector runs once here instead of before every capture (it
    stays off during each capture)."""
    gc.collect()
    prev = getattr(_local, "batch", False)
    _local.batch = True
    try:
        yield
    finally:
        _local.batch = prev


def reset_counters() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    counters.write([0] * len(counters.read()))


def host_tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor (u32 sampling keys as int64: the
    sampler masks them back to 32 bits)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    # a 0-d array stays 0-d (a position a step program takes as data)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else np.ascontiguousarray(a).reshape(a.shape))


class StepProgram:
    """One step family at one bucket key: its static inputs and outputs,
    its graph (None on the CPU), the kernel-counter change of one run, and
    the wall seconds its capture took (the eager first run excluded)."""

    def __init__(self, fn, inputs, outputs, delta, graph=None,
                 capture_seconds=0.0):
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs
        self.delta = delta
        self.graph = graph
        self.capture_seconds = capture_seconds


class StepGraphs:
    """The cache of one engine's step programs, keyed by ``(family,
    bucket..., any_sampled)``.

    ``on_capture(key)`` is called once per new key, after its capture;
    the capture's wall seconds are on ``programs[key].capture_seconds``.
    ``captures`` and ``capture_seconds`` (the wall time of the captures,
    the eager first runs excluded) and ``replays`` count what happened."""

    def __init__(self, device, on_capture: Optional[Callable] = None):
        self.device = torch.device(device)
        self.on_capture = on_capture
        self.programs: Dict[Hashable, StepProgram] = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0
        self._pool = None
        # the AOT artifact this cache is sealed to (None = open)
        self.artifact = None
        # why every family runs eagerly here (None = captured graphs)
        self.eager_reason: Optional[str] = None

    def seal(self, artifact) -> None:
        """Admit only the keys of ``artifact``'s saved universe from now
        on: ``run`` asks ``artifact.check_key(key)``, which raises
        ``AotBucketMissing`` for any other key, before anything runs."""
        self.artifact = artifact

    def run(self, key: Hashable, fn: Callable, inputs: Sequence,
            steps: int = 1) -> Tuple[torch.Tensor, ...]:
        """Run ``fn(*inputs)`` ``steps`` times and return its outputs (a
        tuple of tensors).  ``inputs`` are host arrays, copied in, or
        device tensors, used in place (state a family keeps on the
        device).  ``fn`` must depend on nothing but its inputs and the key:
        a replay repeats the first call's work.  ``steps > 1`` runs a
        family that updates its inputs in place (a burst iteration) that
        many times."""
        if self.artifact is not None:
            self.artifact.check_key(key)
        if self.eager_reason is not None:
            return self._run(key, fn, inputs, steps)
        with _RUN_LOCK:
            return self._run(key, fn, inputs, steps)

    def _run(self, key, fn, inputs, steps):
        if self.eager_reason is not None or not graphs_enabled():
            args = [host_tensor(a).to(self.device) for a in inputs]
            for _ in range(steps):
                out = tuple(fn(*args))
            return out
        prog = self.programs.get(key)
        if prog is None:
            prog, out = self._capture(key, fn, inputs)
            steps -= 1
            if not steps:
                return out
        else:
            self._fill(key, prog, inputs)
        for _ in range(steps):
            self._replay(prog)
        return prog.outputs

    def _capture(self, key, fn, inputs):
        static = [a if isinstance(a, torch.Tensor)
                  else host_tensor(a).to(self.device, copy=True)
                  for a in inputs]
        before = counters.read()
        out = tuple(fn(*static))
        after = counters.read()
        delta = tuple(b - a for a, b in zip(before, after))
        graph = None
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            if self._pool is None:
                # one pool for every graph of this cache: any replay may
                # overwrite any graph's outputs, so callers read theirs
                # back before their next call
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # a dead engine's graphs are freed here: a collection during
            # the capture would destroy a graph on the capturing thread,
            # which invalidates the capture
            if not getattr(_local, "batch", False):
                gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                # the eager run above dispatched these ops: the capture
                # adds no op-bus rows (dispatch.quiet)
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"), \
                        dispatch.quiet():
                    outputs = tuple(fn(*static))
            finally:
                if collecting:
                    gc.enable()
                # the capture executed nothing: its wrapper calls
                # launched no kernel
                counters.write(after)
        else:
            outputs = out
        dt = time.perf_counter() - t0
        self.capture_seconds += dt
        prog = self.programs[key] = StepProgram(fn, static, outputs, delta,
                                                graph, dt)
        self.captures += 1
        if self.on_capture is not None:
            self.on_capture(key)
        return prog, out

    def _fill(self, key, prog, inputs):
        for buf, a in zip(prog.inputs, inputs):
            if a is buf:
                continue
            src = host_tensor(a)
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(
                    f"step program {key}: an input of {tuple(src.shape)} "
                    f"{src.dtype} for a static buffer of "
                    f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(src)

    def _replay(self, prog):
        if prog.graph is not None:
            prog.graph.replay()
        else:
            mark = counters.read()
            for o, r in zip(prog.outputs, prog.fn(*prog.inputs)):
                o.copy_(r)
            counters.write(mark)
        counters.add(prog.delta)
        self.replays += 1
