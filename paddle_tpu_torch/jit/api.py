"""``to_static``: the port of ``paddle_tpu/jit/api.py``.

The JAX package stages a function into one XLA program per signature key
(the tensors' shapes and dtypes, the owning layer's training modes, the
non-tensor arguments).  Here the program of a key is a CUDA graph:

* **The first call of a key** runs the function eagerly: that run is the
  call's result (one step of a train step, one BatchNorm update), and it
  builds every kernel and lazy state (optimizer slots) outside a capture.
  It runs under ``jit/partial.py``'s recorder, on either device: a host
  sync (``.item()``, ``float(loss)``, a branch on a tensor's value), a
  tensor read into host Python (``numpy()``), an op whose output shape
  depends on the data (``nonzero``) or a call into an ``ignore_module``'d
  module cannot be captured, so it is the key's graph break, the
  counterpart of JAX's ``ConcretizationTypeError``; on the card it also
  runs under ``torch.cuda.set_sync_debug_mode("warn")``, whose warnings
  are breaks too.
* **The second call** captures the function into a graph (a capture
  executes nothing) and replays it once, so it too takes one step.
* **Later calls** copy their tensor arguments into the graph's static
  inputs and replay it.

What a replay cannot repeat, the capture records:

* **Host scalars.**  The optimizers compute the learning rate (a
  scheduler's current value) and Adam's bias corrections on the host each
  step.  They pass them through :func:`host_scalars`: eagerly these are
  Python floats, as ever; in a capture they are 0-d device tensors, and
  before each replay the optimizer's host step runs again (advancing its
  counters) and its values are copied in.  Their buffers (one a dtype)
  are allocated before the capture, sized by the count the key's first
  call made: a buffer allocated inside the capture could take the memory
  of a tensor the graph frees earlier in the step (the backward's seed),
  whose replay would then overwrite the values written before it.  The
  values keep the JAX rounding (each in the weight's dtype).  Other host
  work inside the function (a scheduler's ``step()``, logging) runs at the
  capture only: keep it outside, as the JAX package's trace runs it once.
* **Kernel counters.**  A wrapper counts its launches in Python, which a
  replay does not run: the counters' change over the capture is taken back
  and added again at every replay, so ``launches`` stays calls × layers.
* **Outputs** are graph memory that the next replay overwrites: each call
  returns detached copies (the JAX program's outputs carry no tape
  either).  Gradients left on parameters by the function live in the
  graph's pool; a train step that ends in ``clear_grad`` leaves none.

A graph break (found by the first call, or a capture that fails) gives
one warning naming the site (``file.py:line``) and
``jit_graph_breaks_total`` + 1, and sends the key to its trace store
(``jit/partial.py``): the first call's recording, when it can be
replayed, becomes the key's first trace, and later calls replay its
segments around the syncs, with value guards, without running the
Python body; a trace that cannot be replayed leaves the key eager, with
a warning saying why.  After breaks in ``_EAGER_KEYS_LIMIT`` shape
buckets the function stops trying whole captures (the stores still
apply); ``full_graph=True`` raises instead; a break never evicts a
captured entry.  A capture that fails restores what it touched on the
host (parameters' gradients, optimizer counters and slots, schedulers)
and the caller's current stream and the device's random generator (which
``torch.cuda.graph`` leaves on its capture stream and in capture mode when
the capture was invalidated), so nothing is left half-captured, and the
call runs eagerly.

On the CPU a break-free key runs eagerly: there is no graph to capture.
The cache keeps the JAX accounting (one entry a key, built on the key's
first call, ``jit_builds_total``), and outputs are detached as on the
card.  A broken key replays its trace's segments as op lists.  One
departure from the JAX package: its first call of a broken key runs the
Python body up to three times (discovery, staging up to the break, the
recording); the port's runs it once, recording it.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading
import warnings
from typing import Any, Dict, List

import torch

from ..core import dispatch
from ..observability import get_registry
from ..ops import counters
from . import partial

# see the module docstring; the JAX package's value (jit/api.py:65)
_EAGER_KEYS_LIMIT = 8
_CACHE_MAX_ENTRIES = 64      # the JAX flag jit_cache_max_entries' default

_SYNC_WARNING = "called a synchronizing CUDA operation"

_local = threading.local()
_enabled = True
# one capture at a time in the process: the main programs' and the
# partial traces' segments
_CAPTURE_LOCK = threading.RLock()


class IgnoredModuleError(RuntimeError):
    """An ``ignore_module()``d function was reached inside a to_static
    function: a graph break of the outer function."""


class GraphBreak(RuntimeError):
    """A host sync in the first (eager) call of a key."""


def in_to_static_trace() -> bool:
    return getattr(_local, "depth", 0) > 0


# --- host scalars ---------------------------------------------------------

class _Feed:
    """One producer's host scalars in a captured graph: where each sits in
    the capture's buffers (a device buffer a dtype, allocated before the
    capture, so that no tensor of the graph shares its memory)."""

    def __init__(self, produce, rows, cap):
        self.produce = produce
        self.shape = [len(row) for row in rows]
        self.slots: Dict[torch.dtype, torch.Tensor] = {}
        counts: Dict[torch.dtype, int] = {}
        for row in rows:
            for _, dtype in row:
                counts[dtype] = counts.get(dtype, 0) + 1
        for dtype, n in counts.items():
            self.slots[dtype] = cap.take(dtype, n)
        self.layout = []                 # (dtype, index) a scalar, row-major
        seen: Dict[torch.dtype, int] = {}
        for row in rows:
            for _, dtype in row:
                self.layout.append((dtype, seen.get(dtype, 0)))
                seen[dtype] = seen.get(dtype, 0) + 1

    def views(self):
        it = iter(self.layout)
        return [[self.slots[d][i] for d, i in (next(it) for _ in range(n))]
                for n in self.shape]

    def write(self, rows):
        if [len(r) for r in rows] != self.shape:
            raise RuntimeError("to_static: a captured step's host scalars "
                               "changed shape (the parameters stepped "
                               "changed); the graph cannot replay it")
        values: Dict[torch.dtype, List[float]] = {d: [] for d in self.slots}
        for row in rows:
            for value, dtype in row:
                values[dtype].append(value)
        for dtype, slot in self.slots.items():
            # a fresh pinned tensor a copy: the host allocator keeps it
            # until the copy has run
            src = torch.tensor(values[dtype], dtype=dtype).pin_memory()
            slot.copy_(src, non_blocking=True)


def host_scalars(produce):
    """The scalars a step computes on the host: ``produce()`` returns rows
    of ``(value, dtype)`` and advances the host state they come from.
    Eagerly, the values (Python floats); a key's first call also counts
    them, so that its capture can set their buffers aside beforehand.
    Inside a capture, 0-d device tensors of those dtypes, which every
    replay refills from a new ``produce()``."""
    partial.notify_host_scalars()
    rows = produce()
    cap = getattr(_local, "capture", None)
    if cap is None:
        census = getattr(_local, "census", None)
        if census is not None:
            for row in rows:
                for _, dtype in row:
                    census[dtype] = census.get(dtype, 0) + 1
        return [[value for value, _ in row] for row in rows]
    feed = _Feed(produce, rows, cap)
    cap.feeds.append((feed, rows))
    return feed.views()


# --- discovery of the host state a capture may touch ----------------------

def _closure_objects(fn, acc, depth=0):
    """Objects a function reaches: its bound ``self``, closure cells, the
    globals it names, and (one level down) the functions among them."""
    if depth > 2 or fn is None:
        return acc
    owner = getattr(fn, "__self__", None)
    if owner is not None:
        acc.append(owner)
    fn = getattr(fn, "__func__", fn)
    code = getattr(fn, "__code__", None)
    if code is None:
        return acc
    found = [c.cell_contents for c in (fn.__closure__ or ())
             if _has_contents(c)]
    glb = getattr(fn, "__globals__", {})
    found += [glb[n] for n in code.co_names if n in glb]
    for obj in found:
        acc.append(obj)
        if callable(obj) and hasattr(obj, "__code__"):
            _closure_objects(obj, acc, depth + 1)
    return acc


def _has_contents(cell):
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


class _HostState:
    """What a capture may change on the host, to put back if it fails:
    parameters' gradients, optimizers' counters and slot dicts,
    schedulers' attributes."""

    def __init__(self, objects):
        # the optimizers import this module (host_scalars)
        from ..optimizer.lr import LRScheduler
        from ..optimizer.optimizer import Optimizer

        self.grads, self.opts, self.scheds = {}, {}, {}
        for obj in objects:
            if isinstance(obj, torch.nn.Module):
                for p in obj.parameters():
                    self.grads[p] = p.grad
            elif isinstance(obj, Optimizer):
                self.opts[obj] = (obj._step_count,
                                  {k: dict(v) for k, v in obj._state.items()})
                for p in obj._all_params():
                    self.grads[p] = p.grad
                if isinstance(obj._lr, LRScheduler):
                    self.scheds[obj._lr] = dict(obj._lr.__dict__)
            elif isinstance(obj, LRScheduler):
                self.scheds[obj] = dict(obj.__dict__)

    def restore(self):
        for p, g in self.grads.items():
            p.grad = g
        for opt, (count, state) in self.opts.items():
            opt._step_count = count
            opt._state = state
        for sched, attrs in self.scheds.items():
            sched.__dict__.clear()
            sched.__dict__.update(attrs)


# --- the program of one key -----------------------------------------------

class _Capture:
    """A capture in progress: its host feeds, and the buffers their
    scalars take, one a dtype, sized by the key's first call."""

    def __init__(self, device, census):
        self.feeds = []
        self.buffers = {d: torch.empty(n, dtype=d, device=device)
                        for d, n in census.items()}
        self.used = {d: 0 for d in census}

    def take(self, dtype, n):
        start = self.used.get(dtype, 0)
        if dtype not in self.buffers or start + n > len(self.buffers[dtype]):
            raise RuntimeError(
                f"to_static: the capture needs more {dtype} host scalars "
                f"than the first call computed")
        self.used[dtype] = start + n
        return self.buffers[dtype][start:start + n]


class _Program:
    """A key's captured graph: static inputs, outputs, host feeds and the
    counters' change a replay adds."""

    def __init__(self):
        self.graph = None
        self.inputs: List[torch.Tensor] = []
        self.outputs = None
        self.feeds: List[_Feed] = []
        self.delta = None


class _Pending:
    """A key whose first call ran eagerly: captured at its next call.
    ``census``: the host scalars that call computed, by dtype."""

    def __init__(self, census):
        self.census = census


def _tree_tensors(obj, acc):
    if isinstance(obj, torch.Tensor):
        acc.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tree_tensors(o, acc)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tree_tensors(o, acc)
    return acc


def _tree_map(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(v, fn) for k, v in obj.items()}
    return obj


def _prim_leaves(obj, acc):
    if isinstance(obj, torch.Tensor):
        pass
    elif isinstance(obj, (bool, int, float, str, bytes, type(None))):
        acc.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _prim_leaves(o, acc)
    elif isinstance(obj, dict):
        for k in obj:
            _prim_leaves(obj[k], acc)
    return acc


def _pow2_bucket(n: int) -> int:
    if n <= 1:
        return n
    return 1 << (n - 1).bit_length()


def _bucket_key(key):
    sig, mode, prims = key
    bsig = tuple((tuple(_pow2_bucket(d) for d in shape), dtype, dev)
                 for shape, dtype, dev in sig)
    bprims = tuple(_pow2_bucket(p) if isinstance(p, int)
                   and not isinstance(p, bool) else p for p in prims)
    return (bsig, mode, bprims)


def _detached(out):
    return _tree_map(out, lambda t: t.detach().clone())


def capture_graph(device, pool, run):
    """Capture ``run()`` into a CUDA graph in ``pool``, one capture in the
    process at a time and no garbage collection inside it; returns
    ``(graph, run's output, delta)``, ``delta`` the kernel counters'
    change over the capture, which is taken back (each replay adds it).
    When the capture fails, the caller's current stream and the device's
    generator (which ``torch.cuda.graph`` leaves on its capture stream and
    in capture mode when the capture was invalidated) and the counters are
    put back, and the error raised."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.current_stream(device)
    rng = torch.cuda.default_generators[
        device.index if device.index is not None
        else torch.cuda.current_device()]
    rng_before = rng.clone_state()
    before = counters.read()
    with _CAPTURE_LOCK:
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool):
                out = run()
        except Exception:
            torch.cuda.set_stream(stream)
            rng.graphsafe_set_state(rng_before)
            torch.cuda.synchronize(device)
            counters.write(before)
            raise
        finally:
            if collecting:
                gc.enable()
    delta = [a - b for a, b in zip(counters.read(), before)]
    counters.write(before)
    return graph, out, delta


def _break_site(exc) -> str:
    """The innermost frame of the caller's code in ``exc``'s traceback."""
    site = None
    tb = exc.__traceback__
    while tb is not None:
        fname = tb.tb_frame.f_code.co_filename
        if partial.users_file(fname):
            site = (f"{fname}:{tb.tb_lineno} in "
                    f"{tb.tb_frame.f_code.co_name}()")
        tb = tb.tb_next
    return site or "<unknown site>"


class StaticFunction:
    """The callable ``to_static`` returns (see the module docstring)."""

    def __init__(self, function, input_spec=None, build_strategy=None,
                 full_graph=False, backend=None):
        functools.update_wrapper(self, function)
        self._fn = function
        self._input_spec = input_spec
        self._full_graph = full_graph
        self._cache: Dict[Any, Any] = {}
        self._eager_keys: set = set()
        self._eager_buckets: set = set()
        self._eager_all = False
        # the trace store of each graph-broken key (jit/partial.py)
        self._partial: Dict[Any, partial.TraceStore] = {}
        self._partial_announced = False
        self._inlined: set = set()     # CPU keys run once after their build
        self._pool = None
        self.captures = 0
        self.segment_captures = 0
        self.replays = 0

    @property
    def concrete_program_cache(self):
        return self._cache

    def __get__(self, instance, owner):
        if instance is None:
            return self
        # one bound StaticFunction (its own cache) per instance
        per_inst = self.__dict__.setdefault("_bound", {})
        bound = per_inst.get(id(instance))
        if bound is None:
            bound = StaticFunction(self._fn.__get__(instance, owner),
                                   self._input_spec,
                                   full_graph=self._full_graph)
            per_inst[id(instance)] = bound
        return bound

    def _cache_key(self, args, kwargs):
        leaves = _tree_tensors([args, kwargs], [])
        sig = tuple((tuple(t.shape), str(t.dtype), t.device.type)
                    for t in leaves)
        owner = getattr(self._fn, "__self__", None)
        mode = (tuple(m.training for m in owner.modules())
                if isinstance(owner, torch.nn.Module) else None)
        return (sig, mode, tuple(_prim_leaves([args, kwargs], [])))

    def _device(self, args, kwargs):
        leaves = _tree_tensors([args, kwargs], [])
        if leaves:
            return leaves[0].device
        for obj in _closure_objects(self._fn, []):
            if isinstance(obj, torch.nn.Module):
                for p in obj.parameters():
                    return p.device
        return torch.device("cpu")

    def _name(self):
        return getattr(self._fn, "__name__", str(self._fn))

    def __call__(self, *args, **kwargs):
        from . import _ignored_modules

        ignored = getattr(self._fn, "__module__", None) in _ignored_modules
        if torch.compiler.is_exporting():
            return self._fn(*args, **kwargs)      # jit.save's trace
        if partial.in_recording():
            # a recording runs nested functions inline into its trace
            if ignored:
                partial.notify_ignored_module(self._name())
            return self._fn(*args, **kwargs)
        if in_to_static_trace():
            if ignored:
                raise IgnoredModuleError(
                    f"{self._name()!r} is from an ignore_module()d module "
                    f"and cannot be inlined into a to_static function")
            return self._fn(*args, **kwargs)      # nested: inline
        if ignored or not _enabled:
            return self._fn(*args, **kwargs)
        key = self._cache_key(args, kwargs)
        if self._eager_all or key in self._eager_keys:
            return self._fallback(key, args, kwargs)
        bucket = _bucket_key(key)
        if bucket in self._eager_buckets:
            # a same-structure signature already broke: the break is the
            # code's, not the shape's (not added to _eager_keys, which a
            # many-shape stream would grow without bound)
            return self._fallback(key, args, kwargs)
        device = self._device(args, kwargs)
        entry = self._cache.get(key)
        if entry is None:
            return self._first_call(key, bucket, args, kwargs, device)
        if device.type != "cuda":
            return self._inline(key, bucket, args, kwargs)
        if isinstance(entry, _Pending):
            return self._capture(key, bucket, args, kwargs, device,
                                 entry.census)
        return self._replay(entry, args, kwargs)

    def _traced(self, args, kwargs):
        _local.depth = getattr(_local, "depth", 0) + 1
        try:
            return self._fn(*args, **kwargs)
        finally:
            _local.depth -= 1

    def _first_call(self, key, bucket, args, kwargs, device):
        """The eager run of a key's first call, recorded: a break there
        sends the key to its trace store, else the key is built."""
        cuda = device.type == "cuda"
        rec = partial.TraceRecorder(_tree_tensors([args, kwargs], []))
        census = _local.census = {}
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            prev = torch.cuda.get_sync_debug_mode() if cuda else None
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                out = partial.record(rec, lambda: self._traced(args, kwargs))
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(prev)
                _local.census = None
        syncs = [w for w in seen if _SYNC_WARNING in str(w.message)]
        for w in seen:
            if w not in syncs:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        breaks = list(rec.breaks) + [
            (f"a host sync: {w.message}", f"{w.filename}:{w.lineno}")
            for w in syncs[:1]]
        if breaks:
            reason, site = breaks[0]
            if self._full_graph:
                raise GraphBreak(f"{reason} at {site}")
            err = GraphBreak(reason)
            self._record_break(key, bucket, err, site)
            if partial.partial_graph_enabled():
                self._store(key, device).adopt(rec, out)
            return out
        self._count_build()
        self._cache_insert(key, _Pending(census))
        return _detached(out)

    # --- CPU ---------------------------------------------------------------
    def _inline(self, key, bucket, args, kwargs):
        # The op bus sees a key's ops twice, as in the JAX package (its
        # discovery pass and its trace): the first call, then the capture
        # on the card or, here, the first inline run; later runs replay
        # (JAX runs the compiled program) and stay quiet.
        quiet = key in self._inlined
        self._inlined.add(key)
        try:
            with dispatch.quiet() if quiet else contextlib.nullcontext():
                return _detached(self._traced(args, kwargs))
        except IgnoredModuleError as e:
            return self._on_break(key, bucket, e, args, kwargs)

    # --- CUDA --------------------------------------------------------------
    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _capture(self, key, bucket, args, kwargs, device, census):
        prog = _Program()
        prog.inputs = [t.detach().clone() for t in
                       _tree_tensors([args, kwargs], [])]
        it = iter(prog.inputs)
        static_args, static_kwargs = _tree_map(
            (args, kwargs), lambda t: next(it).requires_grad_(
                t.requires_grad))
        host = _HostState(_closure_objects(self._fn, []) + list(
            _tree_tensors([args, kwargs], [])))
        cap = _Capture(device, census)
        _local.capture = cap
        try:
            graph, out, delta = capture_graph(
                device, self._graph_pool(),
                lambda: self._traced(static_args, static_kwargs))
            failed = None
        except Exception as e:   # noqa: BLE001 - any failed capture breaks
            failed = e
        finally:
            _local.capture = None
        if failed is not None:
            # the eager fallback runs with no capture in progress (its host
            # scalars are floats, not the capture's unwritten buffers)
            self._pool = None
            host.restore()
            if self._full_graph:
                raise failed
            self._cache.pop(key, None)
            return self._on_break(key, bucket, failed, args, kwargs)
        prog.delta = delta
        # detached: the captured tape would keep its AccumulateGrad nodes
        # (made on the capture stream) alive into later eager steps
        prog.graph, prog.outputs = graph, _tree_map(out, torch.Tensor.detach)
        for feed, rows in cap.feeds:
            feed.write(rows)
            prog.feeds.append(feed)
        self._cache[key] = prog
        self.captures += 1
        return self._launch(prog)

    def _segment_capture(self, device):
        """A trace store's capture: one segment into a graph of this
        function's pool."""
        def capture(run):
            try:
                graph, outs, delta = capture_graph(device, self._graph_pool(),
                                                   run)
            except Exception:
                self._pool = None
                raise
            self.segment_captures += 1
            return graph, outs, delta
        return capture

    def _replay(self, prog, args, kwargs):
        for buf, t in zip(prog.inputs, _tree_tensors([args, kwargs], [])):
            if buf.shape != t.shape or buf.dtype != t.dtype:
                raise ValueError(
                    f"to_static: an input of {tuple(t.shape)} {t.dtype} "
                    f"for a static input of {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(t.detach())
        for feed in prog.feeds:
            feed.write(feed.produce())
        return self._launch(prog)

    def _launch(self, prog):
        prog.graph.replay()
        counters.add(prog.delta)
        self.replays += 1
        return _detached(prog.outputs)

    # --- graph breaks --------------------------------------------------------
    def _store(self, key, device):
        """The key's trace store (made on first use; FIFO-bounded as the
        cache)."""
        store = self._partial.get(key)
        if store is None:
            def announce_once():
                first = not self._partial_announced
                self._partial_announced = True
                return first

            store = partial.TraceStore(
                self._name(),
                capture=(self._segment_capture(device)
                         if device.type == "cuda" else None),
                announce=announce_once)
            self._partial[key] = store
            while len(self._partial) > _CACHE_MAX_ENTRIES:
                self._partial.pop(next(iter(self._partial)))
        return store

    def _fallback(self, key, args, kwargs):
        """A graph-broken key's call: its trace store's replay, or plain
        eager with the partial graph switched off."""
        if not partial.partial_graph_enabled():
            return self._fn(*args, **kwargs)
        store = self._store(key, self._device(args, kwargs))
        return store.call(self._fn, args, kwargs,
                          _tree_tensors([args, kwargs], []))

    # --- bookkeeping --------------------------------------------------------
    def _count_build(self):
        get_registry().counter(
            "jit_builds_total",
            "to_static builds (one per new signature)").inc()

    def _cache_insert(self, key, entry):
        self._cache[key] = entry
        while len(self._cache) > _CACHE_MAX_ENTRIES:   # FIFO, as the JAX
            self._cache.pop(next(iter(self._cache)))

    def _on_break(self, key, bucket, err, args, kwargs):
        """A graph break found before the call ran: record it, then run the
        call through the key's trace store."""
        if self._full_graph:
            raise err
        self._record_break(key, bucket, err, _break_site(err))
        return self._fallback(key, args, kwargs)

    def _record_break(self, key, bucket, err, site):
        self._eager_keys.add(key)
        self._eager_buckets.add(bucket)
        fname = self._name()
        get_registry().counter(
            "jit_graph_breaks_total",
            "to_static signatures that fell back to partial/eager").inc()
        sig = ", ".join(f"{'x'.join(map(str, s))}:{d}"
                        for s, d, _ in key[0]) or "()"
        warnings.warn(
            f"to_static: graph break in {fname!r} at {site} "
            f"({type(err).__name__}: {err}) for signature [{sig}]; falling "
            f"back to partial-graph/eager execution for this signature "
            f"(other shapes/dtypes may still be captured)", stacklevel=4)
        if (len(self._eager_buckets) >= _EAGER_KEYS_LIMIT
                and not self._eager_all):
            self._eager_all = True
            warnings.warn(
                f"to_static: PERFORMANCE — {fname!r} graph-broke on "
                f"{_EAGER_KEYS_LIMIT} structurally distinct signatures and "
                f"now PERMANENTLY skips whole-graph capture (partial-graph "
                f"segment replay still applies where possible)",
                stacklevel=4)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=False, **kwargs):
    """Decorator / wrapper: a function, or a layer (whose ``forward`` it
    wraps).  ``full_graph=True`` raises on a graph break instead of
    falling back to eager."""

    def decorate(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn.forward, input_spec,
                                        full_graph=full_graph)
            return fn
        return StaticFunction(fn, input_spec, full_graph=full_graph)

    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def enable_to_static(flag: bool = True):
    """``False``: every ``to_static`` function runs eagerly (no capture, no
    cache entry) until it is set back."""
    global _enabled
    _enabled = bool(flag)
