"""Partial-graph execution after a ``to_static`` graph break: the port of
``paddle_tpu/jit/partial.py``.

When a function cannot be captured whole because its Python reads a value
from the device (``if float(x.max()) > 1.0``), the JAX package records one
eager run as a *linear trace*, cuts it into **segments** at the host sync
points, and replays the segments compiled on later calls, re-evaluating
only the host decisions.  The contract is the JAX package's:

* **Recording.**  A :class:`TraceRecorder` watches one eager run.  The JAX
  package records at its ``run_op`` bus; here a ``TorchDispatchMode``
  records every aten op (and registered op, such as the flash forward)
  with the tensors it reads and writes, and a ``TorchFunctionMode``
  watches what never reaches an aten op (``numpy()``, ``backward()``).
* **Syncs.**  ``.item()``, ``float()``, ``int()`` and ``bool()`` on a tensor
  all reach ``aten._local_scalar_dense``: each is a segment boundary, and
  its value a **guard**.  A replay goes on only while the fresh value
  equals the recorded one; a mismatch tries the next recorded trace or
  records a new one, at most :data:`_MAX_TRACES` a signature, after which
  the signature runs eagerly, with a warning.  A mismatch leaves no
  visible side effect: the tensors a trace writes in place are restored.
* **Rejected at record time**, never replayed with stale values: autograd
  activity (a ``backward``, a differentiable return), random draws (aten
  ops tagged ``nondeterministic_seeded``: dropout, ``bernoulli``,
  ``normal_``, ``rand``...), a tensor read into host Python (``numpy()``,
  ``tolist()``, a device-to-host copy), an op whose output shape depends on
  the data (``nonzero``), a tensor made from host data inside the function
  (``torch.tensor``, ``torch.from_numpy``: the counterpart of ``set_value``
  and ``copy_`` from the host), an optimizer's host scalars, a kernel
  launched through ``ctypes`` outside a registered op (the scale kernel,
  a ``cpp_extension`` host op: the dispatcher never sees them), and a
  call into an ``ignore_module``'d module.
* **In-place ops** on tensors that outlive the call (parameters, buffers,
  the arguments; ``fill_``, ``zero_``, ``add_``) replay into the same
  storage.

Replay.  On the CPU each segment replays its op list; on the card each
segment is a CUDA graph, captured at its first replay through
``jit/api.py``'s capture (one lock, the kernel counters' change taken back
and added at every replay, the caller's stream and the device's generator
restored when a capture fails), with the call's tensor arguments copied
into static buffers first.  Either way the Python body does not run again,
and outputs are detached copies.  Python side effects between segments
(prints, list appends) happen only while recording, as in the JAX package.

:func:`enable_partial_graph` is the counterpart of the JAX flag
``jit_partial_graph``: off, a broken signature runs plain eager.
"""

from __future__ import annotations

import os
import sys
import threading
import warnings
from typing import Any, Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

_MAX_TRACES = 3  # per signature; guard churn beyond this -> plain eager

_local = threading.local()
_enabled = True

_aten = torch.ops.aten
_SYNC = _aten._local_scalar_dense.default
_FRESH = (_aten.lift_fresh.default, _aten.lift_fresh_copy.default)
_TORCH_DIR = os.path.dirname(torch.__file__)
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_partial_graph(flag: bool = True) -> None:
    """The JAX flag ``jit_partial_graph``: ``False`` makes a graph-broken
    signature run plain eager (no recording, no replay)."""
    global _enabled
    _enabled = bool(flag)


def partial_graph_enabled() -> bool:
    return _enabled


def in_recording() -> bool:
    return getattr(_local, "recorder", None) is not None


def notify_ignored_module(fn_name: str) -> None:
    _local.recorder.on_ignored_module(fn_name)


def notify_opaque(name: str) -> None:
    """A kernel wrapper launched through ``ctypes``, which torch's
    dispatcher (and so the recording) does not see, unless it ran inside
    a registered op."""
    rec = getattr(_local, "recorder", None)
    if rec is not None and not rec.in_op:
        rec.die(f"{name} launched outside torch's dispatcher (a replay "
                f"would not run it)")


def notify_host_scalars() -> None:
    """``jit.host_scalars`` ran: its values would be baked into the trace."""
    rec = getattr(_local, "recorder", None)
    if rec is not None:
        rec.die("an optimizer's host scalars (the learning rate) were "
                "computed during recording (a replay would reuse this "
                "call's values)")


class GuardMismatch(Exception):
    """A sync value diverged from the recorded path."""


def users_file(fname: str) -> bool:
    """Whether code in ``fname`` is the caller's: not torch's, not this
    package's."""
    return not (fname.startswith(_TORCH_DIR) or fname.startswith(_PKG_DIR)
                or fname.startswith("<"))


def user_site() -> str:
    """The innermost frame of the caller's code, as ``file.py:line in
    function()``."""
    frame = sys._getframe(1)
    while frame is not None:
        if users_file(frame.f_code.co_filename):
            return (f"{frame.f_code.co_filename}:{frame.f_lineno} in "
                    f"{frame.f_code.co_name}()")
        frame = frame.f_back
    return "<unknown site>"


# --- recording ---------------------------------------------------------------

class _Op:
    __slots__ = ("func", "leaves", "spec", "out_ids")

    def __init__(self, func, leaves, spec, out_ids):
        self.func = func
        self.leaves = leaves    # ("t", id) or ("c", constant), flattened
        self.spec = spec        # the (args, kwargs) tree
        self.out_ids = out_ids  # an id (or None) per flattened output


class _Sync:
    __slots__ = ("tid", "value")

    def __init__(self, tid, value):
        self.tid = tid
        self.value = value


class TraceRecorder:
    """One eager run as a linear trace of ops and syncs.

    Tensors are named by a number given the first time the run sees them,
    held weakly (a dead tensor's number is never reused): ``arg_ids`` for
    the call's tensor arguments, ``captured`` for tensors that existed
    before the call (held strongly: parameters, buffers, closures).
    ``breaks`` lists what stops a whole-graph capture (syncs, host
    escapes), each with its site; ``dead`` the first reason the run cannot
    be replayed."""

    def __init__(self, arg_tensors: List[torch.Tensor]):
        self.events: List[Any] = []
        self._ids = WeakIdKeyDictionary()
        self._next = 0
        self.arg_ids = [self._name(t) for t in arg_tensors]
        self.captured: Dict[int, torch.Tensor] = {}
        self.mutated: Dict[int, torch.Tensor] = {}   # outliving, written
        # tensors made from host data inside the call, and every tensor
        # computed from them alone: host arithmetic (an optimizer's bias
        # correction), not part of the trace
        self.host: set = set()
        # tensors computed from no argument and no earlier tensor (host
        # data, factories such as arange): reading one is no sync
        self.const: set = set()
        self.breaks: List[tuple] = []
        self.dead: Optional[str] = None
        self.in_op = 0            # inside an op the dispatch mode runs
        self.rng: Optional[str] = None     # the first op that drew

    def _name(self, t) -> int:
        tid = self._ids.get(t)
        if tid is None:
            tid = self._ids[t] = self._next
            self._next += 1
        return tid

    def tensor_id(self, t) -> Optional[int]:
        return self._ids.get(t)

    def die(self, reason: str) -> None:
        if self.dead is None:      # the FIRST reason is the root cause
            self.dead = reason

    def brk(self, reason: str) -> None:
        self.breaks.append((reason, user_site()))

    def _input(self, t) -> int:
        tid = self._ids.get(t)
        if tid is None:                       # existed before the call
            tid = self._name(t)
            self.captured[tid] = t
        elif tid in self.host:
            self.die("a tensor made from host data inside the function "
                     "entered the trace (torch.tensor / from_numpy: the "
                     "counterpart of set_value; a replay would reuse this "
                     "call's value)")
        return tid

    def _written(self, t, tid) -> None:
        """``t`` (number ``tid``) was written in place: note the tensor
        that outlives the call behind it, if any."""
        base = t._base if t._base is not None else t
        bid = self._ids.get(base)
        if bid is None:
            bid = self._name(base)
            self.captured[bid] = base
        if bid in self.captured or bid in self.arg_ids:
            self.mutated[bid] = base

    # --- the dispatch mode's callback ----------------------------------------
    def on_op(self, func, args, kwargs, out):
        if func is _SYNC:
            if self._ids.get(args[0]) in self.const:
                return            # a value computed from constants alone
            self.brk(f"a host sync ({func.__name__})")
            if self.dead is None:
                self.events.append(_Sync(self._input(args[0]), out))
            return
        leaves, spec = torch.utils._pytree.tree_flatten((args, kwargs))
        outs = [o for o in torch.utils._pytree.tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        inputs = [self._ids.get(a) for a in leaves
                  if isinstance(a, torch.Tensor)]
        if func in _FRESH or (inputs and all(i in self.host
                                             for i in inputs)):
            names = {self._name(o) for o in outs}
            self.host |= names
            self.const |= names
            return
        constant = all(i in self.const for i in inputs)
        tags = func.tags
        if torch.Tag.dynamic_output_shape in tags and not constant:
            self.brk(f"an op whose output shape depends on the data "
                     f"({func.__name__})")
            self.die(f"{func.__name__} computed its output's shape on the "
                     f"host (a replay would reuse this call's shape)")
        if torch.Tag.nondeterministic_seeded in tags and self.rng is None:
            self.rng = func.__name__
        written = _written_tensors(func, args, kwargs)
        if self.dead is None:     # names the inputs first: captured ones
            kinds = [("t", self._input(leaf))
                     if isinstance(leaf, torch.Tensor) else ("c", leaf)
                     for leaf in leaves]
        for t in outs + written:
            (self.const.add if constant else self.const.discard)(
                self._name(t))
        if self.dead is not None:
            return
        for t in written:
            self._written(t, self._input(t))
        if any(o.device.type == "cpu" for o in outs) and any(
                isinstance(a, torch.Tensor) and a.device.type != "cpu"
                for a in leaves):
            self.die("a device-to-host copy escaped into host Python")
        out_ids = [self._name(o) if isinstance(o, torch.Tensor) else None
                   for o in torch.utils._pytree.tree_flatten(out)[0]]
        self.events.append(_Op(func, kinds, spec, out_ids))

    # --- the function mode's callbacks ----------------------------------------
    def on_escape(self, name, t):
        if self._ids.get(t) in self.const:
            return
        self.brk(f"a tensor read into host Python ({name}())")
        self.die(f"a tensor was converted to host data ({name}(): host "
                 f"data escape)")

    def on_backward(self):
        self.die("the autograd tape ran (eager backward closures capture "
                 "record-time values)")

    def on_ignored_module(self, fn_name):
        self.brk(f"ignore_module()'d function {fn_name!r}")
        self.die(f"ignore_module()'d function {fn_name!r} was called")


def _written_tensors(func, args, kwargs):
    """The tensors an op writes in place (its schema's ``Tensor(a!)``)."""
    schema = func._schema
    if not schema.is_mutable:
        return []
    out = []
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        if isinstance(value, torch.Tensor):
            out.append(value)
        elif isinstance(value, (list, tuple)):
            out.extend(v for v in value if isinstance(v, torch.Tensor))
    return out


class _Ops(TorchDispatchMode):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.rec.in_op += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.rec.in_op -= 1
        self.rec.on_op(func, args, kwargs, out)
        return out


class _Watch(TorchFunctionMode):
    def __init__(self, rec):
        super().__init__()
        self.rec = rec
        self.escapes = {torch.Tensor.numpy: "numpy",
                        torch.Tensor.__array__: "__array__",
                        torch.Tensor.tolist: "tolist"}
        self.autograd = {torch.Tensor.backward, torch.autograd.backward,
                         torch.autograd.grad}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.escapes:
            self.rec.on_escape(self.escapes[func], args[0])
        elif func in self.autograd:
            self.rec.on_backward()
        return func(*args, **(kwargs or {}))


def record(rec: TraceRecorder, run):
    """``run()`` under ``rec``; nested ``to_static`` calls inside it run
    inline into the same trace."""
    outer = getattr(_local, "recorder", None)
    _local.recorder = rec
    try:
        with _Watch(rec), _Ops(rec):
            return run()
    finally:
        _local.recorder = outer


def finish(rec: TraceRecorder, result) -> Optional[str]:
    """The reason the recorded run cannot be replayed, judged with its
    result, or None."""
    if rec.dead is not None:
        return rec.dead
    if rec.rng is not None:     # judged after the run, as the JAX package
        return (f"RNG state advanced ({rec.rng}; a replay would freeze the "
                f"draws, e.g. dropout in train mode)")
    from .api import _tree_tensors

    for t in _tree_tensors(result, []):
        tid = rec.tensor_id(t)
        if tid is not None and tid in rec.host:
            return ("a tensor made from host data is returned from the "
                    "function")
        if t.requires_grad:
            # a replayed result has no grad node: handing it to a later
            # backward() would silently train nothing
            return ("the function returns a differentiable tensor "
                    "(requires_grad=True); replayed results detach from "
                    "the autograd tape, which would silently break a "
                    "later backward() — run eagerly, or wrap the call in "
                    "no_grad()")
    return None


# --- segments and replay ------------------------------------------------------

class _Segment:
    """The ops between two syncs.  ``graph`` is its CUDA graph once
    captured (the card); on the CPU it stays None."""

    def __init__(self, nodes, out_ids, sync: Optional[_Sync]):
        self.nodes = nodes
        self.out_ids = out_ids
        self.sync = sync
        self.graph = None
        self.outputs: List[torch.Tensor] = []
        self.delta = None

    def replay_ops(self, env):
        for ev in self.nodes:
            leaves = [env[x] if kind == "t" else x for kind, x in ev.leaves]
            args, kwargs = torch.utils._pytree.tree_unflatten(leaves, ev.spec)
            out = ev.func(*args, **kwargs)
            outs, _ = torch.utils._pytree.tree_flatten(out)
            for oid, o in zip(ev.out_ids, outs):
                if oid is not None:
                    env[oid] = o
        return [env[i] for i in self.out_ids]

    def run(self, env, capture=None):
        if not self.nodes:
            return
        if capture is None:
            self.replay_ops(env)
            return
        if self.graph is None:
            self.graph, self.outputs, self.delta = capture(
                lambda: self.replay_ops(env))
        from ..ops import counters

        self.graph.replay()
        counters.add(self.delta)
        env.update(zip(self.out_ids, self.outputs))


class LinearTrace:
    """A recorded, segmented, guarded trace for one signature and path."""

    def __init__(self, rec: TraceRecorder, result):
        self.arg_ids = rec.arg_ids
        self.captured = dict(rec.captured)
        self.mutated = dict(rec.mutated)
        self.static_args: Optional[List[torch.Tensor]] = None
        result_ids: List[int] = []

        def template(obj):
            if isinstance(obj, torch.Tensor):
                tid = rec.tensor_id(obj)
                if tid is None:                  # returned, never read
                    tid = rec._name(obj)
                    self.captured[tid] = obj
                result_ids.append(tid)
                return ("__tensor__", tid)
            if isinstance(obj, (list, tuple)):
                return type(obj)(template(o) for o in obj)
            if isinstance(obj, dict):
                return {k: template(v) for k, v in obj.items()}
            return obj

        self.result_template = template(result)
        self.segments = self._segment(rec.events, result_ids)
        self.n_compiled_ops = sum(len(s.nodes) for s in self.segments)

    def _segment(self, events, result_ids) -> List[_Segment]:
        chunks, cur = [], []
        for ev in events:
            if isinstance(ev, _Sync):
                chunks.append((cur, ev))
                cur = []
            else:
                cur.append(ev)
        chunks.append((cur, None))
        # walked backwards: each segment exports what later segments,
        # syncs and the result consume
        needed_after = set(result_ids)
        exports = [set() for _ in chunks]
        for i in range(len(chunks) - 1, -1, -1):
            nodes, sync = chunks[i]
            produced, consumed = set(), set()
            for ev in nodes:
                consumed.update(x for kind, x in ev.leaves if kind == "t")
                produced.update(t for t in ev.out_ids if t is not None)
            need_here = set(needed_after)
            if sync is not None:
                need_here.add(sync.tid)
            exports[i] = produced & need_here
            needed_after = (need_here - produced) | consumed
        return [_Segment(nodes, sorted(outs), sync)
                for (nodes, sync), outs in zip(chunks, exports)]

    def replay(self, current_args: List[torch.Tensor], capture=None):
        """Run the segments on ``current_args``; ``capture`` (the card)
        turns each segment into a CUDA graph at its first run.  Raises
        :class:`GuardMismatch` when a sync value differs, after putting
        back what the run wrote in place."""
        env: Dict[int, Any] = dict(self.captured)
        if capture is None:
            env.update(zip(self.arg_ids, current_args))
        else:
            if self.static_args is None:
                self.static_args = [t.detach().clone() for t in current_args]
            for buf, t in zip(self.static_args, current_args):
                buf.copy_(t.detach())
            env.update(zip(self.arg_ids, self.static_args))
        kept = {tid: env[tid].detach().clone() for tid in self.mutated
                if tid in self.captured or capture is None}
        try:
            with torch.no_grad():
                for seg in self.segments:
                    seg.run(env, capture)
                    s = seg.sync
                    if s is not None:
                        fresh = env[s.tid].item()
                        if fresh != s.value:
                            raise GuardMismatch(
                                f"sync: recorded {s.value!r}, got {fresh!r}")
        except BaseException:
            with torch.no_grad():
                for tid, value in kept.items():
                    env[tid].copy_(value)
            raise
        if capture is not None:                 # arguments written
            with torch.no_grad():
                for tid, t in zip(self.arg_ids, current_args):
                    if tid in self.mutated:
                        t.copy_(env[tid])

        def rebuild(obj):
            if isinstance(obj, tuple) and len(obj) == 2 \
                    and obj[0] == "__tensor__":
                return env[obj[1]].detach().clone()
            if isinstance(obj, (list, tuple)):
                return type(obj)(rebuild(o) for o in obj)
            if isinstance(obj, dict):
                return {k: rebuild(v) for k, v in obj.items()}
            return obj

        return rebuild(self.result_template)


class TraceStore:
    """Per-signature store: the recorded traces (one per guard path).

    ``capture`` (the card) turns a segment into a CUDA graph; ``announce``
    is consulted before the informational "compiled a partial graph"
    warning, so that the owning function gives it once."""

    def __init__(self, fn_name: str, capture=None, announce=None):
        self.fn_name = fn_name
        self.capture = capture
        self.announce = announce
        self.traces: List[LinearTrace] = []
        self.dead: Optional[str] = None

    def call(self, fn, args, kwargs, arg_tensors):
        if self.dead is not None:
            return fn(*args, **kwargs)
        for trace in self.traces:
            try:
                return trace.replay(arg_tensors, self.capture)
            except GuardMismatch:
                continue
            except Exception as e:   # noqa: BLE001 - the signature goes eager
                # a trace that cannot replay (a capture refused) disqualifies
                # partial mode for this signature
                self.dead = f"segment replay failed: {type(e).__name__}: {e}"
                warnings.warn(
                    f"to_static[{self.fn_name}]: partial-graph replay "
                    f"failed ({self.dead}); this signature now runs fully "
                    f"eagerly.", RuntimeWarning, stacklevel=3)
                return fn(*args, **kwargs)
        if len(self.traces) >= _MAX_TRACES:
            self.dead = (f"guards diverged on {_MAX_TRACES} recorded paths "
                         f"(an unstable host scalar steers this function, "
                         f"e.g. float(loss) compared each step)")
            warnings.warn(
                f"to_static[{self.fn_name}]: PERFORMANCE — {self.dead}; "
                f"this signature now runs fully eagerly.", RuntimeWarning,
                stacklevel=3)
            return fn(*args, **kwargs)
        rec = TraceRecorder(arg_tensors)
        result = record(rec, lambda: fn(*args, **kwargs))
        self.adopt(rec, result)
        return result

    def adopt(self, rec: TraceRecorder, result) -> None:
        """Keep ``rec``'s run (already executed, ``result`` its output) as
        a trace, or mark the signature eager with the reason."""
        dead = finish(rec, result)
        if dead is not None:
            self.dead = dead
            warnings.warn(
                f"to_static[{self.fn_name}]: cannot build a partial graph: "
                f"{dead}; this signature runs fully eagerly.",
                RuntimeWarning, stacklevel=4)
            return
        trace = LinearTrace(rec, result)
        self.traces.append(trace)
        from ..observability import get_registry, get_tracer

        get_registry().counter(
            "jit_partial_traces_total",
            "partial-graph linear traces recorded around graph breaks").inc()
        get_tracer().instant(
            "partial_trace_recorded", cat="jit", function=self.fn_name,
            segments=len(trace.segments), compiled_ops=trace.n_compiled_ops)
        if self.announce is None or self.announce():
            warnings.warn(
                f"to_static[{self.fn_name}]: compiled a partial graph around "
                f"the break: {len(trace.segments)} segment(s), "
                f"{trace.n_compiled_ops} ops staged; host sync points "
                f"re-evaluated per call with value guards.", RuntimeWarning,
                stacklevel=4)
