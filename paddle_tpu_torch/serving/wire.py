"""Cross-process fleet wire protocol (the port of
``paddle_tpu/serving/wire.py``, stdlib code carried over whole).  Both
halves are live: the socket half carries the cross-process fleet's
traffic between the router (``serving/procfleet.py``) and its worker
processes (``serving/worker.py``), and the KV hand-off's frame codec
(``kv_run_frames`` / ``kv_run_assemble``, used by
``handoff.run_to_frames`` / ``run_from_frames``) moves KV runs across
that socket.

Length-prefixed JSON frames over localhost sockets: every frame is a
4-byte big-endian payload length followed by one UTF-8 JSON object
carrying a ``"type"`` key.  The protocol is deliberately boring — the
interesting contracts are the FAILURE shapes, because the router's
self-healing machinery keys off them:

* **versioned handshake** — the first frame on every connection is a
  ``hello`` carrying :data:`WIRE_VERSION`, the connection role
  (``engine`` drives submit/abort/step; ``control`` drives
  health/debug/drain), and the AOT manifest hash the client expects the
  worker to serve from.  A version or manifest-hash mismatch is answered
  with an ``error`` frame and a closed CONNECTION — the worker process
  stays alive (a stale router must not take down a healthy replica);
* **per-connection error isolation** — malformed JSON, a truncated
  frame, or an oversized length prefix poisons only the connection it
  arrived on (best-effort ``error`` frame, then close).  Every such
  failure is counted under ``serving_wire_errors_total{kind=...}``;
* **clean vs dirty EOF** — EOF on a frame boundary raises
  :class:`ConnectionClosed` (a graceful hangup); EOF mid-header or
  mid-payload raises :class:`FrameError` kind ``truncated`` (the peer
  died mid-frame — exactly what a ``kill -9`` looks like from the
  router's side, and what flips a ``WorkerEngineProxy``
  (``serving/procfleet.py``) into its death path).

Frame vocabulary (``serving/worker.py`` gives the server-side
semantics):
``hello``/``hello_ok``, ``submit``/``submit_ok``, ``abort``/``abort_ok``,
``step`` → zero or more streamed ``token`` frames then ``step_done`` (or
``step_error``), ``health``/``health_ok``, ``drain``/``drain_ok``,
``debug``/``debug_ok``, ``set_fault``/``ok``, ``shutdown``/``ok``,
``error``.

Telemetry piggybacking:

* ``step_done``/``step_error``/``submit_ok``/``abort_ok``/``health_ok``
  may carry ``telemetry`` — a bounded, sequence-numbered delta of the
  worker engine's lifecycle events (``{"events": [...], "dropped": n}``)
  the router merges idempotently
  (``DeltaMerger`` of ``observability/distrib.py``);
* ``step_done`` may carry ``t`` — worker-clock timestamps
  ``{"recv","eng0","eng1","reply"}`` feeding the router's
  host-vs-wire-vs-engine attribution
  (``WireStats``, the same module) — and
  ``step_record``, the worker's stepprof record for the step;
* a ``health`` frame may carry ``t0`` (router clock); the worker echoes
  it on ``health_ok`` with ``t1`` (receipt) and ``t2`` (just before
  send), completing an NTP-style ``(t0,t1,t2,t3)`` clock-sync sample
  (``ClockSync``, the same module).
"""

from __future__ import annotations

import base64
import json
import math
import socket
import struct
import threading
from typing import Dict, List, Optional, Tuple

WIRE_VERSION = 1

# worker boot-protocol stdout markers (canonical home here so the
# router side never imports the worker module — `python -m
# paddle_tpu_torch.serving.worker` must own it as __main__)
READY_PREFIX = "PADDLE_TPU_WORKER_READY"
CACHE_PREFIX = "PADDLE_TPU_COMPILE_CACHE"

# one frame carries at most this many payload bytes (a step_done frame
# embeds a full worker metrics dump — generous, but bounded: a length
# prefix past this is hostile/corrupt, not big)
MAX_FRAME_BYTES = 8 << 20

_HEADER = struct.Struct(">I")

# metric names this module owns (tools/check_metrics_docs lints that
# each appears in README's metrics table)
METRIC_NAMES = (
    "serving_wire_frames_total",
    "serving_wire_errors_total",
)

# bounded error-kind label vocabulary for serving_wire_errors_total
ERROR_KINDS = ("closed", "truncated", "oversized", "malformed",
               "version_mismatch", "aot_mismatch", "deploy_mismatch",
               "protocol", "io")


class WireError(RuntimeError):
    """Base class for wire-protocol failures."""

    kind = "io"


class ConnectionClosed(WireError):
    """EOF on a frame boundary: the peer hung up cleanly."""

    kind = "closed"


class FrameError(WireError):
    """A frame that cannot be decoded: truncated (EOF mid-frame — the
    ``kill -9`` signature), oversized (length prefix past the cap), or
    malformed (not a JSON object with a ``type``)."""

    def __init__(self, kind: str, detail: str):
        super().__init__(f"{kind}: {detail}")
        self.kind = kind


class HandshakeMismatch(WireError):
    """The two ends disagree on protocol version or AOT manifest hash —
    answered with an ``error`` frame; the connection dies, the worker
    does not."""

    def __init__(self, code: str, detail: str):
        super().__init__(f"{code}: {detail}")
        self.kind = code
        self.code = code


def error_frame(code: str, detail: str) -> Dict:
    return {"type": "error", "code": str(code), "detail": str(detail)[:2000]}


def hello_frame(role: str, aot_hash: Optional[str],
                deploy: Optional[Dict] = None) -> Dict:
    """``deploy`` is the caller's deployment identity: ``{"mp": int,
    "spec": manifest_dict|None, "role": str, "model": dict|None}``.  ``None``
    means "default single-chip, spec off" — an old peer that never sends
    the field is indistinguishable from one that runs the defaults,
    which is exactly the interop we want."""
    return {"type": "hello", "version": WIRE_VERSION, "role": role,
            "aot_hash": aot_hash, "deploy": deploy}


def canonical_deploy(deploy: Optional[Dict]) -> Optional[Dict]:
    """Normalize a deployment-identity dict for comparison: the default
    shape (mp=1, spec decoding off, unified role) collapses to ``None``
    so a peer that predates the field and one that runs the defaults
    agree.  ``role`` rides the same rule: ``"unified"`` (or
    absent) drops out of the dict, so a role-less old peer and a
    unified-role new peer still shake hands.  ``model`` is the port's
    own: the model a worker builds (:func:`model_identity`), absent
    for the defaults."""
    if not deploy:
        return None
    out = {"mp": int(deploy.get("mp", 1) or 1),
           "spec": deploy.get("spec") or None}
    role = str(deploy.get("role") or "unified")
    if role != "unified":
        out["role"] = role
    if deploy.get("model"):
        # the port's model identity (preset, dtype, device, weights file;
        # :func:`model_identity`): a worker built from another spec
        # than the router's must not shake hands either
        out["model"] = {str(k): v for k, v in sorted(
            deploy["model"].items())}
    if out["mp"] == 1 and out["spec"] is None and "role" not in out \
            and "model" not in out:
        return None
    if out["spec"] is not None:
        # JSON round-trips must compare equal: coerce the manifest's
        # values through int (they are all counts/flags by contract)
        out["spec"] = {str(k): int(v) for k, v in out["spec"].items()}
    return out


# the port's worker-spec keys naming the model a worker builds, where and
# from what weights (``serving/worker.py``)
MODEL_KEYS = ("preset", "dtype", "device", "weights", "max_seq_len")


def model_identity(spec: Dict) -> Optional[Dict]:
    """The port's part of a worker's deployment identity: the model
    preset, dtype, device, weights file and position limit a worker spec
    asks for, or ``None`` for the defaults (tiny, float32, the card,
    seeded weights).  The router and the worker compute it from the same
    spec, so a worker built from another spec refuses the router's hello
    with ``deploy_mismatch``."""
    out = {k: spec[k] for k in MODEL_KEYS if spec.get(k) is not None}
    if out.get("preset") == "tiny":
        del out["preset"]
    if out.get("dtype") == "float32":
        del out["dtype"]
    if "max_seq_len" in out:
        out["max_seq_len"] = int(out["max_seq_len"])
    return out or None


def check_hello(frame: Dict, aot_hash: Optional[str],
                deploy: Optional[Dict] = None) -> str:
    """Worker-side handshake validation: returns the connection role or
    raises :class:`HandshakeMismatch` (the caller answers with
    :func:`error_frame` and closes the connection — never the process)."""
    if not isinstance(frame, dict) or frame.get("type") != "hello":
        raise HandshakeMismatch(
            "protocol", f"expected a hello frame, got "
                        f"{frame.get('type') if isinstance(frame, dict) else frame!r}")
    if frame.get("version") != WIRE_VERSION:
        raise HandshakeMismatch(
            "version_mismatch",
            f"peer speaks wire version {frame.get('version')!r}, this "
            f"worker speaks {WIRE_VERSION}")
    theirs = frame.get("aot_hash") or None
    ours = aot_hash or None
    if theirs != ours:
        raise HandshakeMismatch(
            "aot_mismatch",
            f"peer expects AOT manifest hash {str(theirs)[:16]!r}, this "
            f"worker serves {str(ours)[:16]!r} — the router and worker "
            "must share ONE artifact")
    their_dep = canonical_deploy(frame.get("deploy"))
    our_dep = canonical_deploy(deploy)
    if their_dep != our_dep:
        # mesh-slice shape (mp) or spec-decoding config drift between
        # the router and a worker: refuse the CONNECTION, exactly like
        # an aot_mismatch — a typed, connection-scoped rejection the
        # supervisor can see, never a poisoned half-configured fleet
        raise HandshakeMismatch(
            "deploy_mismatch",
            f"peer deploys {their_dep!r}, this worker deploys "
            f"{our_dep!r} — mp degree and spec-decoding config must "
            "match fleet-wide")
    role = frame.get("role")
    if role not in ("engine", "control"):
        raise HandshakeMismatch(
            "protocol", f"unknown connection role {role!r} "
                        "(expected 'engine' or 'control')")
    return role


class Connection:
    """One framed socket endpoint.  Sends are serialized under a lock
    (the control connection is shared by the heartbeat thread and HTTP
    debug handlers); receives are single-reader by convention.  When a
    registry is supplied, traffic lands on
    ``serving_wire_frames_total{direction,side,...}`` and failures on
    ``serving_wire_errors_total{kind,side,...}``."""

    def __init__(self, sock: socket.socket, registry=None,
                 labels: Optional[Dict[str, str]] = None,
                 side: str = "router", max_frame: int = MAX_FRAME_BYTES):
        self._sock = sock
        self._wlock = threading.Lock()
        self.max_frame = int(max_frame)
        self._registry = registry
        self._labels = dict(labels or {})
        self._labels["side"] = side
        self._tx = self._rx = None
        if registry is not None:
            self._tx = registry.counter(
                "serving_wire_frames_total",
                "frames sent/received on fleet wire connections",
                direction="tx", **self._labels)
            self._rx = registry.counter(
                "serving_wire_frames_total",
                "frames sent/received on fleet wire connections",
                direction="rx", **self._labels)

    def count_error(self, kind: str) -> None:
        if self._registry is not None:
            if kind not in ERROR_KINDS:
                kind = "io"
            self._registry.counter(
                "serving_wire_errors_total",
                "wire-protocol failures by kind (truncated/oversized/"
                "malformed frames, handshake mismatches, socket errors)",
                kind=kind, **self._labels).inc()

    # --- framed I/O ---------------------------------------------------------
    def send(self, obj: Dict) -> None:
        try:
            payload = json.dumps(obj).encode("utf-8")
        except (TypeError, ValueError) as e:
            raise FrameError("malformed", f"unserializable frame: {e}")
        if len(payload) > self.max_frame:
            self.count_error("oversized")
            raise FrameError(
                "oversized", f"frame of {len(payload)} bytes exceeds the "
                             f"{self.max_frame}-byte cap")
        try:
            with self._wlock:
                self._sock.sendall(_HEADER.pack(len(payload)) + payload)
        except OSError as e:
            self.count_error("io")
            raise WireError(f"send failed: {e}") from e
        if self._tx is not None:
            self._tx.inc()

    def _recv_exact(self, n: int, boundary: bool) -> bytes:
        buf = b""
        while len(buf) < n:
            try:
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout:
                raise
            except OSError as e:
                self.count_error("io")
                raise WireError(f"recv failed: {e}") from e
            if not chunk:
                if boundary and not buf:
                    self.count_error("closed")
                    raise ConnectionClosed("peer closed the connection")
                self.count_error("truncated")
                raise FrameError(
                    "truncated",
                    f"EOF after {len(buf)}/{n} bytes — the peer died "
                    "mid-frame")
            buf += chunk
        return buf

    def recv(self) -> Dict:
        header = self._recv_exact(_HEADER.size, boundary=True)
        (length,) = _HEADER.unpack(header)
        if length > self.max_frame:
            self.count_error("oversized")
            raise FrameError(
                "oversized", f"length prefix {length} exceeds the "
                             f"{self.max_frame}-byte cap")
        payload = self._recv_exact(length, boundary=False)
        try:
            obj = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            self.count_error("malformed")
            raise FrameError("malformed", f"undecodable frame: {e}")
        if not isinstance(obj, dict) or "type" not in obj:
            self.count_error("malformed")
            raise FrameError(
                "malformed", "frame is not a JSON object with a 'type'")
        if self._rx is not None:
            self._rx.inc()
        return obj

    def request(self, obj: Dict) -> Dict:
        """One call-response round trip (caller guarantees exclusive use
        of the connection for the duration — the proxy's locks do)."""
        self.send(obj)
        return self.recv()

    def settimeout(self, s: Optional[float]) -> None:
        self._sock.settimeout(s)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass  # swallow-ok: closing a dead socket; the connection is being discarded either way


def connect(host: str, port: int, role: str, aot_hash: Optional[str],
            registry=None, labels: Optional[Dict[str, str]] = None,
            side: str = "router", timeout: Optional[float] = 30.0,
            max_frame: int = MAX_FRAME_BYTES,
            deploy: Optional[Dict] = None) -> Connection:
    """Dial a worker and complete the client half of the handshake.
    Raises :class:`HandshakeMismatch` when the worker answers with an
    ``error`` frame (version/AOT-hash disagreement)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn = Connection(sock, registry=registry, labels=labels, side=side,
                      max_frame=max_frame)
    conn.settimeout(timeout)
    try:
        reply = conn.request(hello_frame(role, aot_hash, deploy=deploy))
    except WireError:
        conn.close()
        raise
    if reply.get("type") == "error":
        code = str(reply.get("code", "protocol"))
        conn.count_error(code if code in ERROR_KINDS else "protocol")
        conn.close()
        raise HandshakeMismatch(code, str(reply.get("detail", "")))
    if reply.get("type") != "hello_ok":
        conn.count_error("protocol")
        conn.close()
        raise FrameError("protocol",
                         f"expected hello_ok, got {reply.get('type')!r}")
    conn.settimeout(None)
    return conn


# --- KV block-stream frames --------------------------------------
# A KV run (serving/handoff.py) ships as one ``kv_run_begin`` frame —
# block metadata (chain-hash hex, depth, tokens), payload digest, byte
# count, chunk count — followed by exactly ``chunks`` base64
# ``kv_run_chunk`` frames.  Raw chunks are capped well under
# MAX_FRAME_BYTES so the base64 expansion (4/3) plus JSON overhead never
# trips the oversized guard.
KV_CHUNK_BYTES = 4 << 20


def kv_run_frames(meta: Dict, blocks: List, payload: bytes,
                  digest_hex: str) -> List[Dict]:
    """Frame a serialized KV run for the wire: ``meta`` is the pool
    compatibility header, ``blocks`` the JSON-able block records
    (``[hash_hex, depth, [tokens...]]`` rows), ``payload`` the raw
    gathered KV bytes."""
    chunks = [payload[i:i + KV_CHUNK_BYTES]
              for i in range(0, len(payload), KV_CHUNK_BYTES)] or [b""]
    frames: List[Dict] = [{
        "type": "kv_run_begin", "meta": dict(meta), "blocks": blocks,
        "digest": str(digest_hex), "bytes": len(payload),
        "chunks": len(chunks)}]
    for i, c in enumerate(chunks):
        frames.append({"type": "kv_run_chunk", "seq": i,
                       "data": base64.b64encode(c).decode("ascii")})
    return frames


def kv_run_assemble(begin: Dict, chunks: List[Dict]) -> bytes:
    """Reassemble a KV run's payload bytes from its frames, validating
    the chunk protocol: mistyped/misordered chunks raise
    :class:`FrameError` kind ``protocol``, undecodable base64 kind
    ``malformed``, and a byte-count shortfall kind ``truncated`` — the
    same typed vocabulary every other frame failure uses, so the worker
    answers with a typed error and SURVIVES."""
    if begin.get("type") != "kv_run_begin":
        raise FrameError(
            "protocol",
            f"expected kv_run_begin, got {begin.get('type')!r}")
    want = int(begin.get("chunks", 0))
    if len(chunks) != want:
        raise FrameError(
            "truncated",
            f"kv run carries {len(chunks)} of {want} chunk frame(s)")
    parts: List[bytes] = []
    for i, fr in enumerate(chunks):
        if fr.get("type") != "kv_run_chunk" or int(fr.get("seq", -1)) != i:
            raise FrameError(
                "protocol",
                f"kv run chunk {i} is mistyped or out of order")
        try:
            parts.append(base64.b64decode(fr.get("data", ""),
                                          validate=True))
        except (ValueError, TypeError) as e:
            raise FrameError(
                "malformed", f"kv run chunk {i} is not valid base64: {e}")
    payload = b"".join(parts)
    if len(payload) != int(begin.get("bytes", -1)):
        raise FrameError(
            "truncated",
            f"kv run payload is {len(payload)} bytes, the header "
            f"promised {begin.get('bytes')}")
    return payload


# --- registry dump/merge shapes ---------------------------------------------
def dump_registry(registry) -> List[Dict]:
    """JSON-able dump of every series in ``registry``, exact enough for
    the router to merge losslessly: counters ship their value (the
    router applies monotonic deltas), gauges ship their full streaming
    aggregate, histograms ship their NON-cumulative bucket counts so the
    router can merge them bucket-by-bucket (no quantile re-derivation).
    Collect hooks run first, matching every other rendering path."""
    registry.run_collect_hooks()
    rows: List[Dict] = []
    for m in registry.series():
        row = {"name": m.name, "kind": m.kind, "help": m.help,
               "labels": [list(kv) for kv in m.labels]}
        if m.kind == "counter":
            row["value"] = m.value
        elif m.kind == "gauge":
            with m._lock:
                row.update(value=m._value, samples=m.samples,
                           total=m.total,
                           max=None if m.samples == 0 else m.max,
                           min=None if m.samples == 0 else m.min)
        elif m.kind == "histogram":
            with m._lock:
                row.update(bounds=list(m.bounds), counts=list(m._counts),
                           count=m.count, sum=m.sum,
                           max=None if m.count == 0 else m.max,
                           min=None if m.count == 0 else m.min)
        else:
            continue
        rows.append(row)
    return rows


class RegistryMerger:
    """Applies one worker's :func:`dump_registry` rows into the router's
    registry.  Per-(series) delta state makes counter/histogram merges
    idempotent-monotonic: re-sent values add nothing, and a RESPAWNED
    worker (fresh process, counters back at zero) simply contributes
    fresh deltas — accumulated fleet history is never regressed.  One
    merger per worker incarnation (the proxy builds a new one per
    spawn), so the delta baselines reset exactly when the worker's
    counters do.

    Only rows carrying this replica's ``replica`` label are merged: the
    worker exclusively owns those series fleet-wide, which is what makes
    verbatim gauge copies and bucket-exact histogram merges correct.
    Unlabeled worker-local series (its private lifecycle tracker, ...)
    stay worker-local."""

    def __init__(self, registry, replica_label: str):
        self._registry = registry
        self._replica = str(replica_label)
        self._last_counter: Dict = {}    # unbounded-ok: keyed by the worker's bounded (max_series-capped) series set
        self._last_hist: Dict = {}       # unbounded-ok: keyed by the worker's bounded (max_series-capped) series set
        self.errors = 0

    def merge(self, rows: List[Dict]) -> None:
        for row in rows:
            try:
                self._merge_row(row)
            except Exception:
                # a malformed row must not poison the rest of the dump;
                # surfaced as a counted error the tests assert on
                self.errors += 1
                self._registry.counter(
                    "serving_wire_errors_total",
                    "wire-protocol failures by kind",
                    kind="malformed", side="router",
                    replica=self._replica).inc()

    def _merge_row(self, row: Dict) -> None:
        labels = {str(k): str(v) for k, v in (row.get("labels") or [])}
        if labels.get("replica") != self._replica:
            return
        name, kind = row["name"], row["kind"]
        key = (name, tuple(sorted(labels.items())))
        help = row.get("help", "")
        if kind == "counter":
            c = self._registry.counter(name, help, **labels)
            v = float(row["value"])
            delta = v - self._last_counter.get(key, 0.0)
            if delta > 0:
                c.inc(delta)
            self._last_counter[key] = v
        elif kind == "gauge":
            g = self._registry.gauge(name, help, **labels)
            with g._lock:
                g._value = float(row["value"])
                g.samples = int(row["samples"])
                g.total = float(row["total"])
                g.max = (-math.inf if row["max"] is None
                         else float(row["max"]))
                g.min = (math.inf if row["min"] is None
                         else float(row["min"]))
        elif kind == "histogram":
            bounds = tuple(float(b) for b in row["bounds"])
            h = self._registry.histogram(name, help, buckets=bounds,
                                         **labels)
            if tuple(h.bounds) != bounds:
                raise ValueError(f"bucket bounds drifted for {name}")
            counts = [int(c) for c in row["counts"]]
            lastc, lastn, lasts = self._last_hist.get(
                key, ([0] * len(counts), 0, 0.0))
            with h._lock:
                for i in range(min(len(counts), len(h._counts))):
                    h._counts[i] += max(0, counts[i] - lastc[i])
                h.count += max(0, int(row["count"]) - lastn)
                h.sum += max(0.0, float(row["sum"]) - lasts)
                if row["max"] is not None:
                    h.max = max(h.max, float(row["max"]))
                if row["min"] is not None:
                    h.min = min(h.min, float(row["min"]))
            self._last_hist[key] = (counts, int(row["count"]),
                                    float(row["sum"]))
