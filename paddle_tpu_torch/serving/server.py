"""Asyncio HTTP/SSE frontend over a fleet of :class:`EngineCore` replicas
(the port of ``paddle_tpu/serving/server.py``).

A dependency-free HTTP/1.1 server on stdlib ``asyncio`` streams exposing

* ``POST /v1/completions`` — OpenAI-style JSON (``protocol.py``);
  ``stream=true`` answers Server-Sent Events, one ``data:`` event per
  token batch, terminated by ``data: [DONE]``;
* ``GET /healthz`` — liveness (200 while the process runs);
* ``GET /readyz`` — readiness (503 the instant a drain begins, or if every
  engine thread died);
* ``GET /metrics`` — Prometheus text exposition of the fleet's registry,
  byte-identical to ``observability.start_metrics_server`` for the same
  registry (shared ``metrics_page`` handler);
* ``GET /v1/requests[/{id}]`` — request timelines (JSON or Chrome trace);
* ``GET /v1/debug/{alerts,audit,cache,compiles,history,profile,wire}`` —
  the observability surfaces of every replica.

HTTP/1.1 connections are **persistent**: a handler loops request →
response on one socket until the client sends ``Connection: close``, goes
idle past ``keepalive_timeout_s``, or the response is an SSE stream
(self-delimiting — the socket closes after ``data: [DONE]``).  HTTP/1.0
clients must opt in with ``Connection: keep-alive``.

Threading model — a FLEET of engine threads, N async handlers (dp=1 is
simply a fleet of one):

    asyncio loop (handlers)          engine thread i (owns replica i)
    ───────────────────────          ───────────────────────────────
    parse ──router──▶ submit q_i ──▶ add_request(trace_id=...)
    await handle.event   ◀─notify──  step(): prefill/decode/sample
    read req.output_tokens[cursor:]  retire finished
    deadline hit ──owner──▶ abort q_i▶ abort_request(rid, TIMEOUT)

``EngineCore`` is not thread-safe and its steps block, so each replica
runs its own background thread (``serving.fleet.EngineReplica``, a
bounded submit/abort queue bridge per replica); handlers never touch a
scheduler.  The :class:`~paddle_tpu_torch.serving.fleet.FleetRouter`
places each request by **prefix-affinity consistent hashing** over its
leading prompt blocks (least-loaded fallback), and routes aborts through
the request→replica owner map so a deadline or disconnect reaches the
replica that actually holds the blocks.  Handlers read each request's
append-only ``output_tokens`` directly (safe under the GIL); engine
threads wake sleeping handlers via ``loop.call_soon_threadsafe`` after
every step.

The frontend owns three policies the engines deliberately do not:

* **admission control** — per replica: at most ``max_queue`` requests in
  flight on each; a POST gets ``429`` (+ ``Retry-After``,
  ``serving_admission_rejected_total``) only when EVERY eligible replica
  is at its cap.  All cross-thread queues are bounded.
* **per-request deadlines** — ``timeout`` in the body (clamped to
  ``max_timeout_s``, defaulting to ``default_timeout_s``); on expiry the
  handler propagates ``abort(TIMEOUT)`` through the router into the
  OWNING replica's scheduler, the request's blocks are freed, and the
  partial output is returned with ``finish_reason="timeout"``.
* **graceful drain** — ``shutdown()`` (or SIGTERM under the CLI) flips
  ``/readyz`` to 503 immediately and stops admitting fleet-wide;
  in-flight requests run to completion up to the drain deadline, then
  are aborted with TIMEOUT; every engine thread exits only once its pool
  is empty.

Per-replica health rides the router: a dead engine thread is excluded
from routing and the fleet serves on; ``/readyz`` (and POSTs) answer 503
only when the WHOLE fleet is down.  ``/readyz``'s body reports the fleet
shape — ``ok dp=N mp=M``.

Every request gets a trace id (``cmpl-<n>``) attached to the engine's
prefill/preempt/decode spans, so one request's lifecycle is
reconstructible from a single exported chrome trace.

The CLI (:func:`main`) serves a toy Llama built on the card from a seeded
``torch.Generator`` (``--device cpu`` for the CPU), with the self-healing
supervisor on by default::

    python -m paddle_tpu_torch.serving.server --port 0 --dp 2 --unified \\
        --max-tokens-per-step 16 --spec-decode
    python -m paddle_tpu_torch.serving.server --device cpu --layers 2 \
        --selftest

``--workers N`` serves the same router and supervisor over N worker
processes (``serving/procfleet.py``; ``--autoscale``, ``--rebalance`` and
``--compile-cache`` act on that pool); ``/v1/debug/wire`` then attributes
each step's wall to host, wire and engine::

    python -m paddle_tpu_torch.serving.server --workers 2 --device cpu \
        --layers 2 --selftest

AOT serving artifacts (``serving/aot.py``): ``--aot-save DIR`` saves the
configured engine's bucket universe (bounded by ``--aot-max-seq``,
default 128) and exits; ``--aot-path DIR`` serves every replica (in
process, ``--selftest`` or ``--workers``) off that one artifact with no
capture counted after boot; ``--aot-warm`` captures the whole universe at
save (on the saving engine), or on every replica or worker at boot::

    python -m paddle_tpu_torch.serving.server --device cpu --layers 2 \
        --blocks 64 --aot-save /tmp/art --aot-max-seq 32
    python -m paddle_tpu_torch.serving.server --device cpu --layers 2 \
        --blocks 64 --aot-path /tmp/art --aot-warm --selftest

Tensor-parallel serving: ``--mp N`` makes this process rank 0 of N, the
controller, and starts ranks 1..N-1 as follower processes through the
port's ``distributed.spawn`` (``serving/tp.py``): NCCL with a card a rank,
gloo where the ranks share cards, on the CPU, or where
``PADDLE_DISTRI_BACKEND=gloo`` chooses it.  With ``--dp D`` (or
``--roles``) this process is the controller of D replicas, each spanning
the N ranks on an mp group and a control group of its own, built on every
rank before any engine; each follower holds its shard of every replica.
Each rank builds its shards of the toy model; ``/readyz`` answers ``ok
dp=D mp=N``; SIGTERM drains, stops the followers, and every rank exits
0.  ``--max-restarts`` rebuilds a crashed replica on every rank of it; a
replica whose follower died is excluded instead
(``serving/resilience.py``)::

    python -m paddle_tpu_torch.serving.server --device cpu --layers 2 \
        --dp 2 --mp 2 --unified

``--workers W --mp N`` runs W worker processes, each the controller of a
world of N ranks of its own (``serving/worker.py``); this process builds
no world.  ``--mp`` > 1 with ``--spec-decode``, ``--audit-sample``,
``--selftest`` or the AOT flags exits non-zero naming ROADMAP A11.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..observability.httpd import PROMETHEUS_CONTENT_TYPE, metrics_page
from .engine import EngineCore
from .fleet import (
    FleetConfig,
    FleetDown,
    FleetRouter,
    FleetSaturated,
    SubmitHandle,
)
from .protocol import (
    SSE_DONE,
    CompletionRequest,
    ProtocolError,
    chunk_body,
    completion_body,
    error_body,
    parse_completion_request,
    sse_event,
    usage_body,
)
from .request import FinishReason

_MAX_HEADER_BYTES = 16384
_ROUTES = ("/v1/completions", "/v1/requests", "/v1/debug/compiles",
           "/v1/debug/profile", "/v1/debug/audit", "/v1/debug/cache",
           "/v1/debug/alerts", "/v1/debug/history", "/v1/debug/wire",
           "/healthz", "/readyz", "/metrics")

# pre-registered metric names this module owns
METRIC_NAMES = (
    "serving_admission_rejected_total",
    "serving_http_requests_total",
)


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 0                 # 0 = ephemeral, read back from .port
    max_queue: int = 64           # per-replica engine-side in-flight cap
                                  # (must match FleetConfig.max_queue for
                                  # a pre-built fleet); the HTTP-side
                                  # in-flight set is capped at dp x this
    retry_after_s: int = 1        # 429 Retry-After hint
    default_timeout_s: Optional[float] = None   # None = no deadline
    max_timeout_s: float = 600.0
    drain_timeout_s: float = 5.0  # shutdown(): grace for in-flight work
    keepalive_timeout_s: float = 30.0  # idle wait for the NEXT request on
                                       # a persistent connection (also the
                                       # first-request header deadline)
    model_name: str = "paddle-tpu"
    tokenize: Optional[Callable[[str], List[int]]] = None


class _Handle(SubmitHandle):
    """One in-flight HTTP completion: the fleet's :class:`SubmitHandle`
    (rid / prompt / sampling / req / done / cancel_reason, routed and
    owned by one replica) plus the parsed protocol request and the
    asyncio waker created on the server's loop."""

    __slots__ = ("creq",)

    def __init__(self, rid: str, creq: CompletionRequest,
                 event: asyncio.Event):
        super().__init__(rid, creq.prompt_ids, sampling=creq.sampling(),
                         priority=creq.priority, event=event,
                         slo_ms=creq.slo_ms, retryable=creq.retryable)
        self.creq = creq


class CompletionServer:
    """HTTP frontend bound to a fleet of engine replicas.

    Accepts either a :class:`FleetRouter` (dp ≥ 1) or a bare
    :class:`EngineCore` — the latter is wrapped as a fleet of one: its
    ``serving_*`` series stay unlabeled on its own registry as before,
    with the ``serving_fleet_*`` family (a one-replica fleet) added
    alongside.  ``await start()`` spawns the engine threads and binds
    the socket; ``await shutdown()`` drains the whole fleet gracefully.
    ``registry`` defaults to the fleet's shared metrics registry, so
    ``GET /metrics`` serves per-replica-labeled ``serving_*`` series,
    the ``serving_fleet_*`` family, and whatever else the caller
    registered there."""

    def __init__(self, engine,
                 config: Optional[ServerConfig] = None, registry=None):
        self.cfg = config or ServerConfig()
        if isinstance(engine, FleetRouter):
            self.fleet = engine
            if self.cfg.max_queue != self.fleet.cfg.max_queue:
                # admission lives in the router (per-replica caps), so a
                # divergent ServerConfig.max_queue would be silently dead
                # configuration — refuse instead of letting the operator
                # believe their overload cap is enforced
                raise ValueError(
                    f"ServerConfig.max_queue={self.cfg.max_queue} but the "
                    f"fleet was built with FleetConfig.max_queue="
                    f"{self.fleet.cfg.max_queue}; admission is per-replica "
                    "and owned by the fleet — set the cap there (or pass "
                    "matching values)")
        else:
            self.fleet = FleetRouter.from_engine(
                engine, max_queue=self.cfg.max_queue)
        self.registry = (registry if registry is not None
                         else self.fleet.registry)
        self._handles: Dict[str, _Handle] = {}
        self._ids = itertools.count(1)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._draining = False
        self._stop = False
        self._shutdown_done: Optional[asyncio.Event] = None
        self._rejected = self.registry.counter(
            "serving_admission_rejected_total",
            "requests rejected 429 at admission (every replica saturated)")
        self.port: Optional[int] = None

    # --- single-engine compat views (dp=1 tests/tools poke these) -----------
    @property
    def engine(self) -> EngineCore:
        """Replica 0's engine — the single-engine compat surface
        (selftest / existing callers poke ``.engine.mp``, ``.engine.kv``
        ...).  A property, not a snapshot: the supervisor may
        replace replica 0's engine wholesale on restart/quarantine."""
        return self.fleet.replicas[0].engine

    @property
    def tracer(self):
        # follows replica 0's engine like `engine` above — a snapshot
        # would pin a retired engine's tracer after a supervisor rebuild
        return self.engine.tracer

    @property
    def _engine_thread(self) -> Optional[threading.Thread]:
        return self.fleet.replicas[0].thread

    @property
    def _engine_error(self) -> Optional[str]:
        return self.fleet.replicas[0].error

    # --- lifecycle ----------------------------------------------------------
    async def start(self) -> "CompletionServer":
        self._loop = asyncio.get_running_loop()
        self._shutdown_done = asyncio.Event()
        self.fleet.start(notify=self._notify)
        self._server = await asyncio.start_server(
            self._handle_conn, self.cfg.host, self.cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    def request_shutdown(self) -> None:
        """Thread/signal-safe trigger for a graceful drain."""
        if self._loop is None or self._loop.is_closed():
            return
        self._loop.call_soon_threadsafe(
            lambda: self._loop.create_task(self.shutdown()))

    async def shutdown(self, drain_timeout: Optional[float] = None) -> None:
        """Fleet-wide graceful drain: stop admission now (``/readyz`` →
        503 instantly, router refuses), let in-flight requests finish
        until the drain deadline, abort the stragglers with TIMEOUT
        through their owning replicas, stop every engine thread, close
        the socket.  Every replica exits with zero pool occupancy.
        Idempotent; concurrent callers await the first drain."""
        if self._draining:
            await self._shutdown_done.wait()
            return
        self._draining = True
        self.fleet.begin_drain()
        deadline = time.monotonic() + (
            drain_timeout if drain_timeout is not None
            else self.cfg.drain_timeout_s)
        while self._handles and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        stragglers = list(self._handles.values())
        if stragglers:
            # drain-deadline overrun: post-mortem bundle BEFORE the
            # aborts end the stragglers' timelines (flight recorder)
            self.fleet.flight.trigger(
                "drain_overrun",
                detail=f"{len(stragglers)} request(s) still in flight "
                       f"at the HTTP drain deadline")
        for h in stragglers:
            self._request_abort(h, FinishReason.TIMEOUT)
        # handlers still need loop time to flush their (aborted) responses
        flush_deadline = time.monotonic() + 5.0
        while self._handles and time.monotonic() < flush_deadline:
            await asyncio.sleep(0.01)
        self._stop = True
        await self._loop.run_in_executor(None, self.fleet.stop)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self._shutdown_done.set()

    async def serve_forever(self) -> None:
        await self._shutdown_done.wait()

    @property
    def ready(self) -> bool:
        # ready while ANY replica's engine thread lives: the router
        # excludes dead replicas, so a partial fleet still serves (503
        # only when the whole fleet is down or draining)
        return (self._server is not None and not self._draining
                and self.fleet.alive)

    # --- fleet bridge -------------------------------------------------------
    def _notify(self, replica=None) -> None:
        """Wake waiting handlers (engine threads → loop thread).  The
        stepping replica passes itself, so only the handlers whose
        requests it owns are woken — wakeup work per step stays
        per-replica instead of dp × fleet-wide.  ``None`` wakes all."""
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        for h in list(self._handles.values()):
            if replica is not None and h.replica is not replica:
                continue
            try:
                loop.call_soon_threadsafe(h.event.set)
            except RuntimeError:
                return  # swallow-ok: loop shut down mid-iteration — the handlers it would wake are being torn down with it

    def _unavailable_503(self) -> Tuple[str, Tuple]:
        """(message, extra headers) for a 503.  A draining server is
        going away (no retry hint); a fleet whose replicas are all
        momentarily down while the supervisor restarts them
        tells the client to come back — 503 **with** ``Retry-After``,
        matching the 429 path."""
        if self._draining or self._stop:
            return "server is draining", ()
        n = self.fleet.restarting_count
        if n:
            return (f"fleet is restarting ({n} replica(s) recovering); "
                    "retry later",
                    (("Retry-After", str(self.cfg.retry_after_s)),))
        return "engine is not running", ()

    def _request_abort(self, h: _Handle, reason: FinishReason) -> None:
        h.cancel_reason = reason
        # the router's request→replica owner map sends the abort to the
        # replica that actually holds the request's blocks
        self.fleet.abort(h.rid, reason)

    # --- HTTP plumbing ------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """Serve one connection: HTTP/1.1 requests are persistent by
        default (``Connection: close`` or HTTP/1.0 without an explicit
        ``keep-alive`` opts out), so this loops request → response until
        the client closes, opts out, hits the idle timeout, or switches
        to a self-delimiting response (SSE streams close the socket —
        their framing has no length)."""
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"),
                        timeout=self.cfg.keepalive_timeout_s)
                except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                        asyncio.LimitOverrunError, ConnectionError):
                    return  # swallow-ok: idle timeout / client closed between requests — normal keep-alive connection end, not a fault
                if len(head) > _MAX_HEADER_BYTES:
                    await self._respond(writer, 431, error_body(
                        "headers too large"))
                    return
                lines = head.decode("latin-1").split("\r\n")
                parts = lines[0].split()
                if len(parts) != 3:
                    await self._respond(writer, 400, error_body(
                        "malformed request line"))
                    return
                method, target = parts[0].upper(), parts[1]
                version = parts[2].upper()
                headers = {}
                for ln in lines[1:]:
                    if ":" in ln:
                        k, v = ln.split(":", 1)
                        headers[k.strip().lower()] = v.strip()
                conn_hdr = headers.get("connection", "").lower()
                keep_alive = (conn_hdr != "close" if version == "HTTP/1.1"
                              else conn_hdr == "keep-alive")
                if "transfer-encoding" in headers:
                    # bodies are framed by Content-Length only; a chunked
                    # body left unread would desync the persistent stream
                    # (its bytes would parse as the next request line), so
                    # reject AND close
                    await self._respond(writer, 411, error_body(
                        "Transfer-Encoding unsupported; send "
                        "Content-Length"))
                    return
                body = b""
                clen = int(headers.get("content-length", 0) or 0)
                if clen:
                    if clen > 2 * 1024 * 1024:
                        await self._respond(writer, 413, error_body(
                            "body too large"))
                        return
                    body = await asyncio.wait_for(
                        reader.readexactly(clen), timeout=30.0)
                keep_alive = await self._dispatch(
                    method, target, body, writer, keep_alive)
                if not keep_alive:
                    return
        except (ConnectionError, asyncio.TimeoutError,
                asyncio.IncompleteReadError):
            pass  # swallow-ok: client went away; the per-request abort path already freed the engine-side work
        finally:
            try:
                writer.close()
            except Exception:
                pass  # swallow-ok: socket already dead — close() is best-effort teardown of a connection we are done with

    def _count_http(self, route: str, status: int) -> None:
        if route.startswith("/v1/requests"):
            route = "/v1/requests"  # one series for all request ids
        route = route if route in _ROUTES else "other"
        self.registry.counter(
            "serving_http_requests_total", "HTTP requests served",
            route=route, code=str(status)).inc()

    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       payload, content_type: str = "application/json",
                       extra: Tuple[Tuple[str, str], ...] = (),
                       keep_alive: bool = False) -> None:
        body = (json.dumps(payload).encode("utf-8") + b"\n"
                if isinstance(payload, dict) else payload)
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 409: "Conflict",
                  411: "Length Required",
                  413: "Payload Too Large",
                  429: "Too Many Requests", 431: "Headers Too Large",
                  500: "Internal Server Error",
                  503: "Service Unavailable"}.get(status, "OK")
        head = [f"HTTP/1.1 {status} {reason}",
                f"Content-Type: {content_type}",
                f"Content-Length: {len(body)}",
                "Connection: keep-alive" if keep_alive
                else "Connection: close"]
        head += [f"{k}: {v}" for k, v in extra]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        writer.write(body)
        await writer.drain()

    async def _dispatch(self, method: str, target: str, body: bytes,
                        writer: asyncio.StreamWriter,
                        keep_alive: bool = False) -> bool:
        """Route one request; returns whether the connection stays open
        (an SSE stream always closes — its framing is delimited by EOF)."""
        path, _, query = target.partition("?")
        with self.tracer.span("http_request", cat="serving",
                              method=method, path=path) as sp:
            if path == "/healthz":
                status = 200
                await self._respond(writer, status, b"ok\n", "text/plain",
                                    keep_alive=keep_alive)
            elif path == "/readyz":
                status = 200 if self.ready else 503
                # the fleet shape rides the probe body: a
                # deployment that came up single-replica or single-chip
                # when the operator expected dp=N / mp=M is visible from
                # the readiness check alone
                mp = getattr(self.engine, "mp", 1)
                # a degraded numerics auditor ANNOTATES readiness but
                # never flips it: the fleet still serves —
                # the operator sees the flag on every probe and digs in
                # via /v1/debug/audit
                audit_ann = (" audit=degraded" if any(
                    r.engine.audit.degraded for r in self.fleet.replicas)
                    else "")
                # replicas the supervisor is bringing back:
                # annotated while the fleet still serves, and the WHOLE
                # body when every replica is momentarily down but
                # recovery is underway — probes can tell "restarting"
                # from "dead" (and clients get Retry-After on POSTs)
                restarting = self.fleet.restarting_count
                restart_ann = (f" restarting={restarting}" if restarting
                               else "")
                if status == 200:
                    msg = (f"ok dp={self.fleet.dp} mp={mp}{audit_ann}"
                           f"{restart_ann}\n").encode()
                elif self._draining:
                    msg = b"draining\n"
                elif restarting:
                    msg = f"restarting={restarting}\n".encode()
                else:
                    msg = b"not ready\n"
                await self._respond(writer, status, msg, "text/plain",
                                    keep_alive=keep_alive)
            elif path == "/metrics":
                status = 200
                # serving_fleet_* replica gauges refresh via the
                # registry collect hook inside prometheus_text — the
                # same freshness the push gateway and the
                # history sampler observe
                await self._respond(writer, status,
                                    metrics_page(self.registry),
                                    PROMETHEUS_CONTENT_TYPE,
                                    keep_alive=keep_alive)
            elif path == "/v1/completions":
                if method != "POST":
                    status = 405
                    await self._respond(writer, status, error_body(
                        "use POST", "method_not_allowed"),
                        keep_alive=keep_alive)
                else:
                    status, keep_alive = await self._handle_completion(
                        body, writer, keep_alive)
            elif path == "/v1/requests" or path.startswith("/v1/requests/") \
                    or path.startswith("/v1/debug/"):
                if method != "GET":
                    status = 405
                    await self._respond(writer, status, error_body(
                        "use GET", "method_not_allowed"),
                        keep_alive=keep_alive)
                else:
                    # debug surfaces answer JSON for every outcome —
                    # unknown ids are 404 and malformed query params 400
                    # (never a 500 or a dropped connection)
                    try:
                        if path.startswith("/v1/debug/"):
                            status = await self._handle_debug(
                                path, query, writer, keep_alive)
                        else:
                            status = await self._handle_requests_debug(
                                path, query, writer, keep_alive)
                    except (ConnectionError, asyncio.TimeoutError):
                        raise
                    except Exception as e:
                        status = 500
                        await self._respond(writer, status, error_body(
                            f"debug handler failed: {e}", "internal_error"),
                            keep_alive=keep_alive)
            else:
                status = 404
                await self._respond(writer, status, error_body(
                    f"no route {path!r}", "not_found"),
                    keep_alive=keep_alive)
            sp.set_attribute("status", status)
        self._count_http(path, status)
        return keep_alive

    # --- request-lifecycle debug routes ---------------------------
    async def _handle_requests_debug(self, path: str, query: str,
                                     writer: asyncio.StreamWriter,
                                     keep_alive: bool) -> int:
        """``GET /v1/requests?state=active|recent`` (timeline summaries)
        and ``GET /v1/requests/{id}[?format=chrome]`` (one request's full
        timeline, or its per-request Chrome trace)."""
        import urllib.parse

        params = urllib.parse.parse_qs(query)
        lc = self.fleet.lifecycle
        source, complete = self._timeline_source()
        if path == "/v1/requests":
            state = params.get("state", ["active"])[0]
            if state not in ("active", "recent"):
                await self._respond(writer, 400, error_body(
                    "state must be 'active' or 'recent'"),
                    keep_alive=keep_alive)
                return 400
            await self._respond(
                writer, 200,
                {"object": "list", "state": state,
                 "source": source, "complete": complete,
                 "data": lc.summaries(state)},
                keep_alive=keep_alive)
            return 200
        rid = urllib.parse.unquote(path[len("/v1/requests/"):])
        fmt = params.get("format", [None])[0]
        if fmt not in (None, "json", "chrome"):
            # invalid query param: a crisp JSON 400, not a silently
            # ignored knob
            await self._respond(writer, 400, error_body(
                f"format must be 'json' or 'chrome', got {fmt!r}"),
                keep_alive=keep_alive)
            return 400
        tl = lc.get(rid)
        if tl is None:
            await self._respond(writer, 404, error_body(
                f"no timeline for request {rid!r} (it may have aged out "
                "of the recent ring)", "not_found"),
                keep_alive=keep_alive)
            return 404
        if fmt == "chrome":
            # build from the timeline already in hand — a second lookup
            # could miss (the recent ring is bounded) and return None
            from ..observability.export import chrome_trace_dict

            payload = chrome_trace_dict(tl.chrome_spans(),
                                        epoch_offset=lc.epoch_offset)
        else:
            payload = dict(tl.to_dict(lc.epoch_offset), object="request",
                           source=source, complete=complete)
        await self._respond(writer, 200, payload, keep_alive=keep_alive)
        return 200

    def _timeline_source(self) -> Tuple[str, bool]:
        """Honesty marker for the timeline endpoints: in ``--workers``
        mode WITHOUT telemetry streaming the router's tracker holds
        router-synthesized stand-ins only, so the response must say
        ``complete: false`` instead of presenting a router-only view as
        the whole story."""
        proxies = [r.engine for r in self.fleet.replicas
                   if hasattr(r.engine, "distrib_state")]
        if not proxies:
            return "in-process", True
        if all(getattr(p, "_telemetry", False) for p in proxies):
            return "router+workers", True
        return "router-only", False

    # --- step-level introspection routes --------------------------
    def _debug_int(self, params, name: str, default: int,
                   lo: int, hi: int) -> int:
        """Parse an integer query param in [lo, hi]; raises ValueError
        with an operator-readable message (mapped to a JSON 400)."""
        raw = params.get(name, [None])[0]
        if raw is None:
            return default
        try:
            v = int(raw)
        except ValueError:
            raise ValueError(
                f"{name} must be an integer, got {raw!r}") from None
        if not lo <= v <= hi:
            raise ValueError(f"{name} must be in [{lo}, {hi}], got {v}")
        return v

    def _replica_rows(self, reps, fetch) -> List[Dict]:
        """Per-replica debug rows with mid-restart degradation : a replica that is being rebuilt/respawned —
        unhealthy, or whose snapshot fetch fails during the engine swap
        / worker respawn window — contributes a
        ``{"status": "restarting"}`` row instead of 404/500-ing the
        whole endpoint.  Debug surfaces stay useful DURING incidents,
        which is exactly when operators hit them."""
        rows = []
        for r in reps:
            if not r.healthy:
                rows.append({"replica": str(r.index), "enabled": False,
                             "status": "restarting"})
                continue
            try:
                rows.append(dict(fetch(r), replica=str(r.index)))
            except Exception:
                rows.append({"replica": str(r.index), "enabled": False,
                             "status": "restarting"})
        return rows

    async def _handle_debug(self, path: str, query: str,
                            writer: asyncio.StreamWriter,
                            keep_alive: bool) -> int:
        """``GET /v1/debug/compiles`` — per-replica compile-time
        attribution table (every observed trace+compile with its wall
        seconds); ``GET /v1/debug/profile?steps=N[&replica=i]`` — arm a
        bounded capture window on the replica's StepProfiler, wait for
        the next N engine steps, answer the annotated Chrome trace."""
        import urllib.parse

        from ..observability.stepprof import CaptureBusy

        params = urllib.parse.parse_qs(query)
        if path == "/v1/debug/audit":
            # numerics-audit status: per-replica auditor
            # snapshots (counters, last divergence, repro paths) plus a
            # fleet-level status roll-up — "ok" only when every enabled
            # auditor is clean, "degraded" the moment any diverged,
            # "disabled" when no replica audits
            try:
                replica = self._debug_int(params, "replica", -1,
                                          -1, 1 << 30)
            except ValueError as e:
                await self._respond(writer, 400, error_body(str(e)),
                                    keep_alive=keep_alive)
                return 400
            if replica >= self.fleet.dp:
                await self._respond(writer, 404, error_body(
                    f"no replica {replica} (fleet has dp="
                    f"{self.fleet.dp})", "not_found"),
                    keep_alive=keep_alive)
                return 404
            reps = (self.fleet.replicas if replica < 0
                    else [self.fleet.replicas[replica]])
            data = self._replica_rows(
                reps, lambda r: r.engine.audit.snapshot())
            enabled = [d for d in data if d.get("enabled")]
            status = ("disabled" if not enabled else
                      "degraded" if any(d.get("status") == "degraded"
                                        for d in enabled) else "ok")
            await self._respond(
                writer, 200,
                {"object": "list", "status": status, "data": data},
                keep_alive=keep_alive)
            return 200
        if path == "/v1/debug/cache":
            # KV-cache & memory observability: per-replica
            # pool timelines, prefix-heat tables, hit-depth/eviction
            # reports and per-request attribution, plus a fleet view —
            # per-replica cached-token ratios and the max−min imbalance
            # (the cache-aware rebalancing signal)
            try:
                replica = self._debug_int(params, "replica", -1,
                                          -1, 1 << 30)
            except ValueError as e:
                await self._respond(writer, 400, error_body(str(e)),
                                    keep_alive=keep_alive)
                return 400
            if replica >= self.fleet.dp:
                await self._respond(writer, 404, error_body(
                    f"no replica {replica} (fleet has dp="
                    f"{self.fleet.dp})", "not_found"),
                    keep_alive=keep_alive)
                return 404
            reps = (self.fleet.replicas if replica < 0
                    else [self.fleet.replicas[replica]])
            data = self._replica_rows(
                reps, lambda r: r.engine.cachestat.snapshot())
            # ONE ratio snapshot: the body's imbalance is derived from
            # the very ratios it reports, so the two fields can never
            # disagree under concurrent traffic
            ratios = self.fleet.cached_token_ratios()
            vals = [v for v in ratios.values() if v is not None]
            imbalance = max(vals) - min(vals) if vals else None
            self.fleet.sample_gauges()  # the imbalance gauge tracks it
            await self._respond(
                writer, 200,
                {"object": "list",
                 "status": ("ok" if any(d.get("enabled") for d in data)
                            else "disabled"),
                 "fleet": {
                     "dp": self.fleet.dp,
                     "cached_token_ratios": {
                         k: (None if v is None else round(v, 4))
                         for k, v in ratios.items()},
                     "cache_imbalance": (None if imbalance is None
                                         else round(imbalance, 4)),
                 },
                 "data": data},
                keep_alive=keep_alive)
            return 200
        if path == "/v1/debug/alerts":
            # alert-engine state: every rule with its live
            # pending/firing state + recent transitions, plus engine
            # totals; ?rule= filters to one rule (unknown -> 404)
            alerts = self.fleet.alerts
            if alerts is None:
                await self._respond(
                    writer, 200,
                    {"object": "alerts", "status": "disabled",
                     "rules": 0, "data": []}, keep_alive=keep_alive)
                return 200
            snap = alerts.snapshot()
            rule = params.get("rule", [None])[0]
            if rule is not None:
                rows = [d for d in snap["data"]
                        if d["rule"]["name"] == rule]
                if not rows:
                    await self._respond(writer, 404, error_body(
                        f"no alert rule {rule!r}", "not_found"),
                        keep_alive=keep_alive)
                    return 404
                # scope status + firing to the queried rule: an
                # operator asking about an inactive rule must not read
                # "firing" off some OTHER rule's incident
                snap = dict(snap, data=rows, firing=[
                    d["rule"]["name"] for d in rows
                    if d["state"] == "firing"])
            status = ("firing" if snap["firing"] else "ok")
            await self._respond(
                writer, 200,
                dict({"object": "alerts", "status": status}, **snap),
                keep_alive=keep_alive)
            return 200
        if path == "/v1/debug/history":
            # metrics history: ?series=<metric name> answers
            # the per-label-set windows (per-replica view) plus a fleet
            # aggregate; without ?series= the series index is returned.
            # ?window=N bounds the returned samples (malformed -> 400,
            # unknown series -> 404 — protocol-clean like /v1/debug/cache)
            history = self.fleet.history
            if history is None:
                await self._respond(
                    writer, 200,
                    {"object": "history", "status": "disabled",
                     "data": []}, keep_alive=keep_alive)
                return 200
            try:
                window = self._debug_int(params, "window",
                                         history.cfg.ring_len, 1,
                                         history.cfg.ring_len)
            except ValueError as e:
                await self._respond(writer, 400, error_body(str(e)),
                                    keep_alive=keep_alive)
                return 400
            series = params.get("series", [None])[0]
            if series is None:
                await self._respond(
                    writer, 200,
                    {"object": "history", "status": "ok",
                     "stats": history.stats(),
                     "series": history.names()}, keep_alive=keep_alive)
                return 200
            keys = history.match(series)
            if not keys:
                await self._respond(writer, 404, error_body(
                    f"no recorded series {series!r} (see "
                    "/v1/debug/history for the index)", "not_found"),
                    keep_alive=keep_alive)
                return 404
            rows = [{"key": k, "kind": history.kind(k),
                     "latest": history.latest(k),
                     "window": history.window(k, window)}
                    for k in keys]
            fleet_view = {"latest_sum": history.name_latest_sum(series)}
            if all(r["kind"] == "counter" for r in rows):
                fleet_view["increase"] = history.name_increase(
                    series, window)
            await self._respond(
                writer, 200,
                {"object": "history", "status": "ok", "series": series,
                 "window": window, "fleet": fleet_view, "data": rows},
                keep_alive=keep_alive)
            return 200
        if path == "/v1/debug/compiles":
            data = []
            totals: Dict[str, Dict] = {}
            aot: Dict[str, Dict] = {}
            for r in self.fleet.replicas:
                if not r.healthy:
                    # mid-restart replica: degrade
                    # its slot instead of failing the fleet-wide table
                    aot[str(r.index)] = {"status": "restarting"}
                    continue
                try:
                    sp = r.engine.stepprof
                    rows = [dict(row, replica=str(r.index))
                            for row in sp.compile_table()]
                    tots = list(sp.compile_totals().items())
                    # AOT attribution: with an artifact bound the
                    # compile table stays empty and the hits count here
                    aot[str(r.index)] = sp.aot_snapshot()
                except Exception:
                    aot[str(r.index)] = {"status": "restarting"}
                    continue
                data.extend(rows)
                for prog, t in tots:
                    agg = totals.setdefault(
                        prog, {"seconds": 0.0, "count": 0})
                    agg["seconds"] = round(agg["seconds"] + t["seconds"], 6)
                    agg["count"] += t["count"]
            await self._respond(
                writer, 200,
                {"object": "list", "data": data, "totals": totals,
                 "aot": aot,
                 "step_profile": self.engine.stepprof.enabled},
                keep_alive=keep_alive)
            return 200
        if path == "/v1/debug/wire":
            # per-worker wire-latency attribution + clock-sync +
            # telemetry-merge state.  In-process fleets answer a crisp
            # "disabled" shape (there is no wire), mirroring the other
            # debug endpoints' degrade-not-404 discipline.
            rows: Dict[str, Dict] = {}
            for r in self.fleet.replicas:
                eng = r.engine
                if not hasattr(eng, "distrib_state"):
                    continue
                try:
                    rows[str(r.index)] = eng.distrib_state()
                except Exception:
                    rows[str(r.index)] = {"status": "restarting"}
            if not rows:
                await self._respond(
                    writer, 200,
                    {"object": "wire", "enabled": False,
                     "reason": "in-process fleet: no process wire to "
                               "attribute (use --workers)"},
                    keep_alive=keep_alive)
                return 200
            from ..observability.distrib import WireStats

            agg = {"steps": 0, "wire_s": 0.0, "queue_s": 0.0,
                   "engine_s": 0.0, "total_s": 0.0}
            for state in rows.values():
                w = state.get("wire") or {}
                for k in agg:
                    agg[k] += w.get(k, 0) or 0
            await self._respond(
                writer, 200,
                {"object": "wire", "enabled": True,
                 "shares": WireStats._shares(agg),
                 "steps": agg["steps"],
                 "replicas": rows},
                keep_alive=keep_alive)
            return 200
        if path != "/v1/debug/profile":
            await self._respond(writer, 404, error_body(
                f"no route {path!r}", "not_found"),
                keep_alive=keep_alive)
            return 404
        try:
            timeout_s = self._debug_int(params, "timeout_s", 30, 1, 300)
            replica = self._debug_int(params, "replica", 0,
                                      0, 1 << 30)
        except ValueError as e:
            await self._respond(writer, 400, error_body(str(e)),
                                keep_alive=keep_alive)
            return 400
        if replica >= self.fleet.dp:
            # an unknown id is a 404, not a malformed request
            await self._respond(writer, 404, error_body(
                f"no replica {replica} (fleet has dp={self.fleet.dp})",
                "not_found"), keep_alive=keep_alive)
            return 404
        sp = self.fleet.replicas[replica].engine.stepprof
        try:
            # bound against the TARGET profiler's own cap — one limit,
            # owned by arm_capture, never duplicated here
            steps = self._debug_int(params, "steps", 32, 1,
                                    sp.max_capture_steps)
            window = sp.arm_capture(steps)
        except CaptureBusy as e:
            await self._respond(writer, 409, error_body(
                str(e), "conflict"), keep_alive=keep_alive)
            return 409
        except (RuntimeError, ValueError) as e:
            # step_profile disabled, or a steps value the profiler's
            # own validation refuses — either way a client error
            await self._respond(writer, 400, error_body(str(e)),
                                keep_alive=keep_alive)
            return 400
        try:
            deadline = time.monotonic() + timeout_s
            while not window.done.is_set() \
                    and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            if not window.done.is_set():
                # idle/slow engine: return what the window captured so
                # far (``complete: false``) instead of hanging.  The
                # finalize runs in an executor — a device stop_trace
                # flushing its XPlane dump must not stall the event
                # loop — and may lose to a concurrent engine-side
                # finalize, so keep polling ``done`` afterwards: never
                # read a half-built result
                await self._loop.run_in_executor(
                    None, sp.cancel_capture, window)
                grace = time.monotonic() + 30.0
                while not window.done.is_set() \
                        and time.monotonic() < grace:
                    await asyncio.sleep(0.01)
            if window.result is None:
                await self._respond(writer, 503, error_body(
                    "capture window did not finalize in time",
                    "unavailable_error"), keep_alive=keep_alive)
                return 503
            await self._respond(writer, 200, window.result,
                                keep_alive=keep_alive)
            return 200
        finally:
            # the handler task can die mid-wait (client disconnect,
            # CancelledError on shutdown): an armed window left behind
            # would 409 every future capture — and on device leave
            # torch.profiler tracing.  No-op when already finalized; runs
            # on its own thread so a slow device trace stop never
            # stalls the event loop (and cancellation can't skip it).
            threading.Thread(target=sp.cancel_capture, args=(window,),
                             daemon=True).start()

    # --- the completions route ----------------------------------------------
    async def _handle_completion(self, body: bytes,
                                 writer: asyncio.StreamWriter,
                                 keep_alive: bool = False,
                                 ) -> Tuple[int, bool]:
        """Returns (status, connection-still-open)."""
        unavailable_msg, unavailable_extra = self._unavailable_503()
        if not self.ready:
            # draining OR every engine thread died: either way nobody
            # will ever drain a submit queue, so refuse instead of
            # hanging.  A fleet mid-restart answers with
            # Retry-After — the outage is transient by construction.
            await self._respond(writer, 503, error_body(
                unavailable_msg, "unavailable_error"),
                extra=unavailable_extra, keep_alive=keep_alive)
            return 503, keep_alive
        try:
            creq = parse_completion_request(body, tokenize=self.cfg.tokenize)
        except ProtocolError as e:
            await self._respond(writer, 400, error_body(str(e)),
                                keep_alive=keep_alive)
            return 400, keep_alive

        # two admission layers: the router's per-replica caps bound
        # ENGINE-side work (evicted as requests finish computing), while
        # this server-wide cap bounds HTTP-side work — handles, sockets,
        # buffered output still flushing to slow clients — which can
        # outlive the engine's interest in a request
        if len(self._handles) >= self.cfg.max_queue * self.fleet.dp:
            self._rejected.inc()
            self.fleet.flight.note_rejection()
            await self._respond(
                writer, 429,
                error_body("admission queue is full; retry later",
                           "overloaded_error"),
                extra=(("Retry-After", str(self.cfg.retry_after_s)),),
                keep_alive=keep_alive)
            return 429, keep_alive
        # router admission is per replica: prefix-affinity target first,
        # least-loaded fallback; 429 only when EVERY eligible replica is
        # at its in-flight cap
        rid = f"cmpl-{next(self._ids)}"
        handle = _Handle(rid, creq, asyncio.Event())
        try:
            self.fleet.submit(handle)
        except FleetSaturated:
            self._rejected.inc()
            self.fleet.flight.note_rejection()
            await self._respond(
                writer, 429,
                error_body("admission queue is full; retry later",
                           "overloaded_error"),
                extra=(("Retry-After", str(self.cfg.retry_after_s)),),
                keep_alive=keep_alive)
            return 429, keep_alive
        except FleetDown:
            unavailable_msg, unavailable_extra = self._unavailable_503()
            await self._respond(writer, 503, error_body(
                unavailable_msg, "unavailable_error"),
                extra=unavailable_extra, keep_alive=keep_alive)
            return 503, keep_alive
        self._handles[rid] = handle

        timeout = creq.timeout if creq.timeout is not None \
            else self.cfg.default_timeout_s
        if timeout is not None:
            timeout = min(float(timeout), self.cfg.max_timeout_s)
        try:
            if creq.stream:
                status = await self._stream_response(handle, timeout, writer)
                return status, False  # SSE framing is delimited by EOF
            status = await self._json_response(handle, timeout, writer,
                                               keep_alive)
            return status, keep_alive
        except (ConnectionError, asyncio.TimeoutError):
            # client vanished mid-response: free the engine-side work
            self._request_abort(handle, FinishReason.ABORT)
            raise
        finally:
            self._handles.pop(rid, None)

    async def _collect(self, handle: _Handle, timeout: Optional[float],
                       on_tokens=None) -> Tuple[List[int], str]:
        """Wait on the engine until ``handle``'s request finishes (or its
        deadline aborts it); returns (tokens, finish_reason).  Streaming
        passes ``on_tokens`` to flush each batch as it lands."""
        deadline = None if timeout is None else time.monotonic() + timeout
        tokens: List[int] = []
        cursor = 0
        while True:
            req = handle.req
            if req is not None:
                out = req.output_tokens
                if cursor < len(out):
                    new = out[cursor:]
                    cursor = len(out)
                    tokens.extend(new)
                    if on_tokens is not None:
                        await on_tokens(new)
                if req.finished and cursor == len(req.output_tokens):
                    reason = (req.finish_reason.value
                              if req.finish_reason else "abort")
                    return tokens, reason
            if handle.done and (req is None or not req.finished):
                # terminal without an engine finish: cancelled before
                # admission, or the owning replica died and the
                # supervisor closed the handle 
                reason = (handle.cancel_reason.value
                          if handle.cancel_reason else "abort")
                return tokens, reason
            if deadline is not None and time.monotonic() >= deadline:
                # propagate the deadline into the scheduler, then keep
                # waiting (deadline-free) for the engine to acknowledge
                # so the partial output below is consistent
                self._request_abort(handle, FinishReason.TIMEOUT)
                deadline = None
                continue
            wait = 0.25 if deadline is None \
                else max(0.0, min(0.25, deadline - time.monotonic()))
            try:
                await asyncio.wait_for(handle.event.wait(), wait + 1e-3)
            except asyncio.TimeoutError:
                continue  # swallow-ok: the wait IS a poll; timeout means re-check request state, not a fault
            handle.event.clear()

    @staticmethod
    def _prompt_cached(handle: _Handle) -> int:
        """Cached prompt tokens at the request's first admission (the
        usage attribution); 0 when never admitted."""
        cached = getattr(handle.req, "prompt_cached_tokens", None)
        return int(cached or 0)

    async def _json_response(self, handle: _Handle,
                             timeout: Optional[float],
                             writer: asyncio.StreamWriter,
                             keep_alive: bool = False) -> int:
        tokens, reason = await self._collect(handle, timeout)
        req = handle.req
        await self._respond(writer, 200, completion_body(
            handle.rid, self.cfg.model_name, tokens, reason,
            len(handle.creq.prompt_ids),
            error=getattr(req, "error", None),
            prompt_cached_tokens=self._prompt_cached(handle)),
            extra=(("X-Request-Id", handle.rid),), keep_alive=keep_alive)
        return 200

    async def _stream_response(self, handle: _Handle,
                               timeout: Optional[float],
                               writer: asyncio.StreamWriter) -> int:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-store\r\n"
                     + f"X-Request-Id: {handle.rid}\r\n".encode("latin-1")
                     + b"Connection: close\r\n\r\n")
        # id-bearing FIRST chunk, before any token exists: an SSE client
        # learns the request id immediately (for /v1/requests/{id} or an
        # out-of-band abort) instead of only once the first token lands
        writer.write(sse_event(chunk_body(
            handle.rid, self.cfg.model_name, [], None)))
        await writer.drain()

        async def on_tokens(new: List[int]) -> None:
            writer.write(sse_event(chunk_body(
                handle.rid, self.cfg.model_name, new, None)))
            await writer.drain()

        tokens, reason = await self._collect(handle, timeout, on_tokens)
        # the FINAL chunk carries the usage block — SSE clients see the
        # prefix-cache attribution too
        writer.write(sse_event(chunk_body(
            handle.rid, self.cfg.model_name, [], reason,
            usage=usage_body(len(handle.creq.prompt_ids), len(tokens),
                             self._prompt_cached(handle)))))
        writer.write(SSE_DONE)
        await writer.drain()
        return 200


# --- CLI / selftest ---------------------------------------------------------
# flags that wait for the rest of ROADMAP A11 at --mp > 1 (items 1.4 and
# 1.5: AOT artifacts; speculative decoding and the auditor's replicated
# re-run): each exits non-zero naming it, none is silently ignored
_WAITING_AT_MP = (
    ("spec_decode", "--spec-decode (speculative decoding at mp > 1)"),
    ("audit_sample", "--audit-sample (the auditor at mp > 1)"),
    ("selftest", "--selftest (it audits every step)"),
    ("aot_save", "--aot-save (AOT artifacts at mp > 1)"),
    ("aot_path", "--aot-path (AOT artifacts at mp > 1)"),
)

# --aot-save's bound when --aot-max-seq is not given (the JAX CLI's)
_AOT_MAX_SEQ = 128


def _toy_model(layers: int = 2, device=None):
    """The CLI's toy Llama (``LlamaConfig.tiny``), its weights drawn from
    a ``torch.Generator`` seeded with 0 on ``device`` (the card unless
    ``device="cpu"``).  Its weights differ from the JAX CLI's: parity
    with the JAX package goes through ``convert.llama_from_paddle_tpu``
    on the same numpy weights, never through the two CLIs."""
    import torch

    from ..device import resolve_device
    from ..models import LlamaConfig, LlamaForCausalLM

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=layers),
                            device=dev, generator=gen)


def _toy_engine(model, num_blocks: int = 64, block_size: int = 4,
                registry=None, metrics_labels=None, audit=None,
                unified: bool = False,
                max_tokens_per_step: Optional[int] = None,
                spec=None, burst_steps: int = 0,
                role: str = "unified", aot=None) -> EngineCore:
    from .engine import EngineConfig
    from .scheduler import SchedulerConfig

    scheduler = None
    if max_tokens_per_step is not None:
        scheduler = SchedulerConfig(
            max_tokens_per_step=int(max_tokens_per_step))
    return EngineCore(model,
                      config=EngineConfig(num_blocks=num_blocks,
                                          block_size=block_size,
                                          audit=audit,
                                          unified_step=unified,
                                          scheduler=scheduler,
                                          spec=spec,
                                          burst_steps=burst_steps,
                                          aot=aot, role=role),
                      registry=registry, metrics_labels=metrics_labels)


def _toy_fleet(dp: int = 1, layers: int = 2, num_blocks: int = 64,
               max_queue: int = 64,
               flight_dir: Optional[str] = None,
               audit=None, unified: bool = False,
               fault_plan=None, alert_rules=None,
               max_tokens_per_step: Optional[int] = None,
               spec=None, burst_steps: int = 0,
               roles=None, device=None, aot=None) -> FleetRouter:
    """A dp-replica fleet of toy engines on one shared registry, with
    per-replica-labeled serving series.  The replicas share ONE model
    module (the port's step writes no module state), so the supervisor's
    rebuild through the same factory serves the same weights.  ``aot`` is
    ONE loaded :class:`~paddle_tpu_torch.serving.aot.AotArtifact` shared
    by every replica — the fleet refuses per-replica loads."""
    model = _toy_model(layers, device)
    return FleetRouter.build(
        lambda i, registry: _toy_engine(
            model, num_blocks=num_blocks, registry=registry,
            metrics_labels={"replica": str(i)}, audit=audit,
            unified=unified, max_tokens_per_step=max_tokens_per_step,
            spec=spec, burst_steps=burst_steps,
            role=(roles[i] if roles else "unified"), aot=aot),
        dp=dp, config=FleetConfig(max_queue=max_queue,
                                  flight_dir=flight_dir,
                                  fault_plan=fault_plan,
                                  alert_rules=alert_rules,
                                  roles=roles))


def _http(port: int, method: str, path: str, body: Optional[dict] = None):
    """Blocking loopback request (runs in an executor under asyncio)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    payload = None if body is None else json.dumps(body)
    conn.request(method, path, payload,
                 {"Content-Type": "application/json"} if payload else {})
    resp = conn.getresponse()
    data = resp.read()
    status = resp.status
    conn.close()
    return status, data


def _load_aot(path: Optional[str], device=None):
    """ONE artifact load for the whole in-process fleet (every replica
    and every supervisor rebuild binds it), or None.  ``device`` is the
    replicas' (None: the card)."""
    if not path:
        return None
    from ..device import resolve_device
    from .aot import AotArtifact

    aot = AotArtifact.load(path, device=resolve_device(device))
    print(f"aot: loaded {aot.program_count} program(s) from {path} in "
          f"{aot.load_seconds:.3f}s", flush=True)
    return aot


def _warm_fleet(fleet) -> None:
    """``--aot-warm`` in process: capture the artifact's universe on
    every replica before the server starts (and on every replica the
    supervisor rebuilds, before it serves)."""
    for i, wall in fleet.warm_aot().items():
        print(f"aot-warm: replica {i} captured "
              f"{fleet.engines[i].graphs.captures} step program(s) in "
              f"{wall:.3f}s", flush=True)


async def _selftest_async(dp: int = 1, audit_sample: int = 1,
                          unified: bool = False, layers: int = 2,
                          blocks: int = 64, device=None,
                          aot_path: Optional[str] = None,
                          aot_warm: bool = False) -> int:
    from ..observability.audit import AuditConfig

    loop = asyncio.get_running_loop()
    # the selftest always exercises the numerics-audit surface: every step
    # sampled by default, so the probe completion runs with the shadow
    # oracle live and must come back divergence-free.  With --aot-path the
    # probe must then serve with zero traces (and, warmed, no capture)
    aot = _load_aot(aot_path, device)
    fleet = _toy_fleet(dp=dp, layers=layers, num_blocks=blocks,
                       audit=AuditConfig(
                           enabled=True,
                           sample_every=max(1, audit_sample)),
                       unified=unified, device=device, aot=aot)
    if aot is not None and aot_warm:
        _warm_fleet(fleet)
    captures0 = sum(e.graphs.captures for e in fleet.engines)
    server = CompletionServer(fleet, ServerConfig(port=0))
    engine = server.engine
    await server.start()
    try:
        status, data = await loop.run_in_executor(
            None, _http, server.port, "GET", "/readyz", None)
        if status != 200:
            raise RuntimeError(f"/readyz {status}")
        # readiness reports the fleet shape
        if f"dp={fleet.dp} mp={engine.mp}".encode() not in data:
            raise RuntimeError(f"/readyz body missing fleet shape: {data!r}")
        status, data = await loop.run_in_executor(
            None, _http, server.port, "POST", "/v1/completions",
            {"prompt": [5, 9, 23, 7], "max_tokens": 4})
        if status != 200:
            raise RuntimeError(f"completions {status}: {data!r}")
        obj = json.loads(data)
        choice = obj["choices"][0]
        if len(choice["token_ids"]) != 4 \
                or choice["finish_reason"] != "length":
            raise RuntimeError(f"unexpected completion {choice}")
        # the completion's timeline is queryable after it finished
        status, data = await loop.run_in_executor(
            None, _http, server.port, "GET", "/v1/requests?state=recent",
            None)
        rows = json.loads(data)["data"] if status == 200 else []
        if not any(row["id"] == obj["id"] for row in rows):
            raise RuntimeError(
                f"finished completion missing from /v1/requests: {rows}")
        status, data = await loop.run_in_executor(
            None, _http, server.port, "GET", "/metrics", None)
        for series in (b"serving_time_to_first_token", b"serving_e2e_seconds",
                       b"serving_mp_shards", b"serving_fleet_replicas",
                       b"serving_audit_steps_total"):
            if status != 200 or series not in data:
                raise RuntimeError(f"metrics page missing {series!r}")
        # the probe went through the router
        if sum(fleet.routing_counts.values()) < 1:
            raise RuntimeError("completion did not route through the fleet")
        # the completion ran under sample_every=1: at least one step was
        # shadow-audited, with no divergence and no oracle failure
        status, data = await loop.run_in_executor(
            None, _http, server.port, "GET", "/v1/debug/audit", None)
        audit = json.loads(data)
        audited = sum(sum(row["audited_launches"].values())
                      for row in audit["data"])
        if (status != 200 or audit["status"] != "ok" or audited <= 0
                or any(sum(row["divergences"].values())
                       or row["oracle_failures"] for row in audit["data"])):
            raise RuntimeError(f"/v1/debug/audit {status}: {audit}")
        if aot is not None:
            # served inside the artifact's universe: no trace counter
            # moved, the compile table is empty, every replica is bound
            traces = sum(e.prefill_trace_count + e.decode_trace_count
                         + e.ragged_trace_count + e.burst_trace_count
                         for e in fleet.engines)
            if traces:
                raise RuntimeError(f"AOT selftest traced {traces} "
                                   "program(s)")
            if aot_warm and sum(e.graphs.captures for e in fleet.engines) \
                    != captures0:
                raise RuntimeError("a warmed AOT fleet captured while "
                                   "serving")
            status, data = await loop.run_in_executor(
                None, _http, server.port, "GET", "/v1/debug/compiles",
                None)
            obj = json.loads(data)
            if status != 200 or obj["data"] or not all(
                    row["loaded"] for row in obj["aot"].values()):
                raise RuntimeError(f"/v1/debug/compiles {status}: {obj}")
        print(f"selftest: OK (port {server.port}, dp={fleet.dp}, "
              f"mp={engine.mp}, device {engine.device}, tokens "
              f"{choice['token_ids']}, audited launches {audited}"
              + (f", aot programs {aot.program_count}, zero traces"
                 if aot is not None else "") + ")")
        return 0
    finally:
        await server.shutdown(drain_timeout=2.0)


def _mp_rank_factory(spec: dict):
    """This rank's part of ``--mp N``: join the world, lay the ranks out
    at mp=N, make every replica's groups (collective, on every rank in one
    order, before any engine), and return the replicas'
    ``serving.tp.ReplicaFactory``: replica ``i`` is this rank's shard of
    the toy model (every rank draws the same seeded weights and keeps its
    slice) and its engine, in role ``spec["roles"][i]``."""
    from .. import device as _device
    from ..distributed import env, topology
    from .tp import ReplicaFactory, replica_groups

    if spec["device"] == "cpu":
        _device.set_device("cpu")
    env.init_parallel_env()
    topology.init_mesh(mp=spec["mp"])
    groups = replica_groups(spec["dp"])
    roles = spec.get("roles")

    def build(i, registry=None):
        return _toy_engine(
            _toy_model(spec["layers"], spec["device"]),
            num_blocks=spec["blocks"], unified=spec["unified"],
            max_tokens_per_step=spec["max_tokens_per_step"],
            burst_steps=spec["burst"], registry=registry,
            metrics_labels=(None if spec["dp"] == 1
                            else {"replica": str(i)}),
            role=roles[i] if roles else "unified")

    return ReplicaFactory(groups, build)


def _mp_follower(spec: dict) -> None:
    """A follower rank of ``--mp N`` (started by the controller): its
    shard of every replica, each replica's steps launched on a thread of
    its own, until the controller stops the ranks."""
    import signal

    from ..distributed import env
    from .tp import follow_replicas

    # the controller stops this rank; an interrupt of the terminal's
    # process group is the controller's to handle
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    factory = _mp_rank_factory(spec)
    follow_replicas([factory(i) for i in range(spec["dp"])], factory)
    env.destroy_process_group()


def _spec_dict(args) -> Optional[dict]:
    """SpecConfig kwargs from the CLI (``None`` = spec decoding off)."""
    if not getattr(args, "spec_decode", False):
        return None
    return {"enabled": True, "k": args.spec_k}


def _build_procfleet(args, fault_plan=None, alert_rules=None):
    """N worker processes behind the SAME router/supervisor stack,
    reached over the wire protocol; each worker builds the CLI's toy
    model (``LlamaConfig.tiny``, a generator seeded with 0) on
    ``--device``, at ``--mp`` in a world of its own (the mp degree rides
    the worker spec; this process builds no world)."""
    from .procfleet import ProcessFleet, ProcessFleetConfig

    pf = ProcessFleet(ProcessFleetConfig(
        dp=args.workers, layers=args.layers, num_blocks=args.blocks,
        mp=args.mp,
        max_num_seqs=8, max_prefill_tokens_per_step=None,
        max_tokens_per_step=args.max_tokens_per_step,
        spec=_spec_dict(args), burst_steps=args.burst,
        unified=args.unified, device=args.device,
        audit_enabled=bool(args.audit_sample),
        audit_sample_every=args.audit_sample or 1,
        compile_cache=args.compile_cache,
        aot_path=args.aot_path, warm_boot=args.aot_warm,
        roles=args.roles_list,
        fleet=FleetConfig(max_queue=args.max_queue,
                          flight_dir=args.flight_dir,
                          fault_plan=fault_plan,
                          alert_rules=alert_rules)))
    if args.autoscale:
        from .procfleet import AutoscalerConfig

        pf.enable_autoscaler(AutoscalerConfig(
            min_replicas=args.autoscale_min,
            max_replicas=args.autoscale_max))
        print(f"autoscaler: live (min={pf.autoscaler.min_replicas}, "
              f"max={pf.autoscaler.max_replicas})", flush=True)
    if args.rebalance:
        pf.enable_rebalancer()
        print("rebalancer: live", flush=True)
    return pf


async def _selftest_procfleet_async(args) -> int:
    """Boot ``--workers`` worker processes, serve one completion over
    HTTP, and check the cross-process surfaces: the timeline honesty
    markers, the wire attribution and (with ``--autoscale``) a live
    autoscaler."""
    loop = asyncio.get_running_loop()
    pf = _build_procfleet(args)
    fleet = pf.router
    server = CompletionServer(fleet, ServerConfig(
        port=0, max_queue=args.max_queue))
    try:
        await server.start()
        status, data = await loop.run_in_executor(
            None, _http, server.port, "GET", "/readyz", None)
        if status != 200 or f"dp={args.workers}".encode() not in data:
            raise RuntimeError(f"/readyz {status}: {data!r}")
        status, data = await loop.run_in_executor(
            None, _http, server.port, "POST", "/v1/completions",
            {"prompt": [5, 9, 23, 7], "max_tokens": 4})
        if status != 200:
            raise RuntimeError(f"completions {status}: {data!r}")
        choice = json.loads(data)["choices"][0]
        if len(choice["token_ids"]) != 4:
            raise RuntimeError(f"unexpected completion {choice}")
        # honesty markers: --workers mode with telemetry streaming
        # answers /v1/requests with the full cross-process story
        status, data = await loop.run_in_executor(
            None, _http, server.port, "GET", "/v1/requests?state=recent",
            None)
        listing = json.loads(data) if status == 200 else {}
        if listing.get("source") != "router+workers" \
                or listing.get("complete") is not True:
            raise RuntimeError(f"/v1/requests {status}: {listing}")
        # wire-latency attribution is queryable after one completion
        status, data = await loop.run_in_executor(
            None, _http, server.port, "GET", "/v1/debug/wire", None)
        wire = json.loads(data) if status == 200 else {}
        if not wire.get("enabled") or wire.get("steps", 0) < 1:
            raise RuntimeError(f"/v1/debug/wire {status}: {wire}")
        if args.aot_path:
            # every worker booted off the artifact and traced nothing
            status, data = await loop.run_in_executor(
                None, _http, server.port, "GET", "/v1/debug/compiles",
                None)
            obj = json.loads(data)
            if status != 200 or obj["data"] or not all(
                    row.get("loaded") for row in obj["aot"].values()):
                raise RuntimeError(f"/v1/debug/compiles {status}: {obj}")
        if args.autoscale and (pf.autoscaler is None
                               or not pf.autoscaler._thread.is_alive()):
            raise RuntimeError("autoscaler actuator thread is not live")
        print(f"selftest: OK (port {server.port}, workers={args.workers},"
              f" device {server.engine.device}, tokens "
              f"{choice['token_ids']}, wire steps {wire['steps']}"
              + (", autoscaler live" if args.autoscale else "")
              + (", aot zero traces" if args.aot_path else "") + ")")
        return 0
    finally:
        await server.shutdown(drain_timeout=2.0)
        pf.shared.close_all()


async def _serve_cli(args) -> int:
    audit = None
    if args.audit_sample:
        from ..observability.audit import AuditConfig

        audit = AuditConfig(enabled=True, sample_every=args.audit_sample)
    fault_plan = None
    if args.fault_plan:
        from .faultinject import FaultPlan

        fault_plan = FaultPlan.from_json(args.fault_plan)
    alert_rules = None
    if args.alert_rules:
        from ..observability.alerts import AlertRuleSet

        alert_rules = AlertRuleSet.from_json(args.alert_rules)
    pf = followers = None
    if args.mp > 1 and not args.workers:
        from .tp import launch_followers, world_backend

        spec = {"mp": args.mp, "dp": args.dp, "device": args.device,
                "layers": args.layers, "blocks": args.blocks,
                "unified": args.unified,
                "max_tokens_per_step": args.max_tokens_per_step,
                "burst": args.burst, "roles": args.roles_list}
        followers = launch_followers(args.mp, _mp_follower, (spec,),
                                     backend=world_backend(args.mp,
                                                           args.device))
        factory = _mp_rank_factory(spec)
        fleet_cfg = FleetConfig(
            max_queue=args.max_queue, flight_dir=args.flight_dir,
            fault_plan=fault_plan, alert_rules=alert_rules,
            roles=args.roles_list)
        if args.dp == 1:
            # one engine keeps its own registry, unlabeled, as at mp=1
            fleet = FleetRouter([factory(0)], config=fleet_cfg)
            fleet._engine_factory = factory
        else:
            fleet = FleetRouter.build(factory, dp=args.dp, config=fleet_cfg)
        print(f"mp: ranks 1..{args.mp - 1} follow, pids "
              f"{[p.pid for p in followers.processes]}", flush=True)
    elif args.workers:
        pf = _build_procfleet(args, fault_plan=fault_plan,
                              alert_rules=alert_rules)
        fleet = pf.router
        for i in range(args.workers):
            print(f"worker {i}: pid {pf.worker_pid(i)}", flush=True)
    else:
        spec = None
        spec_kwargs = _spec_dict(args)
        if spec_kwargs:
            from .spec import SpecConfig

            spec = SpecConfig(**spec_kwargs)
        aot = _load_aot(args.aot_path, args.device)
        fleet = _toy_fleet(dp=args.dp, layers=args.layers,
                           num_blocks=args.blocks,
                           max_queue=args.max_queue,
                           flight_dir=args.flight_dir, audit=audit,
                           unified=args.unified, fault_plan=fault_plan,
                           alert_rules=alert_rules,
                           max_tokens_per_step=args.max_tokens_per_step,
                           spec=spec, burst_steps=args.burst,
                           roles=args.roles_list, device=args.device,
                           aot=aot)
        if aot is not None and args.aot_warm:
            _warm_fleet(fleet)
    supervisor = None
    if args.max_restarts > 0:
        # self-healing by default: dead replicas restart under capped
        # exponential backoff, audit-degraded replicas are quarantined
        # and replaced, wedged steps are watchdogged.  --max-restarts 0
        # opts out (a dead replica stays excluded)
        from .resilience import FleetSupervisor, SupervisorConfig

        supervisor = FleetSupervisor(fleet, config=SupervisorConfig(
            max_restarts=args.max_restarts,
            watchdog_timeout_s=args.watchdog_timeout))
    server = CompletionServer(fleet, ServerConfig(
        host=args.host, port=args.port,
        max_queue=args.max_queue,
        default_timeout_s=args.timeout))
    pusher = None
    if args.push_gateway:
        from ..observability.push import PushGateway

        pusher = PushGateway(args.push_gateway, registry=fleet.registry,
                             interval_s=args.push_interval).start()
    await server.start()
    if supervisor is not None:
        supervisor.start()  # closed by fleet.stop() during shutdown
    loop = asyncio.get_running_loop()
    try:
        import signal

        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, server.request_shutdown)
    except (NotImplementedError, RuntimeError):
        pass  # swallow-ok: platform without signal-handler support (non-main loop); Ctrl-C still raises KeyboardInterrupt
    print(f"serving on http://{server.cfg.host}:{server.port} "
          f"dp={fleet.dp} mp={server.engine.mp} "
          f"device={server.engine.device} "
          "(POST /v1/completions; GET /healthz /readyz /metrics "
          "/v1/requests /v1/debug/compiles /v1/debug/profile "
          "/v1/debug/audit /v1/debug/alerts /v1/debug/history "
          "/v1/debug/wire)", flush=True)
    try:
        await server.serve_forever()
    finally:
        if pusher is not None:
            pusher.close()
        if pf is not None:
            pf.shared.close_all()  # reap the worker processes
    if followers is not None:
        # drained: the followers leave every replica's loop and exit 0
        from ..distributed import env

        for eng in fleet.engines:
            eng.tp.release()
        followers.join(timeout=120)
        env.destroy_process_group()
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.server",
        description="HTTP/SSE serving frontend (toy model demo + selftest)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="device of the model and pools (default: the "
                        "card; 'cpu' runs the plain PyTorch versions)")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--blocks", type=int, default=256)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--timeout", type=float, default=None,
                   help="default per-request deadline (seconds)")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel degree: this process is rank 0 "
                        "(the controller) and starts mp-1 follower ranks; "
                        "NCCL with a card a rank, else gloo "
                        "(PADDLE_DISTRI_BACKEND chooses)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel fleet degree: N engine replicas "
                        "behind the prefix-affinity router")
    p.add_argument("--push-gateway", default=None, metavar="URL",
                   help="POST Prometheus text exposition of the fleet "
                        "registry to this URL on an interval (daemon "
                        "thread, capped exponential backoff on failure)")
    p.add_argument("--push-interval", type=float, default=15.0,
                   help="push-gateway export interval in seconds")
    p.add_argument("--fault-plan", default=None, metavar="FILE",
                   help="JSON fault plan for deterministic chaos runs "
                        "(serving/faultinject.py): named injection "
                        "points scheduled by (replica, engine step) — "
                        "engine_step_raise, pool_exhaust, slow_step, "
                        "kernel_corrupt; each fires exactly once and is "
                        "recorded as lifecycle/flight events")
    p.add_argument("--max-restarts", type=int, default=5, metavar="K",
                   help="self-healing supervisor: restarts allowed per "
                        "replica inside the crash-loop window before "
                        "permanent exclusion (capped exponential "
                        "backoff between attempts; audit-degraded "
                        "replicas are quarantined and replaced).  0 "
                        "disables supervision — a dead replica stays "
                        "excluded until an operator acts")
    p.add_argument("--watchdog-timeout", type=float, default=60.0,
                   metavar="S",
                   help="per-replica step watchdog: a step exceeding "
                        "this marks the replica unhealthy (excluded "
                        "from routing) and escalates to a restart if "
                        "the stall persists; only with supervision on")
    p.add_argument("--alert-rules", default=None, metavar="FILE",
                   help="JSON alert rule set evaluated over the metrics "
                        "history (observability/alerts.py); omitted = "
                        "the default serving rule set")
    p.add_argument("--flight-dir", default=None, metavar="DIR",
                   help="write flight-recorder post-mortem bundles "
                        "(engine death, preemption storms, 429 bursts, "
                        "drain overruns, numerics divergences) into "
                        "this directory")
    p.add_argument("--audit-sample", type=int, default=None, metavar="N",
                   help="enable online numerics auditing with a shadow-"
                        "oracle re-execution every Nth engine step "
                        "(NaN/Inf sentinel + logit telemetry on every "
                        "step; .npz repros land in --flight-dir); off "
                        "by default")
    p.add_argument("--max-tokens-per-step", type=int, default=None,
                   metavar="T",
                   help="unified ragged packing: per-step token budget "
                        "shared by decode rows, prefill chunks and "
                        "(with --spec-decode) draft verification; "
                        "required by --spec-decode")
    p.add_argument("--spec-decode", action="store_true",
                   help="speculative decoding: a host-side n-gram "
                        "proposer drafts tokens per decode-resident "
                        "request and the engine verifies them as short "
                        "chunks packed into the unified ragged step.  "
                        "Requires --unified and --max-tokens-per-step")
    p.add_argument("--spec-k", type=int, default=4, metavar="K",
                   help="--spec-decode: max draft tokens proposed per "
                        "request per step (default 4)")
    p.add_argument("--burst", type=int, default=0, metavar="N",
                   help="decode bursts: up to N decode steps on the "
                        "device per host round trip for a decode-only "
                        "resident cohort; token streams are identical "
                        "to per-step decode.  0 disables; inert with "
                        "--spec-decode (spec drafting wins)")
    p.add_argument("--unified", action="store_true",
                   help="serve through the unified ragged step (one "
                        "packed prefill+decode launch per engine step)")
    p.add_argument("--roles", default=None, metavar="SPEC",
                   help="prefill/decode disaggregation: per-replica role "
                        "counts, e.g. 'prefill:1,decode:2', summing to "
                        "--dp.  Admissions route to prefill specialists; "
                        "each request migrates (with its computed prompt "
                        "KV) to a decode specialist at its first token")
    p.add_argument("--workers", type=int, default=0, metavar="N",
                   help="cross-process fleet: N worker PROCESSES (python "
                        "-m paddle_tpu_torch.serving.worker) behind the "
                        "same prefix-affinity router and self-healing "
                        "supervisor, speaking the length-prefixed JSON "
                        "wire protocol over localhost — kill -9 a worker "
                        "and the fleet reroutes, respawns it and loses "
                        "nothing.  0 = in-process replicas (--dp)")
    p.add_argument("--autoscale", action="store_true",
                   help="with --workers: enable the SLO-driven "
                        "autoscaler (alert firings → bounded worker "
                        "scale actions).  Bounds via --autoscale-min / "
                        "--autoscale-max")
    p.add_argument("--autoscale-min", type=int, default=1, metavar="N",
                   help="autoscaler floor: never drain below N live "
                        "workers (default 1)")
    p.add_argument("--autoscale-max", type=int, default=0, metavar="N",
                   help="autoscaler ceiling: never provision above N "
                        "workers (0 = the fleet's --workers count; the "
                        "index space is fixed at boot)")
    p.add_argument("--rebalance", action="store_true",
                   help="with --workers: enable the prefix-cache "
                        "rebalancer (vnode reweighting and hot-prefix "
                        "migration across replicas)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="with --workers: the build directory of the "
                        "workers' CUDA kernels — sibling workers on one "
                        "DIR run nvcc once, and a later boot on DIR "
                        "builds nothing")
    p.add_argument("--aot-save", default=None, metavar="DIR",
                   help="save the configured engine's closed bucket "
                        "universe (--layers/--blocks/--unified/--burst/"
                        "--max-tokens-per-step) as an AOT artifact "
                        "directory (manifest, the kernels' libraries), "
                        "then exit")
    p.add_argument("--aot-path", default=None, metavar="DIR",
                   help="serve off a saved AOT artifact: every replica, "
                        "worker and supervisor rebuild shares it, and no "
                        "engine counts a trace (a mismatch fails at "
                        "boot); composes with --selftest and --workers")
    p.add_argument("--aot-max-seq", type=int, default=None, metavar="T",
                   help=f"--aot-save: bound the saved universe to "
                        f"sequences of at most T tokens (default "
                        f"{_AOT_MAX_SEQ}; the pool capacity caps it "
                        "either way)")
    p.add_argument("--aot-warm", action="store_true",
                   help="with --aot-save: capture every step program on "
                        "the saving engine (proves each captures; "
                        "nothing of it persists); with --aot-path: every "
                        "replica or worker captures the universe at boot, "
                        "so serving captures nothing (recorded as "
                        "serving_aot_warm_seconds)")
    p.add_argument("--selftest", action="store_true",
                   help="boot on an ephemeral port, serve one completion "
                        "against the toy fleet through the router path, "
                        "exit 0 on success")
    args = p.parse_args(argv)
    if args.mp > 1:
        for dest, flag in _WAITING_AT_MP:
            if getattr(args, dest):
                p.error(f"--mp {args.mp} with {flag} is not ported to "
                        f"paddle_tpu_torch yet (ROADMAP A11)")
    if args.dp < 1:
        p.error(f"--dp must be >= 1, got {args.dp}")
    if args.mp < 1:
        p.error(f"--mp must be >= 1, got {args.mp}")
    if args.workers < 0:
        p.error(f"--workers must be >= 0, got {args.workers}")
    if args.workers:
        if args.dp > 1:
            p.error("--workers and --dp are the two fleet modes — pick "
                    "one (cross-process: --workers N; in-process: "
                    "--dp N)")
        if args.autoscale_min < 1:
            p.error(f"--autoscale-min must be >= 1, got "
                    f"{args.autoscale_min}")
        if args.autoscale_max < 0:
            p.error(f"--autoscale-max must be >= 0, got "
                    f"{args.autoscale_max}")
        if args.autoscale_max and args.autoscale_max < args.autoscale_min:
            p.error("--autoscale-max must be >= --autoscale-min")
    elif args.autoscale or args.rebalance or args.compile_cache:
        p.error("--autoscale/--rebalance/--compile-cache act on the "
                "cross-process worker pool; they require --workers N")
    args.roles_list = None
    if args.roles:
        from .fleet import parse_roles

        try:
            args.roles_list = parse_roles(args.roles)
        except ValueError as e:
            p.error(f"--roles: {e}")
        size = args.workers if args.workers else args.dp
        if len(args.roles_list) != size:
            p.error(f"--roles names {len(args.roles_list)} replica(s) "
                    f"but the fleet has {size} (--workers/--dp)")
    if args.audit_sample is not None and args.audit_sample < 1:
        p.error(f"--audit-sample must be >= 1, got {args.audit_sample}")
    if args.max_restarts < 0:
        p.error(f"--max-restarts must be >= 0, got {args.max_restarts}")
    if args.spec_decode:
        if not args.unified:
            p.error("--spec-decode verifies drafts inside the unified "
                    "ragged step; it requires --unified")
        if args.max_tokens_per_step is None:
            p.error("--spec-decode needs --max-tokens-per-step: drafts "
                    "compete for the step's leftover token budget")
        if args.spec_k < 0:
            p.error(f"--spec-k must be >= 0, got {args.spec_k}")
    if args.burst < 0:
        p.error(f"--burst must be >= 0, got {args.burst}")
    if args.aot_max_seq is not None:
        if not args.aot_save:
            p.error("--aot-max-seq bounds the universe --aot-save saves; "
                    "it requires --aot-save")
        if args.aot_max_seq < 1:
            p.error(f"--aot-max-seq must be >= 1, got {args.aot_max_seq}")
    if args.aot_save and args.aot_path:
        p.error("--aot-save writes an artifact and exits, --aot-path "
                "serves one — pick one")
    if args.aot_warm and not (args.aot_save or args.aot_path):
        p.error("--aot-warm warms an artifact's universe: it requires "
                "--aot-save or --aot-path")
    if args.aot_path:
        import os

        if not os.path.exists(os.path.join(args.aot_path,
                                           "manifest.json")):
            p.error(f"--aot-path {args.aot_path}: no AOT artifact there "
                    "(manifest.json missing: unsaved, or a save was torn "
                    "before commit)")
    if args.aot_save:
        return _aot_save_cli(args)
    if args.selftest:
        if args.workers:
            return asyncio.run(_selftest_procfleet_async(args))
        return asyncio.run(_selftest_async(
            dp=args.dp, audit_sample=args.audit_sample or 1,
            unified=args.unified, layers=args.layers, blocks=args.blocks,
            device=args.device, aot_path=args.aot_path,
            aot_warm=args.aot_warm))
    return asyncio.run(_serve_cli(args))


def _aot_save_cli(args) -> int:
    """``--aot-save``: save the configured toy engine's universe; with
    ``--aot-warm`` capture every key of it on that saving engine."""
    from .aot import AotArtifact

    eng = _toy_engine(_toy_model(args.layers, args.device),
                      num_blocks=args.blocks, unified=args.unified,
                      max_tokens_per_step=args.max_tokens_per_step,
                      burst_steps=args.burst)
    art = AotArtifact.save(eng, args.aot_save,
                           max_seq_len=args.aot_max_seq or _AOT_MAX_SEQ)
    print("aot-save: " + json.dumps(art.describe(), indent=1), flush=True)
    if args.aot_warm:
        wall = art.warm(eng)
        print(f"aot-warm: captured {eng.graphs.captures} step program(s) "
              f"of {art.program_count} bucket(s) in {wall:.3f}s",
              flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
