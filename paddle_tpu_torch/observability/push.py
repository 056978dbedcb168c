"""Prometheus push-gateway export (the port of
``paddle_tpu/observability/push.py``).

Scrape-based ``/metrics`` endpoints (``httpd.py``, the serving route)
assume something can reach the process; batch jobs and short-lived
workers behind NAT need the inverse — the process **pushes** its
registry to a gateway.  :class:`PushGateway` runs a daemon thread that
POSTs the Prometheus text exposition to a configured URL on an
interval, with capped exponential backoff on failure:

* success → sleep ``interval_s``, backoff resets;
* failure → ``push_failures_total`` increments and the next attempt
  waits ``min(interval_s * 2**consecutive_failures, max_backoff_s)`` —
  a dead gateway costs bounded retry traffic, never a hot loop.

A serving frontend or any training job wires this in with three
lines.  Everything is stdlib (``urllib.request``) — no client library.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.request
from typing import Optional

from .httpd import PROMETHEUS_CONTENT_TYPE
from .metrics import MetricsRegistry, get_registry

# the metric names this module registers
METRIC_NAMES = ("push_total", "push_failures_total")


class PushGateway:
    """Daemon-thread pusher for one registry.

    ``start()`` begins the loop, which pushes IMMEDIATELY and then on
    the interval — a job shorter than one interval still exports.
    ``close()`` stops the loop after one final push (bounded by
    ``timeout_s``; pass ``final_push=False`` to skip it, e.g. when the
    gateway is known dead and a drain must not stall).  ``push_now()``
    performs one synchronous push and returns whether it succeeded (the
    loop and tests share it)."""

    def __init__(self, url: str,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 15.0,
                 timeout_s: float = 5.0,
                 max_backoff_s: float = 120.0):
        if not url.lower().startswith(("http://", "https://")):
            raise ValueError(f"push-gateway URL must be http(s), got {url!r}")
        self.url = url
        self.registry = registry if registry is not None else get_registry()
        self.interval_s = max(0.01, float(interval_s))
        self.timeout_s = float(timeout_s)
        self.max_backoff_s = max(self.interval_s, float(max_backoff_s))
        self._pushes = self.registry.counter(
            "push_total", "push-gateway export attempts")
        self._failures = self.registry.counter(
            "push_failures_total", "push-gateway export failures")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._consecutive_failures = 0

    # --- one push -----------------------------------------------------------
    def push_now(self) -> bool:
        """POST the registry's text exposition once; never raises."""
        body = self.registry.prometheus_text().encode("utf-8")
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": PROMETHEUS_CONTENT_TYPE})
        self._pushes.inc()
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                ok = 200 <= resp.status < 300
        except (urllib.error.URLError, OSError, ValueError):
            ok = False  # swallow-ok: counted just below via push_failures_total + backoff
        if ok:
            self._consecutive_failures = 0
        else:
            self._consecutive_failures += 1
            self._failures.inc()
        return ok

    @property
    def next_delay_s(self) -> float:
        """The loop's current sleep: the interval, or the capped
        exponential backoff while the gateway is failing."""
        if self._consecutive_failures == 0:
            return self.interval_s
        return min(self.interval_s * (2.0 ** self._consecutive_failures),
                   self.max_backoff_s)

    # --- loop ---------------------------------------------------------------
    def _loop(self) -> None:
        self.push_now()  # immediately: a job shorter than one interval
        # (the stated NAT'd-batch-job use case) still exports its state
        while not self._stop.wait(self.next_delay_s):
            self.push_now()

    def start(self) -> "PushGateway":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="push-gateway", daemon=True)
            self._thread.start()
        return self

    def close(self, join_timeout: float = 2.0,
              final_push: bool = True) -> None:
        started = self._thread is not None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(join_timeout)
            self._thread = None
        if started and final_push:
            # the job's last recorded state; one attempt, bounded by
            # timeout_s — a dead gateway costs that much, never a hang
            self.push_now()


def start_push_gateway(url: str,
                       registry: Optional[MetricsRegistry] = None,
                       interval_s: float = 15.0,
                       **kwargs) -> PushGateway:
    """Convenience: build + start a :class:`PushGateway`."""
    return PushGateway(url, registry=registry, interval_s=interval_s,
                       **kwargs).start()
