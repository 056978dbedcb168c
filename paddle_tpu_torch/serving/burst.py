"""Decode-burst host surface (the port of ``paddle_tpu/serving/burst.py``).

The device side is :func:`paddle_tpu_torch.ops.decode_burst.run_burst` — up
to N chained decode forwards whose sampled tokens stay on the device.  This
module owns the host half: the eligibility predicate (WHEN the engine may
burst), the length clamp (HOW FAR it may burst), and the burst metric
series, with the JAX package's names.

A burst launches only when the running set is a decode-only resident
cohort and the whole horizon is decided up front, so admission and
preemption stay host decisions at burst boundaries:

* ``burst_steps >= 2`` configured (1-step bursts are just decode);
* no prefill work pending: the plan carries no chunks AND the waiting
  queue is empty AND no running request still needs prefill (a chunk the
  budget deferred this step must not starve for N steps);
* speculative decoding off (it drafts from the freshest host history);
* at least 2 steps of headroom after the clamp.

The clamp reads ``plan.burst_capacity``, which the scheduler computed from
the ONE headroom accessor ``KVCacheManager.burst_capacity``, so a burst can
never hit pool exhaustion or a ``max_new_tokens`` boundary mid-flight.
"""

from __future__ import annotations

METRIC_NAMES = (
    "serving_burst_launches_total",
    "serving_burst_tokens_total",
    "serving_burst_length",
    "serving_host_roundtrips_total",
)

# burst lengths are clamped to config.burst_steps: power-of-two buckets
_LENGTH_BUCKETS = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


def register_metrics(registry, labels=None):
    """Create the burst series on ``registry`` (get-or-create).  The
    engine registers them at construction so they exist from the first
    read."""
    lb = labels or {}
    return {
        "launches": registry.counter(
            "serving_burst_launches_total",
            help="device-resident decode bursts launched", **lb),
        "tokens": registry.counter(
            "serving_burst_tokens_total",
            help="tokens emitted by burst launches (all rows)", **lb),
        "length": registry.histogram(
            "serving_burst_length",
            help="clamped burst length N per launch (decode steps "
                 "covered by one host round-trip)",
            buckets=_LENGTH_BUCKETS, **lb),
        "roundtrips": registry.counter(
            "serving_host_roundtrips_total",
            help="host->device step-program launches (a burst counts "
                 "once; the saving vs per-step decode is this series' "
                 "slope)", **lb),
    }


def clamp_burst(burst_steps: int, decodes, capacity: int) -> int:
    """``N = min(burst_steps, min per-row remaining max_new_tokens, pool
    headroom per row)`` — every term a quantity the host owns, so the
    device loop needs no max_new or pool masking.  Returns 0 when no burst
    is worth launching (``N < 2``)."""
    if burst_steps < 2 or not decodes:
        return 0
    remaining = min(r.sampling.max_new_tokens - len(r.output_tokens)
                    for r in decodes)
    n = min(int(burst_steps), int(remaining), int(capacity))
    return n if n >= 2 else 0


def burst_eligible(scheduler, plan, decodes, spec) -> bool:
    """True when this step's running set is a decode-only resident cohort
    (see the module docstring)."""
    if spec is not None or not decodes:
        return False
    if plan.prefills or scheduler.waiting:
        return False
    # a running request the chunk budget deferred this step still needs
    # prefill — bursting the decode cohort would starve it for N steps
    return not any(scheduler._needs_prefill(r) for r in scheduler.running)
