"""Request objects for the serving engine (the port of
``paddle_tpu/serving/request.py``, host code carried over unchanged).

One :class:`Request` is the unit the engine schedules: a prompt, sampling
parameters, a deterministic per-request RNG stream, and the request's
lifecycle state.  The state machine is the vLLM-style one the Ragged Paged
Attention serving shape implies (PAPERS.md):

    WAITING ──admit──> RUNNING ──(eos/length/abort)──> FINISHED
       ▲                  │
       └────preempt───────┘   (blocks freed; recompute re-enqueues at the
                               FRONT of the waiting queue so a preempted
                               request never starves behind new arrivals)

Preemption-with-recompute keeps ``output_tokens``: the recompute prefill
runs over ``prompt + output_tokens`` and decoding continues where it
stopped, so a preempted request produces token-identical output to an
uninterrupted run (greedy; for sampling, the per-request RNG has already
consumed exactly ``len(output_tokens)`` draws, so the stream also lines up).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional

import numpy as np


class RequestState(Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


class FinishReason(Enum):
    EOS = "eos"          # emitted the eos token
    LENGTH = "length"    # hit max_new_tokens
    ABORT = "abort"      # caller abort / unservable request
    TIMEOUT = "timeout"  # per-request deadline / drain deadline hit
    REPLICA_FAILED = "replica_failed"  # the owning fleet replica died
    # (or was quarantined) mid-flight and the request was not
    # re-dispatchable (tokens already streamed, retryable not set) —
    # the supervisor's honest verdict instead of a hang


@dataclass
class SamplingParams:
    """Per-request decoding knobs (greedy when ``temperature == 0``)."""

    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0

    def sample(self, logits: np.ndarray, rng: np.random.Generator) -> int:
        """One token from a [vocab] logits row.  Greedy is RNG-free; a
        sampled draw consumes exactly one ``rng`` event, which is what
        makes recompute resume the stream at the right point.

        NOTE: the engine samples on device (Gumbel-max keyed by
        ``(seed, draw_index)`` inside the step — see ``ops/sampling.py``);
        this host implementation stays as the reference semantics (the filtering pipeline matches: temperature
        scale -> top-k mask -> top-p nucleus mask -> draw)."""
        if self.temperature == 0.0:
            return int(logits.argmax(-1))
        x = logits.astype(np.float64) / max(self.temperature, 1e-6)
        if self.top_k > 0:
            kth = np.sort(x)[-min(self.top_k, x.shape[-1])]
            x = np.where(x < kth, -np.inf, x)
        p = np.exp(x - x.max())
        p /= p.sum()
        if 0.0 < self.top_p < 1.0:
            # nucleus filter: keep the smallest prob mass >= top_p.  The
            # max-prob token always survives (its cumsum entry is first),
            # so the filtered distribution is never empty.
            order = np.argsort(-p)
            csum = np.cumsum(p[order])
            cut = int(np.argmax(csum >= self.top_p))
            keep = np.zeros_like(p, dtype=bool)
            keep[order[:cut + 1]] = True
            p = np.where(keep, p, 0.0)
            p /= p.sum()
        return int(rng.choice(p.shape[-1], p=p))


_req_counter = itertools.count()


@dataclass
class Request:
    """One generation request, engine-owned after :meth:`EngineCore.add_request`."""

    prompt_ids: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: object = None
    trace_id: Optional[str] = None   # rides every span/instant the engine
                                     # records for this request, so one
                                     # request's lifecycle is a filter over
                                     # the exported chrome trace
    priority: int = 0            # lower = more important; ties break by
                                 # arrival order (newest preempted first)
    state: RequestState = RequestState.WAITING
    finish_reason: Optional[FinishReason] = None
    output_tokens: List[int] = field(default_factory=list)
    num_preemptions: int = 0
    error: Optional[str] = None
    # prefix-cache accounting (scheduler-owned): tokens restored for free
    # from the prefix cache at the LAST admission (fork, zero recompute).
    # Reset on preemption (blocks freed), re-filled on re-admission.
    # Prefill *progress* has no mirror here — kv.seq_len(request_id) is
    # the single source of truth.
    num_cached_tokens: int = 0
    # client-facing cache attribution: cached tokens at the
    # FIRST admission — output is empty there, so this is always a count
    # of PROMPT tokens served for free, the number the completions
    # ``usage.prompt_cached_tokens`` field reports.  num_cached_tokens
    # above tracks the LAST admission and resets on preemption.
    prompt_cached_tokens: Optional[int] = None
    # externally-computed leading-block chain hashes: the fleet
    # router hashes the prompt's leading full blocks once for
    # prefix-affinity placement and hands them down, so the scheduler's
    # admission probe (kv.match_prefix) does not re-hash those blocks.
    # None = the probe hashes everything itself (single-engine path).
    prefix_hashes: Optional[List[bytes]] = None
    # per-request latency objective: when set, the engine
    # scores the finished request against it — serving_slo_total /
    # serving_slo_good_total are the fleet's goodput pair.  None = the
    # request carries no objective and is not scored.
    slo_ms: Optional[float] = None
    # engine-stamped timing (perf_counter seconds)
    arrival_time: float = 0.0
    prefill_start_time: Optional[float] = None  # first prefill chunk ran
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    def __post_init__(self):
        self.arrival_seq = next(_req_counter)
        if self.request_id is None:
            self.request_id = self.arrival_seq
        if self.trace_id is None:
            self.trace_id = str(self.request_id)
        self.prompt_ids = [int(t) for t in np.asarray(self.prompt_ids).reshape(-1)]
        self._rng = np.random.default_rng(self.sampling.seed)
        self._chunk_tokens = None  # this step's planned prefill chunk width
                                   # (scheduler-stamped, engine-consumed)
        self._probe_blocks = None  # memoized prefix-cache match for this
        self._probe_epoch = -1     # prompt, valid while kv.cache_epoch is
                                   # unchanged — a head-of-queue request
                                   # blocked on capacity is not re-hashed
                                   # every engine step

    # --- views --------------------------------------------------------------
    @property
    def finished(self) -> bool:
        return self.state == RequestState.FINISHED

    @property
    def num_computed_tokens(self) -> int:
        """Tokens whose KV must live in the pool while RUNNING: the prompt
        plus every generated token except the newest (whose KV is written
        by the decode step that consumes it)."""
        return len(self.prompt_ids) + len(self.output_tokens)

    @property
    def last_token(self) -> int:
        return (self.output_tokens[-1] if self.output_tokens
                else self.prompt_ids[-1])

    def append_token(self, tok: int) -> None:
        self.output_tokens.append(int(tok))

    def hit_eos(self, tok: int) -> bool:
        eos = self.sampling.eos_token_id
        return eos is not None and int(tok) == int(eos)

    @property
    def preempt_key(self):
        """Victim ordering: highest (priority, arrival_seq) goes first —
        least important, most recently arrived."""
        return (self.priority, self.arrival_seq)
