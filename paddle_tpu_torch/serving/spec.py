"""Speculative decoding: self-speculative n-gram draft and verify (the
port of ``paddle_tpu/serving/spec.py``, host code carried over).

Decode is one token per model step.  This module drafts k candidate
tokens per decode-resident request on the host (an n-gram proposer with
no model cost) and the engine packs them as a short **verify chunk**
``[last_token, d1..dk]`` into the unified ragged step: a verify row IS a
prefill-chunk-shaped row of already-chosen tokens, so there is **no new
step family and no new bucket axis** — the packed token count stays
inside the same ``max(max_tokens_per_step, decode rows)`` bucket bound,
and spec on captures no graph under a key spec off lacks.

Verification is **exact-match against the in-step sampler's targets**
(``ops/sampling.py``): position j of a verify row yields target token
T_j — the token the plain one-token-per-step path would have sampled at
that output position, because the logits prefix AND the
``(seed, draw_index)`` key are identical.  The longest
``d_{j+1} == T_j`` prefix is accepted, tokens ``T_0..T_a`` all emit in
ONE engine step, and the KV slots past the last consumed position roll
back via :meth:`~paddle_tpu_torch.serving.kv_manager.KVCacheManager.truncate`.
Hence the contract: spec on is **token-identical** to spec off (greedy
and seeded sampling alike) with **strictly fewer engine steps** on a
decode-heavy stream — exactly where both run the same attention route
(on the card, a verify row takes the ragged kernel's chunk path where a
plain decode row takes its decode path; in bf16 the two may round a
near-tie differently).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

# pre-registered on the engine's registry by :class:`SpecDecoder` so the
# series exist from the first scrape
METRIC_NAMES = (
    "serving_spec_draft_tokens_total",     # drafts packed into verify rows
    "serving_spec_accepted_tokens_total",  # drafts that matched their target
    "serving_spec_verify_rows_total",      # decode rows upgraded to verify
    "serving_spec_accept_ratio",           # accepted/drafted, cumulative
    "serving_spec_accept_length",          # accepted-run length per verify row
)

# accepted-run length buckets: k is small (draft budget), so unit bins
_ACCEPT_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)


@dataclass
class SpecConfig:
    """Speculative-decoding knobs (``EngineConfig.spec``)."""

    enabled: bool = True
    k: int = 4           # max draft tokens per request per step
    ngram: int = 3       # longest suffix n-gram the proposer matches
    min_ngram: int = 1   # shortest match worth proposing from
    window: int = 256    # proposer lookback cap (host-cost bound): only
                         # the most recent ``window`` context tokens are
                         # scanned for a match

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"SpecConfig.k must be >= 0, got {self.k}")
        if self.min_ngram < 1 or self.ngram < self.min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= ngram, got min_ngram="
                f"{self.min_ngram}, ngram={self.ngram}")
        if self.window < self.ngram + 1:
            raise ValueError(
                f"SpecConfig.window={self.window} cannot cover an "
                f"ngram={self.ngram} match plus a draft token")

    def manifest_dict(self) -> Dict[str, int]:
        """The wire/manifest identity of this config: workers hash it
        into their handshake so replicas running different spec
        deployments refuse each other."""
        return {"enabled": bool(self.enabled), "k": int(self.k),
                "ngram": int(self.ngram),
                "min_ngram": int(self.min_ngram),
                "window": int(self.window)}

    def manifest_json(self) -> str:
        return json.dumps(self.manifest_dict(), sort_keys=True)


class NgramProposer:
    """Draft proposer with zero model cost: find the most recent earlier
    occurrence of the context's longest suffix n-gram and propose the
    tokens that followed it.  Stateless — every call re-derives from the
    context, so preemption/recompute cannot desynchronize it.  Returns
    ``[]`` whenever there is nothing defensible to propose (no match,
    ``k == 0``, context too short) — the row stays a plain decode row.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 window: int = 256):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.window = int(window)

    def propose(self, context: List[int], k: int) -> List[int]:
        if k <= 0:
            return []
        ctx = [int(t) for t in context[-self.window:]]
        n = len(ctx)
        for m in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            suffix = ctx[n - m:]
            # most recent earlier occurrence whose continuation exists
            for i in range(n - m - 1, -1, -1):
                if ctx[i:i + m] == suffix:
                    follow = ctx[i + m:i + m + k]
                    if follow:
                        return follow
        return []


class SpecDecoder:
    """Per-engine speculative-decode driver: proposes drafts inside the
    scheduler's leftover token budget, upgrades decode rows to verify
    rows (allocating their draft KV slots), and owns the accept-ratio /
    accept-length telemetry.  The engine does the packing, emission and
    rollback — this object never touches device state."""

    def __init__(self, config: SpecConfig, registry=None,
                 labels: Optional[Dict[str, str]] = None):
        self.config = config
        self.proposer = NgramProposer(config.ngram, config.min_ngram,
                                      config.window)
        self.drafted_total = 0
        self.accepted_total = 0
        lb = labels or {}
        self._m_drafted = self._m_accepted = None
        self._m_rows = self._m_ratio = self._m_len = None
        if registry is not None:
            self._m_drafted = registry.counter(
                "serving_spec_draft_tokens_total",
                help="draft tokens packed into verify rows", **lb)
            self._m_accepted = registry.counter(
                "serving_spec_accepted_tokens_total",
                help="draft tokens that matched their sampled target", **lb)
            self._m_rows = registry.counter(
                "serving_spec_verify_rows_total",
                help="decode rows upgraded to draft/verify rows", **lb)
            self._m_ratio = registry.gauge(
                "serving_spec_accept_ratio",
                help="cumulative accepted/drafted draft-token ratio", **lb)
            self._m_len = registry.histogram(
                "serving_spec_accept_length",
                help="accepted-run length per verify row (in draft tokens)",
                buckets=_ACCEPT_BUCKETS, **lb)

    # --- planning (engine's _unified_exec, pre-launch) ----------------------
    def plan_drafts(self, kv, rows: List[Dict], budget: int) -> int:
        """Upgrade decode rows to verify rows in-place, spending at most
        ``budget`` draft tokens.  Per row: propose up to k drafts from
        the request's full context, allocate the draft KV slots
        all-or-nothing (`spec_draft` cause), and rewrite the row as the
        ``[last_token, d1..dk]`` chunk.  A row with no proposal, no
        remaining length headroom, or no allocatable slots stays a plain
        decode row.  Returns the number of draft tokens packed."""
        packed = 0
        for row in rows:
            if row["kind"] != "decode":
                continue
            left = budget - packed
            if left <= 0:
                break
            req = row["req"]
            # never draft past the request's own length budget: the step
            # emits at least one token, so only max_new - out - 1 more
            # CAN be consumed
            headroom = (req.sampling.max_new_tokens
                        - len(req.output_tokens) - 1)
            k = min(self.config.k, left, headroom)
            if k <= 0:
                continue
            drafts = self.proposer.propose(
                req.prompt_ids + req.output_tokens, k)
            if not drafts:
                continue
            # +1 covers the decode slot's own position already held; the
            # extra blocks cover positions p+1..p+k (all-or-nothing)
            if not kv.allocate(req.request_id, 1 + len(drafts),
                               cause="spec_draft"):
                continue  # pool pressure: plain decode, not an error
            row["kind"] = "verify"
            row["drafts"] = [int(d) for d in drafts]
            row["tokens"] = [req.last_token] + row["drafts"]
            row["n"] = 1 + len(drafts)
            packed += len(drafts)
            self.drafted_total += len(drafts)
            if self._m_drafted is not None:
                self._m_drafted.inc(len(drafts))
                self._m_rows.inc()
        return packed

    # --- accounting (engine's _unified_exec, post-launch) -------------------
    def record(self, drafted: int, accepted: int) -> None:
        self.accepted_total += accepted
        if self._m_accepted is not None:
            self._m_accepted.inc(accepted)
            self._m_len.observe(accepted)
            if self.drafted_total:
                self._m_ratio.set(self.accepted_total
                                  / self.drafted_total)

    @property
    def accept_ratio(self) -> float:
        return (self.accepted_total / self.drafted_total
                if self.drafted_total else 0.0)
