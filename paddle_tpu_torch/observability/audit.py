"""Online numerics auditing for the serving engine (the port of
``paddle_tpu/observability/audit.py``).

The engine's step programs are watched in *value*: a NaN that leaked into
a KV pool or a drifting attention kernel would otherwise surface only as
garbage tokens with no telemetry trail.  Three capabilities, all gated by
``EngineConfig.audit`` (an :class:`AuditConfig`; default **off** — zero
``serving_audit_*`` / ``serving_logit_*`` series on ``/metrics``):

* **NaN/Inf sentinel + logit-stats telemetry** — every step family
  computes :func:`logit_stats` over its output logits (per-row non-finite
  count, max \\|logit\\|, argmax margin).  With the auditor on, the
  captured graphs keep those stats (and the last logits) as static
  outputs, read after the replay; nothing is recomputed outside the graph
  and the capture keys are the same, so audit on vs off captures the same
  number of graphs (tested).  Every launch feeds the
  ``serving_logit_absmax`` / ``serving_logit_margin`` histograms; a
  non-finite row increments ``serving_audit_nonfinite_total{program}``,
  fires the ``nonfinite`` flight-recorder trigger and dumps a repro.
* **Shadow-oracle differential execution** — on sampled steps (a
  deterministic step-counter schedule, ``sample_every``; no wall clock,
  no randomness) the auditor re-executes the same step inputs through the
  model with the attention kernels' plain twins (``use_pallas=False``:
  ``ops/paged_decode.decode_reference`` for a decode step,
  ``ops/ragged_paged.ragged_reference`` for a unified step), eagerly and
  outside every graph: it touches no graph's static buffers and moves no
  kernel wrapper's launch counter.  Its pools are a snapshot taken on the
  device before the step: only the pages the step's block tables and
  slots name, gathered into compact pools whose tables are remapped — the
  oracle reads nothing else, so the answer is the same as over the whole
  pools at a fraction of the copy.  Greedy tokens must match exactly and
  logits within ``logit_atol``/``logit_rtol``;
  ``serving_audit_steps_total{program}`` counts audited launches,
  ``serving_audit_logit_absdiff`` the max-abs-diff per shadow run, and a
  mismatch increments ``serving_audit_divergence_total{kind=token|logit|
  nonfinite}``.  A shadow run that raises is counted in
  ``serving_audit_oracle_failures_total`` (never silently skipped).
* **Repro bundles + degraded state** — a divergence dumps an atomic
  (tmp→rename), size-capped (``max_repro_bytes``) ``.npz`` repro — the
  step inputs (tables and slots remapped onto the compact pools), the
  compact pre-step pools and the pages they came from, primary + reference
  logits, JSON metadata — and fires the ``divergence`` flight trigger.
  :func:`replay_repro` re-executes the reference on the stored inputs and
  verifies the mismatch reproduces.  The auditor marks itself
  ``degraded``.

Boundedness: repro paths live in a ``deque(maxlen=max_repros)``; at most
ONE repro is written per (kind, program) pair per auditor; counters are
fixed-key dicts.  Host-side cost when enabled is O(rows) per launch
outside sampled steps; the snapshot and the shadow re-run happen only on
sampled steps.
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the bucketed program families the engine audits: the legacy three plus
# the unified packed ragged step
AUDIT_PROGRAMS = ("prefill", "chunk", "decode", "ragged")

# divergence taxonomy: greedy token flipped / logits outside tolerance /
# non-finite values in the primary output
DIVERGENCE_KINDS = ("token", "logit", "nonfinite")

# the metric names this module registers
METRIC_NAMES = (
    "serving_audit_steps_total",
    "serving_audit_divergence_total",
    "serving_audit_nonfinite_total",
    "serving_audit_oracle_failures_total",
    "serving_audit_logit_absdiff",
    "serving_logit_absmax",
    "serving_logit_margin",
)

_ABSMAX_BUCKETS = (0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 1e3, 1e4)
_MARGIN_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 25.0)
_ABSDIFF_BUCKETS = (1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1,
                    1.0, 10.0)

# arrays dropped (biggest first) when a repro would exceed the byte cap
_REPRO_DROP_ORDER = ("v_pools", "k_pools", "reference_logits",
                     "primary_logits")

# the step inputs each shadow-audited family's reference consumes
_DECODE_INPUTS = ("ids", "pos", "tables", "lens", "slot_blocks",
                  "slot_offsets")
_RAGGED_INPUTS = ("ids", "pos", "seg_ids", "last_idx", "tables", "lens",
                  "slot_blocks", "slot_offsets")


def logit_stats(logits):
    """Per-row logit reductions: ``[rows, 3]`` float32 of (non-finite
    count, max |logit|, argmax margin = top1 - top2).  Non-finite entries
    are masked to 0 before the max/top-k so absmax/margin stay finite; the
    non-finite count carries the alarm.  A 1-D ``[vocab]`` row is one
    row."""
    l = logits.to(torch.float32)
    if l.dim() == 1:
        l = l[None, :]
    finite = torch.isfinite(l)
    nonfinite = torch.sum(~finite, dim=-1).to(torch.float32)
    safe = torch.where(finite, l, torch.zeros_like(l))
    absmax = torch.amax(torch.abs(safe), dim=-1)
    top2 = torch.topk(safe, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    return torch.stack([nonfinite, absmax, margin], dim=-1)


@dataclass(frozen=True)
class AuditConfig:
    """Numerics-audit knobs (``EngineConfig.audit``), the JAX package's
    fields and defaults.  Frozen so configs compare by value."""

    enabled: bool = False
    # deterministic step-counter schedule: engine step k (1-based) is
    # shadow-audited when (k - 1) % sample_every == 0.  1 = every step.
    sample_every: int = 16
    # logit comparison tolerance for the shadow oracle:
    # |primary - reference| <= atol + rtol * |reference|
    logit_atol: float = 1e-4
    logit_rtol: float = 1e-4
    # hard byte cap per .npz repro bundle: arrays are dropped biggest-
    # first (pools, then logits) until the bundle fits
    max_repro_bytes: int = 4 << 20
    # where .npz repros land; None = next to the flight recorder's
    # bundles (its dump_dir), or nowhere if neither is configured
    repro_dir: Optional[str] = None
    # cap on repros written per auditor (also once per (kind, program))
    max_repros: int = 4

    def __post_init__(self):
        if self.sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {self.sample_every}")
        if self.max_repros < 1:
            raise ValueError(
                f"max_repros must be >= 1, got {self.max_repros}")


def compact_pages(inputs: Dict[str, np.ndarray]) -> np.ndarray:
    """The sorted pages a step reads or writes: every page its block
    tables and slot arrays name, and the null page 0."""
    pages = np.union1d(np.asarray(inputs["tables"]).ravel(),
                       np.asarray(inputs["slot_blocks"]).ravel())
    return np.union1d(pages, [0]).astype(np.int64)


def remap_pages(inputs: Dict[str, np.ndarray],
                pages: np.ndarray) -> Dict[str, np.ndarray]:
    """``inputs`` with its block tables and slot pages renumbered onto
    the compact pools built from ``pages`` (page ``pages[i]`` → ``i``)."""
    out = dict(inputs)
    for key in ("tables", "slot_blocks"):
        a = np.asarray(inputs[key])
        out[key] = np.searchsorted(pages, a).astype(a.dtype)
    return out


class NumericsAuditor:
    """Per-engine online numerics audit: sentinel, shadow oracle, repro
    bundles, degraded state.

    One instance per :class:`~paddle_tpu_torch.serving.EngineCore`.  The
    engine thread is the only writer; other threads read :meth:`snapshot`
    under the auditor lock."""

    def __init__(self, engine, config: Optional[AuditConfig] = None,
                 registry=None, labels: Optional[Dict[str, str]] = None):
        self.engine = engine
        self.cfg = config if config is not None else AuditConfig()
        self.enabled = self.cfg.enabled
        self.labels: Dict[str, str] = dict(labels or {})
        self.registry = registry
        self._replica = self.labels.get("replica", "0")
        self.flight = None  # FlightRecorder, bound by bind_flight
        self._lock = threading.Lock()
        self._step = 0
        self._sampled = False
        self._degraded = False
        self.last_divergence: Optional[Dict] = None
        self._repros: deque = deque(maxlen=max(1, self.cfg.max_repros))
        self._repro_count = 0
        self._fired: set = set()   # (kind, program): one repro per pair
        # last dump ATTEMPT per key (≤ kinds × programs entries): a
        # persistently failing dump is retried only after a cooldown
        self._attempt_ts: Dict[Tuple[str, str], float] = {}
        self._attempt_cooldown_s = 30.0
        self._seq = 0
        # the largest pre-step snapshot taken (bytes of device memory the
        # compact pools held), for the cost of a sampled step
        self.snapshot_bytes_max = 0
        # the largest |primary - oracle| logit gap seen on a shadow run
        self.max_abs_diff = 0.0
        # plain-int mirrors for snapshot() — fixed keys
        self._launches = {p: 0 for p in AUDIT_PROGRAMS}
        self._divergences = {k: 0 for k in DIVERGENCE_KINDS}
        self._nonfinite_values = 0
        self._oracle_failures = 0
        if not self.enabled or registry is None:
            # disabled: never touch the registry, so /metrics stays free
            # of every serving_audit_* / serving_logit_* series (tested)
            self._steps_c = self._div_c = self._nonf_c = None
            self._oracle_fail_c = None
            self._absmax_h = self._margin_h = self._absdiff_h = None
            return
        self._steps_c = {
            p: registry.counter(
                "serving_audit_steps_total",
                "program launches audited on sampled steps",
                **dict(self.labels, program=p))
            for p in AUDIT_PROGRAMS}
        self._div_c = {
            k: registry.counter(
                "serving_audit_divergence_total",
                "numerics-audit divergences by kind",
                **dict(self.labels, kind=k))
            for k in DIVERGENCE_KINDS}
        self._nonf_c = {
            p: registry.counter(
                "serving_audit_nonfinite_total",
                "non-finite values observed in step-program logits",
                **dict(self.labels, program=p))
            for p in AUDIT_PROGRAMS}
        self._oracle_fail_c = registry.counter(
            "serving_audit_oracle_failures_total",
            "shadow re-executions that crashed before comparing — a "
            "non-zero value means the audit net is NOT providing "
            "coverage",
            **self.labels)
        self._absmax_h = registry.histogram(
            "serving_logit_absmax",
            "max |logit| over a step program's output rows",
            buckets=_ABSMAX_BUCKETS, **self.labels)
        self._margin_h = registry.histogram(
            "serving_logit_margin",
            "smallest argmax margin (top1 - top2) over a program's rows",
            buckets=_MARGIN_BUCKETS, **self.labels)
        self._absdiff_h = registry.histogram(
            "serving_audit_logit_absdiff",
            "max |primary - oracle| logit diff per shadow re-execution",
            buckets=_ABSDIFF_BUCKETS, **self.labels)

    # --- wiring -------------------------------------------------------------
    def bind_flight(self, recorder, replica: Optional[str] = None) -> None:
        """Attach a flight recorder (and pin the replica identity the
        divergence triggers and bundles carry)."""
        self.flight = recorder
        if replica is not None:
            self._replica = str(replica)

    # --- schedule -----------------------------------------------------------
    def begin_step(self) -> None:
        """Engine step opened: advance the deterministic sampling
        schedule."""
        if not self.enabled:
            return
        self._step += 1
        self._sampled = (self._step - 1) % self.cfg.sample_every == 0

    @property
    def sampled(self) -> bool:
        """True while the CURRENT engine step is shadow-audited."""
        return self.enabled and self._sampled

    @property
    def degraded(self) -> bool:
        return self._degraded

    @property
    def status(self) -> str:
        if not self.enabled:
            return "disabled"
        return "degraded" if self._degraded else "ok"

    # --- step-input capture -------------------------------------------------
    def snapshot_pools(self, k_pools: Sequence[torch.Tensor],
                       v_pools: Sequence[torch.Tensor],
                       inputs: Dict[str, np.ndarray]):
        """Capture the PRE-step KV pools for a shadow re-run, before the
        step writes the engine's pools in place.  Returns ``(pre_pools,
        inputs)``: ``pre_pools`` is ``(k_pages, v_pages)``, each layer's
        pool gathered on the device down to the pages the step names, and
        ``inputs`` the step inputs with their tables and slots remapped
        onto those pages (plus ``pages``, the original page ids).  Off a
        sampled step: ``(None, inputs)``, and nothing is copied.  The
        remapped tables keep only the columns the longest row reaches."""
        if not self.sampled:
            return None, inputs
        pages = compact_pages(inputs)
        idx = torch.as_tensor(pages, dtype=torch.long,
                              device=k_pools[0].device)
        with torch.no_grad():
            k = tuple(p.index_select(0, idx) for p in k_pools)
            v = tuple(p.index_select(0, idx) for p in v_pools)
        nbytes = sum(t.numel() * t.element_size() for t in k + v)
        self.snapshot_bytes_max = max(self.snapshot_bytes_max, nbytes)
        remapped = remap_pages(inputs, pages)
        # the table columns past the longest row are null-page padding of
        # the bucket, which the oracle masks out: dropping them bounds its
        # gathered context by the step's real width
        bs = k_pools[0].shape[1]
        width = max(1, -(-int(np.asarray(inputs["lens"]).max()) // bs))
        remapped["tables"] = np.ascontiguousarray(
            remapped["tables"][:, :width])
        remapped["pages"] = pages
        return (k, v), remapped

    # --- the audit hook (engine thread) -------------------------------------
    def observe_program(self, program: str, stats, bucket: Tuple[int, ...],
                        logits: Optional[np.ndarray] = None,
                        inputs: Optional[Dict[str, np.ndarray]] = None,
                        pre_pools=None,
                        requests: Sequence[Dict] = ()) -> Optional[str]:
        """One bucketed program launch: sentinel over the ``stats`` rows
        (every launch), plus — for a decode or unified launch on a sampled
        step with captured pools — the shadow-oracle re-execution.
        Returns the divergence kind when one fired (``None``
        otherwise)."""
        if not self.enabled:
            return None
        stats = np.asarray(stats, np.float32).reshape(-1, 3)
        if self._absmax_h is not None and stats.size:
            self._absmax_h.observe(float(stats[:, 1].max()))
            self._margin_h.observe(float(stats[:, 2].min()))
        if self.sampled:
            with self._lock:
                self._launches[program] += 1
            if self._steps_c is not None:
                self._steps_c[program].inc()
        nonfinite = int(stats[:, 0].sum())
        if nonfinite:
            with self._lock:
                self._nonfinite_values += nonfinite
            if self._nonf_c is not None:
                self._nonf_c[program].inc(nonfinite)
            self._divergence(
                "nonfinite", program, bucket,
                info={"nonfinite_values": nonfinite,
                      "nonfinite_rows": int((stats[:, 0] > 0).sum()),
                      "requests": [str(r.get("id")) for r in requests]},
                arrays_fn=lambda: self._repro_arrays(inputs, pre_pools,
                                                     primary=logits))
            return "nonfinite"
        if program in ("decode", "ragged") and self.sampled \
                and pre_pools is not None and logits is not None:
            return self._shadow_step(program, pre_pools, inputs, logits,
                                     bucket, requests)
        return None

    # --- shadow oracle ------------------------------------------------------
    def _shadow_step(self, program, pre_pools, inputs, primary, bucket,
                     requests) -> Optional[str]:
        try:
            if program == "ragged":
                ref = self._reference_ragged(pre_pools, inputs)
            else:
                ref = self._reference_decode(pre_pools, inputs)
        except Exception:
            # the oracle must never kill the engine — but a crashed
            # oracle means this step was NOT compared, so it is counted
            # loudly: "audited launches > 0 with zero divergences" must
            # never be satisfiable vacuously
            with self._lock:
                self._oracle_failures += 1
            if self._oracle_fail_c is not None:
                self._oracle_fail_c.inc()
            sys.stderr.write("[audit] shadow re-execution failed:\n"
                             + traceback.format_exc())
            return None
        B = primary.shape[0]
        ref = ref[:B]
        diff = np.abs(ref - primary)
        maxdiff = float(diff.max()) if diff.size else 0.0
        self.max_abs_diff = max(self.max_abs_diff, maxdiff)
        if self._absdiff_h is not None:
            self._absdiff_h.observe(maxdiff)
        tok_p = primary.argmax(-1)
        tok_r = ref.argmax(-1)
        greedy = np.array([bool(r.get("greedy", True)) for r in requests]
                          or [True] * B)[:B]
        token_rows = [int(i) for i in range(B)
                      if greedy[i] and tok_p[i] != tok_r[i]]
        tol = self.cfg.logit_atol + self.cfg.logit_rtol * np.abs(ref)
        logit_bad = bool((diff > tol).any())
        if token_rows:
            kind = "token"
        elif logit_bad:
            kind = "logit"
        else:
            return None
        self._divergence(
            kind, program, bucket,
            info={"max_abs_diff": round(maxdiff, 8),
                  "token_rows": token_rows,
                  "greedy_rows": [int(i) for i in range(B) if greedy[i]],
                  "primary_tokens": [int(t) for t in tok_p],
                  "reference_tokens": [int(t) for t in tok_r],
                  "requests": [str(r.get("id")) for r in requests]},
            arrays_fn=lambda: self._repro_arrays(
                inputs, pre_pools, primary=primary, reference=ref))
        return kind

    def _reference_caches(self, pre_pools, inputs, ragged: bool):
        """One plain-twin :class:`PagedCache` per layer over (copies of)
        the snapshot pools, routed with the step's remapped inputs."""
        from ..ops.paged_attention import PagedCache

        dev = self.engine.device
        dtype = self.engine._pool_dtype
        k_pools, v_pools = pre_pools
        caches = []
        for k, v in zip(k_pools, v_pools):
            # the oracle writes this step's K/V into its pools: a copy,
            # so a snapshot (or a repro's arrays) can be replayed again
            c = PagedCache(torch.as_tensor(k).to(dev, dtype, copy=True),
                           torch.as_tensor(v).to(dev, dtype, copy=True))
            if ragged:
                pos = torch.as_tensor(np.asarray(inputs["pos"]),
                                      device=dev)
                c.route(inputs["tables"], inputs["lens"],
                        inputs["slot_blocks"], inputs["slot_offsets"],
                        q_start=pos[0], seg_ids=inputs["seg_ids"])
            else:
                c.route(inputs["tables"], inputs["lens"],
                        inputs["slot_blocks"], inputs["slot_offsets"])
            c.use_pallas = False   # the plain twin: the oracle
            caches.append(c)
        return caches

    def _reference_decode(self, pre_pools, inputs) -> np.ndarray:
        """Re-execute one decode step through the model with the decode
        kernel's plain twin (``ops/paged_decode.decode_reference``),
        eagerly: ``[Bb, vocab]`` fp32 last-position logits."""
        eng = self.engine
        caches = self._reference_caches(pre_pools, inputs, ragged=False)
        ids = torch.as_tensor(np.asarray(inputs["ids"]), dtype=torch.long,
                              device=eng.device)
        pos = torch.as_tensor(np.asarray(inputs["pos"]), device=eng.device)
        with torch.no_grad():
            logits = eng.model(ids, caches=caches, pos=pos)
            out = logits[:, -1, :].float()
        return out.cpu().numpy()

    def _reference_ragged(self, pre_pools, inputs) -> np.ndarray:
        """Re-execute one packed ragged step through the model with the
        ragged kernel's plain twin (``ops/ragged_paged.ragged_reference``)
        and the same packing metadata, eagerly: each row's last-token
        logits, ``[Tb, vocab]`` fp32."""
        eng = self.engine
        caches = self._reference_caches(pre_pools, inputs, ragged=True)
        ids = torch.as_tensor(np.asarray(inputs["ids"]), dtype=torch.long,
                              device=eng.device)
        pos = torch.as_tensor(np.asarray(inputs["pos"]), device=eng.device)
        last_idx = torch.as_tensor(np.asarray(inputs["last_idx"]),
                                   dtype=torch.long, device=eng.device)
        with torch.no_grad():
            logits = eng.model(ids, caches=caches, pos=pos)[0].float()
            out = logits[last_idx]
        return out.cpu().numpy()

    # --- divergence handling ------------------------------------------------
    @staticmethod
    def _repro_arrays(inputs, pre_pools, primary=None,
                      reference=None) -> Dict[str, np.ndarray]:
        arrays: Dict[str, np.ndarray] = {}
        for k, v in (inputs or {}).items():
            arrays[k] = np.asarray(v)
        if pre_pools is not None:
            k_pools, v_pools = pre_pools
            arrays["k_pools"] = _host_stack(k_pools)
            arrays["v_pools"] = _host_stack(v_pools)
        if primary is not None:
            arrays["primary_logits"] = np.asarray(primary, np.float32)
        if reference is not None:
            arrays["reference_logits"] = np.asarray(reference, np.float32)
        return arrays

    def _divergence(self, kind: str, program: str, bucket, info: Dict,
                    arrays_fn) -> None:
        entry = {
            "kind": kind, "program": program,
            "bucket": [int(b) for b in bucket],
            "step": self._step, "replica": self._replica,
            "unix": round(time.time(), 6), **info,
        }
        key = (kind, program)
        repro = None
        now = time.perf_counter()
        with self._lock:
            # degraded flips in the SAME critical section the counter
            # moves: a concurrent snapshot() can never read
            # divergences > 0 next to status "ok"
            self._divergences[kind] += 1
            self._degraded = True
            last_try = self._attempt_ts.get(key)
            want = (key not in self._fired
                    and self._repro_count < self.cfg.max_repros
                    and (last_try is None
                         or now - last_try >= self._attempt_cooldown_s))
            if want:
                self._attempt_ts[key] = now
        if self._div_c is not None:
            self._div_c[kind].inc()
        if want and self._repro_dir() is not None:
            # arrays are materialized ONLY when a dump will actually be
            # attempted
            repro = self._dump_repro(kind, program, entry, arrays_fn())
        if repro is not None:
            entry["repro"] = repro
            with self._lock:
                # fired-once is recorded on SUCCESS, not attempt: a
                # transient dump failure must not suppress the one
                # actionable bundle for this divergence kind
                self._fired.add(key)
                self._repros.append(repro)
                self._repro_count += 1
        with self._lock:
            self.last_divergence = entry
        if self.flight is not None:
            trigger = "nonfinite" if kind == "nonfinite" else "divergence"
            try:
                self.flight.trigger(
                    trigger, replica=self._replica,
                    detail=json.dumps(entry, default=str))
            except Exception:
                pass  # telemetry must never take down the engine thread; the divergence itself is already counted and degraded above

    def _repro_dir(self) -> Optional[str]:
        if self.cfg.repro_dir is not None:
            return self.cfg.repro_dir
        if self.flight is not None:
            return self.flight.cfg.dump_dir
        return None

    def _dump_repro(self, kind: str, program: str, meta: Dict,
                    arrays: Dict[str, np.ndarray]) -> Optional[str]:
        """Atomic, size-capped ``.npz`` repro: step inputs + pre-step
        pools + primary/reference logits + JSON metadata.  Arrays are
        dropped biggest-first until the bundle fits
        ``max_repro_bytes``; the metadata records what was dropped."""
        d = self._repro_dir()
        if d is None:
            return None
        eng = self.engine
        self._seq += 1
        path = os.path.join(
            d, f"audit_{kind}_{program}_r{self._replica}_"
               f"{self._seq:03d}.npz")
        arrays = dict(arrays)
        dropped: List[str] = []
        cfg_meta = {
            "sample_every": self.cfg.sample_every,
            "logit_atol": self.cfg.logit_atol,
            "logit_rtol": self.cfg.logit_rtol,
            "block_size": eng.block_size,
            "num_blocks": eng.num_blocks,
            "mp": 1,
            "use_pallas_paged": bool(eng._use_pallas),
            "device": str(eng.device),
        }
        while True:
            m = dict(meta, config=cfg_meta, dropped=list(dropped),
                     bundle="paddle_tpu.audit_repro")
            buf = io.BytesIO()
            np.savez_compressed(buf, meta=np.array(json.dumps(
                m, default=str)), **arrays)
            if buf.tell() <= self.cfg.max_repro_bytes:
                break
            for k in _REPRO_DROP_ORDER:
                if k in arrays:
                    dropped.append(k)
                    del arrays[k]
                    break
            else:
                return None  # even the minimal bundle exceeds the cap
        try:
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(buf.getvalue())
            os.replace(tmp, path)  # atomic: no torn repro on crash
        except Exception:
            sys.stderr.write("[audit] repro dump failed:\n"
                             + traceback.format_exc())
            return None
        return path

    # --- inspection ---------------------------------------------------------
    @property
    def steps(self) -> int:
        return self._step

    @property
    def repros(self) -> List[str]:
        with self._lock:
            return list(self._repros)

    def snapshot(self) -> Dict:
        """JSON-able state (the payload of a ``/v1/debug/audit``
        endpoint).  Read under the auditor lock, so the degraded flag and
        the divergence counters are always mutually consistent."""
        with self._lock:
            last = (dict(self.last_divergence)
                    if self.last_divergence is not None else None)
            return {
                "replica": self._replica,
                "enabled": self.enabled,
                "status": self.status,
                "sample_every": self.cfg.sample_every,
                "steps": self._step,
                "audited_launches": dict(self._launches),
                "divergences": dict(self._divergences),
                "nonfinite_values": self._nonfinite_values,
                "oracle_failures": self._oracle_failures,
                "last_divergence": last,
                "repros": list(self._repros),
            }


def _host_stack(pools) -> np.ndarray:
    """Layers of pool pages as one host array (bf16 pools as fp32: numpy
    has no bfloat16)."""
    out = []
    for p in pools:
        t = torch.as_tensor(p)
        if t.dtype == torch.bfloat16:
            t = t.float()
        out.append(t.detach().cpu().numpy())
    return np.stack(out)


# --- repro load / replay ----------------------------------------------------

def load_repro(path: str) -> Dict:
    """Read a ``.npz`` repro back: ``{"meta": dict, "arrays": {...}}``."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        arrays = {k: np.array(z[k]) for k in z.files if k != "meta"}
    return {"meta": meta, "arrays": arrays}


def replay_repro(path: str, engine) -> Dict:
    """Replay a repro bundle against ``engine`` (same model/weights as
    the auditing engine): re-execute the reference on the stored step
    inputs + pre-step pools and check the recorded mismatch reproduces.
    For ``nonfinite`` repros (or bundles whose pools were size-capped
    away) the verdict comes from the stored arrays.  Returns ``{"kind",
    "program", "reproduced", ...}``."""
    r = load_repro(path)
    meta, a = r["meta"], r["arrays"]
    kind, program = meta["kind"], meta["program"]
    out: Dict = {"kind": kind, "program": program}
    primary = a.get("primary_logits")
    if kind == "nonfinite":
        out["reproduced"] = (primary is not None
                             and not np.isfinite(primary).all())
        return out
    if program == "decode" and "k_pools" in a and "v_pools" in a:
        ref = engine.audit._reference_decode(
            (tuple(a["k_pools"]), tuple(a["v_pools"])),
            {k: a[k] for k in _DECODE_INPUTS})
        ref = ref[:primary.shape[0]] if primary is not None else ref
        out["replayed"] = True
    elif program == "ragged" and "k_pools" in a and "v_pools" in a:
        ref = engine.audit._reference_ragged(
            (tuple(a["k_pools"]), tuple(a["v_pools"])),
            {k: a[k] for k in _RAGGED_INPUTS})
        ref = ref[:primary.shape[0]] if primary is not None else ref
        out["replayed"] = True
    else:
        ref = a.get("reference_logits")
        out["replayed"] = False
    if ref is None or primary is None:
        out["reproduced"] = False
        out["note"] = "arrays truncated below the replayable minimum"
        return out
    diff = np.abs(ref - primary)
    out["max_abs_diff"] = float(diff.max()) if diff.size else 0.0
    if kind == "token":
        # compare only the greedy rows the original divergence was
        # allowed to claim — a near-tie argmax flip on a sampled row must
        # not fake a reproduction
        rows = meta.get("greedy_rows")
        if rows is None:
            rows = list(range(primary.shape[0]))
        rows = [r for r in rows if r < primary.shape[0]]
        out["reproduced"] = bool(rows) and bool(
            (ref[rows].argmax(-1) != primary[rows].argmax(-1)).any())
    else:
        # compare under the tolerances the divergence was DETECTED with
        # (recorded in the bundle)
        rec = meta.get("config", {})
        atol = float(rec.get("logit_atol", engine.audit.cfg.logit_atol))
        rtol = float(rec.get("logit_rtol", engine.audit.cfg.logit_rtol))
        tol = atol + rtol * np.abs(ref)
        out["reproduced"] = bool((diff > tol).any())
    return out
