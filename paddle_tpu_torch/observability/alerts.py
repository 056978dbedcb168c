"""SLO burn-rate alerting over the metrics history (the port of
``paddle_tpu/observability/alerts.py``).

The serving fleet can *inspect* everything (lifecycle, step profiles,
numerics, cache state) but *notices* nothing: no component watches a
series over time and says "this is degrading".  This module closes that
loop: an :class:`AlertEngine` evaluates a frozen, value-comparable
:class:`AlertRuleSet` (the AuditConfig / FaultPlan discipline — no
wall-clock in decisions, windows measured in **history samples**) over a
:class:`~paddle_tpu_torch.observability.history.HistoryStore` after every
sample.  Three rule kinds:

``threshold``
    The latest sample of any series of ``series`` breaches a floor
    (``op="lt"``) or ceiling (``op="gt"``) — e.g. the
    ``serving_pool_available_blocks`` floor (pool exhaustion) or the
    ``serving_fleet_cache_imbalance`` ceiling (placement skew).
``rate``
    The windowed increase of a cumulative series (summed across label
    sets, per-series counter resets clamped to 0) reaches ``threshold``
    — e.g. 429 bursts, compile storms, restart/quarantine churn,
    audit-divergence bursts.
``burn_rate``
    Multi-window SLO burn over the goodput pair
    (``serving_slo_good_total`` / ``serving_slo_total``): the error rate
    over a window divided by the error budget ``1 - objective`` is the
    **burn rate** (burn 1.0 = exactly consuming budget on schedule).  A
    rule fires only when the **fast AND slow windows both burn** past
    ``threshold`` — the standard page-vs-ticket split: the slow window
    proves it is sustained, the fast window proves it is still
    happening (so a resolved incident stops paging as the fast window
    drains, long before the slow one does).

State machine per rule — ``inactive -> pending -> firing -> resolved``
(resolved collapses back to inactive and starts the per-rule
``cooldown`` in samples): a breach makes the rule pending; ``for_samples``
consecutive breaching evaluations make it firing; the first clean
evaluation of a firing rule resolves it.  Transitions are counted on
``serving_alert_transitions_total{rule,state}``, the instantaneous
state rides ``serving_alerts_firing{rule}`` (1 while firing), a firing
transition emits a lifecycle instant AND an ``alert`` flight-recorder
bundle embedding the offending series' history window, and a resolve
emits the matching instant.  Everything is deterministic from the
recorded history: replaying the same window produces the same
transitions (tested).
"""

from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .history import HistoryStore

# the metric names this module registers
METRIC_NAMES = (
    "serving_alerts_firing",
    "serving_alert_transitions_total",
)

RULE_KINDS = ("threshold", "rate", "burn_rate")
SEVERITIES = ("page", "ticket")
# transition states the counter is labeled by
TRANSITION_STATES = ("pending", "firing", "resolved")
# how many recent transitions each rule retains for the debug surface
_TRANSITION_RING = 16


@dataclass(frozen=True)
class AlertRule:
    """One frozen alert rule.  Windows/cooldowns are in history
    **samples** (engine-step-indexed), never wall-clock — evaluation is
    a pure function of the recorded history."""

    name: str
    kind: str                      # threshold | rate | burn_rate
    series: str = ""               # threshold/rate: the metric name
    op: str = "gt"                 # threshold: "gt" ceiling, "lt" floor
    threshold: float = 0.0         # threshold value / rate count / burn
    window: int = 16               # rate: samples per window
    good_series: str = "serving_slo_good_total"   # burn_rate pair
    total_series: str = "serving_slo_total"
    objective: float = 0.95        # burn_rate: SLO target (error budget
    # = 1 - objective)
    fast_window: int = 8           # burn_rate: page window (samples)
    slow_window: int = 64          # burn_rate: ticket window (samples)
    for_samples: int = 1           # consecutive breaches before firing
    cooldown: int = 8              # samples after resolve before the
    # rule may go pending again (flap damping)
    warmup_samples: int = 0        # skip evaluation for the first N
    # samples — grace for expected cold-start noise (warmup graph captures
    # tripping a compile-rate rule); still sample-indexed, so replay
    # stays deterministic
    severity: str = "ticket"       # page | ticket

    def __post_init__(self):
        if self.kind not in RULE_KINDS:
            raise ValueError(f"unknown rule kind {self.kind!r}; expected "
                             f"one of {RULE_KINDS}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"expected one of {SEVERITIES}")
        if not self.name:
            raise ValueError("alert rule needs a name")
        if self.kind == "threshold":
            if self.op not in ("gt", "lt"):
                raise ValueError(f"threshold op must be 'gt' or 'lt', "
                                 f"got {self.op!r}")
            if not self.series:
                raise ValueError(f"rule {self.name!r}: threshold rules "
                                 "need a series")
        if self.kind == "rate":
            if not self.series:
                raise ValueError(f"rule {self.name!r}: rate rules need "
                                 "a series")
            if self.window < 1:
                raise ValueError(f"rule {self.name!r}: window must be "
                                 f">= 1, got {self.window}")
        if self.kind == "burn_rate":
            if not 0.0 < self.objective < 1.0:
                raise ValueError(f"rule {self.name!r}: objective must "
                                 f"be in (0, 1), got {self.objective}")
            if self.fast_window < 1 or self.slow_window < self.fast_window:
                raise ValueError(
                    f"rule {self.name!r}: need 1 <= fast_window "
                    f"({self.fast_window}) <= slow_window "
                    f"({self.slow_window})")
        if self.for_samples < 1:
            raise ValueError(f"rule {self.name!r}: for_samples must be "
                             f">= 1, got {self.for_samples}")
        if self.cooldown < 0:
            raise ValueError(f"rule {self.name!r}: cooldown must be "
                             f">= 0, got {self.cooldown}")
        if self.warmup_samples < 0:
            raise ValueError(f"rule {self.name!r}: warmup_samples must "
                             f"be >= 0, got {self.warmup_samples}")

    def to_obj(self) -> Dict:
        base = {"name": self.name, "kind": self.kind,
                "threshold": self.threshold,
                "for_samples": self.for_samples,
                "cooldown": self.cooldown,
                "warmup_samples": self.warmup_samples,
                "severity": self.severity}
        if self.kind == "threshold":
            base.update(series=self.series, op=self.op)
        elif self.kind == "rate":
            base.update(series=self.series, window=self.window)
        else:
            base.update(good_series=self.good_series,
                        total_series=self.total_series,
                        objective=self.objective,
                        fast_window=self.fast_window,
                        slow_window=self.slow_window)
        return base


# the fields each kind actually evaluates (mirrors to_obj): from_obj
# rejects anything outside its kind's set so a dead knob never parses
_COMMON_FIELDS = ("name", "kind", "threshold", "for_samples",
                  "cooldown", "warmup_samples", "severity")
_KIND_FIELDS = {
    "threshold": _COMMON_FIELDS + ("series", "op"),
    "rate": _COMMON_FIELDS + ("series", "window"),
    "burn_rate": _COMMON_FIELDS + ("good_series", "total_series",
                                   "objective", "fast_window",
                                   "slow_window"),
}


@dataclass(frozen=True)
class AlertRuleSet:
    """A frozen, ordered rule collection (fleet-config value: compare by
    ``==`` like AuditConfig / FaultPlan)."""

    rules: Tuple[AlertRule, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        names = [r.name for r in self.rules]
        dupes = sorted({n for n in names if names.count(n) > 1})
        if dupes:
            raise ValueError(f"duplicate alert rule names: {dupes}")

    @classmethod
    def from_obj(cls, obj) -> "AlertRuleSet":
        """Build from the JSON shape (``--alert-rules`` CLI)::

            {"rules": [
                {"name": "pool_exhaustion", "kind": "threshold",
                 "series": "serving_pool_available_blocks", "op": "lt",
                 "threshold": 1, "for_samples": 2},
                {"name": "goodput_burn", "kind": "burn_rate",
                 "objective": 0.95, "threshold": 4.0,
                 "fast_window": 8, "slow_window": 64}]}

        A bare list is accepted as the ``rules`` array.  Unknown keys
        raise — a typo'd field must not silently fall back to the
        default."""
        if isinstance(obj, list):
            obj = {"rules": obj}
        if not isinstance(obj, dict):
            raise ValueError(f"alert rules must be a JSON object or "
                             f"list, got {type(obj).__name__}")
        unknown_top = set(obj) - {"rules"}
        if unknown_top:
            raise ValueError(
                f"unknown top-level key(s) {sorted(unknown_top)} — the "
                "shape is {\"rules\": [...]}; a typo'd 'rules' key must "
                "not silently disable every alert")
        if "rules" not in obj:
            raise ValueError("alert rules object has no 'rules' array — "
                             "an empty rule set must be explicit "
                             "({\"rules\": []}), not an accident")
        rules = []
        for entry in obj["rules"]:
            if not isinstance(entry, dict):
                raise ValueError(f"each rule must be an object, got "
                                 f"{entry!r}")
            # validate against the KIND's effective fields (the same
            # per-kind sets to_obj emits), not the union: a burn_rate
            # knob on a rate rule would otherwise parse fine and
            # silently evaluate with the rate defaults
            allowed = set(_KIND_FIELDS.get(entry.get("kind"),
                                           AlertRule.__dataclass_fields__))
            unknown = set(entry) - allowed
            if unknown:
                raise ValueError(
                    f"field(s) {sorted(unknown)} not valid for a "
                    f"{entry.get('kind', '<no kind>')!r} rule in "
                    f"{entry.get('name', '<unnamed>')!r} "
                    f"(allowed: {sorted(allowed)})")
            rules.append(AlertRule(**entry))
        return cls(rules=tuple(rules))

    @classmethod
    def from_json(cls, path: str) -> "AlertRuleSet":
        with open(path) as f:
            return cls.from_obj(json.load(f))

    def to_obj(self) -> Dict:
        return {"rules": [r.to_obj() for r in self.rules]}


def default_rule_set() -> AlertRuleSet:
    """The default-on serving rule set: pool exhaustion, goodput burn,
    cache-imbalance skew, 429 bursts, compile storms, restart /
    quarantine churn, and audit divergence.  Windows are in history
    samples (default cadence: one sample per engine step fleet-wide)."""
    return AlertRuleSet(rules=(
        # KV pool about to refuse allocations: any replica below 2
        # servable blocks for 4 consecutive samples.  The floor is on
        # free + reuse (``serving_pool_available_blocks``), NOT the free
        # list proper: a warm prefix cache parks every refcount-0 block
        # in the reuse LRU, so free alone drains to ~0 on a perfectly
        # healthy fleet and a free-list floor would page forever.
        AlertRule(name="pool_exhaustion", kind="threshold",
                  series="serving_pool_available_blocks", op="lt",
                  threshold=2.0, for_samples=4, cooldown=16,
                  severity="page"),
        # multi-window goodput burn over the SLO pair: page only
        # when the fast AND slow windows both burn >= 4x budget
        AlertRule(name="goodput_burn", kind="burn_rate",
                  objective=0.95, threshold=4.0,
                  fast_window=8, slow_window=64,
                  for_samples=1, cooldown=16, severity="page"),
        # one replica's prefix cache starving while another idles (the
        # cache-aware rebalancing trigger signal)
        AlertRule(name="cache_imbalance_high", kind="threshold",
                  series="serving_fleet_cache_imbalance", op="gt",
                  threshold=0.5, for_samples=8, cooldown=32),
        # admission collapse: sustained 429s
        AlertRule(name="rejection_burst", kind="rate",
                  series="serving_admission_rejected_total",
                  window=16, threshold=8.0, cooldown=16,
                  severity="page"),
        # compile storm: the bucket discipline broke (retraces per
        # window way past steady state).  warmup_samples skips the
        # first window: a cold fleet's expected warmup traces (~6 per
        # replica) clear the threshold at dp>=2, and a default that
        # fires on every healthy start trains operators to ignore it
        AlertRule(name="compile_storm", kind="rate",
                  series="serving_compiles_total",
                  window=32, threshold=8.0, cooldown=32,
                  warmup_samples=32),
        # self-healing churn: restarts / quarantines inside
        # a window mean the fleet is cycling, not healing
        AlertRule(name="restart_churn", kind="rate",
                  series="serving_replica_restarts_total",
                  window=64, threshold=1.0, cooldown=16,
                  severity="page"),
        AlertRule(name="quarantine_churn", kind="rate",
                  series="serving_quarantines_total",
                  window=64, threshold=1.0, cooldown=16),
        # numerics divergence: any shadow-oracle disagreement
        # in the window
        AlertRule(name="audit_divergence", kind="rate",
                  series="serving_audit_divergence_total",
                  window=32, threshold=1.0, cooldown=32,
                  severity="page"),
    ))


@dataclass
class _RuleState:
    state: str = "inactive"        # inactive | pending | firing
    breaches: int = 0              # consecutive breaching evaluations
    cooldown_until: int = 0        # sample index gating re-pending
    since: Optional[int] = None    # sample index of the current state
    last_value: Optional[float] = None
    last_detail: str = ""
    transitions: deque = field(
        default_factory=lambda: deque(maxlen=_TRANSITION_RING))


class AlertEngine:
    """Evaluates an :class:`AlertRuleSet` over a :class:`HistoryStore`
    after every history sample (registered as a store listener).

    Observability on firing/resolve: ``serving_alerts_firing{rule}``
    gauge, ``serving_alert_transitions_total{rule,state}`` counters, a
    rid-less lifecycle instant (lands in the flight recorder's router
    ring), and — on the **firing** transition only — an ``alert`` flight
    bundle whose ``alert`` key embeds the rule, the breach value, and
    the offending series' recorded window."""

    def __init__(self, history: HistoryStore,
                 rules: Optional[AlertRuleSet] = None,
                 registry=None, lifecycle=None, flight=None):
        self.history = history
        self.rules = rules if rules is not None else default_rule_set()
        self.registry = (registry if registry is not None
                         else history.registry)
        self.lifecycle = lifecycle
        self.flight = flight
        self._lock = threading.Lock()
        self.evaluations = 0
        self._states: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in self.rules.rules}
        self._g_firing = {
            r.name: self.registry.gauge(
                "serving_alerts_firing",
                "1 while the alert rule is firing", rule=r.name)
            for r in self.rules.rules}
        for g in self._g_firing.values():
            g.set(0)
        self._c_trans = {
            (r.name, st): self.registry.counter(
                "serving_alert_transitions_total",
                "alert rule state transitions",
                rule=r.name, state=st)
            for r in self.rules.rules for st in TRANSITION_STATES}
        self._remove_listener = history.add_listener(self.evaluate)

    def close(self) -> None:
        if self._remove_listener is not None:
            self._remove_listener()
            self._remove_listener = None

    # --- evaluation ---------------------------------------------------------
    def evaluate(self, sample: int, step: int = -1) -> None:
        """One evaluation pass at history sample ``sample`` — a pure
        function of the recorded rings + the per-rule state machines
        (no wall clock: replaying the same window reproduces the same
        transitions)."""
        with self._lock:
            self.evaluations += 1
            for rule in self.rules.rules:
                if sample <= rule.warmup_samples:
                    continue  # cold-start grace, still sample-indexed
                breach, value, detail, offenders = self._check(rule,
                                                               sample)
                self._advance(rule, breach, value, detail, offenders,
                              sample, step)

    def _check(self, rule: AlertRule, sample: int
               ) -> Tuple[bool, Optional[float], str, List[str]]:
        """(breached, value, human detail, offending series keys)."""
        h = self.history
        if rule.kind == "threshold":
            offenders = []
            worst = None
            for key in h.match(rule.series):
                v = h.latest(key)
                if v is None:
                    continue
                hit = v > rule.threshold if rule.op == "gt" \
                    else v < rule.threshold
                if hit:
                    offenders.append(key)
                if worst is None or (v > worst if rule.op == "gt"
                                     else v < worst):
                    worst = v
            side = ">" if rule.op == "gt" else "<"
            if worst is None:
                # silent-death guard: a rule whose series is never
                # recorded (its source gate off — e.g. cache_stats=False
                # starves the pool gauges) can never breach; say so
                # instead of posing as a healthy "inactive"
                return (False, None,
                        f"{rule.series}: no recorded data (source gate "
                        "off or not yet sampled) — rule cannot breach",
                        [])
            return (bool(offenders), worst,
                    f"{rule.series} {side} {rule.threshold} "
                    f"(worst {worst})", offenders)
        if rule.kind == "rate":
            win = rule.window
            if rule.warmup_samples:
                # the warmup era is excluded from the EVIDENCE, not
                # just from evaluation timing: an unclamped window
                # reaching back into boot would count the warmup burst
                # on the first post-grace evaluation anyway
                win = max(1, min(win, sample - rule.warmup_samples))
            inc = h.name_increase(rule.series, win)
            if inc is None:
                return (False, None,
                        f"{rule.series}: no recorded data (source gate "
                        "off or not yet sampled) — rule cannot breach",
                        [])
            breached = inc >= rule.threshold
            return (breached, inc,
                    f"increase({rule.series}[{win} samples]) = "
                    f"{inc} (threshold {rule.threshold})",
                    h.match(rule.series) if breached else [])

        # burn_rate: fast AND slow windows must both burn
        budget = 1.0 - rule.objective
        burns = {}
        for label, win in (("fast", rule.fast_window),
                           ("slow", rule.slow_window)):
            if not h.covers(rule.total_series, win):
                # a window the history can't fully cover yet (cold
                # start / just-registered pair) has not produced the
                # evidence it stands for — two samples after a restart,
                # "slow" would just be the fast window relabeled, and
                # the first SLO misses of a warmup would page
                burns[label] = None
                continue
            good = h.name_increase(rule.good_series, win)
            total = h.name_increase(rule.total_series, win)
            if not total:
                burns[label] = None
                continue
            # clamped per-series deltas can momentarily leave good a
            # hair above total across a reset; cap the ratio at 1
            err = 1.0 - min(1.0, (good or 0.0) / total)
            burns[label] = err / budget
        breached = all(b is not None and b >= rule.threshold
                       for b in burns.values())
        offenders = (h.match(rule.good_series)
                     + h.match(rule.total_series)) if breached else []
        return (breached, burns.get("fast"),
                f"burn fast={_fmt(burns['fast'])} "
                f"slow={_fmt(burns['slow'])} (threshold "
                f"{rule.threshold}x budget {round(budget, 4)})",
                offenders)

    def _advance(self, rule: AlertRule, breach: bool,
                 value: Optional[float], detail: str,
                 offenders: List[str], sample: int, step: int) -> None:
        # caller holds self._lock
        st = self._states[rule.name]
        st.last_value = value
        st.last_detail = detail
        if st.state == "inactive":
            if breach and sample >= st.cooldown_until:
                st.state, st.since, st.breaches = "pending", sample, 1
                self._transition(rule, st, "pending", sample, step,
                                 value, detail, offenders)
                if st.breaches >= rule.for_samples:
                    st.state, st.since = "firing", sample
                    self._transition(rule, st, "firing", sample, step,
                                     value, detail, offenders)
            return
        if st.state == "pending":
            if not breach:
                # pending that clears is a non-incident: back to
                # inactive without a counted transition
                st.state, st.since, st.breaches = "inactive", None, 0
                return
            st.breaches += 1
            if st.breaches >= rule.for_samples:
                st.state, st.since = "firing", sample
                self._transition(rule, st, "firing", sample, step,
                                 value, detail, offenders)
            return
        # firing
        if breach:
            st.breaches += 1
            return
        st.state, st.since, st.breaches = "inactive", None, 0
        st.cooldown_until = sample + rule.cooldown
        self._transition(rule, st, "resolved", sample, step,
                         value, detail, offenders)

    def _transition(self, rule: AlertRule, st: _RuleState, to: str,
                    sample: int, step: int, value: Optional[float],
                    detail: str, offenders: List[str]) -> None:
        st.transitions.append({
            "state": to, "sample": sample, "step": step,
            "value": value, "detail": detail})
        self._c_trans[(rule.name, to)].inc()
        if to == "firing":
            self._g_firing[rule.name].set(1)
        elif to == "resolved":
            self._g_firing[rule.name].set(0)
        if to in ("firing", "resolved") and self.lifecycle is not None:
            # rid-less instant: lands in the flight recorder's router
            # ring so post-mortems show the alert timeline inline
            self.lifecycle.event(None, "alert", rule=rule.name,
                                 state=to, severity=rule.severity,
                                 sample=sample, step=step, value=value,
                                 detail=detail)
        if to == "firing" and self.flight is not None:
            # exactly one bundle per firing transition, keyed per rule
            # (the flight cooldown additionally damps flapping); the
            # bundle embeds the offending series' recorded window — the
            # evidence the page is about
            windows = {k: self.history.window(k, rule.slow_window
                                              if rule.kind == "burn_rate"
                                              else max(rule.window, 16))
                       for k in offenders[:8]}
            self.flight.trigger(
                "alert", key=rule.name,
                detail=f"{rule.name} ({rule.severity}): {detail}",
                extra={"alert": {
                    "rule": rule.to_obj(), "state": to,
                    "sample": sample, "step": step, "value": value,
                    "offending_series": offenders,
                    "history": windows}})

    # --- inspection ---------------------------------------------------------
    def state(self, name: str) -> Dict:
        rule = next((r for r in self.rules.rules if r.name == name), None)
        if rule is None:
            raise KeyError(name)
        with self._lock:
            st = self._states[name]
            return {
                "rule": rule.to_obj(),
                "state": st.state,
                "since_sample": st.since,
                "consecutive_breaches": st.breaches,
                "cooldown_until_sample": (st.cooldown_until
                                          if st.cooldown_until else None),
                "last_value": st.last_value,
                "last_detail": st.last_detail,
                # False = this rule has never seen evaluable data (its
                # series unrecorded / window not yet covered): it is NOT
                # protecting anything, which is different from inactive
                "has_data": st.last_value is not None,
                "transitions": list(st.transitions),
            }

    def snapshot(self) -> Dict:
        """The ``GET /v1/debug/alerts`` body core: every rule with its
        live state + recent transitions, plus engine totals."""
        data = [self.state(r.name) for r in self.rules.rules]
        with self._lock:
            evals = self.evaluations
        firing = [d["rule"]["name"] for d in data
                  if d["state"] == "firing"]
        return {
            "rules": len(self.rules.rules),
            "evaluations": evals,
            "firing": firing,
            # rules with nothing evaluable behind them (series gated
            # off, window not yet covered): listed loudly — an operator
            # must not read a starved rule as a healthy "inactive"
            "no_data": [d["rule"]["name"] for d in data
                        if not d["has_data"]],
            "history": self.history.stats(),
            "data": data,
        }

    def transitions_report(self) -> Dict[str, List[Dict]]:
        """{rule: transitions} — the shape bench phases embed."""
        return {r.name: self.state(r.name)["transitions"]
                for r in self.rules.rules}


def _fmt(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.2f}"
