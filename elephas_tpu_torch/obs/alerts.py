"""SLO alert engine: declarative rules over ``MetricsRegistry`` snapshots.

Counterpart of ``elephas_tpu/obs/alerts.py``, whose logic is framework-free;
the port keeps its own copy so that it imports nothing of the JAX package.

The flight recorder captures anomalies only where code *already*
detects them; this module closes the loop by turning any registry
metric into an anomaly source. A rule is declarative data — metric
name, comparator + threshold, evaluation mode (instantaneous value or
windowed rate), severity, and a burn count — and the engine evaluates
the whole pack against ``registry.snapshot()`` on demand (every
``/alerts`` scrape, every bench checkpoint): no background thread, an
injectable clock, so seeded chaos runs replay the exact same ordered
alert sequence.

Matching is per *snapshot key*: a rule on ``ps_staleness_versions_p95``
evaluates every labeled child (``...{worker="w1"}``) independently, so
one rule yields per-worker breaches — that is how ``worker_lagging``
singles out the straggler. Breaches emit FlightRecorder events (kinds
from the registered ``flight.KINDS`` table), bump
``alerts_fired_total{rule=}``, and append to an ordered ``fired``
history the ``/alerts`` route serves.

Rule *names* come from the ``RULE_NAMES`` registered-constant table —
``scripts/lint_blocking.py`` rejects free-string names at ``AlertRule``
call sites (``# kind-ok`` escapes) so dashboards and runbooks can key
on a closed vocabulary.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from elephas_tpu_torch.obs.flight import KINDS
from elephas_tpu_torch.obs.history import HistoryRing
from elephas_tpu_torch.utils import locksan

__all__ = ["AlertEngine", "AlertRule", "RULE_NAMES", "default_rules"]

#: Registered rule-name vocabulary (see module docstring). Grow the
#: table when adding a rule; don't invent names inline.
RULE_NAMES = (
    "staleness_p95_high",
    "worker_lag_high",
    "worker_expiry_rate",
    "push_retry_rate",
    "serving_itl_p99_high",
    "shard_failover_rate",
    "goodput_burn_high",
    "goodput_burn_critical",
    "canary_probe_failures",
    "staleness_rejection_rate",
    "tune_trial_stalled",
    "tenant_burn_high",
    "noisy_neighbor",
    "tier_imbalance",
    "handoff_slow",
    "rollout_stuck",
    "version_skew",
)

_PREDICATES = (">", "<")
_MODES = ("value", "rate")


class AlertRule:
    """One declarative SLO rule.

    ``metric`` names a snapshot key — matched exactly, or as the family
    prefix of labeled keys (``metric{...}``). ``mode="value"`` compares
    the key's current value; ``mode="rate"`` compares its per-second
    rate of change over the trailing ``window_s`` (needs two evaluation
    points inside the window before it can trip — counters only).
    ``burn`` is how many *consecutive* evaluations must trip before the
    breach fires; after firing, the rule re-arms once it evaluates
    clean.
    """

    __slots__ = ("name", "metric", "predicate", "threshold", "window_s",
                 "mode", "severity", "burn", "kind")

    def __init__(self, name: str, metric: str, predicate: str,
                 threshold: float, kind: str, window_s: float = 60.0,
                 mode: str = "value", severity: str = "warn",
                 burn: int = 1):
        if predicate not in _PREDICATES:
            raise ValueError(
                f"predicate must be one of {_PREDICATES}, got {predicate!r}")
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if kind not in KINDS:
            raise ValueError(
                f"alert kind must come from flight.KINDS, got {kind!r}")
        if burn < 1:
            raise ValueError(f"burn must be >= 1, got {burn}")
        self.name = name
        self.metric = metric
        self.predicate = predicate
        self.threshold = float(threshold)
        self.window_s = float(window_s)
        self.mode = mode
        self.severity = severity
        self.burn = int(burn)
        self.kind = kind

    def to_dict(self) -> Dict[str, Any]:
        return {s: getattr(self, s) for s in self.__slots__}

    def __repr__(self):
        return (f"AlertRule({self.name!r}, {self.metric!r} "
                f"{self.predicate} {self.threshold}, mode={self.mode}, "
                f"burn={self.burn}, kind={self.kind!r})")


def default_rules() -> List[AlertRule]:
    """The stock training-health pack. Thresholds are deliberately
    conservative defaults — override by constructing the engine with an
    explicit rule list."""
    return [
        # Applied-delta staleness: p95 of any worker's version lag.
        AlertRule("staleness_p95_high", "ps_staleness_versions_p95",
                  ">", 8.0, kind="staleness_spike", severity="warn"),
        # A single worker far behind the fleet (same family, harder
        # threshold): the bounded-staleness admission candidate.
        AlertRule("worker_lag_high", "ps_staleness_versions_p95",
                  ">", 32.0, kind="worker_lagging", severity="error"),
        # Membership churn: liveness expiries per second.
        AlertRule("worker_expiry_rate", "ps_worker_expired_total",
                  ">", 0.1, kind="slo_breach", mode="rate",
                  window_s=60.0, severity="warn", burn=2),
        # Push retries per second (comms pipeline under partition/loss).
        AlertRule("push_retry_rate", "ps_push_retry_total",
                  ">", 0.5, kind="slo_breach", mode="rate",
                  window_s=60.0, severity="warn", burn=2),
        # Bounded-staleness admission refusing deltas at a sustained
        # rate: an occasional rejection is the ratchet doing its job
        # (the worker halves its push interval and recovers); a
        # sustained rate means some worker can't catch up and its
        # training work is being thrown away.
        AlertRule("staleness_rejection_rate", "ps_delta_rejected_total",
                  ">", 0.2, kind="delta_rejected", mode="rate",
                  window_s=60.0, severity="warn", burn=2),
        # Serving inter-token latency p99 (seconds).
        AlertRule("serving_itl_p99_high", "serving_itl_seconds_p99",
                  ">", 0.25, kind="slo_breach", severity="warn"),
        # PS-group standby promotions per second: one failover is the
        # mechanism working; a sustained rate means primaries are
        # flapping (or the detector threshold is mis-set) and each
        # promotion burns the shard's only spare.
        AlertRule("shard_failover_rate", "ps_shard_failover_total",
                  ">", 1 / 300.0, kind="shard_failover", mode="rate",
                  window_s=600.0, severity="error"),
        # Multi-window SLO burn (obs/slo.py mirrors
        # serving_goodput_burn{objective=} = min(fast, slow bad
        # fraction) / budget — both windows must be burning for the
        # gauge to rise, so these are the classic fast+slow AND-gate
        # as plain value rules, latch-until-clean like every rule).
        # Warn at budget parity, page at the 6x fast burn.
        AlertRule("goodput_burn_high", "serving_goodput_burn",
                  ">", 1.0, kind="goodput_burn", severity="warn"),
        AlertRule("goodput_burn_critical", "serving_goodput_burn",
                  ">", 6.0, kind="goodput_burn", severity="error"),
        # Blackbox canary probes failing at any sustained rate: users
        # (or workers) cannot get through regardless of what the
        # whitebox metrics claim.
        AlertRule("canary_probe_failures", "serving_canary_fail_total",
                  ">", 0.0, kind="canary_fail", mode="rate",
                  window_s=60.0, severity="error"),
        # Elastic tuner: the slowest RUNNING trial has not progressed
        # for two minutes. The gauge is refreshed at every unit
        # boundary by the tune runner; a trial wedged in a device call
        # can't refresh it down, which is exactly the point — the
        # elastic pool's detector will expire the worker, and this rule
        # is the operator-facing heads-up that a re-lease is coming.
        AlertRule("tune_trial_stalled", "tune_trial_stall_seconds",
                  ">", 120.0, kind="trial_stalled", severity="warn"),
        # Disaggregated serving topology: the prefill and decode tiers'
        # average load scores diverging past half the scale means one
        # tier is starved while the other saturates — rebalance the
        # tier split (the gauge is 0 on a mono fleet, so the rule
        # idles). Handoff p99 creeping toward decode-ITL territory
        # erodes the entire point of tiering — the export/import path
        # should be microseconds of staging, not a scheduling stall.
        AlertRule("tier_imbalance", "fleet_tier_imbalance",
                  ">", 0.5, kind="tier_imbalance", severity="warn"),
        AlertRule("handoff_slow", "fleet_handoff_seconds_p99",
                  ">", 0.25, kind="handoff_slow", severity="warn"),
        # Live model delivery: a rollout that has sat in a non-idle
        # phase for minutes is wedged — the canary is neither being
        # judged good (promote) nor bad (rollback), usually a dead
        # canary replica or a judge starved of traffic. Version skew
        # means replicas are serving models >1 version apart after the
        # promotion ripple should have converged — mixed-fleet answers
        # are a correctness smell, not just an ops one. Both gauges are
        # refreshed by the RolloutController's tick and sit at 0 on
        # fleets without one, so the rules idle elsewhere.
        AlertRule("rollout_stuck", "fleet_rollout_age_s",
                  ">", 120.0, kind="rollout_stuck", severity="warn"),
        AlertRule("version_skew", "fleet_version_skew",
                  ">", 1.0, kind="version_skew", severity="warn",
                  burn=2),
    ]


class AlertEngine:
    """Evaluates a rule pack against registry snapshots (thread-safe).

    ``evaluate()`` is the only mutation point and is explicitly driven —
    by the ``/alerts`` scrape, by bench checkpoints, by tests — on an
    injectable clock, so there is nothing time-racy to make a seeded
    chaos run non-deterministic. Missing metrics idle their rules (a
    serving rule on a PS process never errors, it just never trips).
    """

    def __init__(self, registry=None, flight=None,
                 rules: Optional[List[AlertRule]] = None,
                 clock=time.monotonic):
        self._registry = registry
        self._flight = flight
        self.rules = list(rules) if rules is not None else default_rules()
        self.clock = clock
        self._lock = locksan.make_lock("AlertEngine._lock")
        # (rule.name, key) → consecutive trip count / latched breach.
        self._trips: Dict[Tuple[str, str], int] = {}
        self._breached: Dict[Tuple[str, str], bool] = {}
        # (rule.name, key) → HistoryRing for rate rules: the same
        # windowed-rate substrate /history serves, instead of a private
        # two-point-delta bookkeeping scheme.
        self._points: Dict[Tuple[str, str], HistoryRing] = {}
        self.fired: List[Dict[str, Any]] = []
        self._stores: tuple = ()  # durable tees (obs/store.py), COW

    # -- surface resolution (late, so process globals rebind) ---------------

    def _get_registry(self):
        if self._registry is not None:
            return self._registry
        from elephas_tpu_torch import obs

        return obs.default_registry()

    def _get_flight(self):
        if self._flight is not None:
            return self._flight
        from elephas_tpu_torch import obs

        return obs.default_flight_recorder()

    # -- durable tee --------------------------------------------------------

    def attach_store(self, store) -> None:
        """Journal every subsequent fire/clear transition into ``store``
        (a ``TelemetryStore``) at transition time — alert history must
        survive SIGKILL, not just the next scrape. Idempotent."""
        with self._lock:
            if store not in self._stores:
                self._stores = self._stores + (store,)

    def detach_store(self, store) -> None:
        with self._lock:
            self._stores = tuple(s for s in self._stores if s is not store)

    # -- evaluation ---------------------------------------------------------

    @staticmethod
    def _match(metric: str, snap: Dict[str, float]) -> List[str]:
        if metric in snap:
            return [metric]
        prefix = metric + "{"
        return [k for k in snap if k.startswith(prefix)]

    def _measure(self, rule: AlertRule, key: str, value: float,
                 now: float) -> Optional[float]:
        """The number the predicate sees: the value itself, or the
        windowed per-second rate (None while under-sampled)."""
        if rule.mode == "value":
            return value
        ring = self._points.get((rule.name, key))
        if ring is None:
            # 512 slots at the 60 s default window tolerates ~8 Hz
            # evaluation before the oldest in-window point can rotate
            # out — far denser than any scrape loop in this repo.
            ring = self._points.setdefault((rule.name, key),
                                           HistoryRing(capacity=512))
        ring.push(now, value)
        return ring.rate(rule.window_s, now=now)

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One pass over every rule; returns alerts newly fired by THIS
        pass (the full ordered history stays in ``self.fired``)."""
        if now is None:
            now = self.clock()
        snap = self._get_registry().snapshot()
        new_fired: List[Dict[str, Any]] = []
        new_cleared: List[Dict[str, Any]] = []
        with self._lock:
            stores = self._stores
            for rule in self.rules:
                for key in self._match(rule.metric, snap):
                    measured = self._measure(rule, key, snap[key], now)
                    if measured is None:
                        continue
                    tripped = (measured > rule.threshold
                               if rule.predicate == ">"
                               else measured < rule.threshold)
                    state = (rule.name, key)
                    if not tripped:
                        if self._breached.get(state):
                            # latched breach evaluating clean: the
                            # clear transition is history worth keeping
                            # as much as the fire was.
                            new_cleared.append({
                                "rule": rule.name, "kind": rule.kind,
                                "severity": rule.severity, "metric": key,
                                "value": measured,
                                "threshold": rule.threshold, "t": now,
                            })
                        self._trips[state] = 0
                        self._breached[state] = False
                        continue
                    self._trips[state] = self._trips.get(state, 0) + 1
                    if (self._trips[state] >= rule.burn
                            and not self._breached.get(state)):
                        self._breached[state] = True
                        alert = {
                            "rule": rule.name, "kind": rule.kind,
                            "severity": rule.severity, "metric": key,
                            "value": measured,
                            "threshold": rule.threshold, "t": now,
                        }
                        self.fired.append(alert)
                        new_fired.append(alert)
        # Emit outside the engine lock: flight + registry take their own.
        for alert in new_fired:
            self._get_flight().note(
                alert["kind"], alert["severity"], rule=alert["rule"],
                metric=alert["metric"], value=alert["value"],
                threshold=alert["threshold"])
            self._get_registry().counter(
                "alerts_fired_total",
                help="SLO alert breaches fired, by rule",
                labelnames=("rule",)).labels(rule=alert["rule"]).inc()
        # Durable tee: both transition edges journal at transition time.
        for store in stores:
            try:
                for alert in new_fired:
                    store.record_alert("fire", alert)
                for alert in new_cleared:
                    store.record_alert("clear", alert)
            except Exception:
                pass
        return new_fired

    # -- read-out -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready state — the ``/alerts`` opsd route serves this."""
        with self._lock:
            active = [
                {"rule": name, "metric": key}
                for (name, key), hot in sorted(self._breached.items())
                if hot
            ]
            fired = list(self.fired)
        return {
            "rules": [r.to_dict() for r in self.rules],
            "active": active,
            "fired": fired,
            "fired_kinds": [a["kind"] for a in fired],
        }

    def scrape(self) -> Dict[str, Any]:
        """Evaluate, then snapshot — the one-call ops-route handler."""
        self.evaluate()
        return self.snapshot()
