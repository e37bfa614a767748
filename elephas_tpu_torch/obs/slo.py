"""Goodput accounting: did users get what they asked for, per window.

Counterpart of ``elephas_tpu/obs/slo.py``, whose logic is framework-free;
the port keeps its own copy so that it imports nothing of the JAX package.

Throughput says how many tokens the engine moved; it says nothing
about whether requests met their latency promises. This module keeps
the second ledger — *goodput*, the fraction of finished requests that
met each declared objective — the way SRE burn-rate alerting expects
it:

- ``SLOObjective`` — a declarative promise evaluated against one
  finished ``GenerationResult``: time-to-first-token under a bound,
  mean inter-token latency under a bound, or plain deadline attainment
  (the request completed rather than timing out). Each carries a
  ``target`` (e.g. 0.99) whose complement is the error budget.
- ``GoodputLedger`` — evaluates every finished request against the
  pack, pushes met/missed samples into one ``HistoryRing`` per
  objective, and answers windowed ratios (met/total) over a *fast* and
  a *slow* window plus lifetime counts. The opsd ``/slo`` route serves
  ``snapshot()``.
- Multi-window burn rate — per objective,
  ``burn = min(bad_fast, bad_slow) / (1 - target)``: the classic
  fast+slow AND-gate collapsed into one number (both windows must be
  burning for the minimum to rise). The ledger mirrors it into the
  default registry as ``serving_goodput_burn{objective=}``, and the
  default alert pack (``obs.alerts.default_rules``) carries
  latch-until-clean rules over that family — a warn at budget parity
  and an error at 6x, the ``goodput_burn`` flight kind.

Canary probes never reach this ledger: the engine routes results whose
request ids are canary-tagged to the canary driver instead (see
``obs/canary.py``), so real-traffic goodput is identical with canaries
on or off — pinned by test.

Everything runs on the injected clock; replaying a seeded request
trace replays the exact same ratios and burn values.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from elephas_tpu_torch.obs.history import HistoryRing

OBJECTIVE_KINDS = ("ttft", "itl", "deadline")

DEFAULT_FAST_WINDOW_S = 60.0
DEFAULT_SLOW_WINDOW_S = 600.0

# Burn thresholds the default alert pack keys on: 1.0 means "spending
# budget exactly as fast as the target allows"; 6.0 is the classic
# page-level fast burn.
BURN_WARN = 1.0
BURN_CRITICAL = 6.0


class SLOObjective:
    """One declarative promise about a finished request."""

    __slots__ = ("name", "kind", "threshold_s", "target", "description")

    def __init__(self, name: str, kind: str, *, threshold_s: Optional[float]
                 = None, target: float = 0.99, description: str = ""):
        if kind not in OBJECTIVE_KINDS:
            raise ValueError(
                f"kind must be one of {OBJECTIVE_KINDS}, got {kind!r}")
        if kind != "deadline" and threshold_s is None:
            raise ValueError(f"{kind!r} objective needs threshold_s")
        if not 0.0 < target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {target}")
        self.name = name
        self.kind = kind
        self.threshold_s = None if threshold_s is None else float(threshold_s)
        self.target = float(target)
        self.description = description

    @property
    def budget(self) -> float:
        """Tolerable bad fraction: the complement of the target."""
        return 1.0 - self.target

    def met(self, result) -> bool:
        """Did this finished request keep the promise?

        A request that timed out (or never produced a first token)
        misses every latency objective — "we never answered" is the
        worst latency, not a vacuous pass.
        """
        if self.kind == "deadline":
            return result.status == "completed"
        if result.status != "completed":
            return False
        if self.kind == "ttft":
            return result.ttft_s is not None and \
                result.ttft_s <= self.threshold_s
        # kind == "itl": a single-token answer has no inter-token gaps
        # to violate the bound.
        return result.itl_s_avg is None or \
            result.itl_s_avg <= self.threshold_s

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name, "kind": self.kind,
            "threshold_s": self.threshold_s, "target": self.target,
            "description": self.description,
        }


def default_objectives() -> List[SLOObjective]:
    """The stock serving pack: first token fast, stream smooth, answer
    delivered. Thresholds match the existing ``serving_itl_p99_high``
    alert's working point."""
    return [
        SLOObjective("ttft", "ttft", threshold_s=2.5, target=0.99,
                     description="first token within 2.5 s"),
        SLOObjective("itl_p99", "itl", threshold_s=0.25, target=0.99,
                     description="mean inter-token latency under 250 ms"),
        SLOObjective("deadline", "deadline", target=0.995,
                     description="request completed before its deadline"),
    ]


class GoodputLedger:
    """Windowed met/total accounting over a pack of objectives."""

    def __init__(self, objectives: Optional[Sequence[SLOObjective]] = None,
                 *, fast_window_s: float = DEFAULT_FAST_WINDOW_S,
                 slow_window_s: float = DEFAULT_SLOW_WINDOW_S,
                 clock: Callable[[], float] = time.monotonic,
                 capacity: int = 2048, registry=None):
        if fast_window_s >= slow_window_s:
            raise ValueError("fast window must be shorter than slow window")
        self.objectives = list(default_objectives() if objectives is None
                               else objectives)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.clock = clock
        # registry=None → the process default, resolved lazily on first
        # record (an explicit one keeps seeded ladders self-contained).
        self._registry = registry
        self._lock = threading.Lock()
        self._rings = {o.name: HistoryRing(capacity) for o in self.objectives}
        self._evaluated = 0
        self._met = {o.name: 0 for o in self.objectives}
        self._burn_gauge = None   # lazy family; False after failed bind
        self._ratio_gauge = None

    # -- registry mirror ---------------------------------------------------

    def _families(self):
        if self._burn_gauge is None:
            try:
                reg = self._registry
                if reg is None:
                    from elephas_tpu_torch import obs
                    reg = obs.default_registry()
                self._burn_gauge = reg.gauge(
                    "serving_goodput_burn",
                    help="multi-window SLO burn rate (min of fast/slow bad "
                         "fraction over error budget)",
                    labelnames=("objective",),
                )
                self._ratio_gauge = reg.gauge(
                    "serving_goodput_ratio",
                    help="fast-window goodput ratio (met/total)",
                    labelnames=("objective",),
                )
            except Exception:
                self._burn_gauge = False
                self._ratio_gauge = False
        return self._burn_gauge, self._ratio_gauge

    # -- accounting --------------------------------------------------------

    def record(self, result, now: Optional[float] = None) -> Dict[str, bool]:
        """Evaluate one finished request against every objective."""
        now = self.clock() if now is None else float(now)
        verdicts = {o.name: o.met(result) for o in self.objectives}
        with self._lock:
            self._evaluated += 1
            for name, ok in verdicts.items():
                self._rings[name].push(now, 1.0 if ok else 0.0)
                if ok:
                    self._met[name] += 1
        burn_gauge, ratio_gauge = self._families()
        if burn_gauge:
            burns = self.burn(now=now)
            fast = self.goodput(self.fast_window_s, now=now)
            for o in self.objectives:
                if burns[o.name] is not None:
                    burn_gauge.labels(objective=o.name).set(burns[o.name])
                if fast[o.name] is not None:
                    ratio_gauge.labels(objective=o.name).set(fast[o.name])
        return verdicts

    def _window_ratio(self, ring: HistoryRing, window_s: float,
                      now: float) -> Optional[float]:
        pts = ring.samples(window_s, now=now)
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def goodput(self, window_s: Optional[float] = None,
                now: Optional[float] = None) -> Dict[str, Optional[float]]:
        """Per-objective met/total ratio; lifetime when ``window_s`` is
        None; ``None`` entries mean no finished requests in window."""
        now = self.clock() if now is None else float(now)
        with self._lock:
            if window_s is None:
                if self._evaluated == 0:
                    return {o.name: None for o in self.objectives}
                return {o.name: self._met[o.name] / self._evaluated
                        for o in self.objectives}
            return {o.name: self._window_ratio(self._rings[o.name],
                                               window_s, now)
                    for o in self.objectives}

    def burn(self, now: Optional[float] = None) -> Dict[str, Optional[float]]:
        """Multi-window burn per objective: both windows must be bad for
        the minimum to rise, so a brief spike (fast-only) or an old,
        resolved incident (slow-only) reads as no burn."""
        now = self.clock() if now is None else float(now)
        fast = self.goodput(self.fast_window_s, now=now)
        slow = self.goodput(self.slow_window_s, now=now)
        out: Dict[str, Optional[float]] = {}
        for o in self.objectives:
            if fast[o.name] is None or slow[o.name] is None:
                out[o.name] = None
                continue
            bad = min(1.0 - fast[o.name], 1.0 - slow[o.name])
            out[o.name] = bad / o.budget
        return out

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        """The opsd ``/slo`` document."""
        now = self.clock() if now is None else float(now)
        lifetime = self.goodput(None, now=now)
        defined = [v for v in lifetime.values() if v is not None]
        with self._lock:
            evaluated = self._evaluated
        return {
            "objectives": [o.to_dict() for o in self.objectives],
            "evaluated": evaluated,
            "windows": {"fast_s": self.fast_window_s,
                        "slow_s": self.slow_window_s},
            "goodput": {
                "lifetime": lifetime,
                "fast": self.goodput(self.fast_window_s, now=now),
                "slow": self.goodput(self.slow_window_s, now=now),
            },
            "burn": self.burn(now=now),
            # The single roll-up fleet_top renders: the worst lifetime
            # objective, or None before any traffic.
            "goodput_ratio": min(defined) if defined else None,
        }
