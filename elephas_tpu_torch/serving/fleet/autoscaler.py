"""Goodput-burn-driven replica-count decisions (counterpart of
``elephas_tpu/serving/fleet/autoscaler.py``).

The autoscaler is the fleet's slowest control loop, so it is built as
a *pure decision core*: ``observe(burn=, n_replicas=, now=)`` folds one
observation into streak state and returns ``"up"``, ``"down"``, or
``None``. No threads, no sleeps, no wall-clock reads outside the
injectable ``clock`` — the same observation sequence always yields the
same decision sequence, which is what lets tests pin the replay and
the chaos bench gate on it.

Three stabilizers keep it from flapping, mirroring the alert plane's
latch-until-clean philosophy one level up:

- a **hysteresis dead band** between ``down_burn`` and ``up_burn``
  where streaks reset — burn hovering near a single threshold can't
  oscillate the fleet,
- **consecutive-observation streaks** (``up_after``/``down_after``):
  one bad window is a blip; N in a row is a trend. Scaling down
  demands a longer streak than scaling up, because under-capacity
  burns SLO budget while over-capacity only burns money,
- a **cooldown** after every actuation, long enough for the
  multi-window burn to actually reflect the new capacity before the
  next decision (reacting to a signal that hasn't seen the last action
  yet is how autoscalers pump).

Every decision is narrated twice: a ``fleet_scale`` flight event (the
post-mortem surface) and a ``fleet_scale_events_total{direction=}``
counter tick (the dashboard surface).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from elephas_tpu_torch import obs

__all__ = ["FleetAutoscaler"]

#: How many recent decisions the snapshot carries (the full list stays
#: on the instance for tests; the ops doc stays bounded).
SNAPSHOT_DECISIONS = 32


class FleetAutoscaler:
    """Replica-count policy from multi-window goodput burn."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 8,
                 up_burn: float = 1.0, down_burn: float = 0.25,
                 up_after: int = 2, down_after: int = 3,
                 cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= "
                f"min_replicas ({min_replicas})")
        if not down_burn < up_burn:
            raise ValueError(
                f"need down_burn < up_burn for a hysteresis band, got "
                f"down={down_burn} up={up_burn}")
        if up_after < 1 or down_after < 1:
            raise ValueError(
                f"streak lengths must be >= 1, got up_after={up_after} "
                f"down_after={down_after}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_burn = up_burn
        self.down_burn = down_burn
        self.up_after = up_after
        self.down_after = down_after
        self.cooldown_s = cooldown_s
        self.clock = clock

        self.observations = 0
        self.decisions: List[Dict[str, Any]] = []
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_t: Optional[float] = None

    def observe(self, *, burn: float, n_replicas: int,
                now: Optional[float] = None) -> Optional[str]:
        """Fold one fleet-burn observation; maybe decide.

        Streaks advance even during cooldown (the trend is real either
        way), but actuation waits the cooldown out — the first
        observation after it expires can fire immediately if the
        streak held.
        """
        now = self.clock() if now is None else now
        self.observations += 1
        if burn > self.up_burn:
            self._up_streak += 1
            self._down_streak = 0
        elif burn < self.down_burn:
            self._down_streak += 1
            self._up_streak = 0
        else:
            # Hysteresis dead band: neither trend survives it.
            self._up_streak = 0
            self._down_streak = 0

        cooling = (self._last_scale_t is not None
                   and now - self._last_scale_t < self.cooldown_s)
        direction = None
        if cooling:
            pass
        elif (self._up_streak >= self.up_after
                and n_replicas < self.max_replicas):
            direction = "up"
        elif (self._down_streak >= self.down_after
                and n_replicas > self.min_replicas):
            direction = "down"
        if direction is None:
            return None

        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_t = now
        record = {"t": now, "direction": direction, "burn": burn,
                  "replicas": n_replicas}
        self.decisions.append(record)
        obs.default_flight_recorder().note(
            "fleet_scale", "info", direction=direction, burn=burn,
            replicas=n_replicas)
        obs.default_registry().counter(
            "fleet_scale_events_total",
            help="autoscaler decisions actuated, by direction",
            labelnames=("direction",),
        ).labels(direction=direction).inc()
        return direction

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready policy + recent-decision card for ``/replicas``."""
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "up_burn": self.up_burn,
            "down_burn": self.down_burn,
            "up_after": self.up_after,
            "down_after": self.down_after,
            "cooldown_s": self.cooldown_s,
            "observations": self.observations,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "last_scale_t": self._last_scale_t,
            "decisions": list(self.decisions[-SNAPSHOT_DECISIONS:]),
            "last": self.decisions[-1] if self.decisions else None,
        }
