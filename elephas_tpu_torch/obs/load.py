"""Engine load signals: one saturation score a router can dispatch on.

Counterpart of ``elephas_tpu/obs/load.py``, whose logic is framework-free;
the port keeps its own copy so that it imports nothing of the JAX package.

Everything the obs stack measures so far is retrospective — spans,
histograms, fleet rollups say what *happened*. The ROADMAP's replica
tier ("per-replica backpressure and queue-depth-aware dispatch") needs
the opposite: a present-tense answer to "how loaded is this engine
right now", cheap enough to compute every scheduler step and stable
enough to route on. This module is that answer:

- ``LoadSnapshot`` — an immutable point-in-time record of the raw
  saturation signals the scheduler already has in hand (queue depth
  against its bound, active decode slots against ``max_slots``, KV-pool
  free fraction) plus trailing rates derived from ``ServingMetrics``
  counters (admissions, rejects, token throughput) over a
  ``HistoryRing`` window.
- ``instant_load(snap)`` — a pure reduction of one snapshot to a raw
  saturation figure in [0, 1]: a weighted blend of slot occupancy,
  queue fullness, and KV-pool pressure, bumped toward 1.0 while the
  engine is actively shedding (non-zero reject rate). Monotone in
  queue depth and occupancy by construction — rising pressure can
  never *lower* the score.
- ``LoadScore`` — a time-based EWMA of the raw figure on the injected
  clock (``alpha = 1 - exp(-dt / tau)``), so a router sees a smoothed
  signal instead of per-step flicker, and seeded tests replay the
  exact same values with a fake clock.
- ``LoadTracker`` — the stateful composition the engine owns: feed it
  the scheduler's live signals each step (``observe()``), read the
  JSON document the opsd ``/load`` route serves (``snapshot()``).

The tracker mirrors the smoothed score into the default registry as a
``serving_load_score`` gauge (lazily bound, latched off on failure —
the same discipline as ``ServingMetrics``), which both rides the
history sampler's ``serving_`` prefix into ``/history`` rings and
reaches the fleet rollup as a per-proc gauge.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, Optional

from elephas_tpu_torch.obs.history import HistoryRing

# Blend weights for the raw saturation figure. Occupancy leads (a full
# decode batch is the first hard resource), queue fullness second (work
# already committed but not placed), KV pressure third (the resource
# that admission actually blocks on).
WEIGHT_OCCUPANCY = 0.4
WEIGHT_QUEUE = 0.3
WEIGHT_KV = 0.2
WEIGHT_REJECT = 0.1

# A sustained reject rate at/above this (per second) reads as "fully
# shedding" and contributes the whole reject weight.
REJECT_RATE_FULL = 1.0

DEFAULT_TAU_S = 5.0
DEFAULT_RATE_WINDOW_S = 30.0


class LoadSnapshot:
    """One point-in-time reading of the engine's saturation signals."""

    __slots__ = (
        "t", "queue_depth", "queue_limit", "active", "max_slots",
        "kv_free_frac", "admit_rate", "reject_rate", "tokens_per_s",
        "kv_blocks_free", "kv_blocks_total", "prefix_hit_rate",
        "spec_accept_rate", "spec_tokens_per_step",
    )

    def __init__(self, *, t, queue_depth, queue_limit, active, max_slots,
                 kv_free_frac, admit_rate=0.0, reject_rate=0.0,
                 tokens_per_s=0.0, kv_blocks_free=None,
                 kv_blocks_total=None, prefix_hit_rate=None,
                 spec_accept_rate=None, spec_tokens_per_step=None):
        self.t = float(t)
        self.queue_depth = int(queue_depth)
        self.queue_limit = max(1, int(queue_limit))
        self.active = int(active)
        self.max_slots = max(1, int(max_slots))
        self.kv_free_frac = min(1.0, max(0.0, float(kv_free_frac)))
        self.admit_rate = max(0.0, float(admit_rate))
        self.reject_rate = max(0.0, float(reject_rate))
        self.tokens_per_s = max(0.0, float(tokens_per_s))
        # Paged-pool extras (None on contiguous pools): block-granular
        # KV pressure — ``kv_free_frac`` above is already block-derived
        # when these are present — plus the prefix-cache hit rate a
        # router can prefer replicas on.
        self.kv_blocks_free = (
            None if kv_blocks_free is None else int(kv_blocks_free)
        )
        self.kv_blocks_total = (
            None if kv_blocks_total is None else int(kv_blocks_total)
        )
        self.prefix_hit_rate = (
            None if prefix_hit_rate is None else float(prefix_hit_rate)
        )
        # Speculative-decode extras (None unless the engine runs
        # speculative=True and has harvested at least one window): the
        # trailing draft-token accept rate and emitted tokens per
        # lane-step a router/operator reads for decode efficiency.
        self.spec_accept_rate = (
            None if spec_accept_rate is None else float(spec_accept_rate)
        )
        self.spec_tokens_per_step = (
            None if spec_tokens_per_step is None
            else float(spec_tokens_per_step)
        )

    @property
    def occupancy(self) -> float:
        return min(1.0, self.active / self.max_slots)

    @property
    def queue_frac(self) -> float:
        return min(1.0, self.queue_depth / self.queue_limit)

    def to_dict(self) -> Dict[str, float]:
        out = {
            "t": self.t,
            "queue_depth": self.queue_depth,
            "queue_limit": self.queue_limit,
            "queue_frac": self.queue_frac,
            "active": self.active,
            "max_slots": self.max_slots,
            "occupancy": self.occupancy,
            "kv_free_frac": self.kv_free_frac,
            "admit_rate_per_s": self.admit_rate,
            "reject_rate_per_s": self.reject_rate,
            "tokens_per_s": self.tokens_per_s,
        }
        if self.kv_blocks_total is not None:
            out["kv_blocks_free"] = self.kv_blocks_free
            out["kv_blocks_total"] = self.kv_blocks_total
            out["prefix_hit_rate"] = self.prefix_hit_rate
        if self.spec_accept_rate is not None:
            out["spec_accept_rate"] = self.spec_accept_rate
        if self.spec_tokens_per_step is not None:
            out["spec_tokens_per_step"] = self.spec_tokens_per_step
        return out


def instant_load(snap: LoadSnapshot) -> float:
    """Reduce one snapshot to a raw saturation figure in [0, 1].

    A weighted blend rather than a max: a router wants to distinguish
    "queue half full, slots idle" from "slots full, queue empty", and a
    max collapses both onto one number. Each component is already in
    [0, 1] and the weights sum to 1, so the result needs no clamp —
    and is monotone non-decreasing in every pressure signal.
    """
    reject_pressure = min(1.0, snap.reject_rate / REJECT_RATE_FULL)
    return (
        WEIGHT_OCCUPANCY * snap.occupancy
        + WEIGHT_QUEUE * snap.queue_frac
        + WEIGHT_KV * (1.0 - snap.kv_free_frac)
        + WEIGHT_REJECT * reject_pressure
    )


class LoadScore:
    """Time-based EWMA of the raw load figure, on the injected clock.

    ``alpha = 1 - exp(-dt / tau)``: irregular observation spacing (the
    scheduler steps as fast as decode allows) still converges at the
    same wall-clock rate, and ``dt == 0`` degenerates to "no update" —
    replaying a seeded trace twice yields bit-identical scores.
    """

    __slots__ = ("tau_s", "_value", "_last_t")

    def __init__(self, tau_s: float = DEFAULT_TAU_S):
        if tau_s <= 0:
            raise ValueError(f"tau_s must be > 0, got {tau_s}")
        self.tau_s = float(tau_s)
        self._value: Optional[float] = None
        self._last_t: Optional[float] = None

    @property
    def value(self) -> Optional[float]:
        return self._value

    def update(self, raw: float, t: float) -> float:
        raw = min(1.0, max(0.0, float(raw)))
        if self._value is None:
            self._value, self._last_t = raw, float(t)
            return raw
        dt = max(0.0, float(t) - self._last_t)
        alpha = 1.0 - math.exp(-dt / self.tau_s)
        self._value += alpha * (raw - self._value)
        self._last_t = float(t)
        return self._value


class LoadTracker:
    """The engine-owned load plane: observe scheduler state, serve /load.

    ``observe()`` is called from the scheduler step with the signals it
    already holds — no locks taken inside the serving hot path beyond
    the tracker's own, no registry work unless the mirror is healthy.
    Counter-valued inputs (``rejected_total`` etc.) are pushed into
    rings and differentiated over ``rate_window_s`` so the snapshot
    carries trailing *rates*, not lifetime totals.
    """

    def __init__(self, *, tau_s: float = DEFAULT_TAU_S,
                 rate_window_s: float = DEFAULT_RATE_WINDOW_S,
                 clock: Callable[[], float] = time.monotonic,
                 capacity: int = 256):
        self.clock = clock
        self.rate_window_s = float(rate_window_s)
        self.score = LoadScore(tau_s=tau_s)
        self._lock = threading.Lock()
        self._admitted = HistoryRing(capacity)
        self._rejected = HistoryRing(capacity)
        self._tokens = HistoryRing(capacity)
        self._last: Optional[LoadSnapshot] = None
        self._raw: Optional[float] = None
        self._observations = 0
        self._registry_gauge = None  # lazy; False after a failed bind
        self._spec_gauges = None  # lazy; False after a failed bind

    def _mirror(self, value: float) -> None:
        if self._registry_gauge is None:
            try:
                from elephas_tpu_torch import obs
                self._registry_gauge = obs.default_registry().gauge(
                    "serving_load_score",
                    help="EWMA engine saturation score in [0,1]",
                )
            except Exception:
                self._registry_gauge = False
        if self._registry_gauge:
            self._registry_gauge.set(value)

    def _mirror_spec(self, accept_rate, tokens_per_step) -> None:
        """Federate the speculative-decode gauges per proc, same
        lazy/latched discipline as the load-score mirror."""
        if self._spec_gauges is None:
            try:
                from elephas_tpu_torch import obs
                reg = obs.default_registry()
                self._spec_gauges = (
                    reg.gauge(
                        "serving_spec_accept_rate",
                        help="draft tokens accepted / drafted in [0,1]",
                    ),
                    reg.gauge(
                        "serving_spec_tokens_per_step",
                        help="tokens emitted per speculative lane-step",
                    ),
                )
            except Exception:
                self._spec_gauges = False
        if self._spec_gauges:
            if accept_rate is not None:
                self._spec_gauges[0].set(accept_rate)
            if tokens_per_step is not None:
                self._spec_gauges[1].set(tokens_per_step)

    def observe(self, *, queue_depth, queue_limit, active, max_slots,
                kv_free_frac, admitted_total=0, rejected_total=0,
                tokens_total=0, now=None, kv_blocks_free=None,
                kv_blocks_total=None, prefix_hit_rate=None,
                spec_accept_rate=None,
                spec_tokens_per_step=None) -> LoadSnapshot:
        now = self.clock() if now is None else float(now)
        with self._lock:
            self._admitted.push(now, float(admitted_total))
            self._rejected.push(now, float(rejected_total))
            self._tokens.push(now, float(tokens_total))
            w = self.rate_window_s
            snap = LoadSnapshot(
                t=now, queue_depth=queue_depth, queue_limit=queue_limit,
                active=active, max_slots=max_slots, kv_free_frac=kv_free_frac,
                admit_rate=self._admitted.rate(w, now=now) or 0.0,
                reject_rate=self._rejected.rate(w, now=now) or 0.0,
                tokens_per_s=self._tokens.rate(w, now=now) or 0.0,
                kv_blocks_free=kv_blocks_free,
                kv_blocks_total=kv_blocks_total,
                prefix_hit_rate=prefix_hit_rate,
                spec_accept_rate=spec_accept_rate,
                spec_tokens_per_step=spec_tokens_per_step,
            )
            self._raw = instant_load(snap)
            score = self.score.update(self._raw, now)
            self._last = snap
            self._observations += 1
        self._mirror(score)
        if spec_accept_rate is not None or spec_tokens_per_step is not None:
            self._mirror_spec(spec_accept_rate, spec_tokens_per_step)
        return snap

    def snapshot(self) -> Dict[str, object]:
        """The opsd ``/load`` document: smoothed score + raw anatomy."""
        with self._lock:
            return {
                "score": self.score.value,
                "raw": self._raw,
                "tau_s": self.score.tau_s,
                "rate_window_s": self.rate_window_s,
                "observations": self._observations,
                "signals": self._last.to_dict() if self._last else None,
            }
