"""Time-series history rings: counters/gauges become rates and windows.

Counterpart of ``elephas_tpu/obs/history.py``, whose logic is framework-free;
the port keeps its own copy so that it imports nothing of the JAX package.

Every scrape surface built so far (``/metrics``, ``/workers``,
``/alerts``) is a *point-in-time* snapshot — it cannot answer "what
happened in the last 60 s before the alert fired", and every consumer
that needed a rate (the alert engine's ``mode="rate"`` rules) grew its
own ad-hoc two-point bookkeeping. This module is the one substrate for
both:

- ``HistoryRing`` — a fixed-capacity ``(t, value)`` ring with
  preallocated storage (pushing in steady state writes two floats into
  existing slots — no allocation, no GC pressure on the sampling path)
  exposing windowed reads: per-second rate over the trailing window,
  min/max/last, sample count.
- ``HistorySampler`` (the registry sampler behind the ops endpoint's
  ``/history`` route) is not ported yet; it arrives with the ops
  endpoint.

The alert engine's windowed-rate rules evaluate on these rings (one
private ring per (rule, matched key)), replacing their original
two-point deque deltas — same semantics (oldest retained point inside
the window to the newest), one implementation.

Rate semantics: ``rate(window_s, now)`` considers samples with
``now - t <= window_s``, needs at least two, and differentiates the
oldest retained against the newest — so a counter sampled every second
over a 60 s window yields the true trailing-minute per-second rate, and
an under-sampled ring answers ``None`` instead of a made-up number.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["HistoryRing"]


class HistoryRing:
    """Fixed-capacity time-series ring (thread-safe).

    Storage is two preallocated float lists indexed modulo capacity:
    ``push`` in steady state is two list writes + integer bumps under a
    small lock — zero allocation, so a 1 Hz sampler tracking hundreds of
    keys costs microseconds, forever. Reads build small lists (readout
    is rare and not on the sampling path).
    """

    __slots__ = ("capacity", "_t", "_v", "_n", "_next", "_lock")

    def __init__(self, capacity: int = 512):
        if capacity < 2:
            raise ValueError(
                f"capacity must be >= 2 (a rate needs two points), "
                f"got {capacity}")
        self.capacity = capacity
        self._t = [0.0] * capacity
        self._v = [0.0] * capacity
        self._n = 0  # samples retained (<= capacity)
        self._next = 0  # slot the next push writes
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n

    def push(self, t: float, value: float) -> None:
        with self._lock:
            self._t[self._next] = float(t)
            self._v[self._next] = float(value)
            self._next = (self._next + 1) % self.capacity
            if self._n < self.capacity:
                self._n += 1

    def samples(self, window_s: Optional[float] = None,
                now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Retained ``(t, value)`` pairs oldest-first; with ``window_s``,
        only those with ``now - t <= window_s`` (``now`` defaults to the
        newest retained timestamp)."""
        with self._lock:
            n, nxt = self._n, self._next
            out = [(self._t[(nxt - n + i) % self.capacity],
                    self._v[(nxt - n + i) % self.capacity])
                   for i in range(n)]
        if window_s is None or not out:
            return out
        if now is None:
            now = out[-1][0]
        return [(t, v) for t, v in out if now - t <= window_s]

    def last(self) -> Optional[Tuple[float, float]]:
        with self._lock:
            if self._n == 0:
                return None
            i = (self._next - 1) % self.capacity
            return (self._t[i], self._v[i])

    def rate(self, window_s: float, now: Optional[float] = None
             ) -> Optional[float]:
        """Per-second rate of change over the trailing window: newest
        retained sample vs the oldest one still inside it. ``None``
        until two samples land in the window (never a made-up number)."""
        pts = self.samples(window_s=window_s, now=now)
        if len(pts) < 2:
            return None
        t0, v0 = pts[0]
        t1, v1 = pts[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def stats(self, window_s: Optional[float] = None,
              now: Optional[float] = None) -> Dict[str, Optional[float]]:
        """JSON-ready windowed roll-up: n / last / min / max / rate."""
        pts = self.samples(window_s=window_s, now=now)
        if not pts:
            return {"n": 0, "last": None, "min": None, "max": None,
                    "rate_per_s": None, "span_s": None}
        values = [v for _, v in pts]
        t0, t1 = pts[0][0], pts[-1][0]
        rate = None
        if len(pts) >= 2 and t1 > t0:
            rate = (pts[-1][1] - pts[0][1]) / (t1 - t0)
        return {
            "n": len(pts),
            "last": pts[-1][1],
            "min": min(values),
            "max": max(values),
            "rate_per_s": rate,
            "span_s": t1 - t0,
        }
