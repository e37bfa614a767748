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
- ``HistorySampler`` — samples *selected* registry snapshot keys
  (prefix-matched: all of ``ps_*``, ``serving_*``, ... by default) into
  one ring per key at a configurable period, either explicitly
  (``tick()`` — tests, bench checkpoints) or on a background daemon
  thread (``start()`` — what a mounted ops endpoint runs). The opsd
  ``/history?window=`` route serves ``snapshot(window_s)``.

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

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["HistoryRing", "HistorySampler", "DEFAULT_SAMPLE_PREFIXES"]

#: Registry snapshot keys the sampler tracks when no explicit selection
#: is given: the cross-process data-path counters, serving latencies,
#: training dynamics, alert firings, and device memory watermarks.
#: Histogram percentile expansions (`*_p50`...) ride along under their
#: family prefix — a percentile's history is exactly what "p95 over the
#: last minute" needs.
DEFAULT_SAMPLE_PREFIXES = (
    "ps_",
    "serving_",
    "train_",
    "alerts_",
    "device_mem_",
    "tracer_",
    "retrace_",
)


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


class HistorySampler:
    """Samples selected registry snapshot keys into per-key rings.

    ``select`` is a tuple of key prefixes (exact keys match their own
    prefix); the default tracks the package's cross-process families
    (``DEFAULT_SAMPLE_PREFIXES``). A ring is allocated the first time a
    key appears — after that, steady state allocates nothing.

    Driving: ``tick(now)`` samples once (tests and bench checkpoints
    call it on an injected clock); ``maybe_tick(now)`` respects
    ``period_s``; ``start()`` runs ``tick`` on a background daemon
    thread every ``period_s`` wall seconds (what a mounted ops endpoint
    uses — sampling must not depend on being scraped). ``extra_fn``
    (e.g. ``devprof.record_device_memory``) runs before each sample so
    pull-style gauges are fresh in the snapshot the tick reads.
    """

    def __init__(self, registry=None,
                 select: Iterable[str] = DEFAULT_SAMPLE_PREFIXES,
                 period_s: float = 1.0, capacity: int = 512,
                 clock=time.monotonic, extra_fn=None):
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self._registry = registry
        self.select = tuple(select)
        self.period_s = float(period_s)
        self.capacity = int(capacity)
        self.clock = clock
        self.extra_fn = extra_fn
        self.rings: Dict[str, HistoryRing] = {}
        self.ticks = 0
        self._last_tick: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stores: tuple = ()  # durable tees (obs/store.py), COW

    def _get_registry(self):
        if self._registry is not None:
            return self._registry
        from elephas_tpu_torch import obs

        return obs.default_registry()

    def _selected(self, key: str) -> bool:
        return any(key.startswith(p) for p in self.select)

    # -- sampling -----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """Sample every selected snapshot key once; returns how many
        keys were recorded. Safe to call from any thread."""
        if now is None:
            now = self.clock()
        if self.extra_fn is not None:
            try:
                self.extra_fn()
            except Exception:
                pass  # a broken watermark probe must not stop sampling
        snap = self._get_registry().snapshot()
        recorded = 0
        sampled: Dict[str, float] = {}
        for key, value in snap.items():
            if not self._selected(key):
                continue
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            if math.isnan(value):
                continue
            ring = self.rings.get(key)
            if ring is None:
                with self._lock:
                    ring = self.rings.setdefault(
                        key, HistoryRing(capacity=self.capacity))
            ring.push(now, value)
            sampled[key] = float(value)
            recorded += 1
        self.ticks += 1
        self._last_tick = now
        # Durable tee: the tick's sampled name→value map journals as one
        # ``metric`` record, so a post-mortem has the metric excerpts
        # the in-memory rings would have lost with the process.
        for store in self._stores:
            try:
                store.record_metrics(sampled, self.ticks)
            except Exception:
                pass
        return recorded

    # -- durable tee --------------------------------------------------------

    def attach_store(self, store) -> None:
        """Journal every subsequent tick into ``store``. Idempotent."""
        with self._lock:
            if store not in self._stores:
                self._stores = self._stores + (store,)

    def detach_store(self, store) -> None:
        with self._lock:
            self._stores = tuple(s for s in self._stores if s is not store)

    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """``tick`` iff at least ``period_s`` elapsed since the last."""
        if now is None:
            now = self.clock()
        if self._last_tick is not None and now - self._last_tick < self.period_s:
            return False
        self.tick(now)
        return True

    # -- background driving -------------------------------------------------

    def start(self) -> "HistorySampler":
        """Run ``tick`` every ``period_s`` on a daemon thread
        (idempotent). The thread waits on an Event, so ``stop()``
        returns promptly."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.period_s):
                self.tick()

        self._thread = threading.Thread(
            target=loop, name="obs-history-sampler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5)
        self._thread = None

    # -- read-out -----------------------------------------------------------

    def snapshot(self, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> Dict[str, object]:
        """JSON-ready dump — the ``/history?window=`` route serves this:
        one windowed stats row per tracked key, plus sampler config."""
        if now is None and window_s is not None:
            now = self.clock()
        with self._lock:
            keys = sorted(self.rings)
        return {
            "period_s": self.period_s,
            "capacity": self.capacity,
            "window_s": window_s,
            "ticks": self.ticks,
            "series": {
                k: self.rings[k].stats(window_s=window_s, now=now)
                for k in keys
            },
        }
