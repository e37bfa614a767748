"""Training-health accounting: staleness ledger + dynamics recording
(counterpart of ``elephas_tpu/obs/health.py``).

The async PS applies deltas that were computed against *old* parameter
versions — that staleness is the central trade the sync-frequency study
(SparkNet/DeepSpark, PAPERS.md) turns on, and bounded-staleness
admission (ROADMAP) can't land until it is measured. This module is the
measurement substrate:

- ``StalenessLedger`` — a rolling per-worker contribution table the PS
  feeds at ``apply_delta`` time: updates applied, cumulative/max version
  lag, last-seen version and time, bytes contributed. Served raw by the
  opsd ``/workers`` route, so "who is lagging, who is dominating" is one
  scrape away.
- ``record_staleness`` — the one-call apply-site hook: observes the lag
  into the labeled ``ps_staleness_versions`` histogram AND the ledger.
- ``tree_norm`` / ``record_unit_dynamics`` — per-unit training-dynamics
  telemetry for the engines (loss, delta norm, effective step size),
  recorded into registry gauges and tagged onto the live unit span so a
  merged trace answers "which worker's stale delta moved the loss".

Everything here is host-side dict bumps; ``tree_norm`` reads one number
back from the device when its tree lives there.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "StalenessLedger",
    "record_staleness",
    "record_unit_dynamics",
    "staleness_histogram",
    "tree_norm",
]

#: Version-lag bucket bounds: lags are small integers (how many applies
#: the server advanced past the worker's pull), not latencies.
STALENESS_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


class StalenessLedger:
    """Rolling per-worker contribution table (thread-safe).

    ``record`` is a dict bump under one small lock — called by every PS
    push handler thread. ``samples`` keeps a bounded window of raw lags
    (all workers interleaved, arrival order) so read-out paths can
    report *exact* percentiles where the fixed-bucket histogram only
    interpolates; the window bounds memory, ``lag_sum``/``updates``
    stay exact forever.
    """

    def __init__(self, clock=time.monotonic, sample_capacity: int = 4096):
        self.clock = clock
        self._lock = threading.Lock()
        self._workers: Dict[str, Dict[str, Any]] = {}
        self._samples: deque = deque(maxlen=sample_capacity)
        self._unstamped = 0

    def record(self, worker: Optional[str], lag: Optional[int],
               nbytes: int = 0, version: Optional[int] = None,
               sync_interval: Optional[float] = None) -> None:
        """One applied delta. ``lag=None`` means the frame carried no
        ``seen_version`` stamp (legacy peer) — counted, not measured.
        ``sync_interval``: the pusher's self-reported adaptive
        units-per-push (last-write-wins; None when unstamped — the
        fleet SYNC column renders '-' for those workers)."""
        now = self.clock()
        with self._lock:
            if lag is None:
                self._unstamped += 1
                return
            row = self._row(worker)
            row["updates"] += 1
            row["lag_sum"] += int(lag)
            if lag > row["lag_max"]:
                row["lag_max"] = int(lag)
            row["bytes"] += int(nbytes)
            row["last_seen_version"] = version
            row["last_seen_s"] = now
            if sync_interval is not None:
                row["sync_interval"] = float(sync_interval)
            self._samples.append(int(lag))

    def _row(self, worker: Optional[str]) -> Dict[str, Any]:
        """Get-or-create a worker's row. Caller holds ``_lock``."""
        key = str(worker) if worker is not None else "unknown"
        row = self._workers.get(key)
        if row is None:
            row = self._workers[key] = {
                "updates": 0, "lag_sum": 0, "lag_max": 0,
                "bytes": 0, "last_seen_version": None,
                "last_seen_s": None, "rejected": 0, "damped": 0,
                "sync_interval": None,
            }
        return row

    def record_rejected(self, worker: Optional[str]) -> None:
        """One delta refused by the admission policy (hard bound).
        Rejected pushes do NOT count as updates — the ledger's
        ``updates`` column keeps meaning "deltas applied"."""
        with self._lock:
            self._row(worker)["rejected"] += 1

    def record_damped(self, worker: Optional[str]) -> None:
        """One delta applied at reduced weight (soft bound). The push
        still counts as an update (``record`` ran for it); this column
        just marks how many of them were decayed."""
        with self._lock:
            self._row(worker)["damped"] += 1

    def samples(self) -> list:
        """The retained lag window, arrival order (read-out paths build
        exact distributions from this; bounded by ``sample_capacity``)."""
        with self._lock:
            return list(self._samples)

    def lag_percentile(self, q: float) -> Optional[float]:
        """Exact quantile over the retained sample window; None if empty."""
        with self._lock:
            samples = sorted(self._samples)
        if not samples:
            return None
        rank = q * (len(samples) - 1)
        lo = int(math.floor(rank))
        hi = min(lo + 1, len(samples) - 1)
        return samples[lo] + (samples[hi] - samples[lo]) * (rank - lo)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready table — the ``/workers`` opsd route serves this."""
        with self._lock:
            workers = {
                k: dict(v, lag_mean=(v["lag_sum"] / v["updates"])
                        if v["updates"] else None)
                for k, v in self._workers.items()
            }
            samples = list(self._samples)
            unstamped = self._unstamped
        doc: Dict[str, Any] = {
            "workers": workers,
            "total_updates": sum(w["updates"] for w in workers.values()),
            "unstamped_updates": unstamped,
            "window_samples": len(samples),
        }
        for q, key in ((0.50, "lag_p50"), (0.95, "lag_p95"),
                       (0.99, "lag_p99")):
            doc[key] = self.lag_percentile(q)
        return doc


def staleness_histogram(registry):
    """The labeled per-worker staleness histogram (get-or-create)."""
    return registry.histogram(  # metric-ok: unit is version lag, not seconds
        "ps_staleness_versions",
        help="version lag of applied deltas (server version at apply "
             "minus the version the worker trained against)",
        buckets=STALENESS_BUCKETS, labelnames=("worker",),
    )


def record_staleness(ledger: Optional[StalenessLedger],
                     worker: Optional[str], lag: Optional[int],
                     nbytes: int = 0, version: Optional[int] = None,
                     registry=None,
                     sync_interval: Optional[float] = None) -> None:
    """The apply-site hook: ledger row + labeled histogram in one call.

    ``lag=None`` (unstamped legacy frame) still bumps the ledger's
    coverage counter but records no distribution point.
    """
    if ledger is not None:
        ledger.record(worker, lag, nbytes=nbytes, version=version,
                      sync_interval=sync_interval)
    if lag is not None and registry is not None:
        staleness_histogram(registry).labels(
            worker=str(worker) if worker is not None else "unknown"
        ).observe(lag)


def tree_norm(tree) -> float:
    """Global L2 norm over a tree's numeric leaves: NumPy arrays and
    scalars on the host, tensors where they live (one read of the result
    per device, not one per leaf)."""
    total = 0.0
    tensors = []
    stack = [tree]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, torch.Tensor):
            if node.numel() and node.dtype != torch.bool and not node.is_complex():
                tensors.append(node.detach())
        else:
            arr = np.asarray(node)
            if arr.dtype.kind in "fiu":
                flat = arr.astype(np.float64, copy=False).ravel()
                total += float(np.dot(flat, flat))
    by_device = {}
    for t in tensors:
        by_device.setdefault(t.device, []).append(t.double().square().sum())
    for sums in by_device.values():
        total += float(torch.stack(sums).sum())
    return math.sqrt(total)


def record_unit_dynamics(registry, worker: Optional[str] = None, *,
                         loss: Optional[float] = None,
                         delta_norm: Optional[float] = None,
                         param_norm: Optional[float] = None,
                         span=None, **span_args) -> Dict[str, float]:
    """Record one training unit's dynamics; returns what was recorded.

    Effective step size is ``|delta| / |params|`` — the scale-free "how
    far did this update move the model" number the staleness trade study
    plots against lag. Gauges are last-write-wins per worker (the
    distribution lives in the trace; alert rules read the gauge).
    ``span`` (the live unit/push span, may be None when tracing is off)
    gets the same numbers as attributes.
    """
    key = str(worker) if worker is not None else "driver"
    out: Dict[str, float] = {}
    if loss is not None:
        out["unit_loss"] = float(loss)
        registry.gauge("train_unit_loss",
                       help="last per-unit training loss",
                       labelnames=("worker",)).labels(worker=key).set(loss)
    if delta_norm is not None:
        out["delta_norm"] = float(delta_norm)
        registry.gauge("train_delta_norm",
                       help="L2 norm of the last pushed/applied delta",
                       labelnames=("worker",)).labels(
                           worker=key).set(delta_norm)
        if param_norm is not None and param_norm > 0.0:
            step = float(delta_norm) / float(param_norm)
            out["effective_step"] = step
            registry.gauge(
                "train_effective_step",
                help="delta L2 norm over parameter L2 norm per unit",
                labelnames=("worker",)).labels(worker=key).set(step)
    if span is not None and out:
        span.note(**out, **span_args)
    return out
