"""Flight recorder: bounded ring of structured anomaly events.

Counterpart of ``elephas_tpu/obs/flight.py``, whose logic is framework-free;
the port keeps its own copy so that it imports nothing of the JAX package.

Metrics answer "how many rejections"; traces answer "where the time
went"; neither answers "what went *wrong* around 14:03:07, in what
order, on which trace" after a PS kill. The flight recorder is that
third surface: every anomaly the system already detects — retrace
storms, heartbeat flaps, stale-delta rejections, backpressure
rejections, deadline evictions, WAL restores — drops one structured
event into a bounded ring, tagged with severity and the trace context
active at the anomaly site, so a merged chaos trace and the anomaly log
join on trace id.

Recording is a clock read + dict build + deque append under a small
lock — cheap enough to stay on unconditionally (anomalies are rare by
definition; a recorder hot enough to matter is itself the anomaly, and
the ring bounds the damage). The ring keeps the *recent* past and
counts what it overwrites (``dropped``), mirroring the span tracer's
truncation honesty.

Read-out paths: ``events()``/``snapshot()`` for tests and the ops
endpoint's ``/flight`` route; ``dump(path)`` for the crash path — PS
``kill()`` writes the ring to disk *before* severing connections, so a
post-mortem has the anomaly log even though the process skipped every
clean-shutdown sync.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from elephas_tpu_torch.obs import trace as _trace
from elephas_tpu_torch.utils import locksan

__all__ = ["FlightEvent", "FlightRecorder", "KINDS", "NULL_FLIGHT_RECORDER"]

#: Allowed severities, in increasing order of alarm.
SEVERITIES = ("info", "warn", "error")

#: The registered anomaly vocabulary. Every ``note()`` call site in the
#: package must use a kind from this table (``scripts/lint_blocking.py``
#: enforces it at the literal site; ``# kind-ok`` escapes) — free-string
#: kinds fragment the ``counts_by_kind`` rollup and the alert engine's
#: breach vocabulary. Grow the table, don't invent inline.
KINDS = (
    "retrace_storm",
    "heartbeat_flap",
    "worker_dead",
    "stale_notmod",
    "backpressure_reject",
    "deadline_eviction",
    "wal_restore",
    "ps_kill",
    # training-health alert kinds (obs/alerts.py)
    "slo_breach",
    "staleness_spike",
    "worker_lagging",
    # shard-group lifecycle (parameter/group.py)
    "shard_failover",
    "standby_promoted",
    "shard_map_mismatch",
    # goodput / canary plane (obs/slo.py, obs/canary.py)
    "goodput_burn",
    "canary_fail",
    # serving fleet lifecycle + autoscaling (serving/fleet/)
    "replica_drain",
    "replica_restart",
    "fleet_scale",
    # paged KV pool (serving/kv_pool.py): a resident prefix-cache entry
    # was LRU-evicted to free blocks under allocation pressure
    "prefix_evict",
    # bounded-staleness admission (parameter/server.py): a pushed delta
    # exceeded the hard max_staleness bound and was refused outright
    "delta_rejected",
    # durable telemetry store (obs/store.py): a torn segment tail was
    # truncated on warm reopen (predecessor boot died mid-append)
    "store_corrupt_tail",
    # elastic hyperparameter tuner (tune/): successive-halving lifecycle
    # — a trial promoted to the next rung, early-stopped by the halving
    # rule, resumed from its vault checkpoint after a worker death, or
    # flagged by the stall detector as running without progress
    "trial_promoted",
    "trial_pruned",
    "trial_resumed",
    "trial_stalled",
    # speculative serving decode (serving/spec.py): the draft source
    # failed to produce params (e.g. PS pull error) and the decoder
    # degraded to plain decode for that window instead of erroring
    "spec_fallback",
    # per-tenant cost attribution (obs/tenancy.py): a tenant's
    # multi-window goodput burn crossed budget parity, or one tenant
    # holds most of the KV pool's integrated block-seconds while other
    # tenants are also paying for blocks
    "tenant_burn",
    "noisy_neighbor",
    # disaggregated serving (serving/fleet/): a prefill replica's KV
    # blocks handed off to a decode replica (kv_handoff), or the
    # handoff failed and the request degraded to a local re-prefill
    # (tier_handoff_fail); QoS admission throttled a tenant's submit
    # (admission_throttle) or preempted its queued request to seat a
    # higher-priority one (tenant_preempted)
    "kv_handoff",
    "tier_handoff_fail",
    "admission_throttle",
    "tenant_preempted",
    # disagg alert-plane kinds (obs/alerts.py): tier load divergence
    # and handoff-latency p99 breaches
    "tier_imbalance",
    "handoff_slow",
    # live model delivery (rollout/): an engine atomically swapped to
    # newly-pulled serving weights at a decode-step boundary
    # (weight_swap); a subscriber's PS pull failed and the engine kept
    # serving its current weights (weight_pull_fail); the controller
    # promoted a baked canary version fleet-wide (rollout_promote) or
    # rolled the canary back to the pinned prior version
    # (rollout_rollback)
    "weight_swap",
    "weight_pull_fail",
    "rollout_promote",
    "rollout_rollback",
    # rollout alert-plane kinds (obs/alerts.py): a rollout has sat in a
    # non-idle phase past its stuck threshold (rollout_stuck); replicas
    # are serving versions >1 apart past the skew grace window
    # (version_skew)
    "rollout_stuck",
    "version_skew",
)


class FlightEvent:
    """One recorded anomaly."""

    __slots__ = ("kind", "severity", "wall_s", "mono_s", "trace_id",
                 "detail")

    def __init__(self, kind: str, severity: str, wall_s: float,
                 mono_s: float, trace_id: Optional[str],
                 detail: Dict[str, Any]):
        self.kind = kind
        self.severity = severity
        self.wall_s = wall_s
        self.mono_s = mono_s
        self.trace_id = trace_id
        self.detail = detail

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "severity": self.severity,
            "wall_s": self.wall_s,
            "mono_s": self.mono_s,
            "trace_id": self.trace_id,
            "detail": self.detail,
        }

    def __repr__(self):
        return (f"FlightEvent({self.kind!r}, {self.severity}, "
                f"trace={self.trace_id}, {self.detail})")


class FlightRecorder:
    """Bounded anomaly ring.

    ``enabled=False`` makes ``note()`` a single attribute check —
    ``NULL_FLIGHT_RECORDER`` is the shared disabled instance, so
    instrumented code can hold a recorder unconditionally.
    """

    def __init__(self, capacity: int = 1024, enabled: bool = True,
                 clock=time.monotonic):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.clock = clock
        self.dropped = 0
        self._events: deque = deque(maxlen=capacity)
        self._lock = locksan.make_lock("FlightRecorder._lock")
        self._dropped_counter = None  # lazily bound on first overwrite
        self._stores: tuple = ()  # durable tees (obs/store.py), COW

    def note(self, kind: str, severity: str = "warn",
             **detail) -> Optional[FlightEvent]:
        """Record one anomaly, tagged with the active trace context.

        ``kind`` is a stable snake_case event name (``retrace_storm``,
        ``heartbeat_flap``, ``backpressure_reject``, ...); ``detail``
        holds the site-specific facts (worker id, depth, version delta).
        """
        if not self.enabled:
            return None
        if severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {severity!r}"
            )
        ctx = _trace.current_context()
        event = FlightEvent(kind, severity, time.time(), self.clock(),
                            ctx.trace_id if ctx is not None else None,
                            detail)
        with self._lock:
            overwrote = len(self._events) == self._events.maxlen
            if overwrote:
                self.dropped += 1
            self._events.append(event)
        # Durable tee: anomalies reach disk at note() time, so a SIGKILL
        # between now and any clean dump loses nothing (obs/store.py).
        # The tuple is copy-on-write — no lock on the hot path; a store
        # must never take a host down with it.
        for store in self._stores:
            try:
                store.record_flight(event)
            except Exception:
                pass
        if overwrote:
            # Silent anomaly loss must itself be observable: mirror the
            # tracer's truncation counter in the process registry so
            # expose_text()/alert rules see it. Lazy-bound outside the
            # ring lock; registry counters take their own lock.
            counter = self._dropped_counter
            if counter is None:
                try:
                    from elephas_tpu_torch import obs

                    counter = obs.default_registry().counter(
                        "flight_dropped_total",
                        help="flight-recorder events overwritten by the "
                             "bounded ring before read-out",
                    )
                except Exception:
                    counter = False  # registry unavailable: stop trying
                self._dropped_counter = counter
            if counter:
                counter.inc()
        return event

    # -- durable tee -------------------------------------------------------

    def attach_store(self, store) -> None:
        """Tee every subsequent ``note()`` into ``store`` (a
        ``TelemetryStore``). Idempotent; multiple co-hosted processes
        may each attach their own store to the shared recorder —
        ``obs/incident.py`` dedupes the copies after the fact."""
        with self._lock:
            if store not in self._stores:
                self._stores = self._stores + (store,)

    def detach_store(self, store) -> None:
        """Stop teeing into ``store`` (unmount/kill path). Idempotent."""
        with self._lock:
            self._stores = tuple(s for s in self._stores if s is not store)

    # -- read-out ----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def events(self, kind: Optional[str] = None,
               min_severity: str = "info") -> List[FlightEvent]:
        """Ring snapshot (oldest first), optionally filtered."""
        floor = SEVERITIES.index(min_severity)
        with self._lock:
            out = list(self._events)
        return [e for e in out
                if (kind is None or e.kind == kind)
                and SEVERITIES.index(e.severity) >= floor]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump — the ``/flight`` ops route and ``dump()``
        both serve exactly this."""
        events = self.events()
        counts: Dict[str, int] = {}
        for e in events:
            counts[e.kind] = counts.get(e.kind, 0) + 1
        return {
            "events": [e.to_dict() for e in events],
            "counts_by_kind": counts,
            "dropped": self.dropped,
            "capacity": self.capacity,
        }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def dump(self, path: str) -> str:
        """Write the ring to ``path`` as JSON (crash-path artifact).
        Returns the path."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
        return path


#: Shared disabled instance — hold it unconditionally in instrumented code.
NULL_FLIGHT_RECORDER = FlightRecorder(capacity=0, enabled=False)
