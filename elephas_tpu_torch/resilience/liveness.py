"""Worker liveness: heartbeats in, a timeout+suspect failure detector out
(counterpart of ``elephas_tpu/resilience/liveness.py``; every parameter
server builds a detector, so the port carries it with the servers).

The reference delegated liveness wholesale to Spark (a lost executor is
the scheduler's problem — SURVEY.md §5.3). The wire transports made
worker/PS failures *observable* but nothing owned them: a worker that
stops pushing simply goes quiet. This module is the server-side half of
the resilience story: workers send heartbeat frames (``("h", id)`` on
the socket transport, ``POST /heartbeat/<id>`` on HTTP), the parameter
server feeds them into a ``FailureDetector``, and the trainer reads the
resulting membership table to drive re-queueing (``resilience.elastic``
publishes it into a ``MembershipView``).

Detector model: timeout + suspect (the simple two-threshold cousin of
phi-accrual). A worker is

- ``alive``   while its last beat is younger than ``suspect_after``,
- ``suspect`` between ``suspect_after`` and ``dead_after`` — still
  counted as a member, but schedulers should stop routing NEW work to
  it, and
- ``dead``    past ``dead_after`` — its pending units are fair game for
  re-queueing. The transition is edge-triggered: ``sweep()`` reports
  each expiry exactly once and bumps ``ps_worker_expired_total``.

A beat from a dead worker *revives* it (rejoin-after-stall): the zombie
fencing that prevents a revived worker from double-completing work lives
in the ledger (``UnitLedger.complete`` counts each unit once), not here.

Clock discipline: everything reads time through the injected ``clock``
so detector tests advance a fake clock instead of sleeping.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from elephas_tpu_torch import obs

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


class FailureDetector:
    """Timeout+suspect failure detector over worker heartbeats.

    ``suspect_after``/``dead_after`` are seconds since the last beat
    (``dead_after`` defaults to twice ``suspect_after``). Thread-safe:
    the PS handler threads beat concurrently with the trainer's monitor
    sweeping.
    """

    def __init__(
        self,
        suspect_after: float = 5.0,
        dead_after: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        register_metrics: bool = True,
    ):
        if suspect_after <= 0:
            raise ValueError(f"suspect_after must be > 0, got {suspect_after}")
        self.suspect_after = float(suspect_after)
        self.dead_after = (
            2.0 * self.suspect_after if dead_after is None else float(dead_after)
        )
        if self.dead_after < self.suspect_after:
            raise ValueError(
                f"dead_after ({self.dead_after}) must be >= suspect_after "
                f"({self.suspect_after})"
            )
        self._clock = clock
        self._lock = threading.Lock()
        self._last_beat: Dict[str, float] = {}
        self._beats: Dict[str, int] = {}
        self._dead: set = set()
        self._expired_total = (
            obs.default_registry().counter(
                "ps_worker_expired_total",
                help="workers declared dead by the PS failure detector",
            )
            if register_metrics
            else None
        )

    def beat(self, worker_id: str) -> None:
        """Record one heartbeat; a beat from a dead worker revives it."""
        worker_id = str(worker_id)
        with self._lock:
            revived = worker_id in self._dead
            dead_for = (
                self._clock() - self._last_beat[worker_id]
                if revived and worker_id in self._last_beat else None
            )
            self._last_beat[worker_id] = self._clock()
            self._beats[worker_id] = self._beats.get(worker_id, 0) + 1
            self._dead.discard(worker_id)
        if revived:
            # A dead→alive flap is either a stalled-then-unstuck worker
            # or a detector threshold set too tight — both worth a
            # flight-recorder entry (outside the lock: note() takes the
            # recorder's own lock).
            obs.default_flight_recorder().note(
                "heartbeat_flap", "warn", worker=worker_id,
                dead_for_s=round(dead_for, 3) if dead_for is not None else None,
            )

    def deregister(self, worker_id: str) -> None:
        """Clean exit: the worker leaves WITHOUT counting as an expiry."""
        worker_id = str(worker_id)
        with self._lock:
            self._last_beat.pop(worker_id, None)
            self._beats.pop(worker_id, None)
            self._dead.discard(worker_id)

    def _state_of(self, age: float) -> str:
        if age < self.suspect_after:
            return ALIVE
        if age < self.dead_after:
            return SUSPECT
        return DEAD

    def sweep(self) -> List[str]:
        """Edge-triggered expiry scan: returns the workers that crossed
        into ``dead`` SINCE the last sweep (each reported exactly once)
        and counts them in ``ps_worker_expired_total``."""
        now = self._clock()
        newly_dead = []
        with self._lock:
            for worker_id, last in self._last_beat.items():
                if worker_id in self._dead:
                    continue
                if now - last >= self.dead_after:
                    self._dead.add(worker_id)
                    newly_dead.append(worker_id)
        if newly_dead:
            if self._expired_total is not None:
                self._expired_total.inc(len(newly_dead))
            obs.default_flight_recorder().note(
                "worker_dead", "error", workers=list(newly_dead),
                dead_after_s=self.dead_after,
            )
        return newly_dead

    def membership(self) -> Dict[str, Dict]:
        """Current membership table ``{worker_id: {state, age_s, beats}}``.

        Runs a ``sweep()`` first so expiries are counted even when nobody
        polls ``sweep`` explicitly — reading the table IS the detector's
        evaluation point."""
        self.sweep()
        now = self._clock()
        with self._lock:
            return {
                worker_id: {
                    "state": DEAD if worker_id in self._dead
                    else self._state_of(now - last),
                    "age_s": now - last,
                    "beats": self._beats.get(worker_id, 0),
                }
                for worker_id, last in self._last_beat.items()
            }

    def state(self, worker_id: str) -> Optional[str]:
        """One worker's state, or None if it never beat."""
        return self.membership().get(str(worker_id), {}).get("state")


class MembershipView:
    """Trainer-side cache of the PS membership table.

    The elastic pool's monitor polls the PS (``client.membership()``)
    and publishes the table here; worker threads read it lock-cheap to
    check their own fencing state (a worker that was declared dead while
    stalled must not keep completing units)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, Dict] = {}

    def publish(self, table: Dict[str, Dict]) -> None:
        with self._lock:
            self._table = dict(table)

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return dict(self._table)

    def state(self, worker_id: str) -> Optional[str]:
        with self._lock:
            entry = self._table.get(str(worker_id))
        return entry.get("state") if entry else None

    def is_dead(self, worker_id: str) -> bool:
        return self.state(worker_id) == DEAD
