"""Elastic execution: a work-stealing unit ledger + self-healing pool
(counterpart of ``elephas_tpu/resilience/elastic.py``; the ledger leases
and requeues in the JAX package's order, so one script gives both
packages the same sequence).

In the port the pool runs the elastic tuner's trials
(``tune/runner.py``) and ``AsyncTrainer(elastic=True)``'s units.

The reference's elasticity WAS Spark: a lost executor's partitions were
re-run by the scheduler, job-wide counters stayed exact, and a new
executor could join mid-stage (SURVEY.md §5.3). This module rebuilds
exactly that contract for the thread-per-chip async trainer:

- ``UnitLedger`` is the scheduler's task table: every frequency unit is
  ``(epoch, partition)`` — or, with ``batches_per_unit`` set,
  ``(epoch, partition, (lo, hi))`` batch ranges so a death mid-epoch
  re-leases only the unfinished ranges — leased epoch-major to
  whichever worker asks next. A dead worker's leases go back to the
  FRONT of the queue
  (earliest epochs first), and **each unit counts exactly once** — a
  zombie (a stalled worker that wakes after its lease was revoked and
  finished by a survivor) can deliver a duplicate completion and the
  ledger ignores it, so total frequency-unit accounting stays exact
  under any interleaving of deaths, stalls, and rejoins.
- ``ElasticWorkerPool`` owns the worker threads: it heartbeats each
  worker through its PS client at every unit boundary, polls the PS
  membership table (``resilience.liveness``) so a STALLED worker (one
  that cannot raise) is detector-expired and its units re-queued to
  survivors, fences revived zombies (a worker that sees itself declared
  dead exits instead of double-completing), admits late joiners
  mid-fit (``join_worker`` — they pull a fresh snapshot via their
  client like any other unit), and survives a parameter-server restart:
  ``ParameterServerUnavailable`` — fail-fast and fatal at the WIRE
  layer, which is the contract PR 4 pinned — is caught HERE, the unit
  is re-queued, and the worker polls ``client.health()`` under a
  bounded ``ps_recovery_grace`` budget for the warm-restarted server
  before resuming with a fresh client. Policy lives in the resilience
  layer; the wire client stays fail-fast.

Observability: ``resilience/mttr_seconds`` (gauge — seconds from a
failure to the first re-queued unit completing, the per-event MTTR),
``resilience/requeue`` + ``resilience/ps_reconnect`` spans, and a
``stats`` dict (deaths, re-queues, outages, MTTR samples) returned by
``wait()`` and surfaced in the trainer history.

Clock discipline: all time flows through injected ``clock``/``sleep``
(enforced by ``scripts/lint_blocking.py``) so chaos tests replay on a
fake clock without real waits where possible.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from elephas_tpu_torch import obs
from elephas_tpu_torch.parameter.client import ParameterServerUnavailable
from elephas_tpu_torch.resilience.faults import FaultInjector, InjectedWorkerDeath
from elephas_tpu_torch.resilience.liveness import MembershipView

#: A ledger unit is ``(epoch, partition)`` (whole-partition granularity)
#: or ``(epoch, partition, (lo, hi))`` (a half-open batch range) — the
#: first two slots are stable either way, so span tags and the pool's
#: per-(epoch, partition) metric table index units identically.
Unit = Tuple


class UnitLedger:
    """Exactly-once accounting over the fit's frequency units.

    Thread-safe. Leases hand out pending units epoch-major (all of
    epoch e before any of e+1 — re-queued units from a death go back to
    the front in epoch order, so survivors repair the earliest hole
    first). ``complete`` is idempotent per unit: the first completion
    counts, anything later (zombie double-completion) is ignored.

    Granularity: by default one unit per ``(epoch, partition)``. With
    ``n_batches`` (per-partition batch counts) the ledger re-keys on
    ``(epoch, partition, (lo, hi))`` batch ranges of ``batches_per_unit``
    batches each (last range may be short) — so a death mid-epoch
    re-leases only the UNFINISHED ranges to survivors instead of
    re-running whole partitions. Epoch completion is counted against the
    true per-epoch unit count (``units_per_epoch``), never against
    ``len(partitions)`` — range completions arrive out of order across
    partitions and an epoch is done only when every range of every
    partition has counted exactly once.
    """

    def __init__(self, epochs: int, partitions: List[int],
                 n_batches=None, batches_per_unit: Optional[int] = None):
        if epochs < 1 or not partitions:
            raise ValueError(
                f"need >=1 epoch and >=1 partition, got {epochs}/{partitions}"
            )
        self.epochs = epochs
        self.partitions = list(partitions)
        if n_batches is None:
            if batches_per_unit is not None:
                raise ValueError(
                    "batches_per_unit needs n_batches (per-partition "
                    "batch counts) to cut ranges from"
                )
            self.ranges: Optional[Dict[int, List[Tuple[int, int]]]] = None
            units = [(e, p) for e in range(epochs) for p in self.partitions]
            self.units_per_epoch = len(self.partitions)
        else:
            if isinstance(n_batches, int):
                n_batches = {p: n_batches for p in self.partitions}
            ranges: Dict[int, List[Tuple[int, int]]] = {}
            for p in self.partitions:
                nb = int(n_batches[p])
                if nb < 1:
                    raise ValueError(
                        f"partition {p}: need >=1 batch, got {nb}"
                    )
                step = nb if batches_per_unit is None \
                    else max(1, int(batches_per_unit))
                ranges[p] = [
                    (lo, min(lo + step, nb)) for lo in range(0, nb, step)
                ]
            self.ranges = ranges
            self.units_per_epoch = sum(len(r) for r in ranges.values())
            units = [
                (e, p, r)
                for e in range(epochs)
                for p in self.partitions
                for r in ranges[p]
            ]
        self.batches_per_unit = batches_per_unit
        self._pending: deque = deque(units)
        self._leased: Dict[Unit, str] = {}
        self._done: Dict[Unit, str] = {}
        self._epoch_done: List[int] = [0] * epochs
        self._requeued_total = 0
        self._lock = threading.Lock()

    @property
    def total_units(self) -> int:
        return self.epochs * self.units_per_epoch

    @property
    def completed_units(self) -> int:
        with self._lock:
            return len(self._done)

    @property
    def requeued_units(self) -> int:
        with self._lock:
            return self._requeued_total

    def lease(self, worker_id: str) -> Optional[Unit]:
        """Next pending unit, or None (nothing pending right now — the
        caller should re-check ``all_done`` and idle-wait: other
        workers' leases may yet be re-queued)."""
        with self._lock:
            if not self._pending:
                return None
            unit = self._pending.popleft()
            self._leased[unit] = str(worker_id)
            return unit

    def complete(self, worker_id: str, unit: Unit) -> Tuple[bool, Optional[int]]:
        """Record a completion. Returns ``(counted, finished_epoch)``:
        ``counted`` is False for duplicates (revoked lease completed by
        a zombie after a survivor already delivered it); and when this
        completion finishes its whole epoch, ``finished_epoch`` is that
        epoch number (fire validation/callbacks once per epoch)."""
        with self._lock:
            if unit in self._done:
                return False, None
            self._done[unit] = str(worker_id)
            self._leased.pop(unit, None)
            # A zombie can complete a unit that was re-queued and is
            # sitting in pending again — drop the duplicate copy so no
            # survivor re-runs already-counted work.
            try:
                self._pending.remove(unit)
            except ValueError:
                pass
            epoch = unit[0]
            self._epoch_done[epoch] += 1
            # Compare against the TRUE per-epoch unit count: under
            # batch-range keying there are more units per epoch than
            # partitions, and completions land out of order — counting
            # against len(partitions) would fire the epoch early.
            finished = epoch if self._epoch_done[epoch] == self.units_per_epoch \
                else None
            return True, finished

    def add_units(self, units: List[Unit]) -> int:
        """Grow the ledger mid-drain (the tuner's rung promotions: a
        promoted trial's next rung becomes schedulable work the moment
        the promoting result lands). Appended to the BACK of the queue
        — promotions are new work, not repair — and deduped against
        pending/leased/done so an idempotent caller (a zombie replaying
        a promotion decision) cannot double-schedule a unit. Epochs
        beyond the constructed range extend the per-epoch table; such
        late epochs never fire ``finished_epoch`` (their population is
        dynamic, there is no "all partitions" to count against — the
        scheduler owns completion semantics for dynamic work). Returns
        how many units were actually added.

        Safe-growth contract: callers must add units from INSIDE the
        processing of a still-leased unit (or before ``start``), so
        ``all_done`` can never report True while a grow is in flight.
        """
        added = 0
        with self._lock:
            pending = set(self._pending)
            for unit in units:
                unit = tuple(unit)
                if unit in self._done or unit in self._leased \
                        or unit in pending:
                    continue
                epoch = int(unit[0])
                while epoch >= len(self._epoch_done):
                    self._epoch_done.append(0)
                    # keep units_per_epoch as the rung-0 population;
                    # dynamic epochs opt out of epoch-complete firing
                    # by construction (population unknown).
                self.epochs = max(self.epochs, epoch + 1)
                self._pending.append(unit)
                pending.add(unit)
                added += 1
        return added

    def requeue_worker(self, worker_id: str) -> List[Unit]:
        """Return all of ``worker_id``'s leases to the FRONT of the
        queue (epoch-major order preserved); idempotent."""
        worker_id = str(worker_id)
        with self._lock:
            units = sorted(
                u for u, w in self._leased.items() if w == worker_id
            )
            for unit in reversed(units):
                self._leased.pop(unit, None)
                self._pending.appendleft(unit)
            self._requeued_total += len(units)
            return units

    def all_done(self) -> bool:
        with self._lock:
            return not self._pending and not self._leased

    def outstanding(self) -> Dict[str, int]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "leased": len(self._leased),
                "done": len(self._done),
            }

    def epoch_complete(self, epoch: int) -> bool:
        with self._lock:
            return self._epoch_done[epoch] == self.units_per_epoch


class _WorkerCtx:
    __slots__ = ("worker_id", "unit_seq", "thread")

    def __init__(self, worker_id: str):
        self.worker_id = worker_id
        self.unit_seq = 0  # leased-unit counter: the fault plan's step index
        self.thread: Optional[threading.Thread] = None


class ElasticWorkerPool:
    """Self-healing thread pool draining a ``UnitLedger``.

    ``run_unit(worker_id, client, unit) -> metrics`` is the trainer's
    workload (pull → train one frequency unit → push); the pool owns
    scheduling, heartbeats, death handling, PS-restart recovery, and
    late joins. ``client_factory(worker_id)`` must return a parameter
    client exposing ``heartbeat``/``membership``/``health`` (all three
    transports do).
    """

    def __init__(
        self,
        ledger: UnitLedger,
        run_unit: Callable,
        client_factory: Callable,
        worker_ids: List[str],
        on_epoch_complete: Optional[Callable] = None,
        injector: Optional[FaultInjector] = None,
        ps_recovery_grace: float = 15.0,
        monitor_poll: float = 0.1,
        idle_wait: float = 0.02,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.ledger = ledger
        self.run_unit = run_unit
        self.client_factory = client_factory
        self.on_epoch_complete = on_epoch_complete
        self.injector = injector
        self.ps_recovery_grace = float(ps_recovery_grace)
        self.monitor_poll = float(monitor_poll)
        self.idle_wait = float(idle_wait)
        self._clock = clock
        self._sleep = sleep
        self.membership = MembershipView()
        self.stats: Dict = {
            "worker_deaths": [],
            "ps_outages": [],
            "mttr_samples": [],
            "late_joins": [],
            "fenced": [],
        }
        self._mttr_gauge = obs.default_registry().gauge(
            "resilience/mttr_seconds",
            help="seconds from a failure to the first re-queued unit completing",
        )
        self._tracer = obs.default_tracer()
        self._lock = threading.Lock()
        self._ctxs: Dict[str, _WorkerCtx] = {}
        self._fatal: Optional[BaseException] = None
        self._stop = False
        self._fire_lock = threading.Lock()
        # Units awaiting repair: unit -> failure timestamp. The first
        # counted completion of such a unit closes the MTTR window.
        self._repairing: Dict[Unit, float] = {}
        self._epoch_metrics: Dict[int, Dict[int, Dict]] = {}
        # How many units have folded into each (epoch, partition) metric
        # slot — batch-range units running-mean into one row so the
        # epoch_metrics() shape is granularity-independent.
        self._metric_counts: Dict[Tuple[int, int], int] = {}
        self._monitor_thread: Optional[threading.Thread] = None
        for worker_id in worker_ids:
            self._ctxs[str(worker_id)] = _WorkerCtx(str(worker_id))

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        for ctx in self._ctxs.values():
            self._start_worker(ctx)
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="elastic-monitor"
        )
        self._monitor_thread.start()

    def _start_worker(self, ctx: _WorkerCtx) -> None:
        ctx.thread = threading.Thread(
            target=self._worker_loop, args=(ctx,), daemon=True,
            name=f"elastic-worker-{ctx.worker_id}",
        )
        ctx.thread.start()

    def join_worker(self, worker_id: str) -> None:
        """Admit a late joiner mid-fit: it leases from the ledger like
        any survivor, and its first ``run_unit`` pulls a fresh snapshot
        through its own client (version-gated pull: a new client holds
        no cached version, so it always receives a full body)."""
        worker_id = str(worker_id)
        with self._lock:
            if worker_id in self._ctxs and self._ctxs[worker_id].thread is not None \
                    and self._ctxs[worker_id].thread.is_alive():
                raise ValueError(f"worker {worker_id} is already in the pool")
            ctx = _WorkerCtx(worker_id)
            self._ctxs[worker_id] = ctx
            self.stats["late_joins"].append(worker_id)
        self._start_worker(ctx)

    def wait(self) -> Dict:
        """Block until the ledger drains (or the pool dies); returns
        ``stats``. Raises the recorded fatal (PS unrecoverable, or every
        worker dead with work still pending)."""
        while True:
            with self._lock:
                threads = [c.thread for c in self._ctxs.values() if c.thread]
            alive = [t for t in threads if t.is_alive()]
            if not alive:
                break
            for t in alive:
                t.join(timeout=0.2)
        self._stop = True
        if self._monitor_thread is not None:
            self._monitor_thread.join()
        if self._fatal is not None:
            raise self._fatal
        if not self.ledger.all_done():
            raise RuntimeError(
                "elastic pool exhausted its workers with units still "
                f"outstanding: {self.ledger.outstanding()} "
                f"(deaths: {self.stats['worker_deaths']})"
            )
        self.stats["requeued_units"] = self.ledger.requeued_units
        self.stats["completed_units"] = self.ledger.completed_units
        return self.stats

    def epoch_metrics(self) -> Dict[int, Dict[int, Dict]]:
        with self._lock:
            return {e: dict(parts) for e, parts in self._epoch_metrics.items()}

    # -- internals -------------------------------------------------------

    def _beat(self, client, worker_id: str) -> None:
        try:
            client.heartbeat(worker_id)
        except ParameterServerUnavailable:
            raise
        except Exception:
            pass  # heartbeat is advisory; the detector tolerates gaps

    def _record_death(self, worker_id: str, reason: str, units: List[Unit]) -> None:
        now = self._clock()
        with self._lock:
            for unit in units:
                self._repairing.setdefault(unit, now)
            self.stats["worker_deaths"].append(
                {"worker": worker_id, "reason": reason,
                 "requeued_units": list(units)}
            )
        with self._tracer.span("resilience/requeue", worker=worker_id,
                               units=len(units), reason=reason):
            pass

    def _note_repaired(self, unit: Unit) -> None:
        with self._lock:
            failed_at = self._repairing.pop(unit, None)
        if failed_at is not None:
            mttr = self._clock() - failed_at
            self._mttr_gauge.set(mttr)
            with self._lock:
                self.stats["mttr_samples"].append(mttr)

    def _record_ps_outage(self, worker_id: str, detected: float,
                          recovered: Optional[float]) -> None:
        with self._lock:
            self.stats["ps_outages"].append({
                "worker": worker_id,
                "outage_s": None if recovered is None else recovered - detected,
                "recovered": recovered is not None,
            })
        if recovered is not None:
            self._mttr_gauge.set(recovered - detected)
            with self._lock:
                self.stats["mttr_samples"].append(recovered - detected)

    def _await_ps(self, worker_id: str, old_client):
        """Poll for a warm-restarted PS under the grace budget; returns
        a FRESH client (the old one may hold poisoned state) or None."""
        detected = self._clock()
        if hasattr(old_client, "close"):
            try:
                old_client.close()
            except Exception:
                pass
        with self._tracer.span("resilience/ps_reconnect", worker=worker_id):
            deadline = detected + self.ps_recovery_grace
            while not self._stop and self._clock() < deadline:
                try:
                    client = self.client_factory(worker_id)
                    if client.health():
                        self._record_ps_outage(worker_id, detected, self._clock())
                        return client
                    if hasattr(client, "close"):
                        client.close()
                except Exception:
                    pass
                self._sleep(min(0.1, self.ps_recovery_grace / 10.0))
        self._record_ps_outage(worker_id, detected, None)
        return None

    def _worker_loop(self, ctx: _WorkerCtx) -> None:
        worker_id = ctx.worker_id
        client = None
        try:
            client = self.client_factory(worker_id)
            try:
                self._beat(client, worker_id)
            except ParameterServerUnavailable:
                # Unreachable before the first lease (a partition that
                # opens at start-up): nothing to re-queue, so ride it out
                # as an outage under the same grace as one mid-fit.
                client = self._await_ps(worker_id, client)
                if client is None:
                    self._fatal = ParameterServerUnavailable(
                        "parameter server did not come back within "
                        f"{self.ps_recovery_grace}s grace"
                    )
                    return
            while not self._stop and self._fatal is None:
                if self.membership.is_dead(worker_id):
                    # Fencing: the detector expired us (we stalled past
                    # dead_after) and our leases were re-queued — keep
                    # OUT of the ledger rather than double-complete.
                    self.ledger.requeue_worker(worker_id)
                    with self._lock:
                        self.stats["fenced"].append(worker_id)
                    return
                unit = self.ledger.lease(worker_id)
                if unit is None:
                    if self.ledger.all_done():
                        return
                    self._sleep(self.idle_wait)
                    continue
                seq = ctx.unit_seq
                ctx.unit_seq += 1
                try:
                    if self.injector is not None:
                        self.injector.maybe_fail_worker(worker_id, seq)
                    self._beat(client, worker_id)
                    metrics = self.run_unit(worker_id, client, unit)
                except InjectedWorkerDeath:
                    units = self.ledger.requeue_worker(worker_id)
                    self._record_death(worker_id, "injected kill", units)
                    return
                except ParameterServerUnavailable:
                    units = self.ledger.requeue_worker(worker_id)
                    self._record_death(worker_id, "ps unavailable", units)
                    client = self._await_ps(worker_id, client)
                    if client is None:
                        self._fatal = ParameterServerUnavailable(
                            "parameter server did not come back within "
                            f"{self.ps_recovery_grace}s grace"
                        )
                        return
                    continue  # resume with the fresh client
                except BaseException as exc:
                    units = self.ledger.requeue_worker(worker_id)
                    self._record_death(worker_id, repr(exc), units)
                    return
                counted, finished_epoch = self.ledger.complete(worker_id, unit)
                if counted:
                    with self._lock:
                        slot = self._epoch_metrics.setdefault(unit[0], {})
                        prev = slot.get(unit[1])
                        n = self._metric_counts.get((unit[0], unit[1]), 0)
                        if prev is None or not isinstance(metrics, dict):
                            slot[unit[1]] = metrics
                        else:
                            # Batch-range units: running mean per
                            # (epoch, partition) so the table keeps its
                            # whole-partition shape (equal weight per
                            # range; a short tail range is slightly
                            # overweighted — metrics noise, not ledger
                            # accounting).
                            slot[unit[1]] = {
                                k: (prev[k] * n + metrics[k]) / (n + 1)
                                for k in prev if k in metrics
                            }
                        self._metric_counts[(unit[0], unit[1])] = n + 1
                    self._note_repaired(unit)
                if finished_epoch is not None and self.on_epoch_complete is not None:
                    # Serialized: epoch fires run user callbacks and
                    # evaluators that are not thread-safe.
                    with self._fire_lock:
                        try:
                            self.on_epoch_complete(finished_epoch)
                        except BaseException as exc:
                            self._fatal = exc
                            return
        finally:
            if client is not None:
                try:
                    client.deregister(worker_id)
                except Exception:
                    pass
                if hasattr(client, "close"):
                    try:
                        client.close()
                    except Exception:
                        pass

    def _monitor_loop(self) -> None:
        """Publish PS membership + re-queue detector-expired workers.

        This is what rescues STALLED workers — a thread wedged in a
        device call can't raise, but it also can't heartbeat, so the
        detector expires it and its leases return to the queue. The
        monitor tolerates PS outages (workers own that recovery path).
        """
        client = None
        try:
            while not self._stop:
                if not any(
                    c.thread is not None and c.thread.is_alive()
                    for c in list(self._ctxs.values())
                ):
                    return
                try:
                    if client is None:
                        client = self.client_factory("monitor")
                    table = client.membership()
                except Exception:
                    if client is not None and hasattr(client, "close"):
                        try:
                            client.close()
                        except Exception:
                            pass
                    client = None
                    table = None
                if table is not None:
                    self.membership.publish(table)
                    for worker_id, entry in table.items():
                        if entry.get("state") != "dead":
                            continue
                        units = self.ledger.requeue_worker(worker_id)
                        if units:
                            self._record_death(
                                worker_id, "detector expiry", units
                            )
                self._sleep(self.monitor_poll)
        finally:
            if client is not None and hasattr(client, "close"):
                try:
                    client.close()
                except Exception:
                    pass
