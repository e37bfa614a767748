"""One serving replica: an ``InferenceEngine`` dressed as a process
(counterpart of ``elephas_tpu/serving/fleet/replica.py``).

The fleet's unit of actuation is not the engine but the *slot* it runs
in: something that can be spawned, drained, killed mid-traffic, and
restarted as a new boot of the same name — exactly the lifecycle the
``FleetAggregator`` already narrates for training processes
(alive → stale → dead → alive, boot counter bumped). ``Replica`` wraps
an engine with that lifecycle plus the three per-replica signal feeds
the router dispatches on:

- ``load_score()`` / ``queue_frac()`` — the saturation plane, read
  straight off ``engine.load`` / ``engine.queue`` (N replicas share one
  process-global metrics registry, so the published
  ``serving_load_score`` gauge would be whichever replica wrote last —
  the router must read the trackers, not the gauges),
- ``worst_burn()`` — worst-objective multi-window goodput burn from the
  replica's own ledger,
- ``shedding`` — a latched per-replica burn alert: an ``AlertEngine``
  evaluated against ``_BurnMetricsView`` (this replica's burn family
  only) with the stock ``goodput_burn_*`` rules, so shed/unshed
  inherits the alert plane's latch-until-clean semantics instead of
  re-inventing flap suppression in the router.

Death comes in two flavors and the distinction is load-bearing for the
router's recovery path: a *drain* (``drain()`` → ``maybe_finish_drain()``)
finishes and hands out every routed request before the serve thread
stops (``drained=True``), while a *kill* halts the engine mid-step —
frozen requests surface to waiting callers as ``ReplicaDead``, the
router's cue to resubmit them elsewhere.

On the card a dead boot gives its memory back, as a dead process's
returns to the device: once its serve thread has stopped, the engine is
halted and ``InferenceEngine.release`` frees its graphs, pool and
weights (published results stay claimable on the host), so spawn, kill
and restart cycles do not grow the card's allocation.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from elephas_tpu_torch import obs
from elephas_tpu_torch.obs.alerts import AlertEngine, default_rules
from elephas_tpu_torch.obs.canary import CanaryDriver
from elephas_tpu_torch.utils import locksan

__all__ = ["DEAD", "DRAINING", "LIFECYCLES", "Replica", "ReplicaDead",
           "SERVING", "TIERS"]

SERVING = "serving"
DRAINING = "draining"
DEAD = "dead"

#: Serving tiers. ``mono`` replicas run the classic prefill+decode
#: loop; a disaggregated fleet splits them — ``prefill`` replicas stop
#: at the prompt and export KV handoffs, ``decode`` replicas import
#: those handoffs and run the token loop. Every tier is the SAME
#: engine; the tier only changes which requests the router sends it.
TIERS = ("mono", "prefill", "decode")

#: Replica lifecycle states, in the order a drain walks them.
LIFECYCLES = (SERVING, DRAINING, DEAD)

#: How often a blocked ``result()`` re-checks the replica's pulse — a
#: kill mid-wait surfaces as ``ReplicaDead`` within one slice instead
#: of blocking out the caller's full timeout.
RESULT_SLICE_S = 0.05

#: Default blackbox probe timeout for the per-replica canary. Shorter
#: than the canary module's 30s default: a fleet tick probes replicas
#: inline, and a wedged replica should cost one bounded slice of the
#: tick, not half a minute.
CANARY_TIMEOUT_S = 5.0


class ReplicaDead(RuntimeError):
    """The replica died un-drained while a routed request was still
    unfinished — the router's requeue trigger."""

    def __init__(self, replica_id: str, req_id: Optional[int] = None):
        super().__init__(f"replica {replica_id} is dead (req={req_id})")
        self.replica_id = replica_id
        self.req_id = req_id


class _BurnMetricsView:
    """Per-replica registry view for the burn ``AlertEngine``.

    ``snapshot()`` exposes only THIS replica's ledger-derived
    ``serving_goodput_burn{objective=,replica=}`` family (the
    process-global gauge mixes N replicas into one sample), while
    ``counter()`` delegates to the real default registry so
    ``alerts_fired_total`` still aggregates fleet-wide.
    """

    def __init__(self, replica: "Replica"):
        self._replica = replica

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        engine = self._replica.engine
        if engine is None:
            return out
        for name, burn in engine.slo.burn().items():
            if burn is not None:
                key = (f'serving_goodput_burn{{objective="{name}",'
                       f'replica="{self._replica.replica_id}"}}')
                out[key] = burn
        return out

    def counter(self, *args, **kwargs):
        return obs.default_registry().counter(*args, **kwargs)


class Replica:
    """One engine slot in the fleet, with a process-like lifecycle.

    ``engine_factory`` builds a fresh ``InferenceEngine`` per boot —
    a restart must come back with empty queues and a clean ledger, the
    way a real process restart does, so the replica cannot reuse a
    halted engine object.
    """

    def __init__(self, replica_id: str, engine_factory: Callable[[], Any],
                 *, clock: Callable[[], float] = time.monotonic,
                 mount_ops: bool = False,
                 store_dir: Optional[str] = None,
                 canary_timeout_s: float = CANARY_TIMEOUT_S,
                 tier: str = "mono"):
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
        self.replica_id = replica_id
        #: Which traffic the router sends here (see ``TIERS``). Fixed
        #: for the slot's lifetime — a re-tiering is a new slot.
        self.tier = tier
        self.engine_factory = engine_factory
        self.clock = clock
        self.mount_ops = mount_ops
        # Durable telemetry directory for every boot of this slot: each
        # respawn reopens it under a fresh store boot id, which is
        # exactly the cross-boot story the incident builder stitches.
        self.store_dir = store_dir
        self.canary_timeout_s = canary_timeout_s

        self.engine = None
        self.canary: Optional[CanaryDriver] = None
        self.state = DEAD
        self.boot = 0
        #: True only when the last shutdown was a completed drain —
        #: every routed result was claimed; nothing needs requeueing.
        self.drained = False
        #: Router bookkeeping: canary-flagged drains restart when the
        #: drain completes; autoscaler drains stay down.
        self.pending_restart = False
        #: Set by the ``RolloutController`` while this slot is the
        #: weight-rollout canary (bake in progress); ``/replicas``
        #: carries it. Distinct from ``CanaryDriver`` (request
        #: probing) above.
        self.rollout_canary = False
        self.scale_down = False
        #: Canary failure count already acted on (drain-and-restart
        #: fires on *fresh* failures, not the lifetime total).
        self.seen_canary_failures = 0
        #: Latched burn-alert state, refreshed by ``evaluate_alerts()``
        #: (a plain attribute so the router's dispatch loop reads a
        #: stable value between ticks).
        self.shedding = False

        self.in_flight = 0
        self._lock = locksan.make_lock("Replica._lock")
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._alerts: Optional[AlertEngine] = None

    # -- lifecycle ---------------------------------------------------------

    def spawn(self) -> "Replica":
        """Boot: fresh engine, serve thread, canary, burn alerts, and
        (optionally) an ops endpoint on an ephemeral port."""
        if self.state != DEAD:
            raise RuntimeError(
                f"replica {self.replica_id} is {self.state}; "
                f"only a dead replica can spawn"
            )
        self.engine = self.engine_factory()
        self.boot += 1
        self.drained = False
        self.pending_restart = False
        self.scale_down = False
        self.seen_canary_failures = 0
        self.shedding = False
        with self._lock:
            self.in_flight = 0
        self.canary = CanaryDriver(self.engine,
                                   timeout_s=self.canary_timeout_s)
        self._alerts = AlertEngine(
            registry=_BurnMetricsView(self),
            rules=[r for r in default_rules()
                   if r.name.startswith("goodput_burn")],
            clock=self.clock,
        )
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self.engine.serve_forever, args=(self._stop,),
            name=f"replica:{self.replica_id}", daemon=True)
        self._thread.start()
        if self.mount_ops:
            self.engine.mount_ops(port=0, store_dir=self.store_dir)
        self.state = SERVING
        return self

    def drain(self, *, reason: str = "operator") -> None:
        """Stop taking new work; finish what's routed here. The serve
        thread keeps stepping until ``maybe_finish_drain()`` observes
        an idle engine with every routed result claimed."""
        if self.state != SERVING:
            return
        self.state = DRAINING
        obs.default_flight_recorder().note(
            "replica_drain", "info", replica=self.replica_id,
            boot=self.boot, reason=reason)

    def maybe_finish_drain(self) -> bool:
        """Complete a drain once the engine is idle and all routed
        results were claimed. Returns True when the drain closed."""
        if self.state != DRAINING:
            return False
        with self._lock:
            busy = self.in_flight
        if busy or self.engine.scheduler.has_work:
            return False
        self._stop_serving()
        self.engine.halt()
        self.engine.release()
        self.drained = True
        self.state = DEAD
        return True

    def kill(self) -> None:
        """Hard death mid-traffic: the engine halts wherever it was,
        the serve thread exits, the ops endpoint goes dark — the fleet
        aggregator must watch this replica *die*, not vanish. Frozen
        requests surface to waiting callers as ``ReplicaDead``."""
        if self.state == DEAD:
            return
        self.engine.halt()
        self._stop_serving(reason="kill")
        self.engine.release()
        self.drained = False
        self.state = DEAD

    def restart(self, *, reason: str = "operator") -> "Replica":
        """Boot a dead replica again: same name, next boot number, a
        completely fresh engine."""
        if self.state != DEAD:
            raise RuntimeError(
                f"replica {self.replica_id} is {self.state}; "
                f"only a dead replica can restart"
            )
        self.spawn()
        obs.default_flight_recorder().note(
            "replica_restart", "info", replica=self.replica_id,
            boot=self.boot, reason=reason)
        return self

    def _stop_serving(self, reason: str = "close") -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self.engine is not None and self.engine.ops is not None:
            self.engine.unmount_ops(reason=reason)

    # -- router bookkeeping ------------------------------------------------

    def note_dispatch(self) -> None:
        with self._lock:
            self.in_flight += 1

    def note_done(self) -> None:
        with self._lock:
            self.in_flight -= 1

    def result(self, req_id: int, timeout_s: Optional[float] = None):
        """Claim a routed result, staying alert to death.

        The engine wait is sliced (``RESULT_SLICE_S``) so a kill
        mid-wait surfaces promptly. A killed replica gets one last
        zero-timeout claim — results the engine published before dying
        are still readable, like a dead process's output pipe — before
        the loss is declared as ``ReplicaDead``.
        """
        deadline = None if timeout_s is None else self.clock() + timeout_s
        while True:
            if self.state == DEAD and not self.drained:
                try:
                    return self.engine.result(req_id, timeout_s=0.0)
                except TimeoutError:
                    raise ReplicaDead(self.replica_id, req_id) from None
            try:
                return self.engine.result(req_id, timeout_s=RESULT_SLICE_S)
            except TimeoutError:
                if deadline is not None and self.clock() >= deadline:
                    raise

    def handoff(self, req_id: int, timeout_s: Optional[float] = None):
        """Claim a prefill-tier KV handoff, staying alert to death —
        the same sliced-wait / last-claim / ``ReplicaDead`` contract as
        ``result()``. Returns the handoff dict, or a
        ``GenerationResult`` when the request terminated locally
        (deadline eviction mid-prefill)."""
        deadline = None if timeout_s is None else self.clock() + timeout_s
        while True:
            if self.state == DEAD and not self.drained:
                try:
                    return self.engine.handoff(req_id, timeout_s=0.0)
                except TimeoutError:
                    raise ReplicaDead(self.replica_id, req_id) from None
            try:
                return self.engine.handoff(req_id,
                                           timeout_s=RESULT_SLICE_S)
            except TimeoutError:
                if deadline is not None and self.clock() >= deadline:
                    raise

    # -- signals -----------------------------------------------------------

    def load_score(self) -> float:
        """Composite saturation score from the replica's own tracker
        (never the process-global gauge — see module docstring)."""
        score = self.engine.load.snapshot()["score"]
        return 0.0 if score is None else score

    def queue_frac(self) -> float:
        """Admission-queue fullness in [0, 1]."""
        return len(self.engine.queue) / self.engine.queue.max_depth

    def kv_pressure(self) -> float:
        """Fraction of the paged KV pool in use, in [0, 1] (0.0 when
        the engine has no paged pool). The decode-tier dispatch signal:
        a decode replica out of free blocks cannot import a handoff
        without evicting prefix state first."""
        sig = self.engine.load.snapshot().get("signals") or {}
        free = sig.get("kv_free_frac")
        return 0.0 if free is None else max(0.0, 1.0 - free)

    def worst_burn(self) -> float:
        """Worst-objective multi-window burn (0.0 before any traffic)
        — the autoscaler's per-replica input."""
        if self.engine is None:
            return 0.0
        burns = [b for b in self.engine.slo.burn().values()
                 if b is not None]
        return max(burns) if burns else 0.0

    def evaluate_alerts(self, now: Optional[float] = None) -> None:
        """Re-evaluate the latched per-replica burn alerts and refresh
        ``shedding`` (called from the router's ``tick()``)."""
        if self._alerts is None or self.state != SERVING:
            return
        self._alerts.evaluate(now)
        self.shedding = bool(self._alerts.snapshot()["active"])

    def signals(self) -> Dict[str, Any]:
        """JSON-ready signal card for the router's ``/replicas`` doc
        and an operator's replica board."""
        doc: Dict[str, Any] = {
            "state": self.state,
            "tier": self.tier,
            "boot": self.boot,
            "drained": self.drained,
            "in_flight": self.in_flight,
            "load_score": None,
            "queue_depth": None,
            "queue_frac": None,
            "burn_worst": None,
            "kv_pressure": None,
            "shedding": False,
            "canary_probes": 0,
            "canary_failures": 0,
            "ops_port": None,
            "model_version": None,
            "rollout_canary": self.rollout_canary,
        }
        if self.engine is None:
            return doc
        doc["model_version"] = self.engine.model_version
        if self.state != DEAD:
            doc["load_score"] = self.load_score()
            doc["queue_depth"] = len(self.engine.queue)
            doc["queue_frac"] = self.queue_frac()
            doc["burn_worst"] = self.worst_burn()
            doc["shedding"] = self.shedding
            doc["kv_pressure"] = self.kv_pressure()
        if self.canary is not None:
            doc["canary_probes"] = self.canary.probes
            doc["canary_failures"] = self.canary.failures
        if self.engine.ops is not None:
            doc["ops_port"] = self.engine.ops.port
        return doc
