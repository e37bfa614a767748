"""Elastic tuner runner: trials as lease-fenced ledger units on the pool
(counterpart of ``elephas_tpu/tune/runner.py``).

The search IS a fleet workload. Every ``(rung, trial)`` pair is one
``UnitLedger`` unit leased to whichever ``ElasticWorkerPool`` thread
asks next — so a dead worker's trials are re-leased to survivors
mid-rung by the exact machinery elastic training uses (requeue to the
queue FRONT, detector expiry for stalled threads, zombie completions
fenced by the ledger's exactly-once accounting), and a promotion is
just ``ledger.add_units([(rung+1, trial)])`` from inside the promoting
unit — added strictly before that unit completes, so the pool can never
observe an "all done" ledger that is about to grow.

Resume is checkpoint-driven: before training, a worker loads the
trial's vault checkpoint (``tune/vault.py`` — packed-wire frames,
optionally resident on the sharded PS group) and trains only the
epochs between the checkpoint's rung and the leased rung. A re-leased
trial therefore continues from its last completed rung rather than
restarting, and a zombie that re-delivers an already-counted rung is
fenced twice: the ledger drops the duplicate completion, the scheduler
drops the duplicate dynamics.

Observability: the whole search runs under ONE root trace context —
every per-rung ``tune/trial_rung`` span, every PS push the trial makes,
and every flight event joins that tree. Stall detection feeds the
``tune_trial_stall_seconds`` gauge the ``tune_trial_stalled`` alert
rule watches.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from elephas_tpu_torch import obs
from elephas_tpu_torch.obs.health import record_unit_dynamics, tree_norm
from elephas_tpu_torch.resilience.elastic import ElasticWorkerPool, UnitLedger
from elephas_tpu_torch.tune.scheduler import AshaScheduler
from elephas_tpu_torch.tune.vault import MemoryVault
from elephas_tpu_torch.utils import locksan

__all__ = ["NullTuneClient", "TuneRunner"]


class NullTuneClient:
    """Stand-in parameter client for searches with no PS in the loop:
    satisfies the pool's ``heartbeat``/``membership``/``health`` surface
    (liveness then rests on thread health alone — injected kills and
    crashes still drive requeue through the pool's exception path)."""

    def heartbeat(self, worker_id: str) -> None:
        pass

    def membership(self) -> dict:
        return {}

    def health(self) -> bool:
        return True

    def deregister(self, worker_id: str) -> None:
        pass

    def close(self) -> None:
        pass


def _float64(leaf):
    """A numeric leaf (tensor anywhere, array, scalar) as a float64 CPU
    tensor; None for a non-numeric one."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bool or leaf.is_complex():
            return None
        return leaf.detach().cpu().double()
    arr = np.asarray(leaf)
    return torch.from_numpy(arr.astype(np.float64)) if arr.dtype.kind in "fiu" else None


def _diff_norm(new, old) -> float:
    """L2 norm of (new - old) over matching numeric leaves; falls back
    to |new| when there is no prior state (rung 0 from scratch)."""
    if old is None:
        return tree_norm(new)
    try:
        def walk(a, b, acc):
            if isinstance(a, dict):
                for k in a:
                    walk(a[k], b[k], acc)
            elif isinstance(a, (list, tuple)):
                for x, y in zip(a, b):
                    walk(x, y, acc)
            else:
                x = _float64(a)
                if x is not None:
                    d = (x - _float64(b)).reshape(-1)
                    acc[0] += float(d @ d)

        acc = [0.0]
        walk(new, old, acc)
        return float(acc[0]) ** 0.5
    except Exception:
        return tree_norm(new)


class TuneRunner:
    """Drive one ASHA search over an elastic worker pool.

    ``trial_fn(config, state, epochs, seed, rung) -> {"loss", "state"}``
    trains ``epochs`` MORE epochs from ``state`` (``None`` = fresh
    init) and must be deterministic in ``(config, seed, rung)`` — that
    determinism is what makes a resumed trial bit-identical to an
    uninterrupted one, and the winner digest replay-stable under kills.

    ``client_factory(worker_id)`` defaults to ``NullTuneClient``; pass
    a real factory (e.g. ``lambda w: group.client()``) to heartbeat
    through a PS and let the failure detector expire stalled workers.
    """

    def __init__(self, trial_fn: Callable, scheduler: AshaScheduler, *,
                 vault=None,
                 worker_ids: Sequence[str] = ("w0", "w1"),
                 client_factory: Optional[Callable] = None,
                 injector=None,
                 registry=None, tracer=None, flight=None,
                 monitor_poll: float = 0.05, idle_wait: float = 0.005,
                 ps_recovery_grace: float = 15.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self.trial_fn = trial_fn
        self.scheduler = scheduler
        self.vault = vault if vault is not None else MemoryVault()
        self.worker_ids = [str(w) for w in worker_ids]
        self.client_factory = client_factory or (lambda wid: NullTuneClient())
        self.injector = injector
        self.monitor_poll = monitor_poll
        self.idle_wait = idle_wait
        self.ps_recovery_grace = ps_recovery_grace
        self._clock = clock
        self._sleep = sleep
        self._registry = registry if registry is not None \
            else obs.default_registry()
        self._tracer = tracer if tracer is not None else obs.default_tracer()
        self._flight = flight if flight is not None \
            else obs.default_flight_recorder()
        self._stall_gauge = self._registry.gauge(
            "tune_trial_stall_seconds",
            help="seconds since the slowest running trial last progressed")
        self._lock = locksan.make_lock("TuneRunner._lock")
        self._stall_noted: set = set()
        self._ledger: Optional[UnitLedger] = None
        self._ctx = None
        self.stats: Dict[str, Any] = {}

    # -- stall plane -----------------------------------------------------

    def check_stalls(self, now: Optional[float] = None) -> List[int]:
        """Refresh the stall gauge; flight-note each trial once per
        stall episode. Called at unit boundaries (and poll-able by an
        ops thread)."""
        if now is None:
            now = self._clock()
        sched = self.scheduler
        ages = []
        with sched._lock:
            for t in sched.trials:
                if t.status == "running" and t.last_progress_at is not None:
                    ages.append(now - t.last_progress_at)
        self._stall_gauge.set(max(ages) if ages else 0.0)
        stalled = sched.stalled(now)
        with self._lock:
            fresh = [t for t in stalled if t not in self._stall_noted]
            self._stall_noted.update(fresh)
            # Re-arm cleared trials so a second stall episode notes again.
            self._stall_noted.intersection_update(stalled)
        for tid in fresh:
            self._flight.note("trial_stalled", "warn", trial=tid)
        return stalled

    # -- the unit body ---------------------------------------------------

    def _run_unit(self, worker_id: str, client, unit):
        rung, tid = int(unit[0]), int(unit[1])
        sched = self.scheduler
        state_rec = sched.trials[tid]
        spec = state_rec.spec
        # A prior owner for this same rung means the lease was revoked
        # and re-queued — this execution is a RESUME, not a first run.
        with sched._lock:
            prior_owner = any(r == rung for r, _ in state_rec.owners)
        sched.on_lease(tid, rung, worker_id, resumed=prior_owner)
        self.check_stalls()

        ckpt = self.vault.load(tid)
        with obs.activate(self._ctx):
            with self._tracer.span("tune/trial_rung", trial=tid, rung=rung,
                                   worker=str(worker_id),
                                   digest=spec.digest) as span:
                if ckpt is not None and ckpt.rung >= rung:
                    # The rung's training already reached the vault (its
                    # worker died between save and complete, or a zombie
                    # re-leased it) — reuse, never re-train.
                    loss, delta_norm = ckpt.loss, None
                else:
                    prev = ckpt.state if ckpt is not None else None
                    done_rung = ckpt.rung if ckpt is not None else -1
                    epochs = (sched.cumulative_epochs(rung)
                              - (sched.cumulative_epochs(done_rung)
                                 if done_rung >= 0 else 0))
                    out = self.trial_fn(spec.config, prev, epochs,
                                        spec.seed, rung)
                    if not isinstance(out, dict) or "loss" not in out:
                        raise TypeError(
                            "trial_fn must return a dict with 'loss' "
                            f"(and 'state'), got {type(out).__name__}")
                    loss = float(out["loss"])
                    new_state = out.get("state")
                    delta_norm = (_diff_norm(new_state, prev)
                                  if new_state is not None else None)
                    if new_state is not None:
                        self.vault.save(tid, rung, loss, new_state)
                record_unit_dynamics(self._registry, worker=f"trial{tid}",
                                     loss=loss, delta_norm=delta_norm,
                                     span=span)
                res = sched.on_result(tid, rung, loss, delta_norm)
                if res["promotions"] and self._ledger is not None:
                    # Added BEFORE this unit completes — the ledger still
                    # holds our lease, so no worker can see an empty,
                    # fully-done ledger that is about to grow.
                    self._ledger.add_units(res["promotions"])
        self.check_stalls()
        return {"trial": tid, "rung": rung, "loss": loss,
                "decision": res["decision"]}

    # -- lifecycle -------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        """Run the search to completion; returns the search doc."""
        sched = self.scheduler
        n = len(sched.trials)
        self._ctx = obs.new_context()
        self._ledger = UnitLedger(1, [tid for _, tid in
                                      sched.initial_units()])
        t0 = self._clock()
        with obs.activate(self._ctx):
            with self._tracer.span("tune/search", trials=n, eta=sched.eta,
                                   rungs=sched.rungs,
                                   workers=len(self.worker_ids)):
                pool = ElasticWorkerPool(
                    self._ledger, self._run_unit, self.client_factory,
                    self.worker_ids, injector=self.injector,
                    ps_recovery_grace=self.ps_recovery_grace,
                    monitor_poll=self.monitor_poll,
                    idle_wait=self.idle_wait,
                    clock=self._clock, sleep=self._sleep,
                )
                pool.start()
                stats = pool.wait()
        winner = sched.finalize()
        self._stall_gauge.set(0.0)
        counts = sched.counts()
        lost = counts["pending"] + counts["running"] + counts["paused"] \
            + counts["promoted"]
        doc = {
            "winner": None if winner is None else dict(
                winner.to_doc(), config=winner.spec.config),
            "winner_digest": None if winner is None else winner.spec.digest,
            "search_digest": sched.search_digest(),
            "best_loss": None if winner is None
            else winner.rung_loss[winner.top_rung],
            "epochs_spent": sched.epochs_spent,
            "full_budget_epochs": sched.full_budget() * n,
            "counts": counts,
            "lost_trials": lost,
            "pruned_frac": counts["pruned"] / float(n) if n else 0.0,
            "secs": self._clock() - t0,
            "pool": {
                "worker_deaths": len(stats["worker_deaths"]),
                "requeued_units": stats.get("requeued_units", 0),
                "completed_units": stats.get("completed_units", 0),
                "fenced": list(stats.get("fenced", ())),
            },
        }
        self.stats = doc
        return doc

    def trials_snapshot(self) -> Dict[str, Any]:
        """The ``/trials`` opsd payload: scheduler state + pool facts."""
        snap = self.scheduler.snapshot()
        if self._ledger is not None:
            snap["units"] = self._ledger.outstanding()
        return snap
