"""ASHA-style asynchronous successive halving over trial rung results
(counterpart of ``elephas_tpu/tune/scheduler.py``: the same decisions for
the same result sequence, on the port's ``obs`` registry and flight
recorder under the same metric names).

Synchronous halving promotes the top 1/eta of a rung only after EVERY
trial in it reports — one straggler parks the whole search. The
asynchronous variant (Li et al., the scheduler SparkNet-style fan-out
grows into) decides *per arrival*: when a trial delivers its rung-r
loss, any paused trial whose loss ranks inside the top
``floor(n_results/eta)`` of rung r's results-so-far is promoted
immediately. A straggler therefore never blocks a rung — it merely
joins the ranking late — and the eventual argmin chain is
order-invariant: a trial holding the rung's minimum loss ranks first
against ANY subset of results, so the best configuration climbs the
full ladder in every interleaving. That invariant is exactly what
makes the chaos gate's winner digest replay-stable under worker kills.

Promotion *score* is the rung loss, refined by the PR 7 health plane's
delta-norm dynamics: a trial whose per-rung update norm collapsed
below ``plateau_delta_norm`` has converged — more epochs cannot move
it — so it is retired as ``completed`` at its current loss instead of
burning a promotion slot (its loss still ranks; its epochs stop).

Everything is clock-injected (``scripts/lint_blocking.py`` enforces no
ambient time reads in the resilience path), so tests pin promotion /
pruning / stall decisions on a fake clock with zero real waits.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from elephas_tpu_torch import obs
from elephas_tpu_torch.tune.trial import TERMINAL, TrialSpec, TrialState, \
    canonical_digest
from elephas_tpu_torch.utils import locksan

__all__ = ["AshaScheduler"]


class AshaScheduler:
    """Async successive halving over a fixed trial population.

    ``eta`` is the reduction factor (top 1/eta of a rung promotes),
    ``rungs`` the ladder height, ``r0`` the epoch budget of rung 0;
    rung r trains ``r0 * eta**r`` *cumulative* epochs, so the per-rung
    increment is the geometric gap — a promoted trial resumes from its
    vault checkpoint and trains only the increment.

    Thread-safe: every decision runs under one lock (the elastic pool
    delivers results from N worker threads concurrently).
    """

    def __init__(self, specs: Sequence[TrialSpec], *, eta: int = 3,
                 rungs: int = 3, r0: int = 1,
                 plateau_delta_norm: Optional[float] = None,
                 stall_after: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, flight=None):
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        if rungs < 1:
            raise ValueError(f"need >= 1 rung, got {rungs}")
        self.eta = int(eta)
        self.rungs = int(rungs)
        self.r0 = int(r0)
        self.plateau_delta_norm = plateau_delta_norm
        self.stall_after = stall_after
        self._clock = clock
        self.trials: List[TrialState] = [TrialState(s) for s in specs]
        self._lock = locksan.make_lock("AshaScheduler._lock")
        self._epochs_spent = 0
        self._running = 0  # gauge shadow: Gauge is set-only
        reg = registry if registry is not None else obs.default_registry()
        self._flight = flight if flight is not None \
            else obs.default_flight_recorder()
        self._g_running = reg.gauge(
            "tune_trials_running", help="trials currently leased to a worker")
        self._c_completed = reg.counter(
            "tune_trials_completed_total",
            "trials that reached the top rung (or a delta-norm plateau)")
        self._c_pruned = reg.counter(
            "tune_trials_pruned_total",
            "trials early-stopped by successive halving")
        self._c_promoted = reg.counter(
            "tune_trials_promoted_total",
            "rung promotions granted by the async halving rule")
        self._c_epochs = reg.counter(
            "tune_epochs_total", "training epochs spent across all trials")

    # -- rung geometry ---------------------------------------------------

    def cumulative_epochs(self, rung: int) -> int:
        """Total epochs a trial has trained once rung ``rung`` is done."""
        return self.r0 * self.eta ** int(rung)

    def rung_epochs(self, rung: int) -> int:
        """Epochs trained AT rung ``rung`` (the geometric increment)."""
        rung = int(rung)
        if rung == 0:
            return self.r0
        return self.cumulative_epochs(rung) - self.cumulative_epochs(rung - 1)

    @property
    def max_rung(self) -> int:
        return self.rungs - 1

    def full_budget(self) -> int:
        """Epochs one trial costs when trained to the top rung — what
        plain random search pays for EVERY trial."""
        return self.cumulative_epochs(self.max_rung)

    def initial_units(self) -> List[Tuple[int, int]]:
        """Rung-0 ledger units, one per trial: ``(rung, trial_id)``."""
        return [(0, t.spec.trial_id) for t in self.trials]

    # -- lease / result hooks -------------------------------------------

    def on_lease(self, trial_id: int, rung: int, worker_id: str,
                 resumed: bool = False) -> None:
        """A worker picked the trial's rung unit up."""
        now = self._clock()
        with self._lock:
            state = self.trials[trial_id]
            was_running = state.status == "running"
            state.start(rung, worker_id, now)
            if resumed:
                state.resumed += 1
            if not was_running:
                self._running += 1
                self._g_running.set(self._running)
        if resumed:
            self._flight.note("trial_resumed", "info", trial=trial_id,
                              rung=int(rung), worker=str(worker_id))

    def on_result(self, trial_id: int, rung: int, loss: float,
                  delta_norm: Optional[float] = None) -> Dict:
        """Record one rung result and apply the async halving rule.

        Returns ``{"decision", "duplicate", "promotions"}`` where
        ``promotions`` is every ``(rung, trial_id)`` unit the arrival
        unlocked — possibly for OTHER trials: a new result grows the
        rung's quota, which can lift an earlier paused trial over the
        promotion line. The caller feeds these to the ledger.
        """
        now = self._clock()
        rung = int(rung)
        with self._lock:
            state = self.trials[trial_id]
            counted = state.record_rung(rung, loss, delta_norm, now)
            if not counted:
                # Zombie re-report of a rung a survivor already
                # delivered — the ledger fenced the accounting, we
                # fence the dynamics.
                return {"decision": "duplicate", "duplicate": True,
                        "promotions": []}
            if state.status == "running":
                self._running = max(0, self._running - 1)
                self._g_running.set(self._running)
            self._epochs_spent += self.rung_epochs(rung)
            self._c_epochs.inc(self.rung_epochs(rung))
            plateaued = (
                self.plateau_delta_norm is not None
                and delta_norm is not None
                and delta_norm < self.plateau_delta_norm
            )
            if rung >= self.max_rung or plateaued:
                state.status = "completed"
                self._c_completed.inc()
                decision = "completed" if rung >= self.max_rung \
                    else "plateau_completed"
            else:
                state.status = "paused"
                decision = "paused"
            promotions = self._promotable(rung)
        for r, tid in promotions:
            self._flight.note("trial_promoted", "info", trial=tid,
                              rung=int(r),
                              loss=self.trials[tid].rung_loss.get(rung))
        return {"decision": decision, "duplicate": False,
                "promotions": promotions}

    def _promotable(self, rung: int) -> List[Tuple[int, int]]:
        """Paused trials inside rung ``rung``'s top-1/eta quantile
        (caller holds the lock). Ranking ties break on trial id so two
        runs of the same seeded search promote identically."""
        results = [(t.rung_loss[rung], t.spec.trial_id, t)
                   for t in self.trials if rung in t.rung_loss]
        quota = len(results) // self.eta
        if quota < 1:
            return []
        results.sort(key=lambda r: (r[0], r[1]))
        out: List[Tuple[int, int]] = []
        for _, tid, state in results[:quota]:
            if state.status != "paused" or state.rung != rung:
                continue
            state.status = "promoted"
            state.rung = rung + 1
            self._c_promoted.inc()
            out.append((rung + 1, tid))
        return out

    # -- stall / finalize -----------------------------------------------

    def stalled(self, now: Optional[float] = None,
                stall_after: Optional[float] = None) -> List[int]:
        """Running trials with no progress for ``stall_after`` seconds —
        the ``tune_trial_stalled`` alert's raw material."""
        budget = stall_after if stall_after is not None else self.stall_after
        if budget is None:
            return []
        if now is None:
            now = self._clock()
        with self._lock:
            return [t.spec.trial_id for t in self.trials
                    if t.status == "running"
                    and t.last_progress_at is not None
                    and now - t.last_progress_at > budget]

    def finalize(self) -> Optional[TrialState]:
        """Sweep every still-paused trial to ``pruned`` (async ASHA's
        early stop: never scheduled again) and return the winner — the
        argmin over the highest rung any trial reached."""
        pruned: List[int] = []
        with self._lock:
            for t in self.trials:
                if t.status in TERMINAL:
                    continue
                t.status = "pruned"
                self._c_pruned.inc()
                pruned.append(t.spec.trial_id)
            winner = self._winner_locked()
        for tid in pruned:
            self._flight.note("trial_pruned", "info", trial=tid,
                              rung=self.trials[tid].top_rung)
        return winner

    def _winner_locked(self) -> Optional[TrialState]:
        scored = [t for t in self.trials if t.rung_loss]
        if not scored:
            return None
        top = max(t.top_rung for t in scored)
        finalists = [t for t in scored if t.top_rung == top]
        return min(finalists,
                   key=lambda t: (t.rung_loss[top], t.spec.trial_id))

    def winner(self) -> Optional[TrialState]:
        with self._lock:
            return self._winner_locked()

    # -- read-outs -------------------------------------------------------

    @property
    def epochs_spent(self) -> int:
        with self._lock:
            return self._epochs_spent

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out = {s: 0 for s in ("pending", "running", "paused",
                                  "promoted", "pruned", "completed")}
            for t in self.trials:
                out[t.status] += 1
            return out

    def search_digest(self) -> Optional[str]:
        """Replay-stable digest of the search OUTCOME: the winner's
        identity plus its full rung-loss trajectory and the ladder
        shape. Independent of arrival order, worker identity, and which
        marginal trials were promoted — the invariant the chaos bench
        compares across killed and unkilled runs."""
        winner = self.winner()
        if winner is None:
            return None
        with self._lock:
            losses = {str(r): float(v)
                      for r, v in sorted(winner.rung_loss.items())}
        return canonical_digest({
            "winner": winner.spec.digest,
            "losses": losses,
            "eta": self.eta, "rungs": self.rungs, "r0": self.r0,
        })

    def snapshot(self) -> Dict:
        """The ``/trials`` route payload."""
        with self._lock:
            trials = {str(t.spec.trial_id): t.to_doc() for t in self.trials}
            winner = self._winner_locked()
            epochs = self._epochs_spent
        counts = self.counts()
        return {
            "eta": self.eta, "rungs": self.rungs, "r0": self.r0,
            "counts": counts,
            "epochs_spent": epochs,
            "best": None if winner is None else winner.to_doc(),
            "search_digest": self.search_digest(),
            "trials": trials,
        }
