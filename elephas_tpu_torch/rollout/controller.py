"""Goodput-gated canary rollout over a serving ``ReplicaSet``
(counterpart of ``elephas_tpu/rollout/controller.py``).

The controller owns fleet-wide delivery POLICY; the per-engine
``WeightSubscriber`` owns the mechanism. Every managed replica's
subscriber starts in **hold** (no wire traffic); the controller moves
pins, so no replica ever adopts a training push the canary arc has not
judged — "no non-canary replica serves an unapproved version" holds by
construction, not by timing.

The arc, one ``tick()`` at a time (explicit actuation, injectable
clock — the same observe→decide→act shape as ``Router.tick``):

- **idle** — probe the PS group (version-gated: steady state costs K
  not-modified frames). A version that is neither approved nor
  previously rejected starts a canary: ONE replica (first tier in
  ``tier_order`` — prefill before decode) is pinned to the candidate
  and swaps in place, no restart.
- **canary** — bake for ``bake_s`` AND at least ``min_results``
  finished canary requests, then ask the judge. The default
  (``goodput_judge``) compares the canary's worst bake-window goodput
  objective against the rest of the fleet's; the judge is injectable
  (a quality probe comparing canary output against reference tokens is
  the natural production upgrade).
- **promoting** — good verdict: the pin ripples tier-aware, one tier
  per wave (``tier_order``), each wave waiting until its replicas
  report the candidate version before the next tier moves. When the
  whole fleet converges, the candidate becomes the approved version.
- **rollback** — bad verdict: the canary is re-pinned to the approved
  prior version (a pinned WAL read — immune to ongoing training
  pushes). If the WAL has pruned it (``pin_failed``), the controller
  stages a peer copy of a healthy replica's live params (``offer``) —
  rollback never depends on the PS retaining history.

Every transition appends a time-independent event ``{seq, kind,
version, replica, tier}``; their canonical-JSON sha256 is the **rollout
digest** — replay-stable under a fake clock, the post-mortem anchor.
Promotions/rollbacks also land on the incident timeline as
``rollout_promote`` / ``rollout_rollback`` flight notes, and the
``fleet_rollout_age_s`` / ``fleet_version_skew`` gauges feed the
``rollout_stuck`` / ``version_skew`` alert rules (skew is measured over
NON-canary replicas — a long bake is not an incident).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from elephas_tpu_torch import obs
from elephas_tpu_torch.rollout.subscriber import WeightSubscriber
from elephas_tpu_torch.serving.fleet.replica import SERVING
from elephas_tpu_torch.utils import locksan

__all__ = ["RolloutController", "goodput_judge"]


def goodput_judge(tolerance: float = 0.10):
    """Default verdict: the canary's worst bake-window goodput objective
    must sit within ``tolerance`` of the fleet's worst (or near-perfect
    when the fleet has no window evidence). Returns a judge callable
    ``(canary, fleet, window_s, now) -> Optional[bool]`` — ``None``
    means "not enough evidence, keep baking"."""

    def judge(canary, fleet, window_s: float, now: float):
        cvals = [v for v in
                 canary.engine.slo.goodput(window_s, now=now).values()
                 if v is not None]
        if not cvals:
            return None
        c = min(cvals)
        fvals = []
        for rep in fleet:
            if rep.engine is None:
                continue
            vals = [v for v in
                    rep.engine.slo.goodput(window_s, now=now).values()
                    if v is not None]
            if vals:
                fvals.append(min(vals))
        if not fvals:
            return c >= 1.0 - tolerance
        return c >= min(fvals) - tolerance

    return judge


def _snapshot(engine):
    """A copy of ``engine``'s served weights for a peer-copy offer: the
    port's ``params`` is the module's live ``state_dict``, where the JAX
    package's is an immutable tree, so the offer takes the values of the
    moment it is staged."""
    return {k: v.detach().clone() for k, v in engine.params.items()}


class RolloutController:
    """See module docstring.

    Parameters
    ----------
    replicas: the ``ReplicaSet`` to manage (subscribers are attached to
        every serving replica lazily, and re-attached after restarts —
        a respawned engine comes back pinned to the approved version).
    client: a ``ShardedParameterClient``-shaped client (``pull`` /
        ``pull(version=)``) — the controller's own probe AND, by
        default, the subscribers' shared wire client.
    bake_s / min_results: the bake window — both must be satisfied
        before the judge runs.
    judge: verdict callable (see ``goodput_judge``); injectable.
    tier_order: canary placement and promotion ripple order.
    """

    PHASES = ("idle", "canary", "promoting", "rollback")

    def __init__(self, replicas, client, *, bake_s: float = 2.0,
                 min_results: int = 4,
                 judge: Optional[Callable] = None,
                 tier_order=("prefill", "mono", "decode"),
                 subscriber_every: int = 1,
                 clock=time.monotonic,
                 client_factory: Optional[Callable[[], Any]] = None):
        self.replicas = replicas
        self.client = client
        self.bake_s = float(bake_s)
        self.min_results = int(min_results)
        self.judge = judge if judge is not None else goodput_judge()
        self.tier_order = tuple(tier_order)
        self.subscriber_every = int(subscriber_every)
        self.clock = clock
        self._client_factory = client_factory
        self._subs: Dict[str, WeightSubscriber] = {}
        self._lock = locksan.make_lock("RolloutController._lock")
        self._phase = "idle"
        self._phase_start: Optional[float] = None
        self._seeded = False  # baseline adopted (see _tick_idle)
        self._baseline: Optional[int] = None
        self._approved: Optional[int] = None
        self._candidate: Optional[int] = None
        self._canary_rid: Optional[str] = None
        self._canary_eval0 = 0
        self._promote_tiers: List[str] = []
        self._promote_wave: List[str] = []
        self._rejected: set = set()
        self._events: List[Dict[str, Any]] = []
        self._seq = 0
        self.rollouts = 0
        self.rollbacks = 0
        self.probe_failures = 0
        self._ticker: Optional[threading.Thread] = None
        self._ticker_stop = threading.Event()
        reg = obs.default_registry()
        self._g_age = reg.gauge(
            "fleet_rollout_age_s",
            help="seconds the rollout state machine has sat in its "
                 "current non-idle phase (0 when idle)")
        self._g_skew = reg.gauge(
            "fleet_version_skew",
            help="max minus min served model_version across non-canary "
                 "serving replicas (0 with fewer than two versions)")

    # -- events / digest ----------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        with self._lock:
            self._seq += 1
            self._events.append({"seq": self._seq, "kind": kind,
                                 **fields})

    def digest(self) -> str:
        """Replay-stable rollout digest: canonical JSON over the
        time-independent event list (events carry seq/kind/version/
        replica/tier, never timestamps — wall time lives in the flight
        notes, which the incident timeline already clock-aligns)."""
        with self._lock:
            blob = json.dumps(self._events, sort_keys=True,
                              separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    # -- subscriber management ----------------------------------------------

    def _make_client(self):
        if self._client_factory is not None:
            return self._client_factory()
        return self.client

    def subscriber_of(self, replica_id: str) -> Optional[WeightSubscriber]:
        return self._subs.get(replica_id)

    def _manage(self) -> None:
        """Attach a held subscriber to every serving engine that lacks
        one (first sight AND post-restart respawns — a fresh engine's
        ``subscriber`` is None). A replica joining an already-delivered
        fleet is pinned straight to the approved version."""
        with self._lock:
            approved = self._approved
        for rep in self.replicas.serving():
            engine = rep.engine
            if engine is None or engine.subscriber is not None:
                continue
            sub = WeightSubscriber(
                self._make_client(), every=self.subscriber_every,
                follow=False,
            ).attach(engine)
            self._subs[rep.replica_id] = sub
            if approved is not None:
                sub.pin(approved)
                sub.nudge(engine)  # a respawn may see no traffic yet

    # -- tick ---------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> str:
        """One observe→decide→act pass; returns the (possibly new)
        phase. Explicit actuation: benches/tests drive it directly on a
        fake clock; ``start_ticker`` wraps it for production."""
        now = self.clock() if now is None else float(now)
        self._manage()
        with self._lock:
            phase = self._phase
        if phase == "idle":
            self._tick_idle(now)
        elif phase == "canary":
            self._tick_canary(now)
        elif phase == "promoting":
            self._tick_promoting(now)
        elif phase == "rollback":
            self._tick_rollback(now)
        self._refresh_gauges(now)
        with self._lock:
            return self._phase

    def _tick_idle(self, now: float) -> None:
        try:
            version, _ = self.client.pull()
        except Exception:
            # A PS outage stalls DELIVERY, never serving: the fleet
            # keeps answering on its current weights.
            self.probe_failures += 1
            return
        with self._lock:
            approved = self._approved
            seeded = self._seeded
            rejected = version in self._rejected
        if version is None:
            return
        if not seeded:
            # First contact: adopt the PS's current version as the
            # approved baseline WITHOUT a canary arc — the fleet is
            # already serving these weights by construction (engines
            # boot from the same params the PS group was built over),
            # so "delivering" them would be a no-op arc that races the
            # first real push.
            with self._lock:
                self._approved = int(version)
                self._baseline = int(version)
                self._seeded = True
            self._event("baseline", version=int(version))
            return
        if version == approved or rejected:
            return
        serving = self.replicas.serving()
        canary = None
        for tier in self.tier_order:
            tiered = [r for r in serving if r.tier == tier]
            if tiered:
                canary = tiered[0]
                break
        if canary is None or canary.engine is None:
            return
        sub = self._subs.get(canary.replica_id)
        if sub is None:
            return
        self._canary_eval0 = canary.engine.slo.snapshot(
            now=now)["evaluated"]
        with self._lock:
            self._candidate = int(version)
            self._canary_rid = canary.replica_id
            self._phase = "canary"
            self._phase_start = now
        canary.rollout_canary = True
        sub.pin(int(version))
        self._event("canary_start", version=int(version),
                    replica=canary.replica_id, tier=canary.tier)

    def _canary(self):
        with self._lock:
            rid = self._canary_rid
        rep = self.replicas.replicas.get(rid) if rid is not None else None
        if rep is None or rep.state != SERVING or rep.engine is None:
            return None
        return rep

    def _abort(self, kind: str) -> None:
        with self._lock:
            version, rid = self._candidate, self._canary_rid
            self._phase = "idle"
            self._phase_start = None
            self._candidate = None
            self._canary_rid = None
        self._clear_canary_flag(rid)
        self._event(kind, version=version, replica=rid)

    def _clear_canary_flag(self, rid: Optional[str]) -> None:
        rep = self.replicas.replicas.get(rid) if rid is not None else None
        if rep is not None:
            rep.rollout_canary = False

    def _tick_canary(self, now: float) -> None:
        canary = self._canary()
        if canary is None:
            self._abort("canary_lost")  # died mid-bake; next tick re-arms
            return
        with self._lock:
            candidate, start = self._candidate, self._phase_start
        sub = self._subs.get(canary.replica_id)
        if canary.engine.model_version != candidate:
            if sub is not None and sub.pin_failed:
                # The trainer outran the WAL window before the canary
                # ever swapped — this candidate is unservable, not bad.
                self._abort("canary_abandoned")
                return
            if sub is not None:
                sub.nudge(canary.engine)  # idle canary: deliver now
            if canary.engine.model_version != candidate:
                return  # still delivering (or degrading on failures)
        if now - start < self.bake_s:
            return
        evaluated = canary.engine.slo.snapshot(now=now)["evaluated"] \
            - self._canary_eval0
        if evaluated < self.min_results:
            return
        fleet = [r for r in self.replicas.serving()
                 if r.replica_id != canary.replica_id]
        verdict = self.judge(canary, fleet, max(now - start, 1e-9), now)
        if verdict is None:
            return
        if verdict:
            self._begin_promote(now)
        else:
            self._begin_rollback(now)

    # -- promotion ----------------------------------------------------------

    def _begin_promote(self, now: float) -> None:
        with self._lock:
            candidate, rid = self._candidate, self._canary_rid
            self._phase = "promoting"
            self._phase_start = now
            self._promote_tiers = list(self.tier_order)
            self._promote_wave = []
        self._event("promote_start", version=candidate, replica=rid)
        self._advance_promote(now)

    def _advance_promote(self, now: float) -> None:
        with self._lock:
            candidate = self._candidate
            wave = list(self._promote_wave)
        for rid in wave:
            rep = self.replicas.replicas.get(rid)
            if rep is None or rep.state != SERVING or rep.engine is None:
                continue  # left the roster; don't wedge the ripple
            if rep.engine.model_version != candidate:
                # Delivery must not depend on traffic: an idle engine
                # has no step boundaries, so hand it a synthetic one.
                sub = self._subs.get(rid)
                if sub is not None and not sub.pin_failed:
                    sub.nudge(rep.engine)
                if rep.engine.model_version != candidate:
                    return  # wave still converging
        while True:
            with self._lock:
                if not self._promote_tiers:
                    break
                tier = self._promote_tiers[0]
            todo = [r for r in self.replicas.serving(tier)
                    if r.engine is not None
                    and r.engine.model_version != candidate
                    and r.replica_id in self._subs]
            if todo:
                for rep in todo:
                    self._subs[rep.replica_id].pin(candidate)
                    self._event("pin", version=candidate,
                                replica=rep.replica_id, tier=rep.tier)
                with self._lock:
                    self._promote_wave = [r.replica_id for r in todo]
                return
            with self._lock:
                self._promote_tiers.pop(0)
        with self._lock:
            self._approved = candidate
            self._phase = "idle"
            self._phase_start = None
            self._candidate = None
            rid = self._canary_rid
            self._canary_rid = None
        self._clear_canary_flag(rid)
        self.rollouts += 1
        self._event("promoted", version=candidate)
        obs.default_flight_recorder().note(
            "rollout_promote", "info", version=candidate,
            replicas=len(self.replicas.serving()),
        )

    def _tick_promoting(self, now: float) -> None:
        self._advance_promote(now)

    # -- rollback -----------------------------------------------------------

    def _begin_rollback(self, now: float) -> None:
        with self._lock:
            candidate, rid = self._candidate, self._canary_rid
            approved = self._approved
            self._rejected.add(candidate)
            self._phase = "rollback"
            self._phase_start = now
        self._event("rollback_start", version=candidate, to=approved,
                    replica=rid)
        obs.default_flight_recorder().note(
            "rollout_rollback", "error", version=candidate,
            to=approved, replica=rid,
        )
        sub = self._subs.get(rid)
        if sub is None:
            return
        if approved is not None:
            sub.pin(approved)  # pinned WAL read — push-race-immune
        else:
            # No PS-delivered prior: restore the pre-delivery weights
            # from a healthy peer (they still serve them).
            sub.unpin()
            peer = self._rollback_peer(rid, None)
            if peer is not None:
                sub.offer(_snapshot(peer.engine), None)

    def _rollback_peer(self, canary_rid: str, version: Optional[int]):
        """A healthy replica serving the ``version`` content. A replica
        that was never delivered to (``model_version is None``) serves
        the baseline content by construction, so it counts when the
        approved version IS the seeded baseline."""
        with self._lock:
            baseline = self._baseline
        for rep in self.replicas.serving():
            if rep.replica_id == canary_rid or rep.engine is None:
                continue
            served = rep.engine.model_version
            if served == version or (
                    served is None and version == baseline):
                return rep
        return None

    def _tick_rollback(self, now: float) -> None:
        canary = self._canary()
        if canary is None:
            self._abort("canary_lost")
            return
        with self._lock:
            approved, rid = self._approved, self._canary_rid
        if canary.engine.model_version == approved:
            with self._lock:
                self._phase = "idle"
                self._phase_start = None
                self._candidate = None
                self._canary_rid = None
            self._clear_canary_flag(rid)
            self.rollbacks += 1
            self._event("rolled_back", version=approved, replica=rid)
            return
        sub = self._subs.get(rid)
        if sub is not None and sub.pin_failed and approved is not None:
            # WAL pruned the prior version mid-arc: peer-copy fallback.
            peer = self._rollback_peer(rid, approved)
            if peer is not None:
                sub.offer(_snapshot(peer.engine), approved)
                self._event("rollback_peer_copy", version=approved,
                            replica=rid)
        if sub is not None:
            sub.nudge(canary.engine)  # idle canary: roll back now

    # -- observability ------------------------------------------------------

    def _skew(self) -> int:
        with self._lock:
            rid = self._canary_rid
        versions = [r.engine.model_version for r in self.replicas.serving()
                    if r.replica_id != rid and r.engine is not None
                    and r.engine.model_version is not None]
        if len(versions) < 2:
            return 0
        return int(max(versions) - min(versions))

    def _refresh_gauges(self, now: float) -> None:
        with self._lock:
            phase, start = self._phase, self._phase_start
        age = 0.0 if phase == "idle" or start is None \
            else max(0.0, now - start)
        self._g_age.set(age)
        self._g_skew.set(float(self._skew()))

    def doc(self) -> Dict[str, Any]:
        """The opsd ``/rollout`` document (federated by the fleet
        aggregator)."""
        now = self.clock()
        with self._lock:
            phase, start = self._phase, self._phase_start
            approved, candidate = self._approved, self._candidate
            rid = self._canary_rid
            events = list(self._events[-100:])
        versions = {}
        for rep_id, rep in self.replicas.replicas.items():
            versions[rep_id] = (rep.engine.model_version
                                if rep.engine is not None else None)
        return {
            "active": True,
            "phase": phase,
            "age_s": (0.0 if phase == "idle" or start is None
                      else max(0.0, now - start)),
            "approved_version": approved,
            "candidate_version": candidate,
            "canary": rid,
            "versions": versions,
            "skew": self._skew(),
            "rollouts": self.rollouts,
            "rollbacks": self.rollbacks,
            "probe_failures": self.probe_failures,
            "subscribers": {rep_id: sub.snapshot()
                            for rep_id, sub in self._subs.items()},
            "events": events,
            "digest": self.digest(),
        }

    # -- background ticker ---------------------------------------------------

    def start_ticker(self, interval: float = 0.2,
                     sleep=time.sleep) -> None:
        if self._ticker is not None:
            return
        self._ticker_stop.clear()

        def run():
            while not self._ticker_stop.is_set():
                try:
                    self.tick()
                except Exception:
                    pass  # policy must outlive one bad pass
                sleep(interval)

        self._ticker = threading.Thread(
            target=run, name="rollout-ticker", daemon=True)
        self._ticker.start()

    def stop_ticker(self) -> None:
        if self._ticker is None:
            return
        self._ticker_stop.set()
        self._ticker.join(timeout=5)
        self._ticker = None
