"""Admission router: the fleet's client-facing submit/result surface
(counterpart of ``elephas_tpu/serving/fleet/router.py``).

The router reuses the scheduler/engine seam one level up — the same
``submit() -> id`` / ``result(id)`` contract the engine offers, fronted
over N replicas — so a client (and the benches, and the canary driver
pointed at the router) cannot tell a fleet from a bare engine except
by throughput. That contract is also the proof surface: with one
replica and no faults, routed output must be token-identical to a bare
engine's.

Dispatch is signal-driven, not round-robin. Each submit ranks the
serving replicas by a composite **dispatch cost** —

    load_score  (the saturation plane's smoothed composite)
  + w_q * queue_frac  (admission queue fullness)
  + w_b * burn        (worst-objective goodput burn, capped)

— with two overrides. **Session affinity**: a follow-up turn goes to
the replica already holding that session's KV state, whatever its
cost, because a re-prefill is pure waste; the pin breaks (and
``affinity_miss_total`` counts it, per session card) only when that
replica is draining, dead, or shedding. **Shed latch**: a replica
whose ``goodput_burn_high`` alert latched ranks behind every clean
replica and takes new work only when nothing clean is left.

Actuation lives in ``tick()`` — explicitly driven (bench loop, test,
ops cadence), never a hidden thread: finish drains, fire canary
probes, refresh shed latches, drain-and-restart canary-flagged
replicas, and feed the autoscaler, actuating its decision (spawn a new
slot, or drain the cheapest one down). Recovery lives in ``result()``:
a request stranded on a killed replica surfaces as ``ReplicaDead`` and
is resubmitted elsewhere (``router_requeue_total``), with the router's
own goodput ledger charging the *end-to-end* wait — a requeue stall is
a real TTFT hit to the client even though the second replica's engine
never saw it.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from elephas_tpu_torch import obs
from elephas_tpu_torch.obs.slo import GoodputLedger
from elephas_tpu_torch.serving.fleet.replica import (
    DRAINING,
    Replica,
    ReplicaDead,
)
from elephas_tpu_torch.serving.fleet.replica_set import ReplicaSet
from elephas_tpu_torch.serving.scheduler import QueueFull
from elephas_tpu_torch.utils import locksan

__all__ = ["FleetUnavailable", "Router"]

#: Dispatch-cost weights: load leads, queue pressure seconds it, burn
#: is a tie-breaking nudge (the hard burn response is the shed latch,
#: not the cost term).
COST_QUEUE_WEIGHT = 0.5
COST_BURN_WEIGHT = 0.25
#: Burn saturates the cost term at critical territory (>6 is already
#: page-worthy; beyond that the number carries no routing signal).
BURN_COST_CAP = 8.0
#: Decode-tier handoff targeting adds KV pressure at full weight — a
#: decode replica out of free blocks evicts prefix state on import,
#: which is exactly the waste tiering exists to avoid.
COST_KV_WEIGHT = 1.0
#: Handoff latency samples kept for the /tiers p50/p99 (bounded ring).
HANDOFF_SAMPLES = 512


class FleetUnavailable(RuntimeError):
    """No serving replica exists (all dead/draining) — distinct from
    ``QueueFull``, where replicas exist but all rejected admission."""


class _Assignment:
    """Where one routed request currently lives (mutable: requeue
    re-points it at a new replica/engine id).

    ``stage`` tracks the disaggregated pipeline position: ``"mono"``
    (classic single-replica serving), ``"prefill"`` (waiting on a
    prefill-tier KV export), or ``"decode"`` (handed off; waiting on
    the decode replica's result). Requeues and handoff failures
    degrade the stage back to ``"mono"``.
    """

    __slots__ = ("router_id", "prompt", "kwargs", "session", "canary",
                 "replica_id", "engine_rid", "t_router", "t_engine",
                 "resubmits", "stage")

    def __init__(self, router_id: int, prompt: Sequence[int],
                 kwargs: Dict[str, Any], session: Optional[str],
                 canary: bool, replica_id: str, engine_rid: int,
                 t_router: float, t_engine: float, stage: str = "mono"):
        self.router_id = router_id
        self.prompt = prompt
        self.kwargs = kwargs
        self.session = session
        self.canary = canary
        self.replica_id = replica_id
        self.engine_rid = engine_rid
        self.t_router = t_router
        self.t_engine = t_engine
        self.resubmits = 0
        self.stage = stage


class _RouterOutcome:
    """Duck-typed ``GenerationResult`` for the router's own goodput
    ledger (``GoodputLedger.record`` reads only these three fields):
    same objective semantics, but TTFT measured from the *router*
    submit, so dispatch and requeue stalls land in the number."""

    __slots__ = ("status", "ttft_s", "itl_s_avg")

    def __init__(self, status: str, ttft_s: Optional[float],
                 itl_s_avg: Optional[float]):
        self.status = status
        self.ttft_s = ttft_s
        self.itl_s_avg = itl_s_avg


class Router:
    """Load- and goodput-driven admission frontend over a ``ReplicaSet``."""

    def __init__(self, replica_set: ReplicaSet, *,
                 clock=None, autoscaler=None,
                 canary_fail_threshold: int = 1,
                 qos=None):
        if canary_fail_threshold < 1:
            raise ValueError(
                f"canary_fail_threshold must be >= 1, "
                f"got {canary_fail_threshold}")
        self.replica_set = replica_set
        self.clock = replica_set.clock if clock is None else clock
        self.autoscaler = autoscaler
        self.canary_fail_threshold = canary_fail_threshold
        #: Optional multi-tenant admission policy (fleet.qos.QoSPolicy):
        #: token buckets + weighted fair share gate every non-canary
        #: submit; priority-0 tenants may preempt queued lower-priority
        #: work when every replica rejects admission.
        self.qos = qos
        #: Router-relative goodput: the client's view of the fleet,
        #: including dispatch and requeue stalls no single engine sees.
        self.slo = GoodputLedger(clock=self.clock)

        self._ids = itertools.count()
        self._lock = locksan.make_lock("Router._lock")
        self._assignments: Dict[int, _Assignment] = {}
        self._sessions: Dict[str, str] = {}
        self._affinity: Dict[str, Dict[str, int]] = {}
        self.ops = None
        #: ``RolloutController`` once attached — feeds the ops
        #: ``/rollout`` route and is ticked alongside the router.
        self.rollout = None

        # Plain-int mirrors readable without a registry scrape; the
        # counters are the dashboard surface.
        self.requests = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.requeues = 0
        self.handoffs = 0
        self.handoff_fails = 0
        self.preemptions = 0
        #: Bounded handoff-latency ring (seconds) for /tiers p50/p99.
        self._handoff_s: List[float] = []
        reg = obs.default_registry()
        self._m_requests = reg.counter(
            "router_requests_total",
            help="requests admitted through the fleet router")
        self._m_hit = reg.counter(
            "affinity_hit_total",
            help="session follow-ups dispatched to the replica already "
                 "holding the session's KV state")
        self._m_miss = reg.counter(
            "affinity_miss_total",
            help="session follow-ups re-routed because the pinned "
                 "replica was draining, dead, or shedding")
        self._m_requeue = reg.counter(
            "router_requeue_total",
            help="in-flight requests resubmitted to another replica "
                 "after their replica died un-drained")
        self._m_handoff = reg.counter(
            "router_handoff_total",
            help="prefill-tier KV exports successfully imported by a "
                 "decode replica")
        self._m_handoff_fail = reg.counter(
            "router_handoff_fail_total",
            help="KV handoffs that failed (corrupt frame, no decode "
                 "capacity, dead target) and degraded to a local "
                 "re-prefill")
        self._m_preempt = reg.counter(
            "router_preempt_total",
            help="queued lower-priority requests cancelled to seat a "
                 "priority-0 submit")
        self._g_imbalance = reg.gauge(
            "fleet_tier_imbalance",
            help="max minus min average load score across populated "
                 "serving tiers (0 with fewer than two tiers)")
        self._g_handoff_p99 = reg.gauge(
            "fleet_handoff_seconds_p99",
            help="p99 of recent prefill->decode KV handoff latency")

    # -- dispatch ----------------------------------------------------------

    def dispatch_cost(self, rep: Replica) -> float:
        """Composite per-replica cost; lower routes first."""
        burn = min(rep.worst_burn(), BURN_COST_CAP) / BURN_COST_CAP
        return (rep.load_score()
                + COST_QUEUE_WEIGHT * rep.queue_frac()
                + COST_BURN_WEIGHT * burn)

    def decode_cost(self, rep: Replica) -> float:
        """Handoff-target cost: the dispatch composite plus KV-pool
        pressure — the signal that actually predicts whether an import
        will evict prefix state."""
        return self.dispatch_cost(rep) + COST_KV_WEIGHT * rep.kv_pressure()

    def _disagg_active(self) -> bool:
        """Disaggregated routing is on when both tiers have a serving
        replica. Canaries always serve mono-style (one replica end to
        end) — a blackbox probe must measure one replica, not the
        pipeline."""
        return bool(self.replica_set.serving("prefill")
                    and self.replica_set.serving("decode"))

    def _dispatch_order(
            self, pinned: Optional[str]) -> Tuple[List[Replica], bool]:
        """Serving replicas in dispatch order, plus whether the
        session pin held.

        Clean replicas rank by cost ahead of every shedding one
        (deterministic id tie-break). A healthy pinned replica jumps
        the whole ranking; a shedding/draining/dead pin does not —
        that's the explicit affinity miss."""
        serving = self.replica_set.serving()
        if not serving:
            raise FleetUnavailable("no serving replica")
        ranked = sorted(
            serving,
            key=lambda r: (r.shedding, self.dispatch_cost(r), r.replica_id))
        if pinned is not None:
            lead = next(
                (r for r in ranked if r.replica_id == pinned), None)
            if lead is not None and not lead.shedding:
                return ([lead] + [r for r in ranked if r is not lead],
                        True)
        return ranked, False

    def _tier_order(self, tier: str) -> List[Replica]:
        """Serving replicas of one tier in dispatch order (shed latch
        first, then cost, then id — same ranking as mono dispatch)."""
        return sorted(
            self.replica_set.serving(tier),
            key=lambda r: (r.shedding, self.dispatch_cost(r), r.replica_id))

    def _admit_on(self, order: List[Replica], prompt: Sequence[int],
                  kwargs: Dict[str, Any],
                  prefill: bool) -> Tuple[Replica, int]:
        """Try each candidate in order; first admission wins. Raises
        the last ``QueueFull`` when every one rejected."""
        last_full = None
        for candidate in order:
            try:
                engine_rid = candidate.engine.submit(
                    prompt, prefill_only=prefill, **kwargs)
            except QueueFull as err:
                last_full = err
                continue
            return candidate, engine_rid
        if last_full is None:
            raise FleetUnavailable("no serving replica")
        raise last_full

    def _try_preempt(self, beneficiary: Optional[str],
                     replica_ids: List[str]) -> Optional[Replica]:
        """Cancel one still-queued lower-priority request on one of
        ``replica_ids`` to free an admission seat. Lowest-priority
        (highest class number) victims go first; admitted work is
        never touched (``engine.cancel`` only yanks queued requests —
        the victim's waiter sees a ``"preempted"`` result and the
        router redispatches it). Returns the replica whose seat was
        freed, or None."""
        if self.qos is None:
            return None
        bene_prio = self.qos.priority(beneficiary)
        with self._lock:
            candidates = [a for a in self._assignments.values()
                          if a.replica_id in replica_ids
                          and not a.canary]
        candidates.sort(
            key=lambda a: -self.qos.priority(a.kwargs.get("tenant")))
        for victim in candidates:
            v_tenant = victim.kwargs.get("tenant")
            if self.qos.priority(v_tenant) <= bene_prio:
                break  # sorted: nothing lower-priority remains
            rep = self.replica_set.get(victim.replica_id)
            if rep.engine.cancel(victim.engine_rid):
                self.preemptions += 1
                self._m_preempt.inc()
                self.qos.note_preempted(v_tenant)
                obs.default_flight_recorder().note(
                    "tenant_preempted", "warn", tenant=v_tenant,
                    beneficiary=beneficiary, replica=victim.replica_id,
                    router_id=victim.router_id)
                return rep
        return None

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               *, session: Optional[str] = None,
               timeout_s: Optional[float] = None,
               canary: bool = False,
               tenant: Optional[str] = None) -> int:
        """Route one request; returns a router-scoped request id.

        ``tenant`` names the account billed for the request in the
        assigned replica's cost ledger. It rides the assignment's
        replay kwargs, so a requeue-on-death resubmits with the SAME
        tag — attribution survives mid-flight replica kills.

        With both a prefill and a decode tier serving (and ``qos`` not
        throttling the tenant), a non-canary request is dispatched to
        the prefill tier; ``result()`` drives the KV handoff to a
        decode replica. Raises ``FleetUnavailable`` when no replica is
        serving, ``AdmissionThrottled`` when QoS refuses the tenant,
        or the last replica's ``QueueFull`` when every one rejected
        admission (after a failed preemption attempt, for priority-0
        tenants).
        """
        t_router = self.clock()
        if self.qos is not None and not canary:
            self.qos.try_admit(tenant, len(prompt) + max_new_tokens)
        with self._lock:
            pinned = None if session is None else self._sessions.get(session)
        disagg = (not canary) and self._disagg_active()
        kwargs = {"max_new_tokens": max_new_tokens, "timeout_s": timeout_s,
                  "canary": canary, "tenant": tenant}
        if disagg:
            # The session pin (if any) points at a decode replica
            # holding KV state; prefill dispatch ignores it — the
            # handoff targeting honors it instead (_do_handoff).
            order = self._tier_order("prefill")
            pin_held = False
        else:
            order, pin_held = self._dispatch_order(pinned)
        try:
            rep, engine_rid = self._admit_on(order, prompt, kwargs,
                                             prefill=disagg)
        except QueueFull:
            if (self.qos is None or canary
                    or self.qos.priority(tenant) != 0):
                raise
            freed = self._try_preempt(
                tenant, [r.replica_id for r in order])
            if freed is None:
                raise
            rep, engine_rid = self._admit_on([freed], prompt, kwargs,
                                             prefill=disagg)

        self.requests += 1
        self._m_requests.inc()
        if pinned is not None and not disagg:
            card = self._affinity.setdefault(
                rep.replica_id, {"hits": 0, "misses": 0})
            if pin_held and rep.replica_id == pinned:
                self.affinity_hits += 1
                card["hits"] += 1
                self._m_hit.inc()
            else:
                self.affinity_misses += 1
                card["misses"] += 1
                self._m_miss.inc()
        rep.note_dispatch()

        router_id = next(self._ids)
        asg = _Assignment(
            router_id, list(prompt), kwargs,
            session, canary, rep.replica_id, engine_rid,
            t_router, self.clock(),
            stage="prefill" if disagg else "mono")
        with self._lock:
            self._assignments[router_id] = asg
            if session is not None and not disagg:
                self._sessions[session] = rep.replica_id
        return router_id

    # -- results + recovery ------------------------------------------------

    def result(self, router_id: int,
               timeout_s: Optional[float] = None):
        """Claim a routed result, requeueing across replica death.

        A ``ReplicaDead`` from the assigned replica resubmits the
        request on the next-best replica and keeps waiting — the
        client sees one slower result, never the outage. A
        ``"prefill"``-stage assignment first waits for the KV export,
        then drives the handoff to a decode replica (falling back to a
        local re-prefill on any handoff failure); a ``"preempted"``
        result redispatches under fair share. Either way the client
        sees exactly one terminal result.
        """
        with self._lock:
            asg = self._assignments.get(router_id)
        if asg is None:
            raise KeyError(f"unknown router request id {router_id}")
        deadline = (None if timeout_s is None
                    else self.clock() + timeout_s)
        while True:
            rep = self.replica_set.get(asg.replica_id)
            remaining = (None if deadline is None
                         else max(0.0, deadline - self.clock()))
            if asg.stage == "prefill":
                try:
                    data = rep.handoff(asg.engine_rid,
                                       timeout_s=remaining)
                except ReplicaDead:
                    self._requeue(asg)
                    continue
                if isinstance(data, dict):
                    self._do_handoff(asg, rep, data, deadline=deadline)
                    continue
                res = data  # terminated on the prefill engine
                rep.note_done()
            else:
                try:
                    res = rep.result(asg.engine_rid, timeout_s=remaining)
                except ReplicaDead:
                    self._requeue(asg)
                    continue
                rep.note_done()
                if res.status == "preempted":
                    self._redispatch(asg, deadline=deadline)
                    continue
            with self._lock:
                self._assignments.pop(router_id, None)
            if not asg.canary:
                ttft = (None if res.ttft_s is None
                        else (asg.t_engine - asg.t_router) + res.ttft_s)
                self.slo.record(
                    _RouterOutcome(res.status, ttft, res.itl_s_avg))
            return res

    def _do_handoff(self, asg: _Assignment, rep: Replica,
                    data: Dict[str, Any],
                    deadline: Optional[float] = None) -> None:
        """Ship a claimed KV export to the best decode replica; on any
        failure, degrade to a local re-prefill (``_redispatch``) — the
        request is never lost, only slower (and token-identical either
        way: the fallback recomputes the same prompt on the same
        params and seed).

        Latency is measured from export claim to accepted import —
        encode, (in-process) transfer, validation, and the device
        staging of every block land inside the number. A decode tier
        that is merely FULL is backpressure, not failure: the loop
        re-ranks and retries with bounded sleeps until ``deadline``
        (same discipline as ``_redispatch``) — only a structural
        defect (corrupt frame, import rejection), an empty tier, or
        deadline exhaustion degrades to the local re-prefill.
        """
        from elephas_tpu_torch.parameter.wire import WireFormatError
        from elephas_tpu_torch.serving.handoff import encode_handoff

        t0 = self.clock()
        failure = None
        try:
            frame = encode_handoff(data).tobytes()
        except WireFormatError as exc:
            frame, failure = None, repr(exc)
        while frame is not None:
            targets = sorted(
                self.replica_set.serving("decode"),
                key=lambda r: (r.shedding, self.decode_cost(r),
                               r.replica_id))
            with self._lock:
                pinned = (None if asg.session is None
                          else self._sessions.get(asg.session))
            if pinned is not None:
                lead = next(
                    (r for r in targets if r.replica_id == pinned), None)
                if lead is not None and not lead.shedding:
                    targets = [lead] + [r for r in targets if r is not lead]
            structural = False
            retry_after = None
            for cand in targets:
                try:
                    new_rid = cand.engine.submit_handoff(
                        frame, canary=asg.canary)
                except QueueFull as err:
                    failure = repr(err)
                    retry_after = (err.retry_after if retry_after is None
                                   else min(retry_after, err.retry_after))
                    continue
                except (WireFormatError, ValueError) as err:
                    failure = repr(err)
                    structural = True
                    break  # structural defect; other targets won't help
                t1 = self.clock()
                self.handoffs += 1
                self._m_handoff.inc()
                self._handoff_s.append(t1 - t0)
                del self._handoff_s[:-HANDOFF_SAMPLES]
                rep.note_done()
                cand.note_dispatch()
                obs.default_flight_recorder().note(
                    "kv_handoff", "info", tenant=asg.kwargs.get("tenant"),
                    src=rep.replica_id, dst=cand.replica_id,
                    blocks=data["export"]["blocks"],
                    matched=data["matched"],
                    ms=round((t1 - t0) * 1e3, 3))
                with self._lock:
                    asg.replica_id = cand.replica_id
                    asg.engine_rid = new_rid
                    asg.stage = "decode"
                    asg.t_engine = t1
                    if asg.session is not None:
                        self._sessions[asg.session] = cand.replica_id
                return
            if not targets:
                failure = "no serving decode replica"
            if structural or retry_after is None:
                break
            if deadline is not None and self.clock() >= deadline:
                break
            time.sleep(min(max(retry_after, 0.01), 0.05))
            # Queue wait is backpressure, not transport: restart the
            # latency sample so handoff_p99 keeps measuring the
            # encode→import path, not how long the decode tier was full.
            t0 = self.clock()
        self.handoff_fails += 1
        self._m_handoff_fail.inc()
        obs.default_flight_recorder().note(
            "tier_handoff_fail", "warn", tenant=asg.kwargs.get("tenant"),
            src=rep.replica_id, reason=failure,
            router_id=asg.router_id)
        rep.note_done()
        self._redispatch(asg, deadline=deadline)

    def _redispatch(self, asg: _Assignment,
                    deadline: Optional[float] = None) -> None:
        """Re-run dispatch for an assignment whose replica already
        released it (handoff failure, preemption): mono-style, to any
        serving replica — correctness over tiering when the pipeline
        degrades. The caller has already ``note_done``d the old
        replica.

        A full fleet is retried with bounded sleeps until ``deadline``
        — a preempted victim often races the very preemptor that freed
        its seat, and losing the request to that race would turn a
        deferral into a failure."""
        while True:
            order, _ = self._dispatch_order(None)
            try:
                rep, engine_rid = self._admit_on(
                    order, asg.prompt, asg.kwargs, prefill=False)
                break
            except QueueFull as err:
                if deadline is not None and self.clock() >= deadline:
                    raise
                time.sleep(min(max(err.retry_after, 0.01), 0.05))
        rep.note_dispatch()
        with self._lock:
            asg.replica_id = rep.replica_id
            asg.engine_rid = engine_rid
            asg.stage = "mono"
            asg.resubmits += 1
            asg.t_engine = self.clock()
            if asg.session is not None:
                self._sessions[asg.session] = rep.replica_id

    def _requeue(self, asg: _Assignment) -> None:
        """Move a stranded assignment off its dead replica."""
        dead_id = asg.replica_id
        self.replica_set.get(dead_id).note_done()
        order, _ = self._dispatch_order(None)
        rep = None
        engine_rid = None
        last_full = None
        for candidate in order:
            if candidate.replica_id == dead_id:
                continue
            try:
                engine_rid = candidate.engine.submit(
                    asg.prompt, **asg.kwargs)
            except QueueFull as err:
                last_full = err
                continue
            rep = candidate
            break
        if rep is None:
            if last_full is not None:
                raise last_full
            raise ReplicaDead(dead_id, asg.engine_rid)
        rep.note_dispatch()
        self.requeues += 1
        self._m_requeue.inc()
        # The replay carried the original tenant tag (it lives in
        # asg.kwargs); charge the requeue itself to that tenant on the
        # RECEIVING replica's ledger, where the rest of the request's
        # costs will now accrue.
        costs = getattr(rep.engine, "costs", None)
        if costs is not None:
            costs.record_requeue(asg.kwargs.get("tenant"))
        with self._lock:
            asg.replica_id = rep.replica_id
            asg.engine_rid = engine_rid
            # The replay is a plain submit — a prefill-stage
            # assignment degrades to mono on its new replica (its KV
            # export died with the old one).
            asg.stage = "mono"
            asg.resubmits += 1
            asg.t_engine = self.clock()
            if (asg.session is not None
                    and self._sessions.get(asg.session) == dead_id):
                self._sessions[asg.session] = rep.replica_id

    # -- actuation ---------------------------------------------------------

    def tick(self, now: Optional[float] = None,
             *, probe: bool = False) -> Dict[str, Any]:
        """One actuation pass (explicitly driven — no hidden thread).

        1. Close out drains whose replicas went idle; restart the
           canary-flagged ones (autoscaler drains stay down).
        2. Per serving replica: optionally fire one blackbox canary
           probe, refresh the latched burn alerts (shed state), and
           drain-and-restart any replica with fresh canary failures.
        3. Feed the worst serving burn to the autoscaler and actuate
           its decision.

        Returns a summary of what actuated, for benches and logs.
        """
        now = self.clock() if now is None else now
        actions: Dict[str, Any] = {
            "drain_finished": [], "restarted": [], "canary_drained": [],
            "scale": None,
        }
        for rep in list(self.replica_set.replicas.values()):
            if rep.state == DRAINING and rep.maybe_finish_drain():
                actions["drain_finished"].append(rep.replica_id)
                if rep.pending_restart and not rep.scale_down:
                    rep.restart(reason="canary")
                    actions["restarted"].append(rep.replica_id)
        for rep in self.replica_set.serving():
            if probe and rep.canary is not None:
                rep.canary.probe()
            rep.evaluate_alerts(now)
            fresh = (0 if rep.canary is None
                     else rep.canary.failures - rep.seen_canary_failures)
            if fresh >= self.canary_fail_threshold:
                rep.seen_canary_failures = rep.canary.failures
                rep.pending_restart = True
                rep.drain(reason="canary_failures")
                actions["canary_drained"].append(rep.replica_id)
        if self.autoscaler is not None:
            serving = self.replica_set.serving()
            if serving:
                burn = max(r.worst_burn() for r in serving)
                decision = self.autoscaler.observe(
                    burn=burn, n_replicas=len(serving), now=now)
                if decision == "up":
                    self.replica_set.spawn()
                elif decision == "down":
                    victim = min(
                        serving,
                        key=lambda r: (self.dispatch_cost(r),
                                       r.replica_id))
                    victim.scale_down = True
                    victim.drain(reason="scale_down")
                actions["scale"] = decision
        if self.rollout is not None:
            actions["rollout"] = self.rollout.tick(now)
        return actions

    # -- introspection -----------------------------------------------------

    def session_replica(self, session: str) -> Optional[str]:
        """Which replica holds this session's KV state (None if the
        session is unknown) — benches use it to aim kills."""
        with self._lock:
            return self._sessions.get(session)

    def replicas_doc(self) -> Dict[str, Any]:
        """The ``/replicas`` ops document: per-replica signal cards
        plus router counters and the autoscaler's policy card."""
        with self._lock:
            sessions = len(self._sessions)
            in_flight = len(self._assignments)
            affinity = {rid: dict(card)
                        for rid, card in self._affinity.items()}
        replicas: Dict[str, Any] = {}
        for rid, rep in self.replica_set.replicas.items():
            card = rep.signals()
            card["affinity"] = affinity.get(rid, {"hits": 0, "misses": 0})
            replicas[rid] = card
        return {
            "replicas": replicas,
            "router": {
                "requests": self.requests,
                "affinity_hits": self.affinity_hits,
                "affinity_misses": self.affinity_misses,
                "requeues": self.requeues,
                "handoffs": self.handoffs,
                "handoff_fails": self.handoff_fails,
                "preemptions": self.preemptions,
                "sessions": sessions,
                "in_flight": in_flight,
            },
            "autoscale": (None if self.autoscaler is None
                          else self.autoscaler.snapshot()),
        }

    @staticmethod
    def _pctl(samples: List[float], q: float) -> Optional[float]:
        if not samples:
            return None
        ordered = sorted(samples)
        idx = min(len(ordered) - 1,
                  int(q * len(ordered)))  # host-ok: host-side latencies
        return ordered[idx]

    def tiers_doc(self) -> Dict[str, Any]:
        """The ``/tiers`` ops document: per-tier membership and
        pressure, handoff latency/failure stats, and the QoS policy
        card. Publishing refreshes the ``fleet_tier_imbalance`` and
        ``fleet_handoff_seconds_p99`` gauges (the alert plane's
        inputs)."""
        tiers: Dict[str, Any] = {}
        for rep in self.replica_set.replicas.values():
            card = tiers.setdefault(rep.tier, {
                "replicas": [], "serving": 0,
                "avg_load": None, "avg_kv_pressure": None,
                "_loads": [], "_kv": []})
            card["replicas"].append(rep.replica_id)
            if rep.state == "serving":
                card["serving"] += 1
                card["_loads"].append(rep.load_score())
                card["_kv"].append(rep.kv_pressure())
        for card in tiers.values():
            loads, kv = card.pop("_loads"), card.pop("_kv")
            if loads:
                card["avg_load"] = sum(loads) / len(loads)
                card["avg_kv_pressure"] = sum(kv) / len(kv)
        avgs = [c["avg_load"] for c in tiers.values()
                if c["avg_load"] is not None]
        imbalance = (max(avgs) - min(avgs)) if len(avgs) >= 2 else 0.0
        self._g_imbalance.set(imbalance)
        samples = list(self._handoff_s)
        p50 = self._pctl(samples, 0.50)
        p99 = self._pctl(samples, 0.99)
        self._g_handoff_p99.set(0.0 if p99 is None else p99)
        return {
            "disagg_active": self._disagg_active(),
            "tiers": tiers,
            "imbalance": imbalance,
            "handoffs": {
                "count": self.handoffs,
                "fails": self.handoff_fails,
                "p50_ms": None if p50 is None else round(p50 * 1e3, 3),
                "p99_ms": None if p99 is None else round(p99 * 1e3, 3),
            },
            "preemptions": self.preemptions,
            "qos": None if self.qos is None else self.qos.snapshot(),
        }

    def mount_ops(self, port: int = 0, host: Optional[str] = None):
        """Serve the router's own ops endpoint (role ``router``): the
        fleet aggregator polls it like any process and picks the
        ``/replicas`` roster out of the tolerant scrape."""
        if self.ops is not None:
            return self.ops
        from elephas_tpu_torch.obs.opsd import OpsServer

        self.ops = OpsServer(
            port=port, host=host, role="router",
            vars_fn=lambda: {
                "role": "router",
                "replicas": len(self.replica_set),
                "serving": len(self.replica_set.serving()),
            },
            health_fn=lambda: {
                "healthy": bool(self.replica_set.serving()),
                "serving": len(self.replica_set.serving()),
                "requests": self.requests,
                "requeues": self.requeues,
            },
            slo_fn=self.slo.snapshot,
            replicas_fn=self.replicas_doc,
            tenants_fn=self._tenants_doc,
            tiers_fn=self.tiers_doc,
            rollout_fn=self._rollout_doc,
        ).start()
        return self.ops

    def attach_rollout(self, controller) -> None:
        """Adopt a ``RolloutController`` for this fleet: its ``doc()``
        serves the ops ``/rollout`` route (federated by the fleet
        aggregator), and each ``Router.tick`` drives one controller
        tick so delivery policy shares the router's actuation cadence.
        The controller stays usable standalone (``start_ticker``)."""
        self.rollout = controller

    def _rollout_doc(self) -> Dict[str, Any]:
        if self.rollout is None:
            return {"active": False, "phase": "idle",
                    "approved_version": None, "candidate_version": None,
                    "canary": None, "versions": {}, "skew": 0,
                    "events": [], "digest": None}
        return self.rollout.doc()

    def _tenants_doc(self) -> Dict[str, Any]:
        """Fleet-wide ``/tenants``: tenant-wise union of every serving
        replica's cost ledger (counters summed, goodput ratio = worst
        across replicas, burn = worst) — the same merge the
        ``FleetAggregator`` applies to scraped per-process docs."""
        from elephas_tpu_torch.obs.tenancy import merge_tenant_docs

        docs = []
        for rep in self.replica_set.serving():
            costs = getattr(rep.engine, "costs", None)
            if costs is not None and costs.tenants():
                costs.evaluate_alerts(self.clock())
                docs.append(costs.snapshot())
        return merge_tenant_docs(docs)

    def unmount_ops(self) -> None:
        if self.ops is not None:
            self.ops.stop()
            self.ops = None

    def close(self) -> None:
        """Teardown for benches/tests."""
        self.unmount_ops()
        self.replica_set.close()
