"""Multi-tenant QoS: token buckets, weighted fair share, priorities
(counterpart of ``elephas_tpu/serving/fleet/qos.py``).

The router's admission layer, sitting ABOVE per-replica queue
admission. Three mechanisms, composed in ``try_admit``:

1. **Token buckets** (per tenant): sustained rate + burst, denominated
   in *work units* (prompt tokens + decode budget — the same unit the
   cost ledger bills). A drained bucket throttles the tenant with
   ``AdmissionThrottled`` (a ``QueueFull`` subclass, so
   ``submit_with_retry``-style clients back off unchanged) carrying a
   ``retry_after`` computed from the refill rate, and an
   ``admission_throttle`` flight for the ops plane.

2. **Weighted fair share** (stride scheduling): every admit advances
   the tenant's virtual time by ``cost / weight``. A tenant whose
   vtime runs more than ``fairness_window`` ahead of the
   slowest active tenant is throttled even with bucket credit — burst
   capacity cannot buy an unfair share of a contended fleet.

3. **Priority classes**: class 0 (interactive) bypasses the fairness
   window and may *preempt* — when every replica's queue rejects a
   class-0 submit, the router cancels one still-QUEUED lower-priority
   request (``tenant_preempted`` flight) and retries in the freed
   slot. Admitted (slot-holding) work is never clawed back; the victim
   redispatches under its own fair share.

The policy is pure bookkeeping — it holds no queue and runs no thread;
the router calls it synchronously on each submit, which keeps the
whole QoS plane deterministic under a fake clock.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

from elephas_tpu_torch import obs
from elephas_tpu_torch.serving.scheduler import QueueFull
from elephas_tpu_torch.utils import locksan

__all__ = ["AdmissionThrottled", "QoSPolicy", "TokenBucket"]

#: Default sustained admission rate (work units / second) and burst
#: for tenants without an explicit bucket. Generous: QoS must be
#: invisible until someone configures it tighter.
DEFAULT_RATE = 1e6
DEFAULT_BURST = 1e6
#: Default fair-share window, in work units: how far one tenant's
#: weighted virtual time may run ahead of the slowest active tenant.
DEFAULT_FAIRNESS_WINDOW = 1e6
#: Priority class for tenants without an explicit one. Class 0 is
#: interactive (preempts); higher numbers yield earlier.
DEFAULT_PRIORITY = 1


class AdmissionThrottled(QueueFull):
    """QoS refused the submit (bucket drained or fair-share overdraft)
    — same retry contract as a replica's ``QueueFull``, so clients
    back off identically, but carries the tenant and reason so the
    caller can tell policy from capacity."""

    def __init__(self, tenant: str, reason: str, retry_after: float):
        RuntimeError.__init__(
            self,
            f"tenant {tenant!r} throttled ({reason}); retry after "
            f"{retry_after:.2f}s")
        self.tenant = tenant
        self.reason = reason
        self.retry_after = retry_after


class TokenBucket:
    """Classic leaky bucket in work units; caller supplies ``now``."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float, burst: float, now: float = 0.0):
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate/burst must be > 0, got {rate}/{burst}")
        self.rate = rate
        self.burst = burst
        self.tokens = burst
        self.last = now

    def refill(self, now: float) -> None:
        if now > self.last:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
        self.last = now

    def try_take(self, cost: float, now: float) -> Optional[float]:
        """Drain ``cost`` if covered; else return seconds until it
        would be (the throttle's ``retry_after``)."""
        self.refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            return None
        return (cost - self.tokens) / self.rate


class _TenantState:
    __slots__ = ("bucket", "weight", "priority", "vtime",
                 "admitted", "throttled", "preempted")

    def __init__(self, bucket: TokenBucket, weight: float, priority: int):
        self.bucket = bucket
        self.weight = weight
        self.priority = priority
        self.vtime = 0.0
        self.admitted = 0
        self.throttled = 0
        self.preempted = 0


class QoSPolicy:
    """Per-tenant admission policy for the fleet router.

    ``buckets`` maps tenant -> (rate, burst); ``weights`` maps tenant
    -> fair-share weight (default 1.0); ``priorities`` maps tenant ->
    class (0 preempts). Unknown tenants get the permissive defaults,
    so only configured tenants feel the policy.
    """

    def __init__(self, *,
                 buckets: Optional[Dict[str, Tuple[float, float]]] = None,
                 weights: Optional[Dict[str, float]] = None,
                 priorities: Optional[Dict[str, int]] = None,
                 fairness_window: float = DEFAULT_FAIRNESS_WINDOW,
                 clock: Callable[[], float] = time.monotonic):
        self.fairness_window = fairness_window
        self.clock = clock
        self._buckets = dict(buckets or {})
        self._weights = dict(weights or {})
        self._priorities = dict(priorities or {})
        self._tenants: Dict[str, _TenantState] = {}
        self._lock = locksan.make_lock("QoSPolicy._lock")

    # -- tenant state ------------------------------------------------------

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            rate, burst = self._buckets.get(
                tenant, (DEFAULT_RATE, DEFAULT_BURST))
            st = _TenantState(
                TokenBucket(rate, burst, self.clock()),
                self._weights.get(tenant, 1.0),
                self._priorities.get(tenant, DEFAULT_PRIORITY))
            # New tenants start at the fleet's current floor, not at
            # zero — joining late must not grant a huge vtime credit.
            if self._tenants:
                st.vtime = min(t.vtime for t in self._tenants.values())
            self._tenants[tenant] = st
        return st

    def priority(self, tenant: Optional[str]) -> int:
        if tenant is None:
            return DEFAULT_PRIORITY
        with self._lock:
            return self._state(tenant).priority

    # -- admission ---------------------------------------------------------

    def try_admit(self, tenant: Optional[str], cost: float) -> None:
        """Admit or raise ``AdmissionThrottled``. ``cost`` is in work
        units (prompt tokens + decode budget)."""
        if tenant is None:
            return  # untagged traffic bypasses QoS, like the ledger's
            # "default" tenant bypasses per-tenant budgets
        now = self.clock()
        with self._lock:
            st = self._state(tenant)
            floor = min(t.vtime for t in self._tenants.values())
            if (st.priority > 0
                    and st.vtime - floor > self.fairness_window):
                st.throttled += 1
                retry = (st.vtime - floor - self.fairness_window) \
                    / (st.bucket.rate * st.weight)
                err = AdmissionThrottled(tenant, "fair_share", retry)
            else:
                retry_after = st.bucket.try_take(cost, now)
                if retry_after is None:
                    st.admitted += 1
                    st.vtime += cost / st.weight
                    return
                st.throttled += 1
                err = AdmissionThrottled(tenant, "bucket", retry_after)
        obs.default_flight_recorder().note(
            "admission_throttle", "warn", tenant=tenant,
            reason=err.reason, cost=cost,
            retry_after=round(err.retry_after, 4))
        raise err

    def note_preempted(self, tenant: Optional[str]) -> None:
        """Bookkeeping when the router preempts this tenant's queued
        request (the router emits the ``tenant_preempted`` flight —
        it knows the victim/beneficiary pair; we only count)."""
        if tenant is None:
            return
        with self._lock:
            self._state(tenant).preempted += 1

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready per-tenant policy card for ``/tiers`` and
        an operator's QoS board."""
        now = self.clock()
        with self._lock:
            tenants: Dict[str, Any] = {}
            for name, st in sorted(self._tenants.items()):
                st.bucket.refill(now)
                tenants[name] = {
                    "bucket_fill": round(
                        st.bucket.tokens / st.bucket.burst, 4),
                    "rate": st.bucket.rate,
                    "burst": st.bucket.burst,
                    "weight": st.weight,
                    "priority": st.priority,
                    "vtime": round(st.vtime, 3),
                    "admitted": st.admitted,
                    "throttled": st.throttled,
                    "preempted": st.preempted,
                }
            return {
                "fairness_window": self.fairness_window,
                "tenants": tenants,
            }
