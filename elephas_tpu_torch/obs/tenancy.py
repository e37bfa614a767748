"""Per-tenant cost attribution: who is spending the fleet's resources.

Counterpart of ``elephas_tpu/obs/tenancy.py``, whose logic is framework-free;
the port keeps its own copy so that it imports nothing of the JAX package.

Every signal the observability arc built so far — load, SLO/goodput,
flight, fleet federation — is per-process or per-request; none of it
knows *who* is asking. The ROADMAP's multi-tenant QoS item needs that
answer before any admission policy can exist: you cannot fair-share
what you cannot attribute. This module is the accounting half:

- A ``tenant=`` tag enters at ``Router.submit`` / ``InferenceEngine.
  submit``, rides the ``Request`` object through the continuous-
  batching scheduler, the spec-decode harvest, and the router's
  requeue-on-death path (the tag lives in the assignment kwargs the
  requeue replays, so attribution survives mid-flight kills), and every
  cost site bills the tag's ``CostLedger`` row.
- ``CostLedger`` — per-tenant prefill vs decode tokens, queue seconds,
  KV **block-seconds** (integrated from ``PagedKVPool`` block occupancy
  per owner slot — the resource that actually saturates, so a noisy
  neighbor is visible in the unit it is stealing), spec-decode
  draft/accept counts, requeues, and terminal statuses. Untagged
  requests bill the ``"default"`` tenant — shared cost is still cost.
- A per-tenant view of the ``GoodputLedger``: each tenant gets
  its own windowed goodput/burn ledger (mirrored into private
  registries so the process-global ``serving_goodput_burn{objective=}``
  family keeps its schema), rolled up as
  ``serving_tenant_goodput_burn{objective=,tenant=}`` gauges plus a
  synthetic ``serving_goodput_burn{objective=,tenant=}`` metrics view
  (the ``_BurnMetricsView`` idiom from ``serving/fleet/replica.py``)
  that the tenancy alert pack evaluates: ``tenant_burn_high`` latches
  per tenant, and ``noisy_neighbor`` fires when one tenant holds more
  than ``NOISY_KV_SHARE`` of the pool's integrated block-seconds while
  at least one other tenant is paying for blocks too.

Read-out paths: ``snapshot()`` is the opsd ``/tenants`` document;
``merge_tenant_docs`` unions per-replica documents tenant-wise (counters
sum; goodput takes the worst burn / min ratio — a fleet-total burn
would be a lie) for the router's ``/tenants`` route and the
``FleetAggregator``'s fleet view; ``scripts/fleet_top.py`` renders the
TENANTS board from either.

Conservation is the design invariant the bench gates: token emission is
billed incrementally at the harvest sites, yet the sum over tenants of
``decode_tokens`` must equal ``ServingMetrics.tokens_out`` (counted
independently at finish from ``len(result.tokens)``), and the sum of
``prefill_tokens`` must equal the prompt tokens admitted. Attribution
that leaks under churn (kills, evictions, requeues) shows up as a
conservation failure, not a silent mis-bill.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from elephas_tpu_torch.obs.alerts import AlertEngine, AlertRule
from elephas_tpu_torch.obs.registry import MetricsRegistry
from elephas_tpu_torch.obs.slo import GoodputLedger, SLOObjective
from elephas_tpu_torch.utils import locksan

__all__ = [
    "CostLedger",
    "DEFAULT_TENANT",
    "NOISY_KV_SHARE",
    "TenantCosts",
    "merge_tenant_docs",
    "tenant_rules",
]

#: The tenant every untagged request bills. A real name, not a None:
#: shared cost rendered as a row is attributable; dropped cost is not.
DEFAULT_TENANT = "default"

#: ``noisy_neighbor`` threshold: the fraction of the pool's integrated
#: block-seconds one tenant must hold — while at least one *other*
#: tenant also holds blocks — for the alert to fire. A single-tenant
#: engine never has a neighbor to be noisy to.
NOISY_KV_SHARE = 0.75

#: Burn threshold for the per-tenant latched alert; matches the
#: fleet-wide ``goodput_burn_high`` working point (budget parity).
TENANT_BURN_WARN = 1.0


class TenantCosts:
    """One tenant's mutable cost row (plain counters, no lock — the
    owning ``CostLedger`` serializes access)."""

    __slots__ = (
        "submitted", "completed", "timed_out", "rejected", "requeues",
        "prefill_tokens", "cached_prefill_tokens", "decode_tokens",
        "queue_seconds", "kv_block_seconds", "cow_copies",
        "spec_windows", "spec_drafted", "spec_accepted", "spec_emitted",
    )

    def __init__(self):
        self.submitted = 0
        self.completed = 0
        self.timed_out = 0
        self.rejected = 0
        self.requeues = 0
        self.prefill_tokens = 0
        self.cached_prefill_tokens = 0
        self.decode_tokens = 0
        self.queue_seconds = 0.0
        self.kv_block_seconds = 0.0
        self.cow_copies = 0
        self.spec_windows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0

    def to_dict(self) -> Dict[str, Any]:
        drafted = self.spec_drafted
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "timed_out": self.timed_out,
            "rejected": self.rejected,
            "requeues": self.requeues,
            "prefill_tokens": self.prefill_tokens,
            "cached_prefill_tokens": self.cached_prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "queue_seconds": self.queue_seconds,
            "kv_block_seconds": self.kv_block_seconds,
            "cow_copies": self.cow_copies,
            "spec": {
                "windows": self.spec_windows,
                "drafted": drafted,
                "accepted": self.spec_accepted,
                "emitted": self.spec_emitted,
                "accept_rate": (self.spec_accepted / drafted
                                if drafted else None),
            },
        }


def tenant_rules() -> List[AlertRule]:
    """The tenancy alert pack, evaluated against the ledger's synthetic
    metrics view (see ``CostLedger.metrics_view``)."""
    return [
        # Per-tenant multi-window burn at budget parity: the same
        # AND-gate semantics as goodput_burn_high, latched per
        # (objective, tenant) child via the prefix match.
        AlertRule("tenant_burn_high", "serving_goodput_burn",
                  ">", TENANT_BURN_WARN, kind="tenant_burn",
                  severity="warn"),
        # One tenant is holding most of the KV pool's block-seconds
        # while somebody else is also paying for blocks: the classic
        # noisy neighbor, measured in the resource that saturates.
        AlertRule("noisy_neighbor", "serving_tenant_kv_share",
                  ">", NOISY_KV_SHARE, kind="noisy_neighbor",
                  severity="warn"),
    ]


class _TenantMetricsView:
    """Synthetic registry view for the tenancy ``AlertEngine``: exposes
    ``serving_goodput_burn{objective=,tenant=}`` and
    ``serving_tenant_kv_share{tenant=}`` keys built from the ledger
    (nothing is *registered*, so the process-global burn family keeps
    its ``{objective=}`` schema — the ``_BurnMetricsView`` idiom), while
    ``counter()`` delegates to the real default registry so
    ``alerts_fired_total`` aggregates normally."""

    def __init__(self, ledger: "CostLedger"):
        self._ledger = ledger

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for tenant, burns in self._ledger.burn().items():
            for objective, burn in burns.items():
                if burn is not None:
                    out[f'serving_goodput_burn{{objective="{objective}",'
                        f'tenant="{tenant}"}}'] = burn
        for tenant, share in self._ledger.kv_share().items():
            out[f'serving_tenant_kv_share{{tenant="{tenant}"}}'] = share
        return out

    def counter(self, *args, **kwargs):
        from elephas_tpu_torch import obs
        return obs.default_registry().counter(*args, **kwargs)


class CostLedger:
    """Per-tenant cost accounting (thread-safe).

    Scalar updates hold one small lock; per-tenant goodput records and
    registry mirrors run outside it (each surface takes its own lock),
    so attribution adds a dict lookup + integer adds to the hot paths.

    Parameters
    ----------
    clock: shared with the engine/scheduler so queue seconds and
        block-second integration replay deterministically under seeded
        fake clocks.
    objectives: the SLO pack each tenant's goodput ledger evaluates;
        defaults to the stock serving pack.
    registry: where the ``serving_tenant_goodput_burn`` mirror lands;
        None → the process default, resolved lazily (the standing
        latch idiom — a failed bind disables the mirror, it never
        takes the serving path down).
    """

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 objectives: Optional[Sequence[SLOObjective]] = None,
                 registry=None):
        self.clock = clock
        self._objectives = objectives
        self._registry = registry
        self._lock = locksan.make_lock("CostLedger._lock")
        self._tenants: Dict[str, TenantCosts] = {}
        self._goodput: Dict[str, GoodputLedger] = {}
        self._burn_gauge = None   # lazy family; False after failed bind
        self._alerts: Optional[AlertEngine] = None

    # -- row access ---------------------------------------------------------

    @staticmethod
    def resolve(tenant: Optional[str]) -> str:
        """Normalize a request tag: untagged bills ``default``."""
        return tenant if tenant else DEFAULT_TENANT

    def _row(self, tenant: Optional[str]) -> TenantCosts:
        name = self.resolve(tenant)
        row = self._tenants.get(name)
        if row is None:
            row = self._tenants.setdefault(name, TenantCosts())
        return row

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    # -- cost sites ---------------------------------------------------------

    def record_submit(self, tenant: Optional[str]) -> None:
        with self._lock:
            self._row(tenant).submitted += 1

    def record_reject(self, tenant: Optional[str]) -> None:
        with self._lock:
            self._row(tenant).rejected += 1

    def record_requeue(self, tenant: Optional[str]) -> None:
        """A mid-flight death sent this request back through dispatch —
        the tag survived; the hop is itself a billable event."""
        with self._lock:
            self._row(tenant).requeues += 1

    def record_queue(self, tenant: Optional[str], seconds: float) -> None:
        """Admission-queue residency, billed when the request leaves the
        queue (admitted, expired, or rejected-on-pop)."""
        with self._lock:
            self._row(tenant).queue_seconds += max(0.0, seconds)

    def record_prefill(self, tenant: Optional[str], tokens: int,
                       cached: int = 0) -> None:
        """Prompt tokens processed for this tenant; ``cached`` of them
        came from the prefix cache (paid for by whoever filled it —
        the discount is visible, not hidden)."""
        with self._lock:
            row = self._row(tenant)
            row.prefill_tokens += int(tokens)
            row.cached_prefill_tokens += int(cached)

    def record_decode(self, tenant: Optional[str], tokens: int = 1) -> None:
        """Tokens emitted (harvest sites bill incrementally; the sum
        over tenants must equal ``ServingMetrics.tokens_out``)."""
        with self._lock:
            self._row(tenant).decode_tokens += int(tokens)

    def record_spec(self, tenant: Optional[str], *, drafted: int,
                    accepted: int, emitted: int, windows: int = 1) -> None:
        """One tenant's share of a speculative-decode window."""
        with self._lock:
            row = self._row(tenant)
            row.spec_windows += int(windows)
            row.spec_drafted += int(drafted)
            row.spec_accepted += int(accepted)
            row.spec_emitted += int(emitted)

    def record_block_seconds(self, tenant: Optional[str],
                             seconds: float, *, cow: bool = False) -> None:
        """KV block-occupancy integral for one owner slot interval
        (``PagedKVPool`` bills these; a COW fork's fresh block bills the
        forking tenant from the copy instant)."""
        with self._lock:
            row = self._row(tenant)
            row.kv_block_seconds += max(0.0, seconds)
            if cow:
                row.cow_copies += 1

    def record_status(self, tenant: Optional[str], status: str) -> None:
        """Terminal status for one request (scheduler-side — bills ALL
        traffic, canaries included: a canary's tokens and blocks are
        real costs, and conservation vs ``ServingMetrics`` needs them)."""
        with self._lock:
            row = self._row(tenant)
            if status == "completed":
                row.completed += 1
            elif status == "timeout":
                row.timed_out += 1
            else:
                row.rejected += 1

    def record_goodput(self, result, now: Optional[float] = None) -> None:
        """One finished request into its tenant's goodput ledger (the
        engine's publish path drives this CANARY-BLIND, mirroring the
        fleet ledger — probe traffic must not move tenant burn)."""
        tenant = self.resolve(getattr(result, "tenant", None))
        with self._lock:
            ledger = self._goodput.get(tenant)
            if ledger is None:
                # Private registry per tenant ledger: its lazy
                # serving_goodput_burn{objective=} mirror must not
                # collide with the process-global family's schema.
                ledger = self._goodput.setdefault(tenant, GoodputLedger(
                    objectives=self._objectives, clock=self.clock,
                    registry=MetricsRegistry()))
        ledger.record(result, now=now)
        self._mirror_burn(tenant, ledger)

    # -- goodput / burn -----------------------------------------------------

    def _gauge(self):
        if self._burn_gauge is None:
            try:
                reg = self._registry
                if reg is None:
                    from elephas_tpu_torch import obs
                    reg = obs.default_registry()
                self._burn_gauge = reg.gauge(
                    "serving_tenant_goodput_burn",
                    help="per-tenant multi-window SLO burn rate (min of "
                         "fast/slow bad fraction over error budget)",
                    labelnames=("objective", "tenant"),
                )
            except Exception:
                self._burn_gauge = False
        return self._burn_gauge

    def _mirror_burn(self, tenant: str, ledger: GoodputLedger) -> None:
        gauge = self._gauge()
        if not gauge:
            return
        for objective, burn in ledger.burn().items():
            if burn is not None:
                gauge.labels(objective=objective, tenant=tenant).set(burn)

    def burn(self) -> Dict[str, Dict[str, Optional[float]]]:
        """tenant → objective → multi-window burn (None pre-traffic)."""
        with self._lock:
            ledgers = dict(self._goodput)
        return {t: ledger.burn() for t, ledger in sorted(ledgers.items())}

    def goodput_ratio(self) -> Dict[str, Optional[float]]:
        """tenant → worst lifetime objective ratio (fleet_top's roll-up
        number, per tenant)."""
        with self._lock:
            ledgers = dict(self._goodput)
        out: Dict[str, Optional[float]] = {}
        for tenant, ledger in sorted(ledgers.items()):
            defined = [v for v in ledger.goodput(None).values()
                       if v is not None]
            out[tenant] = min(defined) if defined else None
        return out

    def kv_share(self) -> Dict[str, float]:
        """tenant → fraction of total integrated block-seconds — only
        when more than one tenant holds a nonzero share (noisiness
        requires a neighbor)."""
        with self._lock:
            held = {t: row.kv_block_seconds
                    for t, row in self._tenants.items()
                    if row.kv_block_seconds > 0.0}
        if len(held) < 2:
            return {}
        total = sum(held.values())
        return {t: s / total for t, s in sorted(held.items())}

    # -- alerts -------------------------------------------------------------

    def evaluate_alerts(self, now: Optional[float] = None) -> List[Dict]:
        """Run the tenancy alert pack (``tenant_burn_high``,
        ``noisy_neighbor``) against the synthetic metrics view; breaches
        land in the flight recorder like every other alert."""
        if self._alerts is None:
            self._alerts = AlertEngine(registry=_TenantMetricsView(self),
                                       rules=tenant_rules(),
                                       clock=self.clock)
        return self._alerts.evaluate(now)

    def alerts_snapshot(self) -> Dict[str, Any]:
        if self._alerts is None:
            return {"rules": [r.to_dict() for r in tenant_rules()],
                    "active": [], "fired": [], "fired_kinds": []}
        return self._alerts.snapshot()

    # -- read-out -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The opsd ``/tenants`` document."""
        with self._lock:
            rows = {t: row.to_dict()
                    for t, row in sorted(self._tenants.items())}
        burns = self.burn()
        ratios = self.goodput_ratio()
        for tenant, row in rows.items():
            tb = burns.get(tenant, {})
            defined = [b for b in tb.values() if b is not None]
            row["goodput"] = {
                "ratio": ratios.get(tenant),
                "burn": tb,
                "burn_worst": max(defined) if defined else None,
            }
        totals: Dict[str, float] = {}
        for row in rows.values():
            for key in ("submitted", "completed", "timed_out", "rejected",
                        "requeues", "prefill_tokens",
                        "cached_prefill_tokens", "decode_tokens",
                        "queue_seconds", "kv_block_seconds", "cow_copies"):
                totals[key] = totals.get(key, 0) + row[key]
        return {
            "tenants": rows,
            "totals": totals,
            "kv_share": self.kv_share(),
            "alerts": self.alerts_snapshot(),
        }


def merge_tenant_docs(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Union N ``/tenants`` documents tenant-wise (the router's view
    over its replicas; the ``FleetAggregator``'s over its roster).

    Counters sum per tenant across documents; spec accept rate is
    recomputed from the summed counts; goodput keeps the **worst** burn
    and the **min** ratio (summing burn across replicas would be a lie
    the same way summing load scores is). Alert state unions with the
    per-document ``fired`` history concatenated.
    """
    tenants: Dict[str, Dict[str, Any]] = {}
    scalar_keys = ("submitted", "completed", "timed_out", "rejected",
                   "requeues", "prefill_tokens", "cached_prefill_tokens",
                   "decode_tokens", "queue_seconds", "kv_block_seconds",
                   "cow_copies")
    spec_keys = ("windows", "drafted", "accepted", "emitted")
    fired: List[Dict[str, Any]] = []
    active: List[Dict[str, Any]] = []
    for doc in docs:
        for name, row in (doc.get("tenants") or {}).items():
            acc = tenants.get(name)
            if acc is None:
                acc = tenants[name] = {k: 0 for k in scalar_keys}
                acc["spec"] = {k: 0 for k in spec_keys}
                acc["goodput"] = {"ratio": None, "burn_worst": None}
            for k in scalar_keys:
                acc[k] += row.get(k, 0)
            for k in spec_keys:
                acc["spec"][k] += (row.get("spec") or {}).get(k, 0)
            good = row.get("goodput") or {}
            ratio = good.get("ratio")
            if ratio is not None:
                prev = acc["goodput"]["ratio"]
                acc["goodput"]["ratio"] = (ratio if prev is None
                                           else min(prev, ratio))
            burn = good.get("burn_worst")
            if burn is not None:
                prev = acc["goodput"]["burn_worst"]
                acc["goodput"]["burn_worst"] = (burn if prev is None
                                                else max(prev, burn))
        alerts = doc.get("alerts") or {}
        fired.extend(alerts.get("fired") or [])
        active.extend(alerts.get("active") or [])
    for acc in tenants.values():
        drafted = acc["spec"]["drafted"]
        acc["spec"]["accept_rate"] = (acc["spec"]["accepted"] / drafted
                                      if drafted else None)
    totals: Dict[str, float] = {}
    for acc in tenants.values():
        for k in scalar_keys:
            totals[k] = totals.get(k, 0) + acc[k]
    return {
        "tenants": {t: tenants[t] for t in sorted(tenants)},
        "totals": totals,
        "alerts": {"active": active, "fired": fired,
                   "fired_kinds": sorted({a.get("kind") for a in fired
                                          if "kind" in a})},
        "merged_from": len(docs),
    }
