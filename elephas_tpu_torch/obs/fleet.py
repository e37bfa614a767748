"""Metrics federation: one view over N per-process ops endpoints
(counterpart of ``elephas_tpu/obs/fleet.py``).

Everything the observability arc built so far (``/metrics``,
``/workers``, ``/alerts``, ``/trace``) is per-process; the ROADMAP's
replicated-serving and sharded-PS arcs are multi-process, and nobody
operates a fleet by curling N loopback ports by hand. This module is
the aggregation side:

- ``parse_prometheus_text`` — parses the exact exposition
  ``MetricsRegistry.expose_text()`` (or a stock Prometheus client)
  emits, including labeled families and cumulative histogram buckets.
  One wire format in and out: the aggregator speaks scrape text, not a
  private RPC, so any process with a ``/metrics`` route federates.
- ``ProcessRegistry`` — the roster. Each entry is one ops endpoint;
  its identity (role, boot id, worker_id, routes) comes from the
  endpoint's own ``/meta`` route at poll time, so a warm-restarted PS
  shows up under the same roster slot with a *new* boot id.
- ``FleetAggregator`` — polls every entry on an injectable clock and
  merges: counters **sum** across processes; gauges keep one child per
  process tagged ``proc=`` (summing queue depths across workers is a
  lie); fixed-bucket histograms merge **bucket-wise**, so fleet
  p50/p95/p99 are computed on the pooled distribution and stay within
  one bucket of exact — not an average of percentiles, which is
  statistically meaningless. ``/workers`` ledgers and ``/alerts``
  states roll up the same way.

Unreachable processes are **marked, never dropped**: a poll failure
flips the entry to ``stale``; once ``dead_after`` seconds pass since
its last successful poll it becomes ``dead``, and every flip lands in
the entry's transition log — a killed PS must read as *dead* in the
fleet view through the outage (``tests/test_torch_fleet_obs.py`` pins
exactly that), not silently vanish from a dashboard.

The merged view is served from opsd's ``/fleet`` route
(``OpsServer(fleet_fn=aggregator.snapshot)``).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "FleetAggregator",
    "ProcessEntry",
    "ProcessRegistry",
    "bucket_percentile",
    "merge_metrics",
    "parse_prometheus_text",
]

# Roster entry lifecycle (also the vocabulary chaos assertions key on).
STATUSES = ("unknown", "alive", "stale", "dead")


# ---------------------------------------------------------------------------
# Exposition parsing
# ---------------------------------------------------------------------------

def _parse_labels(body: str) -> Dict[str, str]:
    """``k="v",k2="v2"`` (brace-stripped) → dict, honoring exposition
    escapes (``\\\\``, ``\\"``, ``\\n``) in values."""
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.index("=", i)
        key = body[i:eq]
        if body[eq + 1] != '"':
            raise ValueError(f"unquoted label value at {body[eq:]!r}")
        j = eq + 2
        buf: List[str] = []
        while body[j] != '"':
            if body[j] == "\\":
                nxt = body[j + 1]
                buf.append({"n": "\n"}.get(nxt, nxt))
                j += 2
            else:
                buf.append(body[j])
                j += 1
        labels[key] = "".join(buf)
        i = j + 1
        if i < n and body[i] == ",":
            i += 1
    return labels


def _split_sample(line: str) -> Tuple[str, Dict[str, str], float]:
    """One exposition sample line → (name, labels, value)."""
    if "{" in line:
        name, rest = line.split("{", 1)
        # Label values are always quoted, so the labels block ends at
        # the last '"}' — robust to spaces/braces inside values.
        end = rest.rindex('"}')
        labels = _parse_labels(rest[:end + 1])
        value = float(rest[end + 2:].strip())
        return name, labels, value
    name, value = line.rsplit(None, 1)
    return name, {}, float(value)


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, Any]]:
    """Exposition text → ``{family_name: {"kind", "help", "samples",
    "histograms"}}``.

    ``samples`` is ``[(labels, value), ...]`` for counters/gauges (and
    untyped lines). ``histograms`` maps a canonical label key (le
    excluded) to ``{"labels", "bounds", "counts", "sum", "count"}`` with
    *per-bucket* (de-cumulated) counts plus a trailing +inf bucket —
    the shape bucket-wise merging wants.
    """
    families: Dict[str, Dict[str, Any]] = {}
    kinds: Dict[str, str] = {}
    helps: Dict[str, str] = {}

    def family(name: str) -> Dict[str, Any]:
        fam = families.get(name)
        if fam is None:
            fam = families[name] = {
                "kind": kinds.get(name, "untyped"),
                "help": helps.get(name, ""),
                "samples": [],
                "histograms": {},
            }
        return fam

    # First pass for TYPE/HELP so ordering never matters.
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            kinds[name] = kind
        elif line.startswith("# HELP "):
            parts = line.split(None, 3)
            helps[parts[2]] = parts[3] if len(parts) > 3 else ""

    hist_names = {n for n, k in kinds.items() if k == "histogram"}
    # Raw cumulative bucket rows: name → labelkey → [(bound, cum)], and
    # the matching _sum/_count scalars.
    buckets: Dict[str, Dict[str, Dict[str, Any]]] = {}

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, labels, value = _split_sample(line)
        base = None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in hist_names:
                base = name[:-len(suffix)]
                break
        if base is None:
            family(name)["samples"].append((labels, value))
            continue
        le = labels.pop("le", None)
        key = canonical_label_key(labels)
        row = buckets.setdefault(base, {}).setdefault(
            key, {"labels": labels, "cum": [], "sum": 0.0, "count": 0})
        if name.endswith("_bucket"):
            bound = float("inf") if le == "+Inf" else float(le)
            row["cum"].append((bound, value))
        elif name.endswith("_sum"):
            row["sum"] = value
        else:
            row["count"] = int(value)

    for base, rows in buckets.items():
        fam = family(base)
        for key, row in rows.items():
            cum = sorted(row["cum"])
            bounds = tuple(b for b, _ in cum if b != float("inf"))
            counts: List[int] = []
            prev = 0.0
            for _, c in cum:
                counts.append(int(c - prev))
                prev = c
            fam["histograms"][key] = {
                "labels": row["labels"],
                "bounds": bounds,
                "counts": counts,
                "sum": row["sum"],
                "count": row["count"],
            }
    return families


def canonical_label_key(labels: Dict[str, str]) -> str:
    """Deterministic ``{k="v",...}`` key (sorted); "" when unlabeled."""
    if not labels:
        return ""
    return "{" + ",".join(
        f'{k}="{labels[k]}"' for k in sorted(labels)) + "}"


def bucket_percentile(bounds: Tuple[float, ...], counts: List[int],
                      q: float) -> Optional[float]:
    """Quantile estimate from per-bucket counts (trailing +inf bucket).

    Linear interpolation inside the owning bucket, lower edge of the
    first bucket taken as 0 (every histogram in this package is a
    non-negative ladder — latencies, version lags, byte sizes). Without
    the per-process min/max the estimate can differ from
    ``Histogram.percentile`` by at most one bucket width — the merge
    tests pin exactly that tolerance.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0.0
    lower = min(0.0, bounds[0]) if bounds else 0.0
    for i, c in enumerate(counts):
        upper = bounds[i] if i < len(bounds) else bounds[-1]
        if c and cum + c >= rank:
            frac = (rank - cum) / c
            return lower + (upper - lower) * frac
        cum += c
        if i < len(bounds):
            lower = bounds[i]
    return bounds[-1] if bounds else None


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------

def merge_metrics(per_proc: Dict[str, Dict[str, Dict[str, Any]]]
                  ) -> Dict[str, Any]:
    """Merge parsed expositions from N processes (see module docstring
    for the per-kind semantics). ``per_proc`` maps proc name → the
    output of ``parse_prometheus_text``."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    untyped: Dict[str, float] = {}
    # name+labelkey → accumulated histogram (or per-proc on mismatch).
    hists: Dict[str, Dict[str, Any]] = {}
    unmerged: List[str] = []

    for proc in sorted(per_proc):
        for name, fam in sorted(per_proc[proc].items()):
            kind = fam["kind"]
            for labels, value in fam["samples"]:
                if kind == "counter":
                    key = name + canonical_label_key(labels)
                    counters[key] = counters.get(key, 0.0) + value
                else:
                    # Gauges (and untyped info lines) are per-process
                    # facts; summing them across processes is a lie.
                    tagged = dict(labels)
                    tagged["proc"] = proc
                    key = name + canonical_label_key(tagged)
                    (gauges if kind == "gauge" else untyped)[key] = value
            for lkey, h in sorted(fam["histograms"].items()):
                key = name + lkey
                acc = hists.get(key)
                if acc is None:
                    hists[key] = {
                        "bounds": h["bounds"],
                        "counts": list(h["counts"]),
                        "sum": h["sum"],
                        "count": h["count"],
                        "procs": [proc],
                    }
                elif acc["bounds"] == h["bounds"]:
                    acc["counts"] = [a + b for a, b in
                                     zip(acc["counts"], h["counts"])]
                    acc["sum"] += h["sum"]
                    acc["count"] += h["count"]
                    acc["procs"].append(proc)
                else:
                    # Bucket ladders disagree: bucket-wise merge would
                    # corrupt percentiles. Keep it per-proc, visibly.
                    tagged = key + f'[proc={proc}]'
                    hists[tagged] = {**h, "counts": list(h["counts"]),
                                     "procs": [proc]}
                    unmerged.append(tagged)

    histograms: Dict[str, Any] = {}
    for key, acc in sorted(hists.items()):
        histograms[key] = {
            "count": acc["count"],
            "sum": acc["sum"],
            "p50": bucket_percentile(acc["bounds"], acc["counts"], 0.50),
            "p95": bucket_percentile(acc["bounds"], acc["counts"], 0.95),
            "p99": bucket_percentile(acc["bounds"], acc["counts"], 0.99),
            "procs": acc["procs"],
        }
    return {
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "untyped": dict(sorted(untyped.items())),
        "histograms": histograms,
        "unmerged_histograms": sorted(unmerged),
    }


def _merge_workers(per_proc: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Cluster roll-up of /workers ledgers: union of worker rows
    (colliding ids get proc-qualified keys), summed totals."""
    workers: Dict[str, Any] = {}
    owner: Dict[str, str] = {}
    totals = {"total_updates": 0, "unstamped_updates": 0}
    for proc in sorted(per_proc):
        doc = per_proc[proc]
        for wid, row in sorted(doc.get("workers", {}).items()):
            if wid in workers and owner[wid] != proc:
                workers[f"{owner[wid]}/{wid}"] = workers.pop(wid)
                workers[f"{proc}/{wid}"] = row
            elif f"{proc}/{wid}" not in workers and wid not in workers:
                workers[wid] = row
                owner[wid] = proc
        for k in totals:
            totals[k] += int(doc.get(k, 0))
    return {"workers": workers, **totals}


def _merge_alerts(per_proc: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Cluster roll-up of /alerts scrapes: active breaches and fired
    history tagged with their process, plus summed counts."""
    active: List[Dict[str, Any]] = []
    fired: List[Dict[str, Any]] = []
    for proc in sorted(per_proc):
        doc = per_proc[proc]
        for a in doc.get("active", []):
            active.append({**a, "proc": proc})
        for a in doc.get("fired", []):
            fired.append({**a, "proc": proc})
    return {
        "active": active,
        "fired": fired,
        "fired_total": len(fired),
        "fired_kinds": sorted({a.get("kind") for a in fired if "kind" in a}),
    }


# ---------------------------------------------------------------------------
# Roster + aggregator
# ---------------------------------------------------------------------------

class ProcessEntry:
    """One roster slot: an ops endpoint plus its observed lifecycle."""

    __slots__ = ("name", "url", "meta", "status", "last_ok", "last_error",
                 "polls", "failures", "transitions", "scrape")

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.meta: Dict[str, Any] = {}
        self.status = "unknown"
        self.last_ok: Optional[float] = None
        self.last_error: Optional[str] = None
        self.polls = 0
        self.failures = 0
        # [(t, status), ...] — every status flip, for chaos assertions.
        self.transitions: List[Tuple[float, str]] = []
        # Last successful scrape bodies: {"metrics", "workers", "alerts"}.
        self.scrape: Dict[str, Any] = {}

    def _set_status(self, status: str, now: float) -> None:
        if status != self.status:
            self.status = status
            self.transitions.append((now, status))

    def to_dict(self, now: float) -> Dict[str, Any]:
        return {
            "url": self.url,
            "status": self.status,
            "meta": self.meta,
            "last_ok_s_ago": (None if self.last_ok is None
                              else now - self.last_ok),
            "last_error": self.last_error,
            "polls": self.polls,
            "failures": self.failures,
            "transitions": [[t, s] for t, s in self.transitions],
        }


class ProcessRegistry:
    """The fleet roster (thread-safe). Entries are added explicitly —
    by a bench, by an operator config, by whatever supervises the
    fleet — and are never removed by polling: death is a *state*."""

    def __init__(self):
        self._entries: Dict[str, ProcessEntry] = {}
        self._lock = threading.Lock()

    def add(self, url: str, name: Optional[str] = None) -> ProcessEntry:
        with self._lock:
            if name is None:
                name = f"proc{len(self._entries)}"
            entry = self._entries.get(name)
            if entry is None:
                entry = self._entries[name] = ProcessEntry(name, url)
            else:
                entry.url = url.rstrip("/")  # re-point a known slot
            return entry

    def get(self, name: str) -> Optional[ProcessEntry]:
        with self._lock:
            return self._entries.get(name)

    def entries(self) -> List[ProcessEntry]:
        with self._lock:
            return [self._entries[k] for k in sorted(self._entries)]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def _default_fetch(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


class FleetAggregator:
    """Polls the roster and serves the merged view (see module doc).

    ``poll()`` is explicitly driven on an injectable clock — by a bench
    loop, by an operator's dashboard, by tests — there is no hidden
    thread, so a seeded chaos run replays the exact same transition
    sequence. ``dead_after`` is the stale→dead promotion window,
    measured from the last *successful* poll.
    """

    def __init__(self, registry: Optional[ProcessRegistry] = None,
                 dead_after: float = 10.0, timeout: float = 2.0,
                 clock=time.monotonic,
                 fetch: Callable[[str, float], bytes] = _default_fetch):
        self.registry = registry if registry is not None else ProcessRegistry()
        self.dead_after = float(dead_after)
        self.timeout = float(timeout)
        self.clock = clock
        self.fetch = fetch
        self.polls = 0

    def add(self, url: str, name: Optional[str] = None) -> ProcessEntry:
        return self.registry.add(url, name=name)

    # -- polling ------------------------------------------------------------

    def _poll_one(self, entry: ProcessEntry, now: float) -> bool:
        try:
            meta = json.loads(self.fetch(f"{entry.url}/meta", self.timeout))
            metrics = parse_prometheus_text(
                self.fetch(f"{entry.url}/metrics", self.timeout).decode())
            workers = json.loads(
                self.fetch(f"{entry.url}/workers", self.timeout))
            alerts = json.loads(
                self.fetch(f"{entry.url}/alerts", self.timeout))
        except Exception as exc:
            entry.failures += 1
            entry.last_error = repr(exc)
            ref = entry.last_ok
            # Never been reachable → stale until dead_after from first
            # sighting of trouble; afterwards, from the last good poll.
            if ref is None and entry.transitions:
                ref = entry.transitions[0][0]
            if ref is not None and now - ref > self.dead_after:
                entry._set_status("dead", now)
            else:
                entry._set_status("stale", now)
            return False
        scrape = {"metrics": metrics, "workers": workers, "alerts": alerts}
        # Saturation/goodput routes are OPTIONAL per process: a roster
        # can mix newer engines with older procs (or fakes) that don't
        # serve them, and their absence must not fail the whole poll —
        # each is fetched in its own tolerant attempt.
        for route in ("/load", "/slo", "/replicas", "/incidents",
                      "/trials", "/tenants", "/tiers", "/rollout"):
            try:
                scrape[route[1:]] = json.loads(
                    self.fetch(f"{entry.url}{route}", self.timeout))
            except Exception:
                pass
        entry.meta = meta
        entry.scrape = scrape
        entry.last_ok = now
        entry.last_error = None
        entry._set_status("alive", now)
        return True

    def poll(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One pass over every roster entry; returns an ok/failed tally
        (bench loops time this call for the scrape-cost gate)."""
        if now is None:
            now = self.clock()
        ok = failed = 0
        for entry in self.registry.entries():
            entry.polls += 1
            if self._poll_one(entry, now):
                ok += 1
            else:
                failed += 1
        self.polls += 1
        return {"t": now, "ok": ok, "failed": failed}

    # -- read-out -----------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The merged fleet view — opsd's ``/fleet`` route serves this.

        Merges the *last-known* scrape of every entry (a dead PS keeps
        contributing its final counter values — dropping them would
        deflate fleet totals mid-outage) and labels each process with
        its current status so consumers can tell.
        """
        if now is None:
            now = self.clock()
        entries = self.registry.entries()
        per_metrics = {e.name: e.scrape["metrics"]
                       for e in entries if "metrics" in e.scrape}
        per_workers = {e.name: e.scrape["workers"]
                       for e in entries if "workers" in e.scrape}
        per_alerts = {e.name: e.scrape["alerts"]
                      for e in entries if "alerts" in e.scrape}
        # Per-proc saturation/goodput views: like gauges, these are NOT
        # summed (a fleet-total load score is a lie) — consumers key by
        # process name and read the status alongside.
        per_load = {e.name: e.scrape["load"]
                    for e in entries if "load" in e.scrape}
        per_slo = {e.name: e.scrape["slo"]
                   for e in entries if "slo" in e.scrape}
        # A serving router's /replicas roster: only procs that serve
        # the route (and returned a non-empty roster) contribute, so a
        # mixed fleet of engines + one router reads naturally.
        per_replicas = {e.name: e.scrape["replicas"]
                        for e in entries
                        if e.scrape.get("replicas", {}).get("replicas")}
        # Durable-store meta (/incidents): only procs with a mounted
        # telemetry store contribute — the fleet board's DISK column
        # reads bytes + last-persisted age from here.
        per_incidents = {e.name: e.scrape["incidents"]
                         for e in entries
                         if e.scrape.get("incidents", {}).get("meta")}
        # Tuner searches (/trials): only procs actually driving one
        # contribute (a non-empty trial table) — the board shows the
        # search through whichever process hosts the runner.
        per_trials = {e.name: e.scrape["trials"]
                      for e in entries
                      if e.scrape.get("trials", {}).get("trials")}
        # Per-tenant cost ledgers (/tenants): only procs with a live
        # ledger contribute (a non-empty tenant table). Counters union
        # tenant-wise across replicas — a tenant's fleet bill is the
        # sum of its per-replica bills — via the same merge the
        # router's own /tenants route uses.
        per_tenants = {e.name: e.scrape["tenants"]
                       for e in entries
                       if e.scrape.get("tenants", {}).get("tenants")}
        # Disaggregated tier topology (/tiers): only routers actually
        # running tiers contribute (a non-empty tier table) — like
        # /replicas, this is a per-router document, never summed.
        per_tiers = {e.name: e.scrape["tiers"]
                     for e in entries
                     if e.scrape.get("tiers", {}).get("tiers")}
        # Live-delivery plane (/rollout): only routers with an attached
        # RolloutController contribute (an active plane) — a per-router
        # document like /tiers, never summed.
        per_rollout = {e.name: e.scrape["rollout"]
                       for e in entries
                       if e.scrape.get("rollout", {}).get("active")}
        from elephas_tpu_torch.obs.tenancy import merge_tenant_docs
        merged_tenants = merge_tenant_docs(
            [per_tenants[k] for k in sorted(per_tenants)])
        status_counts: Dict[str, int] = {}
        for e in entries:
            status_counts[e.status] = status_counts.get(e.status, 0) + 1
        return {
            "t": now,
            "polls": self.polls,
            "dead_after_s": self.dead_after,
            "status_counts": status_counts,
            "processes": {e.name: e.to_dict(now) for e in entries},
            "metrics": merge_metrics(per_metrics),
            "workers": _merge_workers(per_workers),
            "alerts": _merge_alerts(per_alerts),
            "load": per_load,
            "slo": per_slo,
            "replicas": per_replicas,
            "incidents": per_incidents,
            "trials": per_trials,
            "per_tenants": per_tenants,
            "tenants": merged_tenants,
            "tiers": per_tiers,
            "rollout": per_rollout,
        }
