"""Post-mortem incident reconstruction from on-disk telemetry stores.

Counterpart of ``elephas_tpu/obs/incident.py``: the same timeline, digest
and markdown from the same journals.

``obs/store.py`` leaves one journal directory per process slot;
``IncidentBuilder`` walks N of them *after the fact* — every process may
be SIGKILLed and gone — and rebuilds the incident as one causally
ordered timeline:

1. **Clock alignment.** Each record carries both clocks (``wall_s`` +
   ``mono_s``). Per (directory, boot id) the builder computes a wall
   base as the median of ``wall_s - mono_s`` — the same
   clockSync arithmetic ``trace_report.merge_dumps`` uses on trace
   dumps (``wall_at_export - mono_at_export + origin_mono``), but
   estimated per record and median-smoothed so a wall-clock step during
   the run cannot skew the whole boot. Aligned time is then
   ``base + mono_s``: monotonic within a boot, comparable across
   processes.

2. **Cross-boot stitching.** A warm restart reuses the slot's directory
   with a fresh boot id; boots are ordered by first aligned record and
   indexed, so "same slot, new boot" reads as one story (the restart's
   ``lifecycle: boot`` record is labeled a warm restart).

3. **Cross-store dedup + attribution.** In single-process test/bench
   topologies every co-hosted server tees the shared flight recorder
   into its own store, so one anomaly can appear in N journals. The
   builder collapses copies by event identity and attributes the event:
   to the process whose boot id the event's detail names, else to the
   process whose store directory the event's path detail points into,
   else to a synthetic ``driver`` process (group orchestrators note
   from no server's context). In real one-process-per-store
   deployments this is a no-op.

4. **Triggering event + digest.** The trigger is the earliest
   ``error``-severity timeline entry (first ``warn`` as fallback). The
   incident digest is replay-stable and order-canonical: sha256 over
   the *sorted set* of stable identities (record kind, attributed role,
   event kind/rule/transition, severity) — timestamps, boot ids, pids,
   ports and repetition counts are all excluded, so two seeded runs of
   the same chaos arc produce the same digest while any new anomaly
   kind changes it.

Metric ticks and span summaries are counted and excerpted (ticks within
a window of the trigger join the timeline for context) but never enter
the digest — their values are timing-dependent by nature.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
from typing import Any, Dict, List, Optional, Tuple

from elephas_tpu_torch.obs import store as _store

__all__ = ["IncidentBuilder", "render_markdown"]

#: Detail keys that name the *origin boot* of a teed flight event.
_BOOT_KEYS = ("boot", "old_boot", "dead_boot")
#: Detail keys that name an on-disk path near the origin's store dir.
_PATH_KEYS = ("wal_dir", "path", "dir", "out_dir")

_TIMELINE_KINDS = ("flight", "alert", "lifecycle")


def _event_name(rec: Dict[str, Any]) -> str:
    """The human name of a timeline record: flight kind, alert
    rule:transition, or lifecycle event."""
    data = rec.get("data") or {}
    k = rec.get("k")
    if k == "flight":
        return str(data.get("kind", "?"))
    if k == "alert":
        return f"{data.get('rule', '?')}:{data.get('transition', '?')}"
    if k == "lifecycle":
        return str(data.get("event", "?"))
    return str(k)


class IncidentBuilder:
    """Walks N store directories and rebuilds one incident. Purely
    read-only over the directories — safe with every owner dead."""

    def __init__(self):
        self._stores: List[Tuple[str, str]] = []  # (name, dir)

    def add_store(self, directory: str, name: Optional[str] = None) -> str:
        """Register one store directory; returns the process name used
        (defaults to the directory path minus the ``/telemetry`` leaf)."""
        if name is None:
            d = os.path.normpath(directory)
            base = os.path.basename(d)
            name = (os.path.basename(os.path.dirname(d))
                    if base == "telemetry" else base) or d
        self._stores.append((name, directory))
        return name

    def discover(self, root: str) -> List[str]:
        """Register every store directory under ``root`` (named by their
        relative path); returns the names added."""
        names = []
        for d in _store.store_dirs(root):
            rel = os.path.relpath(d, root)
            if os.path.basename(rel) == "telemetry":
                rel = os.path.dirname(rel) or rel
            rel = rel.replace(os.sep, "/")
            names.append(self.add_store(d, name=rel if rel != "." else None))
        return names

    # -- the build ---------------------------------------------------------

    def build(self, metric_window_s: float = 2.0) -> Dict[str, Any]:
        procs: List[Dict[str, Any]] = []
        all_entries: List[Dict[str, Any]] = []
        metric_entries: List[Dict[str, Any]] = []
        counts: Dict[str, int] = {}
        boots_by_proc: Dict[str, List[str]] = {}

        for name, directory in self._stores:
            dump = _store.read_store(directory)
            by_boot: Dict[str, List[Dict[str, Any]]] = {}
            for rec in dump["records"]:
                counts[rec.get("k", "?")] = counts.get(rec.get("k", "?"),
                                                       0) + 1
                by_boot.setdefault(str(rec.get("boot", "?")),
                                   []).append(rec)
            # clockSync per boot: median wall base, aligned = base + mono.
            boot_meta = []
            for boot, recs in by_boot.items():
                base = statistics.median(
                    float(r.get("wall_s", 0.0)) - float(r.get("mono_s", 0.0))
                    for r in recs
                )
                for r in recs:
                    r["_t"] = base + float(r.get("mono_s", 0.0))
                recs.sort(key=lambda r: (r["_t"], r.get("seq", 0)))
                boot_meta.append({
                    "boot": boot,
                    "role": recs[-1].get("role", ""),
                    "records": len(recs),
                    "first_t": recs[0]["_t"],
                    "last_t": recs[-1]["_t"],
                })
            boot_meta.sort(key=lambda b: b["first_t"])
            for i, b in enumerate(boot_meta):
                b["boot_index"] = i
            index_of = {b["boot"]: b["boot_index"] for b in boot_meta}
            boots_by_proc[name] = [b["boot"] for b in boot_meta]

            for boot, recs in by_boot.items():
                for r in recs:
                    entry = {
                        "t": r["_t"],
                        "wall_s": r.get("wall_s"),
                        "mono_s": r.get("mono_s"),
                        "proc": name,
                        "role": r.get("role", ""),
                        "boot": boot,
                        "boot_index": index_of[boot],
                        "seq": r.get("seq", 0),
                        "k": r.get("k"),
                        "name": _event_name(r),
                        "severity": r.get("severity"),
                        "data": r.get("data") or {},
                    }
                    if entry["k"] in _TIMELINE_KINDS:
                        all_entries.append(entry)
                    elif entry["k"] == "metric":
                        metric_entries.append(entry)
            procs.append({
                "name": name,
                "dir": dump["dir"],
                "roles": sorted({b["role"] for b in boot_meta}),
                "boots": boot_meta,
                "records": len(dump["records"]),
                "bytes": dump["bytes"],
                "segments": dump["segments"],
                "corrupt_tails": len(dump["corrupt_tails"]),
            })

        deduped = self._dedupe_flight(all_entries, procs)
        timeline = [e for e in all_entries if not e.pop("_drop", False)]
        for e in timeline:
            if (e["k"] == "lifecycle" and e["name"] == "boot"
                    and e["boot_index"] > 0):
                e["name"] = "boot (warm restart)"
        timeline.sort(key=lambda e: (e["t"], e["proc"], e["boot_index"],
                                     e["seq"]))

        trigger = self._find_trigger(timeline)
        if trigger is not None and metric_entries:
            near = [e for e in metric_entries
                    if abs(e["t"] - trigger["t"]) <= metric_window_s]
            near.sort(key=lambda e: (e["t"], e["proc"], e["seq"]))
            timeline.extend(near[:20])
            timeline.sort(key=lambda e: (e["t"], e["proc"], e["boot_index"],
                                         e["seq"]))

        digest = self._digest(timeline)
        return {
            "stores": len(self._stores),
            "processes": procs,
            "counts": counts,
            "deduped_flight": deduped,
            "timeline": timeline,
            "triggering_event": trigger,
            "digest": digest,
            "boots_by_proc": boots_by_proc,
        }

    # -- internals ---------------------------------------------------------

    def _dedupe_flight(self, entries: List[Dict[str, Any]],
                       procs: List[Dict[str, Any]]) -> int:
        """Collapse cross-store copies of the same flight event; keep
        exactly one attributed copy per event (see module docstring)."""
        boots_of = {p["name"]: {b["boot"] for b in p["boots"]}
                    for p in procs}
        dir_of = {p["name"]: os.path.normpath(p["dir"]) for p in procs}
        groups: Dict[Tuple, List[Dict[str, Any]]] = {}
        for e in entries:
            if e["k"] != "flight":
                continue
            d = e["data"]
            key = (
                d.get("kind"),
                d.get("trace_id"),
                json.dumps(d.get("detail", {}), sort_keys=True),
                round(float(e.get("wall_s") or 0.0), 6),
                round(float(e.get("mono_s") or 0.0), 6),
            )
            groups.setdefault(key, []).append(e)
        deduped = 0
        for copies in groups.values():
            if len(copies) <= 1:
                continue
            keep = self._attribute(copies, boots_of, dir_of)
            for e in copies:
                if e is not keep:
                    e["_drop"] = True
                    deduped += 1
        return deduped

    @staticmethod
    def _attribute(copies: List[Dict[str, Any]],
                   boots_of: Dict[str, set],
                   dir_of: Dict[str, str]) -> Dict[str, Any]:
        detail = (copies[0]["data"] or {}).get("detail") or {}
        for key in _BOOT_KEYS:
            boot = detail.get(key)
            if not boot:
                continue
            for e in copies:
                if boot in boots_of.get(e["proc"], ()):
                    return e
        for key in _PATH_KEYS:
            path = detail.get(key)
            if not isinstance(path, str) or not path:
                continue
            norm = os.path.normpath(path)
            for e in copies:
                d = dir_of.get(e["proc"], "")
                # The store dir is <slot_dir>/telemetry; a detail path
                # anywhere under the slot dir claims the event.
                slot = os.path.dirname(d) or d
                if d and (norm == slot or norm.startswith(slot + os.sep)
                          or d.startswith(norm + os.sep) or d == norm):
                    return e
        # Orchestrator-noted event with no owning process: keep one
        # deterministic copy, re-attributed to the synthetic driver
        # slot so replays agree regardless of which stores saw it.
        keep = min(copies, key=lambda e: (e["proc"], e["boot_index"],
                                          e["seq"]))
        keep["proc"] = "(shared)"
        keep["role"] = "driver"
        return keep

    @staticmethod
    def _find_trigger(timeline: List[Dict[str, Any]]) -> Optional[Dict]:
        for floor in ("error", "warn"):
            for e in timeline:
                if e.get("severity") == floor:
                    return {
                        "kind": e["name"],
                        "k": e["k"],
                        "severity": e["severity"],
                        "proc": e["proc"],
                        "role": e["role"],
                        "t": e["t"],
                        "detail": (e["data"] or {}).get("detail",
                                                        e["data"]),
                    }
        return None

    @staticmethod
    def _digest(timeline: List[Dict[str, Any]]) -> str:
        """Replay-stable, order-canonical: sorted SET of stable
        identities — no timestamps, boots, pids, ports, counts."""
        idents = set()
        for e in timeline:
            if e["k"] not in _TIMELINE_KINDS:
                continue
            idents.add("|".join((
                str(e["k"]), str(e["role"]), str(e["name"]),
                str(e.get("severity")),
            )))
        blob = "\n".join(sorted(idents)).encode("utf-8")
        return hashlib.sha256(blob).hexdigest()[:16]


def render_markdown(incident: Dict[str, Any],
                    title: str = "Incident report") -> str:
    """One self-contained markdown post-mortem: header facts, the
    triggering event by name, per-process inventory, and the causally
    ordered timeline with times relative to the first entry."""
    lines = [f"# {title}", ""]
    trig = incident.get("triggering_event")
    timeline = incident.get("timeline", [])
    t0 = timeline[0]["t"] if timeline else 0.0
    lines.append(f"- stores: {incident.get('stores', 0)} process "
                 f"director{'y' if incident.get('stores') == 1 else 'ies'}")
    counts = incident.get("counts", {})
    lines.append("- records: " + ", ".join(
        f"{k}={counts[k]}" for k in sorted(counts)) if counts else
        "- records: none")
    if incident.get("deduped_flight"):
        lines.append(f"- cross-store flight copies collapsed: "
                     f"{incident['deduped_flight']}")
    if trig is not None:
        lines.append(
            f"- **triggering event**: `{trig['kind']}` "
            f"({trig['severity']}) on `{trig['role'] or trig['proc']}` "
            f"at t+{trig['t'] - t0:.3f}s"
        )
    else:
        lines.append("- **triggering event**: none found "
                     "(no warn/error records)")
    lines.append(f"- incident digest: `{incident.get('digest', '')}`")
    lines.append("")
    lines.append("## Processes")
    lines.append("")
    lines.append("| proc | role(s) | boots | records | bytes "
                 "| corrupt tails |")
    lines.append("|---|---|---|---|---|---|")
    for p in incident.get("processes", []):
        lines.append(
            f"| {p['name']} | {', '.join(p['roles'])} | "
            f"{len(p['boots'])} | {p['records']} | {p['bytes']} | "
            f"{p['corrupt_tails']} |"
        )
    lines.append("")
    lines.append("## Timeline")
    lines.append("")
    lines.append("| t (s) | proc | role | kind | severity | event |")
    lines.append("|---|---|---|---|---|---|")
    for e in timeline:
        if e["k"] == "metric":
            values = (e["data"] or {}).get("values", {})
            keys = sorted(values)[:3]
            event = "tick " + " ".join(
                f"{k}={values[k]:.4g}" for k in keys)
        else:
            event = e["name"]
            if e["boot_index"] > 0 and e["k"] != "lifecycle":
                event += f" (boot#{e['boot_index']})"
        marker = " **←trigger**" if (
            trig is not None and e["t"] == trig["t"]
            and e["name"] == trig["kind"] and e["proc"] == trig["proc"]
        ) else ""
        lines.append(
            f"| +{e['t'] - t0:.3f} | {e['proc']} | {e['role']} | "
            f"{e['k']} | {e.get('severity') or '-'} | {event}{marker} |"
        )
    lines.append("")
    return "\n".join(lines)
