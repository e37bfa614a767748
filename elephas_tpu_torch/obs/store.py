"""Durable telemetry store: append-only segment journal for post-mortem.

Counterpart of ``elephas_tpu/obs/store.py``: the same on-disk format byte
for byte, so either package reads the other's journal.

Every other observability surface — flight ring, alert engine, history
rings, span tracer — lives in process memory; a SIGKILL loses all of it
except the ``flight-<boot>.json`` that only a *clean* ``kill()`` writes.
The telemetry store closes that gap: a per-process, append-only,
segment-rotated on-disk journal that the in-memory surfaces tee into at
event time, so "what happened, in what order" survives the process and
``obs/incident.py`` can rebuild the story from disk alone.

On-disk format (one directory per process slot, conventionally
``<wal_dir>/telemetry``): segment files named
``seg-<seq:08d>-<boot>.etj``, each a run of framed records —
``[ETJ1][u32 len][JSON body]`` — mirroring the packed wire codec's
magic + length framing (``parameter/wire.py``) at journal granularity.
Appends are ``write()+flush()`` per record (a killed *process* loses
nothing the kernel already holds; only a machine crash can lose the
unsynced tail), and ``fsync`` runs at segment rotation and ``sync()``,
so telemetry loss under SIGKILL is bounded to the current unsynced
segment. Like ``resilience/wal.py``, readers never trust the tail: a
torn final frame is walked past (and truncated on warm reopen), noted
as a ``store_corrupt_tail`` flight event.

Each record carries BOTH clocks (``wall_s`` + ``mono_s``) plus the boot
id and role, which is what lets ``IncidentBuilder`` clock-align N
processes' journals the way ``trace_report.merge_dumps`` aligns trace
dumps, and stitch a warm restart (same directory, new boot id) into one
story.

Disk is bounded: ``keep`` segments per boot, pruned oldest-first at
rotation, with the live total published as the ``obs_store_bytes``
gauge (per-role, lazily bound like the flight recorder's drop counter).

Record kinds journaled (``k`` field): ``flight`` (anomaly events at
``note()`` time), ``alert`` (fire/clear transitions), ``metric``
(HistorySampler ticks), ``span`` (completed span summaries),
``lifecycle`` (the store's own boot/close/heal marks — the roster
transitions of the post-mortem timeline).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple
from elephas_tpu_torch.utils import locksan

__all__ = [
    "TelemetryStore", "iter_records", "read_store", "scan_segment",
    "store_dirs", "RECORD_KINDS", "SEGMENT_SUFFIX",
]

_MAGIC = b"ETJ1"
_LEN = struct.Struct("!I")
_HEADER = len(_MAGIC) + _LEN.size
#: Per-record sanity bound — a length field past this is corruption,
#: not a record (records are small JSON; segments rotate at ~128 KiB).
_MAX_RECORD = 8 * 1024 * 1024

SEGMENT_SUFFIX = ".etj"

#: The journal's record vocabulary (the ``k`` field).
RECORD_KINDS = ("flight", "alert", "metric", "span", "lifecycle")


def _segment_name(seq: int, boot: str) -> str:
    return f"seg-{seq:08d}-{boot}{SEGMENT_SUFFIX}"


def _parse_segment_name(name: str) -> Optional[Tuple[int, str]]:
    """``(seq, boot)`` from a segment filename, None for foreign files."""
    if not (name.startswith("seg-") and name.endswith(SEGMENT_SUFFIX)):
        return None
    stem = name[len("seg-"):-len(SEGMENT_SUFFIX)]
    seq_s, sep, boot = stem.partition("-")
    if not sep or not seq_s.isdigit() or not boot:
        return None
    return int(seq_s), boot


def _frame(record: Dict[str, Any]) -> bytes:
    body = json.dumps(record, separators=(",", ":")).encode("utf-8")
    return _MAGIC + _LEN.pack(len(body)) + body


def scan_segment(path: str) -> Tuple[List[Dict[str, Any]], Optional[int]]:
    """Decode one segment, tolerating a torn tail.

    Returns ``(records, good_bytes)`` where ``good_bytes`` is None for a
    fully clean segment, else the byte offset of the last valid frame
    boundary — everything past it is a torn/corrupt tail (crash
    mid-append, partial flush). Mirrors ``SnapshotWAL.restore_latest``'s
    walk-past-the-corrupt-tail discipline at record granularity.
    """
    try:
        buf = Path(path).read_bytes()
    except OSError:
        return [], 0
    records: List[Dict[str, Any]] = []
    off = 0
    while off < len(buf):
        head = buf[off:off + _HEADER]
        if len(head) < _HEADER or head[:len(_MAGIC)] != _MAGIC:
            return records, off
        (length,) = _LEN.unpack(head[len(_MAGIC):])
        end = off + _HEADER + length
        if length > _MAX_RECORD or end > len(buf):
            return records, off
        try:
            rec = json.loads(buf[off + _HEADER:end].decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return records, off
        if not isinstance(rec, dict):
            return records, off
        records.append(rec)
        off = end
    return records, None


def iter_records(directory: str) -> Tuple[List[Dict[str, Any]], List[str]]:
    """All decodable records of one store directory, in append order
    (segment seq, then in-file order), plus the segment paths whose tail
    was corrupt. Purely read-only — safe on a dead process's directory
    and on foreign boots' segments alike."""
    d = Path(directory)
    segs = []
    for p in sorted(d.glob(f"seg-*{SEGMENT_SUFFIX}")):
        parsed = _parse_segment_name(p.name)
        if parsed is not None:
            segs.append((parsed[0], p))
    records: List[Dict[str, Any]] = []
    corrupt: List[str] = []
    for _, p in sorted(segs, key=lambda sp: (sp[0], sp[1].name)):
        recs, good = scan_segment(str(p))
        records.extend(recs)
        if good is not None:
            corrupt.append(str(p))
    return records, corrupt


def read_store(directory: str) -> Dict[str, Any]:
    """Post-mortem read-out of one store directory: records + disk
    stats, computable with the owning process long dead."""
    records, corrupt = iter_records(directory)
    d = Path(directory)
    nbytes = 0
    nsegs = 0
    for p in d.glob(f"seg-*{SEGMENT_SUFFIX}"):
        if _parse_segment_name(p.name) is not None:
            nsegs += 1
            try:
                nbytes += p.stat().st_size
            except OSError:
                pass
    return {
        "dir": str(d),
        "records": records,
        "segments": nsegs,
        "bytes": nbytes,
        "corrupt_tails": corrupt,
    }


def store_dirs(root: str) -> List[str]:
    """Discover store directories under ``root`` (any directory holding
    at least one segment file), sorted — the post-mortem CLI's walk."""
    out = set()
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            if _parse_segment_name(name) is not None:
                out.add(dirpath)
                break
    return sorted(out)


class TelemetryStore:
    """Append-only, segment-rotated, boot-tagged telemetry journal.

    One instance per process slot, mounted next to the WAL. Thread-safe:
    the teeing surfaces (flight recorder, alert engine, history sampler,
    tracer) append from their own threads. ``keep`` bounds disk per
    boot — rotation prunes THIS boot's oldest segments only, so a warm
    restart sharing the directory never eats a predecessor's evidence
    beyond its own budget.
    """

    def __init__(self, directory: str, role: str = "", boot: str = "",
                 keep: int = 8, segment_bytes: int = 128 * 1024,
                 recent: int = 64, clock=time.monotonic,
                 registry=None, flight=None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if segment_bytes < 1024:
            raise ValueError(
                f"segment_bytes must be >= 1024, got {segment_bytes}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.role = role
        self.boot = boot or os.urandom(6).hex()
        self.keep = keep
        self.segment_bytes = segment_bytes
        self.clock = clock
        self.flight = flight
        self._registry = registry
        self._gauge = None  # lazily bound (mirrors flight's drop counter)
        self._lock = locksan.make_lock("TelemetryStore._lock")
        self._seq = 0          # record sequence, this boot
        self._records = 0
        self._rotations = 0
        self._pruned = 0
        self._healed = 0
        self._last_wall: Optional[float] = None
        self._last_mono: Optional[float] = None
        self._recent: deque = deque(maxlen=recent)
        self._closed = False
        self._fh = None
        next_seg = self._heal_and_next_seq()
        # Byte accounting is incremental (per-record stat/glob would tax
        # the hot tee paths): foreign boots' bytes counted once at open,
        # own bytes tracked at append/prune.
        self._other_bytes = 0
        for p in self.directory.glob(f"seg-*{SEGMENT_SUFFIX}"):
            if _parse_segment_name(p.name) is not None:
                try:
                    self._other_bytes += p.stat().st_size
                except OSError:
                    pass
        self._my_bytes = 0
        self._seg_seq = next_seg
        self._seg_path = self.directory / _segment_name(next_seg, self.boot)
        self._seg_bytes = 0
        self._fh = open(self._seg_path, "ab")
        self.record_lifecycle("boot")

    # -- open-time healing -------------------------------------------------

    def _heal_and_next_seq(self) -> int:
        """Truncate torn tails of pre-existing segments (a predecessor
        boot died mid-append) and return the next free segment seq.

        Safe because segment files are single-writer (boot id in the
        name) and this store has not opened its own segment yet; a torn
        tail can only belong to a dead boot. Healing is noted loudly —
        a ``store_corrupt_tail`` flight event per truncated file."""
        max_seq = -1
        for p in sorted(self.directory.glob(f"seg-*{SEGMENT_SUFFIX}")):
            parsed = _parse_segment_name(p.name)
            if parsed is None:
                continue
            seq, boot = parsed
            max_seq = max(max_seq, seq)
            if boot == self.boot:
                continue
            _, good = scan_segment(str(p))
            if good is None:
                continue
            try:
                size = p.stat().st_size
                with open(p, "ab") as f:
                    f.truncate(good)
            except OSError:
                continue
            self._healed += 1
            if self.flight is not None:
                self.flight.note(
                    "store_corrupt_tail", "warn", path=p.name,
                    truncated_bytes=size - good, kept_bytes=good,
                )
        return max_seq + 1

    # -- append path -------------------------------------------------------

    def record(self, k: str, data: Dict[str, Any],
               wall_s: Optional[float] = None,
               mono_s: Optional[float] = None,
               severity: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """Journal one record. ``wall_s``/``mono_s`` default to now —
        pass the event's own stamps when teeing (the flight recorder
        already read both clocks at the anomaly site)."""
        if k not in RECORD_KINDS:
            raise ValueError(f"record kind must be one of {RECORD_KINDS}, "
                             f"got {k!r}")
        rec: Dict[str, Any] = {
            "k": k,
            "wall_s": time.time() if wall_s is None else wall_s,
            "mono_s": self.clock() if mono_s is None else mono_s,
            "boot": self.boot,
            "role": self.role,
            "seq": 0,  # patched under the lock
            "data": data,
        }
        if severity is not None:
            rec["severity"] = severity
        with self._lock:
            if self._closed:
                return None
            rec["seq"] = self._seq
            self._seq += 1
            frame = _frame(rec)
            if (self._seg_bytes and
                    self._seg_bytes + len(frame) > self.segment_bytes):
                self._rotate_locked()
            try:
                self._fh.write(frame)
                self._fh.flush()  # lock-ok: single-writer journal; write+flush is the record boundary
            except OSError:
                return None  # disk gone: telemetry must never crash hosts
            self._seg_bytes += len(frame)
            self._my_bytes += len(frame)
            self._records += 1
            self._last_wall = rec["wall_s"]
            self._last_mono = rec["mono_s"]
            self._recent.append(rec)
        self._set_gauge()
        return rec

    def _rotate_locked(self) -> None:
        """Seal the current segment (fsync — it becomes durable against
        machine crash, not just process death) and open the next."""
        try:
            self._fh.flush()  # lock-ok: segment seal; rotation must be atomic wrt writers
            os.fsync(self._fh.fileno())  # lock-ok: segment seal fsync
        except OSError:
            pass
        self._fh.close()
        self._seg_seq += 1
        self._seg_path = self.directory / _segment_name(self._seg_seq,
                                                        self.boot)
        self._fh = open(self._seg_path, "ab")
        self._seg_bytes = 0
        self._rotations += 1
        self._prune_locked()

    def _prune_locked(self) -> None:
        """keep-N per boot, oldest first — only THIS boot's segments."""
        mine = []
        for p in self.directory.glob(f"seg-*{SEGMENT_SUFFIX}"):
            parsed = _parse_segment_name(p.name)
            if parsed is not None and parsed[1] == self.boot:
                mine.append((parsed[0], p))
        for _, p in sorted(mine)[:-self.keep]:
            try:
                size = p.stat().st_size
                p.unlink()
                self._my_bytes -= size
                self._pruned += 1
            except OSError:
                pass

    def _set_gauge(self) -> None:
        gauge = self._gauge
        if gauge is None:
            try:
                registry = self._registry
                if registry is None:
                    from elephas_tpu_torch import obs

                    registry = obs.default_registry()
                gauge = registry.gauge(
                    "obs_store_bytes",
                    help="on-disk bytes of the durable telemetry store",
                    labelnames=("role",),
                )
            except Exception:
                gauge = False  # registry unavailable: stop trying
            self._gauge = gauge
        if gauge:
            gauge.labels(role=self.role or "unknown").set(
                float(self._other_bytes + self._my_bytes))

    # -- teeing convenience (one per journaled surface) --------------------

    def record_flight(self, event) -> None:
        """Tee one ``FlightEvent`` at ``note()`` time (its own stamps)."""
        self.record(
            "flight",
            {"kind": event.kind, "severity": event.severity,
             "trace_id": event.trace_id, "detail": event.detail},
            wall_s=event.wall_s, mono_s=event.mono_s,
            severity=event.severity,
        )

    def record_alert(self, transition: str, alert: Dict[str, Any]) -> None:
        """Tee one alert transition (``fire`` | ``clear``)."""
        self.record(
            "alert", dict(alert, transition=transition),
            severity=alert.get("severity") if transition == "fire"
            else "info",
        )

    def record_metrics(self, values: Dict[str, float], tick: int) -> None:
        """Tee one HistorySampler tick (the sampled name→value map)."""
        self.record("metric", {"values": values, "tick": tick})

    def record_span(self, summary: Dict[str, Any],
                    mono_s: Optional[float] = None) -> None:
        """Tee one completed span summary."""
        self.record("span", summary, mono_s=mono_s)

    def record_lifecycle(self, event: str, **detail) -> None:
        """Journal a store/process lifecycle mark (boot, close, ...)."""
        data: Dict[str, Any] = {"event": event}
        if self._healed and event == "boot":
            data["healed_tails"] = self._healed
        data.update(detail)
        self.record("lifecycle", data, severity="info")

    def set_role(self, role: str) -> None:
        """Re-stamp subsequent records (standby promotion). The old
        role's gauge child zeroes so the fleet view doesn't double-count
        a process that changed hats mid-boot."""
        old, self.role = self.role, role
        if old != role and self._gauge:
            try:
                self._gauge.labels(role=old or "unknown").set(0.0)
            except Exception:
                pass
        self._set_gauge()

    # -- durability + lifecycle --------------------------------------------

    def sync(self) -> None:
        """fsync the current segment (clean-shutdown / checkpoint hook)."""
        with self._lock:
            if self._closed:
                return
            try:
                self._fh.flush()  # lock-ok: durability barrier, serialized with writers by design
                os.fsync(self._fh.fileno())  # lock-ok: durability barrier
            except OSError:
                pass

    def close(self, reason: str = "close") -> None:
        """Final lifecycle record + fsync + close. Idempotent."""
        with self._lock:
            if self._closed:
                return
        self.record_lifecycle(reason)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._fh.flush()  # lock-ok: final seal before close
                os.fsync(self._fh.fileno())  # lock-ok: final seal before close
            except OSError:
                pass
            self._fh.close()

    # -- read-out ----------------------------------------------------------

    def disk_bytes(self) -> int:
        total = 0
        for p in self.directory.glob(f"seg-*{SEGMENT_SUFFIX}"):
            if _parse_segment_name(p.name) is not None:
                try:
                    total += p.stat().st_size
                except OSError:
                    pass
        return total

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            last_mono = self._last_mono
            out = {
                "dir": str(self.directory),
                "role": self.role,
                "boot": self.boot,
                "records": self._records,
                "segments": self._seg_seq + 1,
                "rotations": self._rotations,
                "pruned_segments": self._pruned,
                "healed_tails": self._healed,
                "last_record_wall_s": self._last_wall,
            }
        out["bytes"] = self.disk_bytes()
        out["last_record_age_s"] = (
            None if last_mono is None else max(0.0, self.clock() - last_mono)
        )
        return out

    def doc(self) -> Dict[str, Any]:
        """The ``/incidents`` ops route payload: live view of the local
        store — disk stats + the most recent records."""
        with self._lock:
            recent = list(self._recent)
        return {"meta": self.stats(), "recent": recent}
