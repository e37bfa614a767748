"""PS durability: write-ahead version-tagged snapshots with warm restart
(counterpart of ``elephas_tpu/resilience/wal.py``).

The reference parameter server held weights in driver memory only — a PS
crash lost the fit (SURVEY.md §2.1/§5.3). ``SnapshotWAL`` gives the wire
servers a durable tail: after an update lands, the server (through
``WalWriter``) appends a **version-tagged snapshot** of the
``ParameterBuffer`` to disk, and a restarted server resumes from the
last durable version instead of its cold init.

On-disk format: one file per snapshot, named ``<version:016d>.epk``,
whose bytes are exactly one packed wire frame (``parameter.wire``:
``[EPK1][u32 hlen][JSON header][pad][payload]`` with ``ver`` in the
header). The port's codec is byte-identical to the JAX package's, so a
directory written by either package restores in the other. Writes go
tmp-file → fsync → atomic ``os.rename``, so a crash mid-append leaves at
worst a ``.tmp`` file, never a torn ``.epk``; ``restore_latest`` still
validates frames (magic + header + payload bounds) and walks past a
corrupt tail to the newest decodable snapshot.

On the card the snapshot is a copy to the host: ``WalWriter`` reads
``ParameterBuffer.get_host_with_version`` on the handler thread, which
hands the buffer's stream over to the thread's current stream before the
copy, so the file holds the applies that its version counts. The version
is read before the snapshot, so a racing hogwild apply can only make a
file newer than its name, never older.

Client reconciliation after a warm restart is the wire protocol's job:
a restarted server mints a fresh **boot id**, and the version-gated pull
requires (boot, version) to match before answering not-modified — so a
client whose cached version numerically collides with the restored
counter still receives a full body (see ``parameter/server.py``).

Cold start: an empty or missing WAL directory raises
``NoCheckpointError`` (``elephas_tpu_torch.checkpoint``) — callers
branch to their cold init on it.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import List, Optional, Tuple

from elephas_tpu_torch.checkpoint.checkpoint import NoCheckpointError
from elephas_tpu_torch.parameter import wire

_SUFFIX = ".epk"
_TMP_PREFIX = ".tmp-"


class SnapshotWAL:
    """Version-tagged snapshot log over the packed wire codec.

    ``keep`` bounds disk: after each append, all but the newest ``keep``
    snapshots are pruned. Appends are serialized by an internal lock
    (PS handler threads may race on the snapshot cadence).
    """

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()

    def _path(self, version: int) -> Path:
        return self.directory / f"{version:016d}{_SUFFIX}"

    def versions(self) -> List[int]:
        """Durable snapshot versions, ascending (filename-derived; a
        corrupt file is discovered at restore, not here)."""
        out = []
        for p in self.directory.glob(f"*{_SUFFIX}"):
            stem = p.name[: -len(_SUFFIX)]
            if stem.isdigit():
                out.append(int(stem))
        return sorted(out)

    def latest_version(self) -> Optional[int]:
        versions = self.versions()
        return versions[-1] if versions else None

    def versions_after(self, version: Optional[int]) -> List[int]:
        """Durable versions strictly newer than ``version``, ascending —
        the tail a streaming follower has not applied yet (``None``: the
        whole durable history). With ``wal_every > 1`` the counter is
        sparse on disk, so this counts unapplied snapshots honestly where
        ``latest - applied`` would over-report the lag."""
        if version is None:
            return self.versions()
        return [v for v in self.versions() if v > version]

    def read_version(self, version: int) -> Optional[bytes]:
        """Raw frame bytes of the durable snapshot at exactly ``version``
        (the pinned-read plane's source), or ``None`` when that version
        is not on disk: pruned past ``keep``, or never snapshotted (with
        ``wal_every > 1`` the durable counter is sparse). Servers relay
        the bytes verbatim; the client's decode validates them."""
        try:
            return self._path(version).read_bytes()
        except OSError:
            return None

    def append(self, tree, version: int) -> Path:
        """Durably persist ``tree`` (host leaves) tagged with ``version``:
        tmp-write → flush → fsync → atomic rename, so neither a reader nor
        a restart can observe a half-written snapshot under the final
        name. Idempotent per version — an existing snapshot at
        ``version`` is left alone."""
        final = self._path(version)
        with self._lock:
            if final.exists():
                return final
            frames = wire.encode_tree(tree, version=version)  # lock-ok: snapshot encode under the WAL lock is the atomic-publish protocol
            tmp = self.directory / f"{_TMP_PREFIX}{version:016d}-{os.getpid()}"
            with open(tmp, "wb") as f:
                for chunk in frames.chunks:
                    f.write(chunk)
                f.flush()  # lock-ok: tmp-file durability before the atomic rename
                os.fsync(f.fileno())  # lock-ok: tmp-file durability before the atomic rename
            os.rename(tmp, final)
            self._prune_locked()
        return final

    def _prune_locked(self) -> None:
        for version in self.versions()[: -self.keep]:
            try:
                self._path(version).unlink()
            except OSError:
                pass  # already gone (concurrent restart pruning)

    def restore_latest(self) -> Tuple[int, dict]:
        """``(version, tree)`` of the newest DECODABLE snapshot, its
        leaves CPU tensors. Walks versions newest-first, skipping
        truncated or corrupt files and frames whose version is not their
        name's; raises ``NoCheckpointError`` when nothing decodable
        remains — the caller's cold-start branch."""
        versions = self.versions()
        for version in reversed(versions):
            try:
                buf = bytearray(self._path(version).read_bytes())
                out = wire.decode(buf)
            except (OSError, wire.WireFormatError):
                continue
            if not isinstance(out, wire.DecodedTree) or out.version != version:
                continue
            return version, out.tree
        raise NoCheckpointError(
            f"no decodable snapshot under {self.directory} "
            f"({len(versions)} candidate file(s) scanned)"
        )


class WalWriter:
    """Snapshot cadence glue between a ``ParameterBuffer`` and its WAL.

    The PS servers call ``after_update()`` after each applied delta and
    BEFORE the ack: when the buffer is ``every`` or more versions past the
    last durable snapshot, the current state is appended synchronously —
    an acked update at a snapshot boundary is durable by the time the
    worker sees the ack, and the durability lag is at most ``every - 1``
    updates elsewhere. ``every=1`` (default) makes every acked update
    durable at the cost of a copy to the host, an encode and an fsync of
    the whole model per push. A write failure raises to the handler, so
    the push is never acked.
    """

    def __init__(self, buffer, wal: SnapshotWAL, every: int = 1):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.buffer = buffer
        self.wal = wal
        self.every = every
        self._lock = threading.Lock()
        self._last_written = wal.latest_version() or 0

    @property
    def last_written(self) -> int:
        return self._last_written

    def after_update(self) -> bool:
        """Maybe-snapshot; True iff a snapshot was written."""
        if self.buffer.version - self._last_written < self.every:
            return False
        with self._lock:
            version, snap = self.buffer.get_host_with_version()
            if version - self._last_written < self.every:
                return False  # a racing handler already wrote this window
            self.wal.append(snap, version)
            self._last_written = version
            return True

    def sync(self) -> int:
        """Force a snapshot of the buffer's current state (the server's
        clean-shutdown hook); returns the durable version."""
        with self._lock:
            version, snap = self.buffer.get_host_with_version()
            if version > self._last_written:
                self.wal.append(snap, version)
                self._last_written = version
            return self._last_written
