"""Parameter servers: in-process (local), HTTP, and raw-socket transports
(counterpart of ``elephas_tpu/parameter/server.py``).

Reference: ``elephas/parameter/server.py::{HttpServer, SocketServer}``
(SURVEY.md §2.1): a Flask app with ``GET /parameters`` / ``POST /update``
or a threaded TCP server speaking ``'g'``/``'u'`` framed pickle messages,
locking iff mode is ``asynchronous``.

All three servers share one ``ParameterBuffer`` (the store on the card
plus the lock discipline); the HTTP/socket ones add a wire transport.
Flask is replaced by the stdlib ``ThreadingHTTPServer`` — same protocol,
no dependency. The wire protocol is the JAX package's, frame for frame:
either package's clients talk to either package's servers.

Wire data path:

- Pulls serve from a **version-gated snapshot cache** (``_SnapshotCache``):
  the tree is snapshotted under the buffer's read lock, copied to the
  host and encoded AFTER the lock is released, once per buffer version —
  N workers pulling an unchanged model cost ONE host copy and ONE
  encoding.
- Clients that advertise their last-seen ``(boot, version)`` get a
  12-byte **not-modified** frame when the buffer has not moved.
- Pushes are packed frames (or legacy pickle, told apart by magic), run
  through the bounded-staleness ``AdmissionPolicy`` and applied on the
  card.

Durability and crashes (wire transports):

- ``wal_dir``: a write-ahead log of version-tagged snapshots
  (``resilience/wal.py``). Construction warm-restarts the buffer from
  the newest durable snapshot; every accepted push is made durable
  BEFORE it is acked (at most ``wal_every - 1`` versions behind);
  ``stop()`` syncs the log, ``kill()`` does not.
- ``kill()`` simulates a crash: live connections are severed (the
  servers track them), the flight recorder notes ``ps_kill`` and dumps
  its ring next to the WAL.
- Version-PINNED pulls serve the live snapshot when the pin is the live
  version, else the WAL's frame at exactly that version, else the typed
  "unavailable" answer.
- ``shard_info``: the shard-group handshake document (``group.py``),
  served with the live boot id merged in.

Observability (wire transports):

- ``ops_port``: an ``obs.opsd.OpsServer`` mounts at ``start()`` (0 picks
  a free port; read ``.ops.url``) with a ``HistorySampler`` ticking once
  a second, a ``DeviceProfiler`` whose captures land next to the WAL,
  and the server's identity, membership, staleness ledger, alert engine,
  group topology (``shards_fn``) and telemetry store behind its routes.
- ``store_dir``: the durable telemetry journal (``obs.store``). ``"auto"``
  (the default) mounts at ``<wal_dir>/telemetry`` when there is a WAL
  and nowhere otherwise; ``None`` mounts nothing; an explicit directory
  mounts there. The flight recorder, the alert engine, a live tracer and
  the ops sampler tee into it; ``kill()`` journals ``ps_kill`` last.
"""

from __future__ import annotations

import hmac
import json
import os
import socket
import socketserver
import tempfile
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from elephas_tpu_torch import obs
from elephas_tpu_torch.checkpoint.checkpoint import NoCheckpointError
from elephas_tpu_torch.obs.health import record_staleness
from elephas_tpu_torch.parameter import wire
from elephas_tpu_torch.parameter.base import BaseParameterServer
from elephas_tpu_torch.parameter.buffer import ParameterBuffer
from elephas_tpu_torch.resilience.liveness import FailureDetector
from elephas_tpu_torch.resilience.wal import SnapshotWAL, WalWriter
from elephas_tpu_torch.utils import locksan
from elephas_tpu_torch.utils import sockets as socket_utils
from elephas_tpu_torch.utils.functional_utils import tree_map


def _ps_counters(transport: str):
    """(cache_hit, bytes_tx, bytes_rx) server-side data-path counters; the
    transport is a label of one family per direction."""
    reg = obs.default_registry()
    return (
        reg.counter("ps_cache_hit_total",
                    "pulls answered with a not-modified frame"),
        reg.counter("ps_bytes_tx_total",
                    "payload bytes sent by the PS servers",
                    labelnames=("transport",)).labels(transport=transport),
        reg.counter("ps_bytes_rx_total",
                    "payload bytes received by the PS servers",
                    labelnames=("transport",)).labels(transport=transport),
    )


def _lag_of(buffer, seen_version) -> Optional[int]:
    """One push's version lag (live version minus the version the worker
    trained against, clamped at 0); None for unstamped frames."""
    if seen_version is None:
        return None
    try:
        return max(0, int(buffer.version) - int(seen_version))
    except (TypeError, ValueError):
        return None


def _note_staleness(ledger, worker, lag, seen_version, nbytes,
                    sync_interval=None) -> None:
    """Feed one APPLIED push into the ledger and the labeled histogram
    (rejected pushes never reach here: ``_admit`` records those)."""
    record_staleness(ledger, worker, lag, nbytes=nbytes, version=seen_version,
                     registry=obs.default_registry(), sync_interval=sync_interval)


def _parse_trace_header(raw: Optional[str]):
    """``X-Elephas-Trace: <trace_id>-<span_id>`` → TraceContext | None;
    malformed values are dropped, never fatal."""
    if not raw:
        return None
    trace_id, sep, span_id = raw.partition("-")
    if not sep or not trace_id or not span_id:
        return None
    return obs.TraceContext(trace_id, span_id)


def _as_trace_ctx(tc):
    """A wire-carried ``(trace_id, span_id)`` pair → TraceContext | None."""
    if (isinstance(tc, (tuple, list)) and len(tc) == 2
            and all(isinstance(x, str) for x in tc)):
        return obs.TraceContext(tc[0], tc[1])
    return None


def _new_boot_id() -> str:
    """Per-server-instance boot id: version-gated pulls are keyed on
    ``(boot, version)``, so a restarted server never aliases a client's
    cached version."""
    return os.urandom(6).hex()


def _heartbeat_timeout(explicit: Optional[float] = None) -> float:
    """Suspect threshold for the failure detector, seconds: explicit >
    ``ELEPHAS_HEARTBEAT_TIMEOUT`` > 5.0 (a malformed env value warns)."""
    if explicit is not None:
        return float(explicit)
    raw = os.environ.get("ELEPHAS_HEARTBEAT_TIMEOUT", "5")
    try:
        return float(raw)
    except ValueError:
        warnings.warn(
            f"ELEPHAS_HEARTBEAT_TIMEOUT={raw!r} is not a number; "
            "using the 5.0s default",
            RuntimeWarning,
            stacklevel=2,
        )
        return 5.0


def _staleness_bound(explicit, env_var: str) -> Optional[int]:
    """Optional staleness bound, versions: explicit > env var > None
    (a malformed env value warns and disables the bound)."""
    if explicit is not None:
        return int(explicit)
    raw = os.environ.get(env_var)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        warnings.warn(
            f"{env_var}={raw!r} is not an integer; staleness bound "
            "disabled",
            RuntimeWarning,
            stacklevel=2,
        )
        return None


class AdmissionPolicy:
    """Accept / damp / reject one stamped delta by its version lag.

    - ``lag <= soft`` (or no bounds set): **accept** at full weight;
    - ``soft < lag <= max_staleness``: **damp** — applied scaled by
      ``1 / (1 + lag - soft)`` (DeepSpark's staleness decay);
    - ``lag > max_staleness``: **reject** — not applied; the pusher gets
      a typed ``wire.encode_rejected`` frame.

    Unstamped pushes (``lag=None``) are always accepted. Bounds resolve
    as explicit argument > ``ELEPHAS_MAX_STALENESS`` /
    ``ELEPHAS_STALENESS_SOFT`` > None.
    """

    def __init__(self, max_staleness: Optional[int] = None,
                 soft: Optional[int] = None):
        self.max_staleness = _staleness_bound(
            max_staleness, "ELEPHAS_MAX_STALENESS")
        self.soft = _staleness_bound(soft, "ELEPHAS_STALENESS_SOFT")

    def decide(self, lag: Optional[int]):
        """``(verdict, weight)``: ``("accept", 1.0)``, ``("damp", w<1)``,
        or ``("reject", 0.0)``."""
        if lag is None:
            return "accept", 1.0
        if self.max_staleness is not None and lag > self.max_staleness:
            return "reject", 0.0
        if self.soft is not None and lag > self.soft:
            return "damp", 1.0 / (1.0 + (lag - self.soft))
        return "accept", 1.0

    def __repr__(self):
        return (f"AdmissionPolicy(max_staleness={self.max_staleness}, "
                f"soft={self.soft})")


def _scale_tree(tree, weight: float):
    """Scale a delta's float leaves by the damping weight; other leaves
    (counters) pass through unscaled."""
    def scale(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf * weight
        return leaf

    return tree_map(scale, tree)


def _admit(policy, ledger, worker, lag, tree, transport: str, hsp=None):
    """Run one stamped push through the admission policy: ``(verdict,
    tree)``, the tree scaled for a damp and ``None`` for a reject. Every
    non-accept decision lands in the counters, the ledger and (rejects)
    the flight recorder."""
    verdict, weight = policy.decide(lag)
    if verdict == "accept":
        return verdict, tree
    reg = obs.default_registry()
    if verdict == "damp":
        reg.counter("ps_delta_damped_total",
                    "stamped deltas applied at reduced weight by the "
                    "staleness admission policy").inc()
        ledger.record_damped(worker)
        if hsp:
            hsp.note(admission="damp", weight=round(weight, 4))
        return verdict, _scale_tree(tree, weight)
    reg.counter("ps_delta_rejected_total",
                "stamped deltas refused by the staleness admission policy",
                labelnames=("reason",)).labels(reason="max_staleness").inc()
    ledger.record_rejected(worker)
    obs.default_flight_recorder().note(
        "delta_rejected", "warn", worker=worker, lag=lag,
        max_staleness=policy.max_staleness, transport=transport,
    )
    if hsp:
        hsp.note(admission="reject", lag=lag)
    return verdict, None


def _make_detector(heartbeat_timeout: Optional[float]):
    return FailureDetector(suspect_after=_heartbeat_timeout(heartbeat_timeout))


def _attach_wal(buffer: ParameterBuffer, wal_dir: str, wal_every: int,
                wal_keep: int = 3) -> WalWriter:
    """Warm-restart ``buffer`` from the newest durable WAL snapshot and
    return the ``WalWriter`` that keeps the log moving. Cold start (an
    empty or wholly corrupt directory) keeps the constructor's params and
    a fresh version line."""
    wal = SnapshotWAL(wal_dir, keep=wal_keep)
    try:
        version, tree = wal.restore_latest()
    except NoCheckpointError:
        pass  # cold start: serve the constructor params
    else:
        buffer.set(tree, version=version)
        obs.default_flight_recorder().note(
            "wal_restore", "info", version=version, wal_dir=wal_dir,
        )
    return WalWriter(buffer, wal, every=wal_every)


class _SnapshotCache:
    """Serialize once per ``ParameterBuffer.version``, outside the lock.

    ``frames(codec)`` returns ``(version, payload)``: a reusable
    ``wire.Frames`` (packed) or ``bytes`` (legacy pickle). The snapshot
    is taken under the buffer's read lock; the copy to the host and the
    encoding run after its release, single-flighted by a private lock.
    """

    def __init__(self, buffer: ParameterBuffer, boot: Optional[str] = None):
        self._buffer = buffer
        self._boot = boot
        self._encode_lock = locksan.make_lock("_SnapshotCache._encode_lock")
        self._entries: dict = {}  # codec -> (version, frames|bytes)

    def frames(self, codec: str):
        entry = self._entries.get(codec)
        if entry is not None and entry[0] == self._buffer.version:
            return entry
        with self._encode_lock:
            entry = self._entries.get(codec)
            if entry is not None and entry[0] == self._buffer.version:
                return entry
            version, snap = self._buffer.get_host_with_version()
            if codec == "packed":
                payload = wire.encode_tree(snap, version=version, boot=self._boot)  # lock-ok: single-flight encode; the lock exists to dedupe this work
            else:
                payload = wire.encode_pickle(snap)  # lock-ok: single-flight encode
            entry = (version, payload)
            self._entries[codec] = entry
            return entry


def _pinned_payload(cache: _SnapshotCache, wal_writer, version: int):
    """Payload of a version-PINNED pull: the live frame when the pin is
    the buffer's current version, else the WAL's frame at exactly that
    version, else ``None`` (the client's ``VersionUnavailable``). Pinned
    reads skip the not-modified negotiation: the caller wants these
    bytes whatever its cached position."""
    live, frames = cache.frames("packed")
    if live == version:
        return frames
    if wal_writer is not None:
        raw = wal_writer.wal.read_version(version)
        if raw is not None:
            return socket_utils.RawPayload([raw])
    return None


def _dump_flight_on_kill(boot: str, wal_dir: Optional[str]) -> Optional[str]:
    """Crash-path flight-recorder dump: next to the WAL when there is
    one, else the temporary directory. Best effort — a full disk must
    not mask the kill itself."""
    recorder = obs.default_flight_recorder()
    if not recorder.enabled:
        return None
    base = wal_dir if wal_dir else tempfile.gettempdir()
    try:
        return recorder.dump(os.path.join(base, f"flight-{boot}.json"))
    except OSError:
        return None


def _default_bind_host() -> str:
    """Loopback unless ``ELEPHAS_PS_BIND`` says otherwise: the wire
    servers speak pickle, so exposure beyond the host is opt-in."""
    return os.environ.get("ELEPHAS_PS_BIND", "127.0.0.1")


def _dial_host(bind_host: str) -> str:
    """Address a same-host client dials for a server bound to ``bind_host``."""
    if bind_host in ("", "0.0.0.0", "::", "*"):
        return "127.0.0.1"
    return bind_host


class LocalServer(BaseParameterServer):
    """In-process server: workers share the buffer on the card directly;
    a pull hands out device tensors (no host copy), a push subtracts on
    the card."""

    def __init__(self, params, lock: bool = True, device=None,
                 granularity: str = "tree",
                 heartbeat_timeout: Optional[float] = None):
        self.buffer = ParameterBuffer(params, lock=lock, device=device,
                                      granularity=granularity)
        self.detector = _make_detector(heartbeat_timeout)

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def get_parameters(self):
        return self.buffer.get()

    def client(self):
        from elephas_tpu_torch.parameter.client import LocalClient

        return LocalClient(self.buffer, detector=self.detector)


class _BarrierBook:
    """Named arrival counters — the PS doubles as a cross-host control
    plane (a host "arrives" at a tag; peers poll the count)."""

    def __init__(self):
        self._counts: dict = {}
        self._lock = threading.Lock()

    def arrive(self, tag: str) -> int:
        with self._lock:
            self._counts[tag] = self._counts.get(tag, 0) + 1
            return self._counts[tag]

    def count(self, tag: str) -> int:
        with self._lock:
            return self._counts.get(tag, 0)


def _read_exact(stream, length: int) -> bytearray:
    """``length`` bytes of ``stream`` into one writable buffer (decoded
    leaves view it without a copy)."""
    buf = bytearray(length)
    view, pos = memoryview(buf), 0
    while pos < length:
        got = stream.readinto(view[pos:])
        if not got:
            raise ConnectionError("stream closed mid-body")
        pos += got
    return buf


class _WireServer(BaseParameterServer):
    """What the HTTP and socket servers share: the buffer, auth, the
    barrier book, the boot id, the failure detector, the staleness
    ledger, the alert engine, the admission policy, the WAL and the
    crash path.

    ``wal_dir``: write-ahead snapshot directory (``resilience/wal.py``):
    construction warm-restarts from it, every accepted push is durable
    before its ack, at most ``wal_every`` versions behind; the newest
    ``wal_keep`` snapshots stay on disk (the pinned-pull window).
    ``role``: the fleet role stamp (``ps``; ``ps/shard<i>`` and
    ``ps/standby`` in a group). ``shard_info``: the group handshake
    document (``{digest, shard, k}``), served with the live boot id
    merged in; unset, sharded clients refuse this server.
    ``ops_port``/``store_dir``: the ops endpoint and the telemetry
    journal (module docstring)."""

    def __init__(self, params, lock: bool = True, port: int = 4000, device=None,
                 host: Optional[str] = None, granularity: str = "tree",
                 auth_key: Optional[bytes] = None, heartbeat_timeout: Optional[float] = None,
                 tracer=None, max_staleness: Optional[int] = None,
                 staleness_soft: Optional[int] = None, wal_dir: Optional[str] = None,
                 wal_every: int = 1, wal_keep: int = 3, role: str = "ps",
                 shard_info: Optional[dict] = None, ops_port: Optional[int] = None,
                 store_dir: Optional[str] = "auto"):
        self.buffer = ParameterBuffer(params, lock=lock, device=device,
                                      granularity=granularity)
        self.host = host if host is not None else _default_bind_host()
        self.port = port
        self.auth_key = auth_key
        self.replay_guard = socket_utils.ReplayGuard() if auth_key else None
        self.barriers = _BarrierBook()
        self.boot = _new_boot_id()
        self.detector = _make_detector(heartbeat_timeout)
        self.tracer = tracer
        self.ledger = obs.StalenessLedger()
        self.alerts = obs.AlertEngine()
        self.admission = AdmissionPolicy(max_staleness, staleness_soft)
        self.wal_writer = (_attach_wal(self.buffer, wal_dir, wal_every, wal_keep)
                           if wal_dir else None)
        self.role = role
        self.shard_info = shard_info
        self.flight_dump: Optional[str] = None
        self._wal_dir = wal_dir
        self.ops_port = ops_port
        self.ops = None
        self._ops_history = None
        self._ops_profiler = None
        self.shards_fn = None  # a group stamps its topology doc here
        self._server = None
        self._thread = None
        self._attach_telemetry_store(store_dir)

    def _tracer(self):
        # Resolved per use: an enable_tracing() after start() is seen.
        return self.tracer if self.tracer is not None else obs.default_tracer()

    def _attach_telemetry_store(self, store_dir) -> None:
        """Mount the durable telemetry journal next to the WAL: the
        process flight recorder and this server's alert engine tee into
        it from construction on, so anomalies before ``start()`` (WAL
        restore, tail healing) are journaled too. An explicit directory
        mounts there regardless of the WAL — a group's standbys share
        their shard's ``wal_dir`` but must not share its journal
        (open-time tail healing assumes one live writer a directory)."""
        self.store = None
        if store_dir == "auto":
            store_dir = (os.path.join(self._wal_dir, "telemetry")
                         if self._wal_dir else None)
        if store_dir is None:
            return
        self.store = obs.TelemetryStore(store_dir, role=self.role, boot=self.boot,
                                        flight=obs.default_flight_recorder())
        obs.default_flight_recorder().attach_store(self.store)
        self.alerts.attach_store(self.store)
        tracer = self._tracer()
        if getattr(tracer, "enabled", False):
            tracer.attach_store(self.store)

    def _close_store(self, reason: str) -> None:
        store = self.store
        if store is None:
            return
        obs.default_flight_recorder().detach_store(store)
        self.alerts.detach_store(store)
        if self._ops_history is not None:
            self._ops_history.detach_store(store)
        tracer = self._tracer()
        if hasattr(tracer, "detach_store"):
            tracer.detach_store(store)
        store.close(reason=reason)
        self.store = None

    def _mount_ops(self, transport: str) -> None:
        """Mount the ops endpoint (``ops_port`` set): the history sampler
        ticks on a daemon thread whether or not anyone scrapes, profiler
        captures land next to the WAL — one directory an incarnation holds
        the flight dump, the WAL, the journal and any device traces."""
        if self.ops_port is None or self.ops is not None:
            return
        buffer, detector, boot = self.buffer, self.detector, self.boot
        self._ops_history = obs.HistorySampler(
            extra_fn=obs.record_device_memory).start()
        if self.store is not None:
            self._ops_history.attach_store(self.store)
        self._ops_profiler = obs.DeviceProfiler(out_dir=self._wal_dir)
        self.ops = obs.OpsServer(
            port=self.ops_port,
            tracer=self.tracer,  # None → the live process default
            role=self.role, boot=boot,
            vars_fn=lambda: {"boot": boot, "version": buffer.version,
                             "transport": transport,
                             "ps_host": self.host, "ps_port": self.port},
            health_fn=lambda: {"membership": detector.membership()},
            workers_fn=self.ledger.snapshot,
            alerts_fn=self.alerts.scrape,
            history=self._ops_history,
            profiler=self._ops_profiler,
            shards_fn=self.shards_fn,
            incidents_fn=self.store.doc if self.store is not None else None,
        ).start()

    def _unmount_ops(self) -> None:
        if self.ops is not None:
            self.ops.stop()
            self.ops = None
        if self._ops_history is not None:
            self._ops_history.stop()
            self._ops_history = None

    def _serve(self, server) -> None:
        self._server = server
        if self.port == 0:  # ephemeral port (tests)
            self.port = server.server_address[1]
        self._thread = threading.Thread(target=server.serve_forever, daemon=True)
        self._thread.start()
        self._mount_ops(self.transport)

    def stop(self) -> None:
        self._unmount_ops()
        self._close_store("close")
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self.wal_writer is not None:
            self.wal_writer.sync()  # a clean shutdown leaves no WAL lag

    def kill(self) -> None:
        """Simulate a crash: go dark first (sever every live connection,
        then stop the acceptor — ``shutdown`` alone waits a poll interval
        while handler threads keep acking), then note ``ps_kill`` with the
        frozen version and dump the flight recorder (``flight_dump``).
        Unlike ``stop`` the WAL is NOT synced: what survives is what
        ``after_update`` already made durable."""
        if self._server is None:
            return
        self._server.sever_all()
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        # The journal closes AFTER the note, so ``ps_kill`` is its last
        # record: the one a post-mortem rebuild names as the trigger.
        obs.default_flight_recorder().note(
            "ps_kill", "error", boot=self.boot, version=self.buffer.version,
        )
        self.flight_dump = _dump_flight_on_kill(self.boot, self._wal_dir)
        self._close_store("kill")
        self._unmount_ops()

    def _durable(self) -> None:
        """After an apply, before its ack: the push's WAL snapshot."""
        if self.wal_writer is not None:
            self.wal_writer.after_update()

    def get_parameters(self):
        return self.buffer.get()

    @property
    def master_url(self) -> str:
        return socket_utils.determine_master(self.port)

    def _address(self) -> str:
        return f"{_dial_host(self.host)}:{self.port}"


class HttpServer(_WireServer):
    """HTTP transport over a ParameterBuffer (reference ``HttpServer``).

    ``GET /parameters`` returns the weights (packed when the client says
    ``X-Elephas-Codec: packed``, else pickle), ``POST /update`` applies a
    delta of either codec. Control plane: ``POST /barrier/<tag>`` and
    ``GET /barrier/<tag>``, ``POST /heartbeat/<id>``,
    ``POST /deregister/<id>``, ``GET /membership``; ``GET /health`` is
    open. Runs in a daemon thread.

    ``auth_key``: shared HMAC-SHA256 secret; every request must carry
    ``X-Elephas-Auth`` = hexmac(method + path + nonce + ts + body) with
    fresh ``X-Elephas-Nonce``/``X-Elephas-TS`` headers (checked BEFORE the
    body is decoded; a bad tag or a replayed nonce is a 403), and every
    response is signed bound to the request's nonce.
    ``max_staleness``/``staleness_soft``: the admission knobs
    (``AdmissionPolicy``). ``tracer``: span recorder for the handle spans
    (default: the process tracer, resolved per request).
    """

    transport = "http"

    def start(self) -> None:
        buffer = self.buffer
        barriers = self.barriers
        auth_key = self.auth_key
        replay_guard = self.replay_guard
        boot = self.boot
        detector = self.detector
        cache = self._cache = _SnapshotCache(buffer, boot=boot)
        cache_hits, bytes_tx, bytes_rx = _ps_counters("http")
        tracer_of = self._tracer
        ledger = self.ledger
        admission = self.admission
        wal_writer = self.wal_writer
        durable = self._durable
        shard_info = self.shard_info

        class Handler(BaseHTTPRequestHandler):
            # Small replies (not-modified frames, acks) must not stall
            # behind Nagle + delayed-ACK coalescing.
            disable_nagle_algorithm = True

            def log_message(self, *args):  # silence per-request stderr spam
                pass

            def _authed(self, body: bytes = b"") -> bool:
                if auth_key is None:
                    return True
                claim = self.headers.get("X-Elephas-Auth", "")
                nonce_hex = self.headers.get("X-Elephas-Nonce", "")
                ts_str = self.headers.get("X-Elephas-TS", "")
                try:
                    nonce = bytes.fromhex(nonce_hex)
                    ts = float(ts_str)
                except ValueError:
                    nonce, ts = b"", 0.0
                want = socket_utils.chunks_mac(
                    auth_key,
                    [self.command.encode(), self.path.encode(), nonce,
                     ts_str.encode(), body],
                ).hex()
                if nonce and hmac.compare_digest(claim, want):
                    try:
                        replay_guard.check(nonce, ts)
                        self._req_nonce = nonce
                        return True
                    except ConnectionError:
                        pass
                self.send_error(403, "authentication failed")
                return False

            def _reply(self, body, content_type: Optional[str] = None,
                       version: Optional[int] = None) -> None:
                # body: bytes OR wire.Frames — frames go out chunk by chunk.
                raw = isinstance(body, socket_utils.RawPayload)
                chunks = body.chunks if raw else [body]
                nbytes = body.nbytes if raw else len(body)
                self.send_response(200)
                if content_type:
                    self.send_header("Content-Type", content_type)
                if version is not None:
                    self.send_header("X-Elephas-Version", str(version))
                if auth_key is not None:
                    self.send_header(
                        "X-Elephas-Auth",
                        socket_utils.chunks_mac(
                            auth_key, [getattr(self, "_req_nonce", b""), *chunks]).hex(),
                    )
                self.send_header("Content-Length", str(nbytes))
                self.end_headers()
                for chunk in chunks:
                    self.wfile.write(chunk)

            def _pull(self):
                pinned = self.headers.get("X-Elephas-Pinned")
                if pinned is not None:
                    try:
                        pin = int(pinned)
                    except ValueError:
                        self.send_error(400, "bad pinned version")
                        return
                    payload = _pinned_payload(cache, wal_writer, pin)
                    if payload is None:
                        self.send_error(404, "pinned version unavailable")
                        return
                    bytes_tx.inc(payload.nbytes)
                    self._reply(payload, content_type="application/octet-stream",
                                version=pin)
                    return
                codec = "packed" if self.headers.get(
                    "X-Elephas-Codec") == "packed" else "pickle"
                known = self.headers.get("X-Elephas-Version")
                known_boot = self.headers.get("X-Elephas-Boot")
                version, payload = cache.frames(codec)
                # Not-modified needs the BOOT to match too (_new_boot_id).
                if codec == "packed" and known is not None \
                        and known == str(version) and known_boot == boot:
                    payload = wire.encode_not_modified(version)
                    cache_hits.inc()
                bytes_tx.inc(payload.nbytes if isinstance(
                    payload, socket_utils.RawPayload) else len(payload))
                self._reply(payload, content_type="application/octet-stream",
                            version=version)

            def do_GET(self):  # noqa: N802
                path = self.path.rstrip("/")
                if path == "/health":
                    self._reply(b"ok")  # open: liveness probe, no pickles
                    return
                if not self._authed():
                    return
                if path == "/parameters":
                    ctx = _parse_trace_header(self.headers.get("X-Elephas-Trace"))
                    with obs.activate(ctx), tracer_of().span(
                            "ps/handle_pull", boot=boot, transport="http"):
                        self._pull()
                elif path == "/membership":
                    self._reply(json.dumps(detector.membership()).encode(),
                                content_type="application/json")
                elif path == "/shardinfo":
                    # Group handshake: the plan identity plus the LIVE boot
                    # id (fencing compares boots, not addresses).
                    if shard_info is None:
                        self.send_error(404)
                        return
                    self._reply(json.dumps(dict(shard_info, boot=boot)).encode(),
                                content_type="application/json")
                elif path.startswith("/barrier/"):
                    self._reply(str(barriers.count(path[len("/barrier/"):])).encode())
                else:
                    self.send_error(404)

            def _header_int(self, name, kind):
                raw = self.headers.get(name)
                try:
                    return None if raw is None else kind(raw)
                except ValueError:
                    return None

            def _push(self, body):
                bytes_rx.inc(len(body))
                tree, body_tc, seen, worker, syncint = wire.decode_push(body)
                # Pickle bodies carry their staleness stamps as headers.
                if seen is None:
                    seen = self._header_int("X-Elephas-Seen-Version", int)
                if worker is None:
                    worker = self.headers.get("X-Elephas-Worker")
                if syncint is None:
                    syncint = self._header_int("X-Elephas-Sync-Interval", float)
                ctx = (_parse_trace_header(self.headers.get("X-Elephas-Trace"))
                       or _as_trace_ctx(body_tc))
                tracer = tracer_of()
                with obs.activate(ctx), tracer.span(
                        "ps/handle_push", boot=boot, transport="http") as hsp:
                    lag = _lag_of(buffer, seen)
                    if hsp and lag is not None:
                        hsp.note(staleness=lag, worker=worker)
                    verdict, tree = _admit(admission, ledger, worker, lag, tree,
                                           "http", hsp)
                    if verdict == "reject":
                        frame = wire.encode_rejected(buffer.version, lag,
                                                     admission.max_staleness)
                        bytes_tx.inc(frame.nbytes)
                        self._reply(frame, content_type="application/octet-stream")
                        return
                    _note_staleness(ledger, worker, lag, seen, len(body),
                                    sync_interval=syncint)
                    with tracer.span("ps/apply", boot=boot):
                        buffer.apply_delta(tree)
                        durable()  # durability BEFORE the ack
                self._reply(b"")

            def do_POST(self):  # noqa: N802
                path = self.path.rstrip("/")
                body = _read_exact(self.rfile, int(self.headers.get("Content-Length", 0)))
                if not self._authed(body):
                    return
                if path == "/update":
                    self._push(body)
                elif path.startswith("/heartbeat/"):
                    detector.beat(path[len("/heartbeat/"):])
                    self._reply(b"ok")
                elif path.startswith("/deregister/"):
                    detector.deregister(path[len("/deregister/"):])
                    self._reply(b"ok")
                elif path.startswith("/barrier/"):
                    self._reply(str(barriers.arrive(path[len("/barrier/"):])).encode())
                else:
                    self.send_error(404)

        self._serve(_TrackingHTTPServer((self.host, self.port), Handler))

    def client(self):
        from elephas_tpu_torch.parameter.client import HttpClient

        return HttpClient(self._address(), auth_key=self.auth_key)


class _SocketHandler(socketserver.BaseRequestHandler):
    def handle(self):
        # Strict request/reply: Nagle + delayed-ACK would stall small frames.
        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ps = self.server.ps  # type: ignore[attr-defined]
        cache = self.server.cache  # type: ignore[attr-defined]
        cache_hits, bytes_tx, bytes_rx = _ps_counters("socket")
        try:
            while True:
                # With a key, receive() verifies the frame's HMAC and
                # freshness BEFORE any decode; replies are MAC-bound to
                # the request's nonce.
                obj, req_nonce = socket_utils.receive(
                    self.request, key=ps.auth_key, replay_guard=ps.replay_guard,
                    return_nonce=True)

                def reply(obj):
                    if isinstance(obj, socket_utils.RawPayload):
                        bytes_tx.inc(obj.nbytes)
                    socket_utils.send(self.request, obj, key=ps.auth_key, bind=req_nonce)

                # A raw (non-pickled) payload is a packed-codec PUSH.
                if isinstance(obj, (bytes, bytearray, memoryview)):
                    mv = memoryview(obj)
                    bytes_rx.inc(mv.nbytes)
                    reply(self._push(ps, mv))
                    continue
                # (kind, payload) from legacy peers, (kind, payload,
                # trace_ctx) from tracing ones.
                kind, payload, *rest = obj
                ctx = _as_trace_ctx(rest[0]) if rest else None
                if kind in ("g", "G"):
                    with obs.activate(ctx), ps._tracer().span(
                            "ps/handle_pull", boot=ps.boot, transport="socket"):
                        reply(self._pull(ps, cache, cache_hits, kind, payload))
                elif kind == "u":
                    tracer = ps._tracer()
                    with obs.activate(ctx), tracer.span(
                            "ps/handle_push", boot=ps.boot, transport="socket"):
                        # Legacy pickle frame: unstamped coverage.
                        _note_staleness(ps.ledger, None, None, None, 0)
                        with tracer.span("ps/apply", boot=ps.boot):
                            ps.buffer.apply_delta(payload)
                            ps._durable()  # durable before the ack
                    reply(b"ok")
                elif kind == "h":  # heartbeat: payload = worker id
                    ps.detector.beat(str(payload))
                    reply(b"ok")
                elif kind == "m":  # membership table (sweeps first)
                    reply(ps.detector.membership())
                elif kind == "d":  # deregister: payload = worker id
                    ps.detector.deregister(str(payload))
                    reply(b"ok")
                elif kind == "b":  # barrier arrive(tag) -> count
                    reply(ps.barriers.arrive(payload))
                elif kind == "c":  # barrier count(tag)
                    reply(ps.barriers.count(payload))
                elif kind == "i":  # shard-group handshake (live boot)
                    reply(dict(ps.shard_info, boot=ps.boot)
                          if ps.shard_info is not None else None)
                elif kind == "V":  # version-PINNED pull
                    with obs.activate(ctx), ps._tracer().span(
                            "ps/handle_pull", boot=ps.boot, transport="socket"):
                        reply(_pinned_payload(cache, ps.wal_writer, int(payload)))
                else:
                    break
        except (ConnectionError, OSError):
            pass

    @staticmethod
    def _pull(ps, cache, cache_hits, kind, payload):
        if kind == "g":  # legacy pull → cached pickle snapshot
            return socket_utils.RawPayload([cache.frames("pickle")[1]])
        # Packed pull; payload is the client's (boot, version) position
        # (a bare int from pre-boot-id peers never earns a not-modified).
        version, frames = cache.frames("packed")
        if (isinstance(payload, (tuple, list)) and len(payload) == 2
                and payload[0] == ps.boot and payload[1] == version):
            cache_hits.inc()
            return wire.encode_not_modified(version)
        return frames

    @staticmethod
    def _push(ps, mv):
        tree, tc, seen, worker, syncint = wire.decode_push(mv)
        tracer = ps._tracer()
        with obs.activate(_as_trace_ctx(tc)), tracer.span(
                "ps/handle_push", boot=ps.boot, transport="socket") as hsp:
            lag = _lag_of(ps.buffer, seen)
            if hsp and lag is not None:
                hsp.note(staleness=lag, worker=worker)
            verdict, tree = _admit(ps.admission, ps.ledger, worker, lag, tree,
                                   "socket", hsp)
            if verdict == "reject":
                # Typed refusal (only ever sent to stamped peers).
                return wire.encode_rejected(ps.buffer.version, lag,
                                            ps.admission.max_staleness)
            _note_staleness(ps.ledger, worker, lag, seen, mv.nbytes,
                            sync_interval=syncint)
            with tracer.span("ps/apply", boot=ps.boot):
                ps.buffer.apply_delta(tree)
                ps._durable()  # durable before the ack
        return b"ok"


class _ConnectionTracker:
    """socketserver mixin that remembers live connections, so a simulated
    crash (``kill``) can sever them: ``shutdown`` alone stops only the
    acceptor, and persistent client connections would go on being served
    by their handler threads — not what a dead process looks like to a
    worker."""

    def __init__(self, *args, **kwargs):
        self._live_conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._live_conns.add(request)
        super().process_request(request, client_address)

    def close_request(self, request):
        with self._conns_lock:
            self._live_conns.discard(request)
        super().close_request(request)

    def sever_all(self) -> None:
        with self._conns_lock:
            conns = list(self._live_conns)
            self._live_conns.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass


# Both reuse the address: a warm restart binds the killed server's port.
class _TrackingHTTPServer(_ConnectionTracker, ThreadingHTTPServer):
    allow_reuse_address = True
    daemon_threads = True


class _ThreadingTCPServer(_ConnectionTracker, socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class SocketServer(_WireServer):
    """Raw-TCP transport (reference ``SocketServer``): persistent
    connections carrying ``('G', (boot, version))`` packed pulls, raw
    packed-frame pushes, and the legacy ``('g', None)`` / ``('u', delta)``
    pickle frames. Knobs as ``HttpServer``'s; a rejected push is answered
    with the raw ``EPRJ`` frame in place of the ``b"ok"`` ack."""

    transport = "socket"

    def start(self) -> None:
        server = _ThreadingTCPServer((self.host, self.port), _SocketHandler)
        server.ps = self  # type: ignore[attr-defined]
        server.cache = _SnapshotCache(self.buffer, boot=self.boot)  # type: ignore[attr-defined]
        self._serve(server)

    def client(self):
        from elephas_tpu_torch.parameter.client import SocketClient

        return SocketClient(self._address(), auth_key=self.auth_key)


def make_server(
    mode: str,
    params,
    lock: bool = True,
    port: int = 4000,
    device=None,
    host: Optional[str] = None,
    granularity: str = "tree",
    auth_key: Optional[bytes] = None,
    wal_dir: Optional[str] = None,
    wal_every: int = 1,
    wal_keep: int = 3,
    heartbeat_timeout: Optional[float] = None,
    tracer=None,
    ops_port: Optional[int] = None,
    role: str = "ps",
    shard_info: Optional[dict] = None,
    max_staleness: Optional[int] = None,
    staleness_soft: Optional[int] = None,
    store_dir: Optional[str] = "auto",
) -> BaseParameterServer:
    """Factory keyed on the reference's ``parameter_server_mode``
    (``local``/``http``/``socket``). ``device``: where the buffer lives
    (the card unless ``"cpu"`` is passed). ``granularity`` ('tree'|'leaf')
    sets the hogwild apply isolation; ``auth_key`` turns on HMAC wire
    authentication; ``max_staleness``/``staleness_soft`` bounded-staleness
    admission (wire transports only — a local push applies under the
    buffer lock and is never stale). ``wal_dir``/``wal_every``/``wal_keep``:
    durable pushes and warm restart; ``role``/``shard_info``: the group's
    stamps (``group.py``); all wire transports only — see ``_WireServer``."""
    if mode == "local":
        if wal_dir is not None:
            raise ValueError(
                "wal_dir requires a wire transport (http|socket): the local "
                "server dies with the training process it would be "
                "restarted for"
            )
        if shard_info is not None:
            raise ValueError(
                "shard_info requires a wire transport (http|socket): shard "
                "group members are separate server processes"
            )
        if max_staleness is not None or staleness_soft is not None:
            raise ValueError(
                "staleness admission requires a wire transport "
                "(http|socket): local pushes apply under the buffer lock "
                "and are never stale"
            )
        if store_dir not in (None, "auto"):
            raise ValueError(
                "store_dir requires a wire transport (http|socket): the "
                "local server's telemetry dies with the training process "
                "a post-mortem would reconstruct"
            )
        return LocalServer(params, lock=lock, device=device, granularity=granularity,
                           heartbeat_timeout=heartbeat_timeout)
    kwargs = dict(lock=lock, port=port, device=device, host=host,
                  granularity=granularity, auth_key=auth_key,
                  heartbeat_timeout=heartbeat_timeout, tracer=tracer,
                  max_staleness=max_staleness, staleness_soft=staleness_soft,
                  wal_dir=wal_dir, wal_every=wal_every, wal_keep=wal_keep, role=role,
                  shard_info=shard_info, ops_port=ops_port, store_dir=store_dir)
    if mode == "http":
        return HttpServer(params, **kwargs)
    if mode == "socket":
        return SocketServer(params, **kwargs)
    raise ValueError(f"parameter_server_mode must be local|http|socket, got {mode!r}")
