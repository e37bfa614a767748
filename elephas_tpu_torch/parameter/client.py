"""Parameter clients (counterpart of ``elephas_tpu/parameter/client.py``;
reference: ``elephas/parameter/client.py``).

``HttpClient``/``SocketClient`` keep the reference's wire behavior
(SURVEY.md §2.1 "PS clients") and speak the JAX package's frames;
``LocalClient`` is the in-process fast path — a pull hands out the
buffer's tensors on the card, a push subtracts there.

Host copies: a wire push copies its delta to the host once (where the
JAX client calls ``jax.device_get``), on the calling thread's current
stream, so after the worker's stream is done with the delta — or the
worker hands over a ``HostCopy`` it already started
(``engine/async_engine.py``). A wire pull returns CPU tensors viewing
the received frame.

Failure model: the wire clients fail FAST instead of hanging —
connection-level failures are retried with backoff for a small budget
(~3 s), then raised as ``ParameterServerUnavailable`` naming the
address. Only connection ESTABLISHMENT is retried (plus, for socket
reads, one transparent reconnect of a pooled connection that died
between calls); once a request has left the socket, failures raise
immediately — a re-sent write would double-apply a delta.
"""

from __future__ import annotations

import hmac
import http.client
import json
import os
import socket
import threading
import time
import warnings
from typing import Optional

import torch

from elephas_tpu_torch import obs
from elephas_tpu_torch.parameter import wire
from elephas_tpu_torch.parameter.base import BaseParameterClient
from elephas_tpu_torch.parameter.buffer import ParameterBuffer
from elephas_tpu_torch.utils import sockets as socket_utils
from elephas_tpu_torch.utils.functional_utils import tree_map

# Connection-failure retry schedule: total sleep ~2.8s before giving up.
_RETRY_DELAYS = (0.1, 0.2, 0.4, 0.8, 1.3)
_CONNECT_TIMEOUT = 2.0  # dial budget per attempt (transfers get self.timeout)

_PS_OP_COUNTERS = {"pull": "ps_pull_total", "push": "ps_push_total"}


class HostCopy:
    """A delta whose copy to the host was started on a worker's stream:
    ``tree`` (pinned CPU tensors) is valid once ``event`` has completed.
    Another thread (the comms thread) calls ``wait()`` to read it."""

    __slots__ = ("tree", "event")

    def __init__(self, tree, event: Optional[torch.cuda.Event]):
        self.tree = tree
        self.event = event

    @classmethod
    def start(cls, tree) -> "HostCopy":
        """Copy ``tree``'s device tensors to pinned host memory on the
        current stream, without waiting."""
        devices = []

        def copy(t):
            if t.device.type != "cuda":
                return t
            devices.append(t.device)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t, non_blocking=True)

        tree = tree_map(copy, tree)
        event = None
        if devices:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(devices[0]))
        return cls(tree, event)

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.tree


def to_host(delta):
    """``delta`` as CPU tensors: a ``HostCopy`` waited for, or a tree
    copied on the current stream (which orders the copy after the work
    that made it)."""
    if isinstance(delta, HostCopy):
        return delta.wait()
    return tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                    delta)


def _ps_span(op: str, transport: str):
    """Span + counter for one PS round-trip; every client's pull/push
    funnels through here so ``ps/pull``/``ps/push`` mean the same thing
    across transports."""
    obs.default_registry().counter(
        _PS_OP_COUNTERS[op], labelnames=("transport",)
    ).labels(transport=transport).inc()
    return obs.default_tracer().span(f"ps/{op}", transport=transport)


def _span_trace(sp):
    """The wire-shippable ``(trace_id, span_id)`` of a live span, or None
    (untraced runs keep the legacy wire shapes byte-identical)."""
    return sp.context if sp else None


def _resolve_codec(codec: Optional[str]) -> str:
    """Wire codec: explicit arg > ``$ELEPHAS_PS_CODEC`` > packed."""
    codec = codec or os.environ.get("ELEPHAS_PS_CODEC", "packed")
    if codec not in ("packed", "pickle"):
        raise ValueError(f"codec must be packed|pickle, got {codec!r}")
    return codec


def _encode_push(delta, codec: str, quantize: Optional[str],
                 seen_version: Optional[int] = None,
                 worker: Optional[str] = None,
                 sync_interval: Optional[float] = None):
    """``(payload, codec_used)`` for one push; structures the packed
    skeleton cannot carry fall back to pickle."""
    if codec == "packed":
        try:
            return wire.encode_tree(delta, quantize=quantize,
                                    seen_version=seen_version, worker=worker,
                                    sync_interval=sync_interval), "packed"
        except wire.WireFormatError:
            pass
    return wire.encode_pickle(delta), "pickle"


class _PullCache:
    """Client side of the version-gated pull: remembers the last
    ``(boot, version, tree)`` a full-body reply carried, advertises the
    ``(boot, version)`` position on the next pull, and resolves a
    not-modified reply back to the cached tree. Thread-safe."""

    __slots__ = ("_lock", "_version", "_tree", "_boot")

    def __init__(self):
        self._lock = threading.Lock()
        self._version = None
        self._tree = None
        self._boot = None

    def known_version(self):
        with self._lock:
            return self._version if self._tree is not None else None

    def known(self):
        """``(boot, version)`` to advertise, or None (a bare version
        against a pre-boot-id server)."""
        with self._lock:
            if self._tree is None or self._version is None:
                return None
            if self._boot is None:
                return self._version
            return (self._boot, self._version)

    def store(self, version, tree, boot=None):
        if version is None:
            return
        with self._lock:
            self._version, self._tree, self._boot = version, tree, boot

    def resolve(self, not_modified: "wire.NotModified"):
        with self._lock:
            version, tree = self._version, self._tree
            if tree is not None and not_modified.version == version:
                return tree
        obs.default_flight_recorder().note(
            "stale_notmod", "error",
            server_version=not_modified.version, client_version=version,
        )
        raise RuntimeError(
            "parameter server sent not-modified for version "
            f"{not_modified.version} but this client last saw "
            f"{version} (protocol violation)"
        )


class ParameterServerUnavailable(ConnectionError):
    """The parameter server could not be reached after retries."""


class VersionUnavailable(RuntimeError):
    """A pinned pull asked for a version the server can no longer serve:
    not the live buffer and outside its WAL window. A definitive answer —
    re-sending cannot succeed, so the caller picks another pin."""

    def __init__(self, address: str, version: int):
        self.address = address
        self.version = int(version)
        super().__init__(
            f"parameter server at {address} cannot serve pinned version "
            f"{version} (not the live buffer and outside its WAL window)"
        )


def _pinned_tree(reply, version: int):
    """The tree of a pinned pull's frame, checked to be that version."""
    out = wire.decode(reply)
    if not isinstance(out, wire.DecodedTree) or out.version != int(version):
        raise RuntimeError(
            f"pinned pull for version {version} answered with "
            f"{getattr(out, 'version', out)!r} (protocol violation)")
    return out.tree


class StaleDeltaRejected(RuntimeError):
    """The PS refused a pushed delta: staler than its admission bound. A
    definitive answer, never retried; the worker drops the delta,
    re-pulls and syncs more often (``_CommsPipeline``). Carries the
    server's live ``version``, the measured ``lag`` and the bound."""

    def __init__(self, address: str, version: int, lag: int,
                 max_staleness: int):
        self.address = address
        self.version = int(version)
        self.lag = int(lag)
        self.max_staleness = int(max_staleness)
        super().__init__(
            f"parameter server at {address} rejected the pushed delta: "
            f"staleness {lag} exceeds max_staleness={max_staleness} "
            f"(server now at version {version}; re-pull and sync more "
            "often)"
        )


def _raise_if_rejected(reply, address: str) -> None:
    """Surface a typed ``EPRJ`` push reply as ``StaleDeltaRejected``."""
    if isinstance(reply, (bytes, bytearray, memoryview)) and wire.is_packed(reply):
        out = wire.decode(reply)
        if isinstance(out, wire.DeltaRejected):
            raise StaleDeltaRejected(address, out.version, out.lag,
                                     out.max_staleness)


def _retry_connect(fn, address: str, op: str, sleep=time.sleep):
    """Run ``fn`` retrying connection-level failures with backoff, then
    raise ``ParameterServerUnavailable``. Only for an ``fn`` that is safe
    to run again (a pure read, or connection establishment)."""
    last: Exception | None = None
    for delay in (*_RETRY_DELAYS, None):
        try:
            return fn()
        except (ConnectionError, socket.timeout, TimeoutError, OSError) as exc:
            last = exc
        if delay is None:
            break
        sleep(delay)
    raise ParameterServerUnavailable(
        f"parameter server at {address} unreachable during {op} "
        f"(retried {len(_RETRY_DELAYS)}x over ~{sum(_RETRY_DELAYS):.1f}s): {last}"
    ) from last


class LocalClient(BaseParameterClient):
    def __init__(self, buffer: ParameterBuffer, detector=None):
        """``detector``: the owning ``LocalServer``'s failure detector."""
        self._buffer = buffer
        self._detector = detector

    def get_parameters(self):
        with _ps_span("pull", "local"):
            return self._buffer.get()

    def hand_over(self, tree):
        """Make a pulled snapshot safe to read on the calling thread's
        current stream (``ParameterBuffer.hand_over``)."""
        return self._buffer.hand_over(tree)

    def update_parameters(self, delta) -> None:
        with _ps_span("push", "local"):
            self._buffer.apply_delta(delta)

    def heartbeat(self, worker_id: str) -> None:
        if self._detector is not None:
            self._detector.beat(worker_id)

    def membership(self) -> dict:
        return {} if self._detector is None else self._detector.membership()

    def deregister(self, worker_id: str) -> None:
        if self._detector is not None:
            self._detector.deregister(worker_id)

    def wait_barrier(self, tag: str, n: int, timeout: Optional[float] = None) -> None:
        pass  # in-process buffer == one process; nothing to synchronize


class _WireClient(BaseParameterClient):
    """What the wire clients share: the address, auth, codec, the pull
    cache, the push stamps and the PS-backed host barrier."""

    def __init__(self, master_url: str, timeout: float, auth_key: Optional[bytes],
                 codec: Optional[str], push_quantize: Optional[str]):
        host, port = master_url.rsplit(":", 1)
        self.master_url = master_url
        self._addr = (host, int(port))
        self.timeout = timeout
        self.auth_key = auth_key
        self.codec = _resolve_codec(codec)
        self.push_quantize = push_quantize
        self._pull_cache = _PullCache()
        # Stamped onto pushes for the PS's staleness ledger (None →
        # unstamped) and its SYNC column.
        self.worker_id: Optional[str] = None
        self.sync_interval: Optional[float] = None

    def known_version(self) -> Optional[int]:
        """Version of the last full-body pull this client cached."""
        return self._pull_cache.known_version()

    def _finish_pull(self, reply, sp):
        out = wire.decode(reply)
        if isinstance(out, wire.NotModified):
            if sp:
                sp.note(codec="packed", payload_bytes=len(reply), cache_hit=True)
            return self._pull_cache.resolve(out)
        self._pull_cache.store(out.version, out.tree, boot=out.boot)
        if sp:
            sp.note(codec="packed", payload_bytes=len(reply))
        return out.tree

    def barrier_arrive(self, tag: str) -> int:
        raise NotImplementedError

    def barrier_count(self, tag: str) -> int:
        raise NotImplementedError

    def wait_barrier(self, tag: str, n: int, timeout: Optional[float] = None) -> None:
        """Arrive, then poll until ``n`` hosts arrived or ``timeout``
        (default ``$ELEPHAS_BARRIER_TIMEOUT``, 600 s)."""
        if timeout is None:
            raw = os.environ.get("ELEPHAS_BARRIER_TIMEOUT", "600")
            try:
                timeout = float(raw)
            except ValueError:
                warnings.warn(
                    f"ELEPHAS_BARRIER_TIMEOUT={raw!r} is not a number; "
                    "using the 600s default",
                    RuntimeWarning,
                    stacklevel=2,
                )
                timeout = 600.0
        self.barrier_arrive(tag)
        deadline = time.monotonic() + timeout
        poll = 0.02
        while time.monotonic() < deadline:
            if self.barrier_count(tag) >= n:
                return
            time.sleep(poll)
            poll = min(poll * 2, 0.5)
        final = self.barrier_count(tag)
        if final >= n:
            return
        raise TimeoutError(
            f"barrier {tag!r}: {final}/{n} hosts after {timeout}s "
            "— a peer host likely died"
        )


def _read_body(resp) -> bytearray:
    """The whole response body in one writable buffer."""
    if resp.length is None:
        return bytearray(resp.read())
    buf = bytearray(resp.length)
    view, pos = memoryview(buf), 0
    while pos < len(buf):
        got = resp.readinto(view[pos:])
        if not got:
            raise http.client.IncompleteRead(bytes(buf[:pos]), len(buf) - pos)
        pos += got
    return buf


class HttpClient(_WireClient):
    """``http.client`` against ``GET /parameters`` / ``POST /update``.
    Dialing gets ``_CONNECT_TIMEOUT`` per attempt; the transfer gets
    ``timeout``. Only the dial retries."""

    def __init__(self, master_url: str, timeout: float = 60.0,
                 auth_key: Optional[bytes] = None, codec: Optional[str] = None,
                 push_quantize: Optional[str] = None):
        super().__init__(master_url, timeout, auth_key, codec, push_quantize)

    def _connect_once(self, transfer_timeout: Optional[float] = None):
        conn = http.client.HTTPConnection(*self._addr, timeout=_CONNECT_TIMEOUT)
        conn.connect()
        conn.sock.settimeout(self.timeout if transfer_timeout is None else transfer_timeout)
        return conn

    def _roundtrip(self, conn, method: str, path: str, payload,
                   extra_headers: Optional[dict] = None) -> bytearray:
        try:
            headers = {"Content-Type": "application/octet-stream"} if payload else {}
            if extra_headers:
                headers.update(extra_headers)
            nonce = b""
            if self.auth_key is not None:
                nonce = os.urandom(16)
                ts = repr(time.time())
                headers["X-Elephas-Nonce"] = nonce.hex()
                headers["X-Elephas-TS"] = ts
                headers["X-Elephas-Auth"] = socket_utils.frame_mac(
                    self.auth_key,
                    method.encode() + path.encode() + nonce + ts.encode()
                    + (payload or b""),
                ).hex()
            conn.request(method, path, body=payload, headers=headers)
            resp = conn.getresponse()
            body = _read_body(resp)
            if resp.status >= 400:
                raise RuntimeError(
                    f"parameter server returned HTTP {resp.status} for {path}"
                )
            if self.auth_key is not None and path != "/health":
                # The server's signature is bound to OUR nonce; verified
                # BEFORE any decode of the body.
                want = socket_utils.chunks_mac(self.auth_key, [nonce, body]).hex()
                if not hmac.compare_digest(resp.headers.get("X-Elephas-Auth", ""), want):
                    raise RuntimeError(
                        f"parameter server response for {path} failed HMAC "
                        "verification (wrong or missing auth key)"
                    )
            return body
        finally:
            conn.close()

    def _call(self, method: str, path: str, payload, op: str,
              headers: Optional[dict] = None) -> bytearray:
        """Dial with the retry budget, then ONE transfer attempt."""
        conn = _retry_connect(self._connect_once, self.master_url, op)
        try:
            return self._roundtrip(conn, method, path, payload, extra_headers=headers)
        except (ConnectionError, socket.timeout, TimeoutError, OSError,
                http.client.HTTPException) as exc:
            raise ParameterServerUnavailable(
                f"parameter server at {self.master_url} failed after the {op} "
                f"request was sent (transfer not retried — server wedged or "
                f"died mid-request): {exc}"
            ) from exc

    def _get(self, path: str, op: str, headers: Optional[dict] = None):
        return self._call("GET", path, None, op, headers=headers)

    def _post(self, path: str, payload: bytes, op: str, headers: Optional[dict] = None):
        return self._call("POST", path, payload, op, headers=headers)

    def get_parameters(self):
        with _ps_span("pull", "http") as sp:
            headers = {}
            tc = _span_trace(sp)
            if tc is not None:
                headers["X-Elephas-Trace"] = f"{tc.trace_id}-{tc.span_id}"
            if self.codec == "packed":
                headers["X-Elephas-Codec"] = "packed"
                known = self._pull_cache.known()
                if isinstance(known, tuple):
                    headers["X-Elephas-Boot"] = known[0]
                    headers["X-Elephas-Version"] = str(known[1])
                elif known is not None:
                    headers["X-Elephas-Version"] = str(known)
            body = self._get("/parameters", "get_parameters", headers=headers or None)
            # A legacy server ignores the codec header and replies pickle.
            if wire.is_packed(body):
                return self._finish_pull(body, sp)
            if sp:
                sp.note(codec="pickle", payload_bytes=len(body))
            return wire.decode_pickle(body)

    def update_parameters(self, delta) -> None:
        with _ps_span("push", "http") as sp:
            delta = to_host(delta)
            seen = self._pull_cache.known_version()
            payload, codec = _encode_push(delta, self.codec, self.push_quantize,
                                          seen_version=seen, worker=self.worker_id,
                                          sync_interval=self.sync_interval)
            if isinstance(payload, wire.Frames):
                payload = payload.tobytes()  # http.client needs one body buffer
            if sp:
                sp.note(codec=codec, payload_bytes=len(payload),
                        quantize=self.push_quantize)
            headers = {}
            tc = _span_trace(sp)
            if tc is not None:
                headers["X-Elephas-Trace"] = f"{tc.trace_id}-{tc.span_id}"
            # Staleness stamps ride as headers too, for pickle bodies.
            if seen is not None:
                headers["X-Elephas-Seen-Version"] = str(seen)
            if self.worker_id is not None:
                headers["X-Elephas-Worker"] = str(self.worker_id)
            if self.sync_interval is not None:
                headers["X-Elephas-Sync-Interval"] = str(self.sync_interval)
            body = self._post("/update", payload, "update_parameters",
                              headers=headers or None)
            _raise_if_rejected(body, self.master_url)

    def get_parameters_pinned(self, version: int):
        """The tree at exactly ``version`` (the live buffer's or a WAL
        frame), bypassing the pull cache: a point lookup must not move
        the cache's position. Raises ``VersionUnavailable`` when the
        server no longer holds that version."""
        with _ps_span("pull", "http") as sp:
            headers = {"X-Elephas-Codec": "packed", "X-Elephas-Pinned": str(int(version))}
            try:
                body = self._get("/parameters", "get_parameters_pinned", headers=headers)
            except RuntimeError as exc:
                if "HTTP 404" in str(exc):
                    raise VersionUnavailable(self.master_url, version) from exc
                raise
            if sp:
                sp.note(codec="packed", payload_bytes=len(body), pinned=int(version))
            return _pinned_tree(body, version)

    def health(self) -> bool:
        """One non-retried probe of ``GET /health``."""
        try:
            return self._roundtrip(
                self._connect_once(transfer_timeout=_CONNECT_TIMEOUT),
                "GET", "/health", None,
            ) == b"ok"
        except Exception:
            return False

    def heartbeat(self, worker_id: str) -> None:
        self._post(f"/heartbeat/{worker_id}", b"", "heartbeat")

    def membership(self) -> dict:
        return json.loads(self._get("/membership", "membership"))

    def deregister(self, worker_id: str) -> None:
        self._post(f"/deregister/{worker_id}", b"", "deregister")

    def shard_info(self) -> Optional[dict]:
        """``{digest, shard, k, boot}`` from a shard-group member, None
        from a standalone server (its ``/shardinfo`` is a 404)."""
        try:
            return json.loads(self._get("/shardinfo", "shard_info"))
        except RuntimeError:
            return None

    def barrier_arrive(self, tag: str) -> int:
        return int(self._post(f"/barrier/{tag}", b"", "barrier_arrive"))

    def barrier_count(self, tag: str) -> int:
        return int(self._get(f"/barrier/{tag}", "barrier_count"))


def make_client(
    mode: str, address: str, auth_key: Optional[bytes] = None,
    codec: Optional[str] = None, push_quantize: Optional[str] = None,
) -> BaseParameterClient:
    """Client for a parameter server reachable at ``address`` ("ip:port")."""
    if mode == "http":
        return HttpClient(address, auth_key=auth_key, codec=codec,
                          push_quantize=push_quantize)
    if mode == "socket":
        return SocketClient(address, auth_key=auth_key, codec=codec,
                            push_quantize=push_quantize)
    raise ValueError(f"no wire client for parameter_server_mode={mode!r}")


class SocketClient(_WireClient):
    """Persistent framed-TCP connection (one per worker thread)."""

    def __init__(self, master_url: str, timeout: float = 60.0,
                 auth_key: Optional[bytes] = None, codec: Optional[str] = None,
                 push_quantize: Optional[str] = None):
        super().__init__(master_url, timeout, auth_key, codec, push_quantize)
        self._sock = None
        self._lock = threading.Lock()  # one in-flight request per connection

    def _connection(self) -> socket.socket:
        if self._sock is None:
            def attempt():
                sock = socket.create_connection(self._addr, timeout=_CONNECT_TIMEOUT)
                sock.settimeout(self.timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return sock

            self._sock = _retry_connect(attempt, self.master_url, "connect")
        return self._sock

    def _roundtrip(self, frame, op: str, idempotent: bool):
        """Send one frame, read one reply. Reads get ONE transparent
        reconnect if the pooled connection died between calls; writes
        are never re-sent."""
        for retry in (idempotent, False):
            sock = self._connection()
            try:
                nonce = socket_utils.send(sock, frame, key=self.auth_key)  # lock-ok: the conn lock exists to serialize this socket (one in-flight request)
                return socket_utils.receive(sock, key=self.auth_key, bind=nonce)  # lock-ok: reply read is the second half of the serialized exchange
            except (socket.timeout, TimeoutError) as exc:
                self._drop_connection(sock)
                raise ParameterServerUnavailable(
                    f"parameter server at {self.master_url} timed out during "
                    f"{op} (wedged — not retried): {exc}"
                ) from exc
            except (ConnectionError, OSError) as exc:
                self._drop_connection(sock)
                if not retry:
                    raise ParameterServerUnavailable(
                        f"parameter server at {self.master_url} dropped the "
                        f"connection during {op}"
                        + ("" if idempotent else " (write not re-sent: a "
                           "duplicate would double-apply)")
                        + f": {exc}"
                    ) from exc

    def _drop_connection(self, sock) -> None:
        self._sock = None
        try:
            sock.close()
        except OSError:
            pass

    def get_parameters(self):
        with _ps_span("pull", "socket") as sp, self._lock:
            if self.codec != "packed":
                tree = self._roundtrip(("g", None), "get_parameters", idempotent=True)
                if sp:
                    sp.note(codec="pickle")
                return tree
            known = self._pull_cache.known()
            tc = _span_trace(sp)
            # Trace context rides as an OPTIONAL third element.
            frame = ("G", known) if tc is None else ("G", known, tuple(tc))
            reply = self._roundtrip(frame, "get_parameters", idempotent=True)
            if not isinstance(reply, (bytes, bytearray, memoryview)):
                raise RuntimeError(
                    "parameter server sent a non-packed reply to a packed "
                    "pull — is it a pre-packed-codec server? dial it with "
                    "codec='pickle' (or ELEPHAS_PS_CODEC=pickle)"
                )
            return self._finish_pull(reply, sp)

    def update_parameters(self, delta) -> None:
        with _ps_span("push", "socket") as sp:
            delta = to_host(delta)
            tc = _span_trace(sp)
            frame = ("u", delta) if tc is None else ("u", delta, tuple(tc))
            codec, nbytes = "pickle", None
            if self.codec == "packed":
                try:
                    frames = wire.encode_tree(
                        delta, quantize=self.push_quantize, trace=tc,
                        seen_version=self._pull_cache.known_version(),
                        worker=self.worker_id, sync_interval=self.sync_interval)
                    frame, codec, nbytes = frames, "packed", frames.nbytes
                except wire.WireFormatError:
                    pass
            with self._lock:
                reply = self._roundtrip(frame, "update_parameters", idempotent=False)
            _raise_if_rejected(reply, self.master_url)
            if sp:
                sp.note(codec=codec, payload_bytes=nbytes, quantize=self.push_quantize)

    def get_parameters_pinned(self, version: int):
        """The tree at exactly ``version`` (frame kind ``"V"``); see
        ``HttpClient.get_parameters_pinned``. A ``None`` reply is the
        server's "not held" answer."""
        with _ps_span("pull", "socket") as sp, self._lock:
            reply = self._roundtrip(("V", int(version)), "get_parameters_pinned",
                                    idempotent=True)
            if reply is None:
                raise VersionUnavailable(self.master_url, version)
            if not isinstance(reply, (bytes, bytearray, memoryview)):
                raise RuntimeError("parameter server sent a non-packed reply to a "
                                   "pinned pull")
            if sp:
                sp.note(codec="packed", payload_bytes=len(reply), pinned=int(version))
            return _pinned_tree(reply, version)

    def health(self) -> bool:
        """A barrier *count* on a FRESH connection: would a new worker get in?"""
        try:
            sock = socket.create_connection(self._addr, timeout=_CONNECT_TIMEOUT)
            try:
                sock.settimeout(_CONNECT_TIMEOUT)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                nonce = socket_utils.send(sock, ("c", "health"), key=self.auth_key)
                socket_utils.receive(sock, key=self.auth_key, bind=nonce)
            finally:
                sock.close()
            return True
        except Exception:
            return False

    def heartbeat(self, worker_id: str) -> None:
        with self._lock:
            self._roundtrip(("h", worker_id), "heartbeat", idempotent=True)

    def membership(self) -> dict:
        with self._lock:
            return self._roundtrip(("m", None), "membership", idempotent=True)

    def deregister(self, worker_id: str) -> None:
        with self._lock:
            self._roundtrip(("d", worker_id), "deregister", idempotent=True)

    def shard_info(self) -> Optional[dict]:
        """``{digest, shard, k, boot}`` from a shard-group member, None
        from a standalone server (or one that closes the connection on
        the unknown frame kind)."""
        with self._lock:
            try:
                return self._roundtrip(("i", None), "shard_info", idempotent=True)
            except ParameterServerUnavailable:
                return None

    def barrier_arrive(self, tag: str) -> int:
        with self._lock:
            return self._roundtrip(("b", tag), "barrier_arrive", idempotent=False)

    def barrier_count(self, tag: str) -> int:
        with self._lock:
            return self._roundtrip(("c", tag), "barrier_count", idempotent=True)

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
