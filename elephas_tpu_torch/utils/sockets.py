"""Socket helpers: master discovery + length-prefixed wire framing
(counterpart of ``elephas_tpu/utils/sockets.py``; the port keeps its own
copy, frame for frame the same, so either package's peers can talk to
the other's).

Reference: ``elephas/utils/sockets.py::{determine_master, send, receive}``
(SURVEY.md §2.1) — the reference frames pickled Python objects with a
length prefix over raw TCP and discovers the driver endpoint via
``socket.gethostbyname(gethostname())``.

Frames are ``!Q``-length-prefixed pickles — or, for the parameter-server
hot path, pre-encoded packed-codec payloads (``RawPayload``) recognized
by magic bytes and sent/received without a pickle round-trip or a
full-frame copy. Because ``pickle.loads`` on attacker bytes is code
execution, frames can carry an HMAC-SHA256 tag (``key=``): the receiver
verifies the tag BEFORE unpickling and treats a mismatch as a connection
error. Keyless framing matches the reference's same-trusted-job model
and stays the single-host loopback default.

A process-wide fault injector (``set_fault_injector``; a
``resilience.faults.FaultInjector``) is consulted once per frame in
``send``/``receive``, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import socket
import struct
import threading
import time

_LEN = struct.Struct("!Q")
_MAC_LEN = 32  # HMAC-SHA256 digest size
_NONCE_LEN = 16
_TS = struct.Struct("!d")
_AUTH_HDR_LEN = _NONCE_LEN + _TS.size

# Packed-codec frame magics (defined HERE, not in parameter/wire.py,
# because wire.py imports this module). Pickle protocol ≥2 bodies start
# with b"\x80", so sniffing these ASCII magics can never misclassify a
# legacy pickle peer's frame.
MAGIC_TREE = b"EPK1"  # packed tensor tree (parameter.wire.encode_tree)
MAGIC_NOTMOD = b"EPNM"  # tiny "not modified since version" reply
MAGIC_REJECT = b"EPRJ"  # typed "delta rejected: too stale" push reply
MAGIC_KV = b"EPKV"  # KV-block handoff frame (parameter.wire.encode_kv_blocks)
_PACKED_MAGICS = (MAGIC_TREE, MAGIC_NOTMOD, MAGIC_REJECT, MAGIC_KV)

_SEND_CHUNK = 1 << 20  # slice large buffers so no send stages a huge copy

# -- deterministic fault injection (resilience.faults) ------------------------
#
# A process-wide injector consulted once per frame in send()/receive().
# None (the default) costs a single attribute check; chaos tests install
# a resilience.faults.FaultInjector whose FaultPlan decides — purely
# from (seed, label, frame_seq) — whether this frame is dropped (raises
# ConnectionError at the injection site, the wire model of a lost
# frame/partition), delayed, or duplicated (the frame bytes are sent
# twice; with auth the peer's ReplayGuard rejects the copy, without it
# the duplicate double-applies — both are behaviors worth testing).
_fault_injector = None


def set_fault_injector(injector) -> None:
    """Install/clear (None) the process-wide wire fault injector."""
    global _fault_injector
    _fault_injector = injector


class RawPayload:
    """A pre-encoded wire payload as scatter-gather ``chunks``.

    ``send`` ships a ``RawPayload`` WITHOUT pickling and WITHOUT
    concatenating header+MAC+payload into one throwaway ``bytes`` — the
    MAC is computed incrementally over the chunks and each chunk goes to
    the socket as a ``memoryview`` slice. ``receive`` hands packed
    payloads (recognized by magic) back as raw bytes for the caller's
    codec; anything else is treated as legacy pickle.
    """

    __slots__ = ("chunks", "nbytes")

    def __init__(self, chunks):
        self.chunks = [
            c if isinstance(c, memoryview) else memoryview(c) for c in chunks
        ]
        self.nbytes = sum(c.nbytes for c in self.chunks)


def frame_mac(key: bytes, payload: bytes) -> bytes:
    """HMAC-SHA256 tag for one wire payload."""
    return hmac.new(key, payload, hashlib.sha256).digest()


def chunks_mac(key: bytes, parts) -> bytes:
    """HMAC-SHA256 over a sequence of buffers without concatenating."""
    mac = hmac.new(key, digestmod=hashlib.sha256)
    for part in parts:
        mac.update(part)
    return mac.digest()


def _sendall_chunks(sock: socket.socket, chunks) -> None:
    """Write each chunk, slicing big ones so no full-frame copy is staged."""
    for chunk in chunks:
        view = chunk if isinstance(chunk, memoryview) else memoryview(chunk)
        if view.nbytes <= _SEND_CHUNK:
            sock.sendall(view)
            continue
        view = view.cast("B")
        for off in range(0, view.nbytes, _SEND_CHUNK):
            sock.sendall(view[off:off + _SEND_CHUNK])


class ReplayGuard:
    """Reject duplicate or stale authenticated frames (server side).

    An HMAC alone authenticates the SENDER, not the OCCASION: a captured
    update/barrier frame replays verbatim and would double-apply. Each
    authenticated frame therefore carries a random nonce + wall-clock
    timestamp under the MAC; the receiver rejects frames outside the
    freshness ``window`` (hosts in one job are NTP-close; 300s is
    generous) and nonces it has already seen within it. Nonce memory is
    bounded by pruning expired entries."""

    def __init__(self, window: float = 300.0):
        from collections import deque

        self.window = window
        self._seen: set = set()
        self._order = deque()  # (expiry, nonce) in arrival order
        self._lock = threading.Lock()

    def check(self, nonce: bytes, ts: float) -> None:
        now = time.time()
        if abs(now - ts) > self.window:
            raise ConnectionError(
                "authenticated frame outside the replay-freshness window"
            )
        with self._lock:
            # Amortized O(1): expiries arrive ROUGHLY in order, so popping
            # the stale front is all the pruning ever needed (a wholesale
            # rebuild per frame would make a busy PS CPU-bound). A frame
            # from a fast-clocked sender can append a later expiry than
            # its successors, which only DELAYS pruning of those entries
            # (bounded by the window) — never drops a live nonce early.
            while self._order and self._order[0][0] <= now:
                self._seen.discard(self._order.popleft()[1])
            if nonce in self._seen:
                raise ConnectionError("replayed authenticated frame rejected")
            self._seen.add(nonce)
            # Retain until the frame could no longer pass the freshness
            # check above (advisor r4): a sender whose clock is AHEAD by S
            # passes freshness until ts + window, so expiring its nonce at
            # now + window would open an S-second replay gap.
            self._order.append((max(now, ts) + self.window, nonce))


def host_ip() -> str:
    """This host's outward-facing IP.

    UDP-connect trick: "connecting" a datagram socket to any external
    address selects the routable local interface without sending a packet.
    ``gethostbyname(gethostname())`` — the reference's approach — returns
    127.0.1.1 on many Linux hosts (an /etc/hosts alias), which other hosts
    can't dial; this avoids that failure mode and needs no actual network
    reachability.
    """
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # never sent; routing only
            ip = s.getsockname()[0]
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    try:  # fall back to resolver, rejecting loopback aliases
        ip = socket.gethostbyname(socket.gethostname())
        if not ip.startswith("127."):
            return ip
    except socket.gaierror:
        pass
    return "127.0.0.1"


def determine_master(port: int = 4000) -> str:
    """Return ``"<host_ip>:<port>"`` for the driver/host-0 endpoint.

    Mirrors the reference's ``determine_master``; used to embed the
    parameter-server address into worker closures.
    """
    return f"{host_ip()}:{port}"


def send(
    sock: socket.socket, obj, key: bytes | None = None, bind: bytes = b""
) -> bytes:
    """Pickle ``obj`` and send it with an 8-byte length prefix; with
    ``key``, the frame is [mac32][nonce16][ts8][payload] with the
    HMAC-SHA256 tag covering bind+nonce+ts+payload (see ``ReplayGuard``).

    ``bind`` mixes extra context under the MAC without shipping it —
    servers bind replies to the REQUEST's nonce so a captured response
    can't be replayed into a later exchange (the receiver must pass the
    same ``bind``). Returns this frame's nonce (b"" when keyless) so
    callers can bind the reply they are about to read.

    A ``RawPayload`` (packed-codec frames) is sent as-is: its chunks go
    out as memoryview slices after the small length/MAC/nonce prefix —
    the payload is never copied into a contiguous frame, and the MAC is
    computed incrementally over the same chunks."""
    action = "pass"
    if _fault_injector is not None:
        # May raise ConnectionError (planned drop/partition) or sleep
        # (planned delay) BEFORE anything hits the wire — the peer never
        # sees a dropped frame, exactly like a lost packet.
        action = _fault_injector.on_send(sock)
    if isinstance(obj, RawPayload):
        chunks, payload_len = obj.chunks, obj.nbytes
    else:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        chunks, payload_len = [payload], len(payload)
    if key is not None:
        nonce = os.urandom(_NONCE_LEN)
        auth_hdr = nonce + _TS.pack(time.time())
        mac = chunks_mac(key, [bind, auth_hdr, *chunks])
        prefix = _LEN.pack(payload_len + _AUTH_HDR_LEN + _MAC_LEN) + mac + auth_hdr
        _sendall_chunks(sock, [prefix, *chunks])
        if action == "dup":  # byte-identical duplicate (same nonce):
            _sendall_chunks(sock, [prefix, *chunks])
        return nonce
    _sendall_chunks(sock, [_LEN.pack(payload_len), *chunks])
    if action == "dup":
        _sendall_chunks(sock, [_LEN.pack(payload_len), *chunks])
    return b""


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    """Read exactly ``n`` bytes into ONE preallocated buffer (recv_into,
    no chunk-list join copy) and return a read-write view of it."""
    buf = bytearray(n)
    view = memoryview(buf)
    pos = 0
    while pos < n:
        got = sock.recv_into(view[pos:], min(n - pos, 1 << 20))
        if not got:
            raise ConnectionError("socket closed mid-frame")
        pos += got
    return view


def _loads_or_raw(payload: memoryview):
    """Magic-byte negotiation: packed-codec payloads come back RAW
    (bytes-like, for ``parameter.wire.decode``); anything else is a
    legacy pickle frame and is unpickled here. Only called AFTER the
    HMAC check when a key is configured."""
    if bytes(payload[:4]) in _PACKED_MAGICS:
        return payload
    return pickle.loads(payload)


def receive(
    sock: socket.socket,
    key: bytes | None = None,
    replay_guard: ReplayGuard | None = None,
    bind: bytes = b"",
    return_nonce: bool = False,
):
    """Receive one length-prefixed pickled object (inverse of ``send``).

    With ``key``, the frame's HMAC tag is verified BEFORE any payload
    decode — unauthenticated or tampered bytes never reach
    ``pickle.loads`` (and never reach the packed codec either; the
    magic sniff below happens strictly after the MAC check).
    ``replay_guard`` (servers) additionally rejects duplicate/stale
    nonces under the MAC. ``bind`` must match the sender's (clients pass
    their request nonce when reading the reply). ``return_nonce=True``
    returns ``(obj, nonce)`` so servers can bind their reply.

    Packed-codec payloads (``MAGIC_TREE``/``MAGIC_NOTMOD``) are returned
    as raw bytes-like views for ``parameter.wire`` to decode zero-copy;
    everything else unpickles as before."""
    if _fault_injector is not None:
        # A planned recv drop models the reply lost in flight: raise
        # before reading so the caller's connection-error path runs.
        _fault_injector.on_recv(sock)
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    data = _recv_exact(sock, length)
    if key is not None:
        if length < _MAC_LEN + _AUTH_HDR_LEN:
            raise ConnectionError("authenticated frame shorter than its header")
        tag, body = data[:_MAC_LEN], data[_MAC_LEN:]
        if not hmac.compare_digest(tag, chunks_mac(key, [bind, body])):
            raise ConnectionError(
                "wire-frame authentication failed (bad or missing HMAC)"
            )
        nonce = bytes(body[:_NONCE_LEN])
        (ts,) = _TS.unpack(body[_NONCE_LEN:_AUTH_HDR_LEN])
        if replay_guard is not None:
            replay_guard.check(nonce, ts)
        obj = _loads_or_raw(body[_AUTH_HDR_LEN:])
        return (obj, nonce) if return_nonce else obj
    obj = _loads_or_raw(data)
    return (obj, b"") if return_nonce else obj
