"""Sharded parameter-server group with a WAL-streamed hot standby tier
(counterpart of ``elephas_tpu/parameter/group.py``).

One PS process is the aggregate-bandwidth ceiling for a large worker
fleet, and failover on a single server is a cold warm restart. This
module scales the PS horizontally and makes failover a *promotion*:

- ``ShardPlan`` — a deterministic partition of the parameter tree across
  K server processes. The partition key is the packed wire codec's
  per-leaf header row (dtype, shape, nbytes): leaves are bin-packed by
  payload bytes, largest first, so each shard carries a near-equal slice
  of the wire traffic. The plan is pinned by a **shard-map digest**; the
  client/server handshake verifies it, so a client holding a stale plan
  gets a typed ``ShardMapMismatch`` instead of silently merging the
  wrong leaves. The codec is byte-identical to the JAX package's, so a
  plan's rows, placement and digest are too: either package's client
  talks to either package's group.
- ``ShardedParameterClient`` — scatters pushes and gathers pulls across
  the shards concurrently. Each shard is an unmodified wire server over
  a *flat path-keyed sub-tree*, so the per-shard version-gated
  not-modified cache and the ``sv``/``wk`` staleness stamps keep working
  shard by shard with no new wire format.
- ``WalStreamer`` + ``ShardGroup`` — each primary's ``SnapshotWAL``
  is tailed into a warm spare's buffer (on the card, uploaded on the
  spare buffer's stream). When the group's
  ``FailureDetector`` declares a primary dead, the spare is promoted:
  final WAL catch-up, ``start()``, directory re-publish. The dead
  primary's boot id is **fenced** — a zombie that comes back serving its
  old boot fails the handshake — and the promoted server's fresh boot id
  invalidates every client's not-modified cache for that shard, exactly
  the (boot, version) gating warm restarts already rely on.

Group membership is a ``GroupDirectory``: a generation-counted
shard → address map. Clients re-resolve on a generation bump (failover),
so a promotion is visible as one reconnect, not a config push.

Observability: with ``ops_port`` every member mounts an ops endpoint
(primary ``i`` at ``ops_port + i``, spare ``i`` at ``ops_port + k + i``;
0 gives each a free port) whose ``/shards`` route serves the group's
topology (``snapshot``); a spare mounts at ``start()`` although it
serves no PS traffic, so the fleet board shows the standby tier. With a
``wal_root`` each primary journals at ``<wal_root>/shard<i>/telemetry``
and each spare at ``<wal_root>/standby<i>/telemetry``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elephas_tpu_torch import obs
from elephas_tpu_torch.checkpoint.checkpoint import NoCheckpointError
from elephas_tpu_torch.parameter import wire
from elephas_tpu_torch.parameter.base import BaseParameterClient, BaseParameterServer
from elephas_tpu_torch.parameter.client import (
    HostCopy,
    ParameterServerUnavailable,
    make_client,
)
from elephas_tpu_torch.parameter.server import _dial_host, make_server
from elephas_tpu_torch.resilience.liveness import FailureDetector
from elephas_tpu_torch.resilience.wal import SnapshotWAL

__all__ = [
    "FencedPrimaryError",
    "GroupDirectory",
    "ShardGroup",
    "ShardGroupError",
    "ShardMapMismatch",
    "ShardPlan",
    "ShardedParameterClient",
    "WalStreamer",
]


class ShardGroupError(RuntimeError):
    """Base class for shard-group protocol errors."""


class ShardMapMismatch(ShardGroupError):
    """Client and server disagree on the shard plan (digest/slot) — a
    stale plan must be a typed error, never a silently mis-merged tree."""


class FencedPrimaryError(ShardGroupError):
    """The dialed server is a fenced (pre-failover) primary — a zombie
    that must not receive writes; re-resolve through the directory."""


def _shard_failover_counter():
    return obs.default_registry().counter(
        "ps_shard_failover_total",
        "standby promotions after a shard primary was declared dead",
    )


def _standby_lag_gauge():
    return obs.default_registry().gauge(
        "ps_standby_lag_snapshots",
        "durable WAL snapshot versions a shard's hot standby has not "
        "yet applied",
        labelnames=("shard",),
    )


# -- shard plan ---------------------------------------------------------------


def _leaf_paths(obj, prefix: Tuple[str, ...], out: List[str]) -> None:
    """Leaf paths in EXACTLY ``wire._build_skeleton``'s traversal order
    (dict insertion order, depth-first), so path i names header row i."""
    if obj is None:
        return
    if isinstance(obj, dict):
        for key, val in obj.items():
            _leaf_paths(val, prefix + (str(key),), out)
        return
    if isinstance(obj, (list, tuple)):
        for i, val in enumerate(obj):
            _leaf_paths(val, prefix + (str(i),), out)
        return
    out.append("/".join(prefix))


def _row(leaf) -> list:
    """A leaf's wire header row ``[dtype, shape, nbytes]``, read from its
    metadata (a tensor on the card is not copied)."""
    if isinstance(leaf, torch.Tensor):
        return [wire._dtype_name(leaf), list(leaf.shape),
                leaf.numel() * leaf.element_size()]
    arr = np.asarray(leaf)
    if arr.dtype == object:
        raise ShardGroupError("object-dtype leaf has no wire layout")
    return [arr.dtype.name, list(arr.shape), int(arr.nbytes)]


class ShardPlan:
    """Deterministic K-way partition of a parameter tree.

    ``build`` enumerates the tree with the packed codec's own skeleton
    walk, computes each leaf's wire header row, and greedily bin-packs
    leaves onto shards by payload bytes (largest first; ties broken by
    path, then by shard index) — the same inputs always produce the same
    plan, on any host. Each shard's store is a FLAT ``{path: leaf}``
    dict, which is itself a valid packed-codec tree: every shard server
    is an unmodified ``HttpServer``/``SocketServer`` with its full cache
    /WAL/staleness machinery intact.
    """

    __slots__ = ("k", "paths", "rows", "shard_of", "_skeleton")

    def __init__(self, k: int, paths: List[str], rows: List[list],
                 shard_of: List[int], skeleton):
        self.k = k
        self.paths = paths
        self.rows = rows          # per-leaf [dtype, shape, nbytes]
        self.shard_of = shard_of  # leaf index -> shard index
        self._skeleton = skeleton

    @classmethod
    def build(cls, tree, k: int) -> "ShardPlan":
        if k < 1:
            raise ValueError(f"shard count must be >= 1, got {k}")
        leaves: List[Any] = []
        try:
            skeleton = wire._build_skeleton(tree, leaves)
        except wire.WireFormatError as exc:
            raise ShardGroupError(
                f"shard plan needs a packed-codec-compatible tree: {exc}"
            ) from exc
        paths: List[str] = []
        _leaf_paths(tree, (), paths)
        if len(paths) != len(leaves):  # defensive: walks must agree
            raise ShardGroupError(
                f"path walk found {len(paths)} leaves but the codec "
                f"skeleton found {len(leaves)}"
            )
        if len(set(paths)) != len(paths):
            raise ShardGroupError(
                "parameter tree has colliding leaf paths (e.g. dict keys "
                "0 and '0' at one level) — cannot shard by path"
            )
        if k > len(leaves):
            raise ValueError(
                f"cannot spread {len(leaves)} leaves over {k} shards "
                "(every shard must own at least one leaf)"
            )
        rows = [_row(leaf) for leaf in leaves]
        # Greedy longest-processing-time: biggest leaf onto the lightest
        # shard. Ties in size break by path; ties in load by shard index.
        order = sorted(range(len(leaves)),
                       key=lambda i: (-rows[i][2], paths[i]))
        loads = [0] * k
        shard_of = [0] * len(leaves)
        for i in order:
            shard = min(range(k), key=lambda s: (loads[s], s))
            shard_of[i] = shard
            loads[shard] += rows[i][2]
        return cls(k, paths, rows, shard_of, skeleton)

    @property
    def digest(self) -> str:
        """Content hash of the full plan — partition key AND placement.
        The client/server handshake compares this, so any drift (plan
        built from a different tree, different K, different balancer)
        is a typed error before a single leaf moves. Entries are sorted
        by path: two plans over the same tree hash identically even if
        one was built from a sorted-key copy (the parameter buffer holds
        dicts in sorted order; the balancer is order-insensitive too)."""
        doc = [self.k, sorted([p, s, r] for p, s, r
                              in zip(self.paths, self.shard_of, self.rows))]
        blob = json.dumps(doc, separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def bytes_per_shard(self) -> List[int]:
        loads = [0] * self.k
        for i, shard in enumerate(self.shard_of):
            loads[shard] += self.rows[i][2]
        return loads

    def shard_paths(self, shard: int) -> List[str]:
        return [p for p, s in zip(self.paths, self.shard_of) if s == shard]

    def split(self, tree) -> List[Dict[str, Any]]:
        """The K flat ``{path: leaf}`` sub-trees of ``tree``.

        Keyed by the GIVEN tree's own path walk, never positionally
        against the plan's build order: the buffer and tree maps rebuild
        dicts in sorted-key order, so a delta computed from a pulled tree
        legitimately carries the same paths in a different traversal
        order. An unknown or missing path —
        a genuinely different tree — is a ``ShardMapMismatch``."""
        leaves: List[Any] = []
        paths: List[str] = []
        wire._build_skeleton(tree, leaves)
        _leaf_paths(tree, (), paths)
        if len(paths) != len(leaves):
            raise ShardGroupError(
                f"path walk found {len(paths)} leaves but the codec "
                f"skeleton found {len(leaves)}"
            )
        if set(paths) != set(self.paths):
            unknown = sorted(set(paths) - set(self.paths))[:3]
            missing = sorted(set(self.paths) - set(paths))[:3]
            raise ShardMapMismatch(
                f"tree does not match the shard plan (digest "
                f"{self.digest}): unknown leaves {unknown}, missing "
                f"leaves {missing}"
            )
        shard_by_path = dict(zip(self.paths, self.shard_of))
        out: List[Dict[str, Any]] = [{} for _ in range(self.k)]
        for path, leaf in zip(paths, leaves):
            out[shard_by_path[path]][path] = leaf
        return out

    def shard_tree(self, tree, shard: int) -> Dict[str, Any]:
        return self.split(tree)[shard]

    def merge(self, shard_trees: List[Dict[str, Any]]):
        """Reassemble the full tree from the K flat sub-trees (inverse
        of ``split``; raises ``ShardMapMismatch`` on a missing leaf)."""
        leaves: List[Any] = []
        for i, path in enumerate(self.paths):
            sub = shard_trees[self.shard_of[i]]
            if path not in sub:
                raise ShardMapMismatch(
                    f"shard {self.shard_of[i]} reply is missing leaf "
                    f"{path!r} — stale shard map?"
                )
            leaves.append(sub[path])
        return wire._restore_skeleton(self._skeleton, leaves)

    def describe(self) -> Dict[str, Any]:
        return {"k": self.k, "digest": self.digest,
                "leaves": len(self.paths),
                "bytes_per_shard": self.bytes_per_shard()}


# -- directory ----------------------------------------------------------------


class GroupDirectory:
    """Generation-counted shard → (address, boot) map plus the fence set.

    The group's single source of truth for "who serves shard i right
    now". A promotion bumps ``generation``; sharded clients compare the
    generation per call and re-dial on a bump — re-resolution is one
    integer check on the hot path. ``fence`` records the boot ids of
    dead primaries; the handshake rejects a server presenting a fenced
    boot (the zombie that never noticed it was declared dead).
    """

    def __init__(self, digest: str, k: int):
        self.digest = digest
        self.k = k
        self._addresses: Dict[int, str] = {}
        self._boots: Dict[int, str] = {}
        self._fenced: set = set()
        self._generation = 0
        self._lock = threading.Lock()

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def publish(self, shard: int, address: str, boot: str) -> int:
        with self._lock:
            self._addresses[shard] = address
            self._boots[shard] = boot
            self._generation += 1
            return self._generation

    def address_of(self, shard: int) -> str:
        with self._lock:
            try:
                return self._addresses[shard]
            except KeyError:
                raise ShardGroupError(
                    f"no address published for shard {shard}"
                ) from None

    def fence(self, boot: str) -> None:
        with self._lock:
            self._fenced.add(boot)

    def is_fenced(self, boot: Optional[str]) -> bool:
        with self._lock:
            return boot in self._fenced

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"digest": self.digest, "k": self.k,
                    "generation": self._generation,
                    "addresses": dict(self._addresses),
                    "boots": dict(self._boots),
                    "fenced": sorted(self._fenced)}


# -- sharded client -----------------------------------------------------------


class ShardedParameterClient(BaseParameterClient):
    """Scatter/gather client over a K-shard group.

    Holds one wire sub-client per shard (dialed through the directory,
    re-dialed on a generation bump) and runs the K round-trips of every
    pull/push concurrently on a small pool — aggregate bandwidth scales
    with K while each sub-client keeps its own version-gated pull cache
    and staleness stamps.

    Handshake: the first dial to each shard fetches the server's
    ``shard_info`` and verifies (digest, slot, un-fenced boot). A server
    that doesn't present a shard map, presents the wrong digest, or sits
    in the wrong slot raises ``ShardMapMismatch``; a fenced boot raises
    ``FencedPrimaryError`` (and triggers one directory re-resolution —
    the promotion may simply not have reached this client yet).
    """

    def __init__(self, mode: str, directory: GroupDirectory, plan: ShardPlan,
                 auth_key: Optional[bytes] = None,
                 codec: Optional[str] = None,
                 push_quantize: Optional[str] = None):
        if mode not in ("http", "socket"):
            raise ValueError(
                f"sharded client needs a wire transport, got {mode!r}")
        if directory.digest != plan.digest:
            raise ShardMapMismatch(
                f"directory pins digest {directory.digest} but the plan "
                f"is {plan.digest}"
            )
        self._mode = mode
        self._directory = directory
        self._plan = plan
        self._auth_key = auth_key
        self._codec = codec
        self._push_quantize = push_quantize
        self._worker_id: Optional[str] = None
        self._sync_interval: Optional[float] = None
        self._clients: Dict[int, BaseParameterClient] = {}
        self._client_gen = -1
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=plan.k, thread_name_prefix="ps-shard")

    # worker_id is a property so a post-construction stamp (the elastic
    # pool's client factory contract) propagates to every sub-client.
    @property
    def worker_id(self) -> Optional[str]:
        return self._worker_id

    @worker_id.setter
    def worker_id(self, value: Optional[str]) -> None:
        self._worker_id = value
        with self._lock:
            for client in self._clients.values():
                client.worker_id = value

    # Same post-construction propagation for the SYNC-column stamp: the
    # comms pipeline updates it on the pool client, every sub-client's
    # next push carries it.
    @property
    def sync_interval(self) -> Optional[float]:
        return self._sync_interval

    @sync_interval.setter
    def sync_interval(self, value: Optional[float]) -> None:
        self._sync_interval = value
        with self._lock:
            for client in self._clients.values():
                client.sync_interval = value

    @property
    def plan(self) -> ShardPlan:
        return self._plan

    def _verify(self, shard: int, client, address: str) -> None:
        info = client.shard_info()
        if info is None:
            obs.default_flight_recorder().note(
                "shard_map_mismatch", "error",
                shard=shard, address=address, reason="no shard map",
            )
            raise ShardMapMismatch(
                f"server at {address} presented no shard map — is it a "
                "standalone (unsharded) parameter server?"
            )
        if self._directory.is_fenced(info.get("boot")):
            raise FencedPrimaryError(
                f"server at {address} is a fenced primary for shard "
                f"{shard} (boot {info.get('boot')}) — re-resolve"
            )
        if (info.get("digest") != self._plan.digest
                or info.get("shard") != shard):
            obs.default_flight_recorder().note(
                "shard_map_mismatch", "error",
                shard=shard, address=address,
                server_digest=info.get("digest"),
                server_shard=info.get("shard"),
                client_digest=self._plan.digest,
            )
            raise ShardMapMismatch(
                f"shard map mismatch at {address}: server serves shard "
                f"{info.get('shard')} of plan {info.get('digest')}, client "
                f"expected shard {shard} of plan {self._plan.digest}"
            )

    def _client(self, shard: int):
        with self._lock:
            gen = self._directory.generation
            if gen != self._client_gen:
                # Failover re-resolution: one promotion invalidates the
                # whole pool (cheap — K small), and the promoted server's
                # fresh boot id makes the first pull a full body anyway.
                for client in self._clients.values():
                    client.close()
                self._clients.clear()
                self._client_gen = gen
            client = self._clients.get(shard)
            if client is None:
                address = self._directory.address_of(shard)
                client = make_client(
                    self._mode, address, auth_key=self._auth_key,
                    codec=self._codec, push_quantize=self._push_quantize,
                )
                client.worker_id = self._worker_id
                client.sync_interval = self._sync_interval
                try:
                    self._verify(shard, client, address)
                except Exception:
                    client.close()
                    raise
                self._clients[shard] = client
            return client

    def shard_client(self, shard: int):
        """The dialed wire sub-client for ONE shard (a per-shard probe
        surface). Shares the pool's cache, verification, and
        generation-bump re-dial."""
        if not 0 <= shard < self._plan.k:
            raise ValueError(
                f"shard {shard} outside plan of {self._plan.k}")
        return self._client(shard)

    def _fanout(self, fn, shards: Optional[List[int]] = None) -> List[Any]:
        """Run ``fn(shard, client)`` for every shard concurrently; the
        first failure propagates (after every future settles, so no
        request is abandoned mid-socket)."""
        shards = list(range(self._plan.k)) if shards is None else shards

        def one(shard: int):
            return fn(shard, self._client(shard))

        futures = [self._pool.submit(one, s) for s in shards]
        results, first_exc = [], None
        for fut in futures:
            try:
                results.append(fut.result())
            except Exception as exc:
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc
        return results

    def get_parameters(self):
        with obs.default_tracer().span("ps/gather", shards=self._plan.k):
            subs = self._fanout(lambda s, c: c.get_parameters())
        return self._plan.merge(subs)

    def known_version(self) -> Optional[int]:
        """The group's pulled position: max over the sub-clients' cached
        versions (None before any pull). Shard version lines advance in
        lockstep under full-tree pushes — every ``update_parameters``
        scatters one slice to every shard — so the max IS the group
        version; a lagging shard is surfaced by the next ``pull``'s
        per-shard version check, not hidden by a min()."""
        versions = [
            c.known_version() for c in list(self._clients.values())
            if hasattr(c, "known_version")
        ]
        versions = [v for v in versions if v is not None]
        return max(versions) if versions else None

    def pull(self, version: Optional[int] = None):
        """``(version, tree)`` — the subscription plane's read.

        ``version=None`` is the live read: the normal version-gated
        gather (steady state costs K not-modified frames) plus the
        group position the reply landed at. ``version=`` is the PINNED
        read: every shard answers from its live buffer or its WAL
        history at exactly that version (``get_parameters_pinned``), so
        rollback and A/B reads cannot race ongoing training pushes.
        Raises ``VersionUnavailable`` when any shard has pruned the pin.
        """
        if version is not None:
            pin = int(version)
            with obs.default_tracer().span(
                    "ps/gather_pinned", shards=self._plan.k):
                subs = self._fanout(
                    lambda s, c: c.get_parameters_pinned(pin))
            return pin, self._plan.merge(subs)
        tree = self.get_parameters()
        return self.known_version(), tree

    def update_parameters(self, delta) -> None:
        # Admission is per shard: each member judges its slice against
        # its own version line, so a StaleDeltaRejected from any shard
        # propagates (first exception wins) while fresher shards may
        # already have applied theirs — sound for SGD (a partial delta
        # is just a smaller step) and the client's re-pull resyncs all
        # K sub-caches anyway. A delta whose copy to the host is in
        # flight (the comms pipeline's ``HostCopy``) is waited for first.
        if isinstance(delta, HostCopy):
            delta = delta.wait()
        parts = self._plan.split(delta)
        with obs.default_tracer().span("ps/scatter", shards=self._plan.k):
            self._fanout(lambda s, c: c.update_parameters(parts[s]))

    def heartbeat(self, worker_id: str) -> None:
        # Every shard's detector sees the worker: membership stays
        # consistent no matter which shard the elastic pool polls.
        self._fanout(lambda s, c: c.heartbeat(worker_id))

    def membership(self) -> dict:
        return self._client(0).membership()

    def deregister(self, worker_id: str) -> None:
        self._fanout(lambda s, c: c.deregister(worker_id))

    def health(self) -> bool:
        try:
            return all(self._fanout(lambda s, c: c.health()))
        except (ShardGroupError, ParameterServerUnavailable, OSError):
            return False

    def wait_barrier(self, tag: str, n: int,
                     timeout: Optional[float] = None) -> None:
        # Barriers are control-plane, not sharded state: shard 0 hosts
        # the arrival counters for the whole group.
        self._client(0).wait_barrier(tag, n, timeout=timeout)

    def close(self) -> None:
        with self._lock:
            for client in self._clients.values():
                client.close()
            self._clients.clear()
        self._pool.shutdown(wait=False)


# -- WAL streaming + standby --------------------------------------------------


class WalStreamer:
    """Tail a primary's ``SnapshotWAL`` into a standby's buffer.

    The WAL is file-per-version with atomic renames, so tailing is just
    polling ``latest_version()`` and decoding the newest durable
    snapshot into the spare's ``ParameterBuffer`` — the standby is never
    more than one poll interval plus ``wal_every - 1`` versions behind
    what the primary acked. ``clock``/``sleep`` are injectable so
    promotion lifecycles are testable on a fake clock.
    """

    def __init__(self, wal, buffer, poll_interval: float = 0.05,
                 sleep=time.sleep):
        self._wal = wal
        self._buffer = buffer
        self._poll_interval = poll_interval
        self._sleep = sleep
        self.applied_version: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> Optional[int]:
        """Apply the newest durable snapshot if it is new; returns the
        version applied (None when already current / WAL empty)."""
        latest = self._wal.latest_version()
        if latest is None or latest == self.applied_version:
            return None
        try:
            version, tree = self._wal.restore_latest()
        except NoCheckpointError:
            return None
        if self.applied_version is not None \
                and version <= self.applied_version:
            return None
        self._buffer.set(tree, version=version)
        self.applied_version = version
        return version

    def lag(self) -> int:
        """Durable snapshots the standby has not applied yet (snapshot
        count, not version delta — honest under sparse ``wal_every``)."""
        return len(self._wal.versions_after(self.applied_version))

    def start(self) -> "WalStreamer":
        if self._thread is not None:
            return self

        def run():
            while not self._stop.is_set():
                try:
                    self.poll_once()
                except OSError:
                    pass  # a mid-prune glob race; next poll sees truth
                self._sleep(self._poll_interval)

        self._thread = threading.Thread(
            target=run, name="wal-streamer", daemon=True)
        self._thread.start()
        return self

    def stop(self, catch_up: bool = True) -> Optional[int]:
        """Stop tailing; with ``catch_up`` (the promotion path) apply
        the newest durable snapshot one final time before returning.
        Returns the standby's applied version — the promotion floor."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if catch_up:
            self.poll_once()
        return self.applied_version


class ShardGroup(BaseParameterServer):
    """K shard primaries + optional warm standbys, one per shard.

    The orchestrator the engines/benches drive: builds the plan, boots
    one wire server per shard over its flat sub-tree (role
    ``ps/shard<i>``), publishes addresses into a ``GroupDirectory``, and
    — with ``standby=1`` — keeps an unstarted spare per shard whose
    buffer a ``WalStreamer`` feeds from the primary's WAL.

    Failure handling: ``check()`` runs one monitor pass — health-probe
    every active primary, beat the group's ``FailureDetector``, and
    promote the spare of any shard the detector sweeps dead (fencing the
    dead primary's boot id first). ``start_monitor()`` runs ``check``
    on a daemon thread; tests drive ``check`` directly on a fake clock.

    ``device``: where every member's and every spare's buffer lives (the
    card unless ``"cpu"`` is passed).
    """

    def __init__(self, params, k: int, mode: str = "socket",
                 standby: int = 0, wal_root: Optional[str] = None,
                 lock: bool = True, device=None, host: Optional[str] = None,
                 granularity: str = "tree",
                 auth_key: Optional[bytes] = None, wal_every: int = 1,
                 wal_keep: int = 3,
                 heartbeat_timeout: Optional[float] = None,
                 ops_port: Optional[int] = None,
                 suspect_after: float = 0.5,
                 clock=time.monotonic, sleep=time.sleep,
                 stream_poll_interval: float = 0.05,
                 max_staleness: Optional[int] = None,
                 staleness_soft: Optional[int] = None):
        if mode not in ("http", "socket"):
            raise ValueError(
                "a PS group needs a wire transport (http|socket): shards "
                f"are separate server processes, got mode={mode!r}"
            )
        if standby not in (0, 1):
            raise ValueError(
                f"standby must be 0 or 1 (one warm spare per shard), "
                f"got {standby}"
            )
        if standby and wal_root is None:
            raise ValueError(
                "standby=1 streams each primary's WAL to its spare — "
                "pass wal_root= (the per-shard WAL parent directory)"
            )

        self.plan = ShardPlan.build(params, k)
        self.mode = mode
        self.standby = standby
        self.wal_root = wal_root
        self.auth_key = auth_key
        self.directory = GroupDirectory(self.plan.digest, k)
        self.detector = FailureDetector(
            suspect_after=suspect_after, clock=clock)
        self.promotions: List[Dict[str, Any]] = []
        self._clock = clock
        self._sleep = sleep
        self._stream_poll_interval = stream_poll_interval
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._health_clients: Dict[int, Any] = {}
        self._health_gen = -1
        self._lock = threading.Lock()
        self._started = False

        def build(shard: int, role: str, ops: Optional[int],
                  store_dir: Optional[str] = "auto"):
            wal_dir = (os.path.join(wal_root, f"shard{shard}")
                       if wal_root else None)
            return make_server(
                mode, self.plan.shard_tree(params, shard), lock=lock,
                port=0, device=device, host=host, granularity=granularity,
                auth_key=auth_key, wal_dir=wal_dir, wal_every=wal_every,
                wal_keep=wal_keep,
                heartbeat_timeout=heartbeat_timeout, ops_port=ops,
                role=role,
                shard_info={"digest": self.plan.digest, "shard": shard,
                            "k": k},
                # Every member enforces the same staleness bounds: a
                # sharded push is admitted (or refused) per shard against
                # that shard's own version line.
                max_staleness=max_staleness,
                staleness_soft=staleness_soft,
                store_dir=store_dir,
            )

        def ops_at(offset: int) -> Optional[int]:
            if ops_port is None:
                return None
            return 0 if ops_port == 0 else ops_port + offset

        self._active: List[BaseParameterServer] = [
            build(i, f"ps/shard{i}", ops_at(i)) for i in range(k)
        ]
        # A spare shares its shard's wal_dir (WAL streaming) and serves
        # nothing until it is promoted, but does NOT share its telemetry
        # directory: the store's open-time tail healing assumes one live
        # writer a directory, and a spare and its primary live at once.
        self._standbys: List[Optional[BaseParameterServer]] = [
            build(i, "ps/standby", ops_at(k + i),
                  store_dir=os.path.join(wal_root, f"standby{i}", "telemetry"))
            if standby else None
            for i in range(k)
        ]
        for member in self._active + self._standbys:
            if member is not None:
                # Every member's /shards route serves the group topology,
                # so any shard answers "who is the group".
                member.shards_fn = self.snapshot
        self._streamers: List[Optional[WalStreamer]] = [None] * k

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for i, server in enumerate(self._active):
            server.start()
            self.directory.publish(i, self._address(server), server.boot)
            self.detector.beat(f"shard{i}")
        for i, spare in enumerate(self._standbys):
            if spare is None:
                continue
            # A warm spare serves no PS traffic, but its ops endpoint
            # mounts now so the fleet board shows the standby tier.
            spare._mount_ops(self.mode)
            wal = SnapshotWAL(os.path.join(self.wal_root, f"shard{i}"))
            self._streamers[i] = WalStreamer(
                wal, spare.buffer,
                poll_interval=self._stream_poll_interval,
                sleep=self._sleep,
            ).start()
        self._started = True

    @staticmethod
    def _address(server) -> str:
        return f"{_dial_host(server.host)}:{server.port}"

    def stop(self) -> None:
        self.stop_monitor()
        for streamer in self._streamers:
            if streamer is not None:
                streamer.stop(catch_up=False)
        self._streamers = [None] * self.plan.k
        for server in self._active:
            try:
                server.stop()
            except Exception:
                pass
        for spare in self._standbys:
            if spare is not None:
                try:
                    spare.stop()
                except Exception:
                    pass
        with self._lock:
            for client in self._health_clients.values():
                client.close()
            self._health_clients.clear()

    # -- server-compatible surface (engine seam) ----------------------------

    def get_parameters(self):
        """Merged tree straight from the shard buffers (driver-side
        snapshot — validation/checkpoint reads, not the worker path),
        safe to read on the calling thread's current stream."""
        return self.plan.merge(
            [server.get_parameters() for server in self._active]
        )

    def hand_over(self, tree):
        """Make a merged snapshot safe to read on the calling thread's
        current stream (``ParameterBuffer.hand_over``, shard by shard)."""
        for server, sub in zip(self._active, self.plan.split(tree)):
            server.buffer.hand_over(sub)
        return tree

    def client(self) -> ShardedParameterClient:
        return ShardedParameterClient(
            self.mode, self.directory, self.plan, auth_key=self.auth_key)

    def primary(self, shard: int) -> BaseParameterServer:
        return self._active[shard]

    def standby_of(self, shard: int) -> Optional[BaseParameterServer]:
        return self._standbys[shard]

    def streamer_of(self, shard: int) -> Optional[WalStreamer]:
        return self._streamers[shard]

    def kill_primary(self, shard: int) -> None:
        """Chaos surface: crash one primary (no WAL sync, severed
        connections) — what the failure detector then has to notice."""
        self._active[shard].kill()

    # -- failure detection + promotion --------------------------------------

    def _health_client(self, shard: int):
        with self._lock:
            gen = self.directory.generation
            if gen != self._health_gen:
                for client in self._health_clients.values():
                    client.close()
                self._health_clients.clear()
                self._health_gen = gen
            client = self._health_clients.get(shard)
            if client is None:
                client = make_client(
                    self.mode, self.directory.address_of(shard),
                    auth_key=self.auth_key,
                )
                self._health_clients[shard] = client
            return client

    def check(self) -> List[int]:
        """One monitor pass: probe every shard, sweep the detector,
        promote the spares of newly-dead shards. Returns the shard
        indices promoted by THIS pass."""
        for i in range(self.plan.k):
            try:
                alive = self._health_client(i).health()
            except (ShardGroupError, OSError):
                alive = False
            if alive:
                self.detector.beat(f"shard{i}")
        promoted = []
        for worker_id in self.detector.sweep():
            if not str(worker_id).startswith("shard"):
                continue
            shard = int(str(worker_id)[len("shard"):])
            if self.promote(shard):
                promoted.append(shard)
        # Every monitor pass refreshes the standby-lag gauge, so lag is
        # visible even on processes nobody scrapes through /shards.
        self._publish_standby_lag()
        return promoted

    def promote(self, shard: int) -> bool:
        """Promote shard ``shard``'s warm spare to primary.

        Fences the dead primary's boot id (the zombie's shard_info
        handshake fails from now on), stops the streamer with one final
        WAL catch-up (nothing acked-and-durable is lost), starts the
        spare, and re-publishes the directory — clients re-resolve on
        the generation bump and their first pull against the fresh boot
        id is a full body, never an aliased cache hit. Returns False
        when the shard has no spare to promote (the failure stays an
        outage, exactly like the single-PS story).
        """
        spare = self._standbys[shard]
        dead = self._active[shard]
        old_boot = getattr(dead, "boot", None)
        if old_boot is not None:
            self.directory.fence(old_boot)
        if spare is None:
            obs.default_flight_recorder().note(
                "shard_failover", "error", shard=shard,
                old_boot=old_boot, promoted=False,
            )
            return False
        t0 = self._clock()
        streamer = self._streamers[shard]
        caught_up = streamer.stop(catch_up=True) if streamer else None
        self._streamers[shard] = None
        self._standbys[shard] = None
        # The promoted server takes the shard's role before its ops
        # endpoint remounts, so the fleet board shows the new topology.
        spare._unmount_ops()
        spare.role = f"ps/shard{shard}"
        if spare.store is not None:
            # The journal survives the remount: re-stamp its role and mark
            # the hat change, so a post-mortem reads the standby's records
            # and the promoted primary's as one process story.
            spare.store.set_role(spare.role)
            spare.store.record_lifecycle("promoted", shard=shard, old_boot=old_boot)
        try:
            dead.stop()  # a crashed server no-ops; a live one is demoted
        except Exception:
            pass
        spare.start()
        self._active[shard] = spare
        self.directory.publish(shard, self._address(spare), spare.boot)
        self.detector.beat(f"shard{shard}")
        promote_s = self._clock() - t0
        record = {
            "shard": shard, "old_boot": old_boot, "new_boot": spare.boot,
            "version": spare.buffer.version, "caught_up_version": caught_up,
            "promote_s": promote_s,
        }
        self.promotions.append(record)
        _shard_failover_counter().inc()
        flight = obs.default_flight_recorder()
        flight.note("shard_failover", "error", shard=shard,
                    old_boot=old_boot, promoted=True)
        flight.note("standby_promoted", "info", shard=shard,
                    boot=spare.boot, version=spare.buffer.version,
                    promote_s=promote_s)
        return True

    def start_monitor(self, interval: float = 0.2) -> None:
        if self._monitor is not None:
            return
        self._monitor_stop.clear()

        def run():
            while not self._monitor_stop.is_set():
                try:
                    self.check()
                except Exception:
                    pass  # the monitor must outlive one bad probe
                self._sleep(interval)

        self._monitor = threading.Thread(
            target=run, name="ps-group-monitor", daemon=True)
        self._monitor.start()

    def stop_monitor(self) -> None:
        if self._monitor is None:
            return
        self._monitor_stop.set()
        self._monitor.join(timeout=5)
        self._monitor = None

    def _publish_standby_lag(self) -> List[Dict[str, Any]]:
        """Per-standby WAL lag, mirrored into the registry gauge
        ``ps_standby_lag_snapshots{shard=}``. A promoted or
        never-staffed shard has no streamer and reports ``None`` —
        the gauge pins 0 there rather than holding a stale lag."""
        out = []
        gauge = _standby_lag_gauge()
        for i, spare in enumerate(self._standbys):
            streamer = self._streamers[i]
            lag = streamer.lag() if streamer else None
            gauge.labels(shard=str(i)).set(float(lag or 0))
            out.append({
                "shard": i,
                "warm": spare is not None,
                "applied_version": (streamer.applied_version
                                    if streamer else None),
                "lag": lag,
            })
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Introspection doc (the reference's opsd ``/shards`` route)."""
        return {
            "plan": self.plan.describe(),
            "directory": self.directory.snapshot(),
            "standbys": self._publish_standby_lag(),
            "promotions": list(self.promotions),
        }
