"""Asynchronous / hogwild trainer: Downpour SGD against the parameter
server (counterpart of ``elephas_tpu/engine/async_engine.py``).

Reference semantics (SURVEY.md §3.2): each ``AsynchronousSparkWorker``
loops pull -> train one ``frequency`` unit ('epoch' or 'batch') -> push
delta against the driver's parameter server; ``asynchronous`` locks the
server state, ``hogwild`` doesn't.

Each worker is a host thread driving its own copy of the model on its
device, and the parameter server is a ``ParameterBuffer`` on the card:
with the ``local`` transport a pull hands out the buffer's tensors and a
push subtracts on the card; the ``http``/``socket`` transports carry the
same loop over the JAX package's wire frames.

What the port does where the JAX package leaned on XLA and pure
functions:

- **One module per worker.** The module holds the weights and training
  updates them in place, so each worker trains a ``CompiledModel.clone()``
  with its own optimizer, which Downpour keeps across rounds (only
  weights flow through the server, as in the reference), and its own
  ``torch.Generator`` for dropout, seeded from (977, worker, step,
  attempt) as the JAX package folds its key. A pull copies the pulled
  weights into the worker's module; the delta is ``pulled - trained``
  over the parameters and the buffers (BatchNorm statistics travel in
  ``batch_stats``), and the server computes ``weights -= delta``.
- **Streams.** On the card each worker issues its work on a stream of
  its own, and the buffer on another. The buffer orders its work after
  the pusher's stream and hands snapshots over to the reader's stream
  (``ParameterBuffer.hand_over``); a delta crossing to the comms thread
  travels with an event recorded on the worker's stream (``_Handoff``),
  copied to pinned host memory first for a wire push.
- **Threads on one card take turns launching.** Workers on one card
  hold the card's dispatch lock while they launch a train step (the
  pull and the push stay outside it, so hogwild's applies still race).
  Eager PyTorch launches a step as hundreds of GIL-releasing calls, and
  four threads interleaving them ran at half the speed of one thread
  launching alone on the H100 (``scripts/torch_async_threads.py``); the
  card runs the queued steps of all workers' streams either way. Off the
  card a step's launches are its compute, so CPU workers take no lock.
- **The shuffle.** Each worker permutes its partition on the device
  every epoch, from a ``torch.Generator`` seeded by (worker, epoch,
  attempt) (``worker_permutation``); torch cannot reproduce the JAX
  package's threefry keys, so the orders differ from its orders.

A retried unit starts again from a fresh pull (weights) and a re-seeded
stream; the worker's optimizer state keeps whatever the failed attempt
did to it (the JAX package's functional state rolls it back).

- **Autotune** (``autotune=True``): before the workers start, the
  eager step is timed against the same step captured as a CUDA graph
  on a 2-batch scan of worker 0's rows (``utils/compiler.py``), and the
  winner is every worker's step: a captured step replays as one launch
  under the card's dispatch lock, on the worker's stream, with the
  worker's dropout generator registered with its graph.
- **Streamed partitions** (``stream_batches=N``): a worker streams its
  partition in chunks of N batches through a double-buffered pipeline
  (``engine.sync.ChunkStream``) in the JAX package's NumPy row order;
  chunk i-1's metrics are read before a third chunk enters flight.

- **The elastic fit** (``elastic=True``): the units of the fit are
  ``(epoch, partition)`` entries of a ``resilience.UnitLedger`` (or batch
  ranges of them, ``batches_per_unit``) leased by an
  ``ElasticWorkerPool`` to whichever worker thread is alive; a dead
  worker's units are re-queued to survivors, and a parameter-server crash
  is ridden out for ``ps_recovery_grace`` seconds against a warm restart
  (``ps_wal_dir``) or a standby's promotion (``ps_shards``, ``standby``).
  Each worker id keeps one model clone, one stream and one optimizer
  state on its device; a unit's shuffle is the JAX package's NumPy
  permutation keyed on (partition, epoch), and its dropout generator is
  seeded from (partition, epoch) and a batch range's start, never from
  the worker, so a survivor re-running a dead worker's unit trains the
  same rows in the same order. A unit reads its metrics back (waiting
  for its steps) before it pushes, so a device fault kills the unit,
  which is re-queued, and never reaches the server.

- **Across processes** (a ``torch.distributed`` group of several ranks):
  one parameter server on rank 0, which every rank's workers dial. Each
  rank's workers take the next slots of the job's global worker list
  (rank r's worker i is worker ``sum(local counts before r) + i``), so
  partition g is trained by exactly one worker of the job. Rank 0 binds
  ``$ELEPHAS_PS_BIND`` (default ``0.0.0.0``) and broadcasts the address it
  can be dialled at and a per-fit HMAC key over the group's control
  plane (gloo or NCCL carries only that: parameters travel through the
  PS); ``$ELEPHAS_PS_ADDRESS`` overrides the address,
  ``$ELEPHAS_PS_AUTH_KEY`` (hex) the key, and ``ELEPHAS_PS_AUTH=off``
  turns authentication off. Autotune is decided job-wide (rank 0 times,
  every rank adopts its choice), validation and callbacks run on rank 0
  (a checkpoint manager must say ``host0_only=True``), and the teardown
  runs through PS-backed barriers: every rank waits on
  ``elephas:pushes_done`` and pulls the final weights, then rank 0 waits
  on ``elephas:final_read`` before it stops the server. A dead peer
  surfaces as ``wait_barrier``'s ``TimeoutError`` after
  ``$ELEPHAS_BARRIER_TIMEOUT`` seconds. The history is the job-wide
  mean (each rank's per-epoch means weighted by its worker count) and
  rank 0's validation records reach every rank verbatim, so every rank
  reports the same history. The local server, ``ps_shards`` and the
  elastic fit are refused across processes, as in the JAX package.
- **Ops** (``ps_ops_port``, ``mount_ops``): the parameter server's ops
  endpoint (``parameter/server.py``) and the worker process's own (role
  ``worker``, id ``w<rank>``), each an ``obs.opsd.OpsServer``.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elephas_tpu_torch import obs
from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.engine.step import (
    CAPTURE_WARMUP_STEPS,
    CapturedStep,
    DeviceEvalCache,
    build_train_step,
    init_train_state,
    make_epoch_scanner,
    make_eval_step,
    weighted_mean_over_chunks,
)
from elephas_tpu_torch.engine.sync import _AUTOTUNE_SKIPPED, ChunkStream, decide_autotune
from elephas_tpu_torch.parameter.client import (
    HostCopy,
    ParameterServerUnavailable,
    StaleDeltaRejected,
    make_client,
)
from elephas_tpu_torch.parameter.group import ShardGroup
from elephas_tpu_torch.parallel import distributed
from elephas_tpu_torch.parallel.mesh import Mesh, world
from elephas_tpu_torch.parameter.server import _dial_host, make_server
from elephas_tpu_torch.resilience import ElasticWorkerPool, FaultInjector, UnitLedger, install
from elephas_tpu_torch.utils.compiler import autotune_candidates, autotune_compile_options
from elephas_tpu_torch.utils.device import resolve_device
from elephas_tpu_torch.utils.functional_utils import tree_map
from elephas_tpu_torch.utils.sockets import determine_master

_FREQUENCIES = ("batch", "epoch")

logger = logging.getLogger(__name__)


def _seed(*words: int) -> int:
    """A 63-bit generator seed from a sequence of ints."""
    key = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
    return int(key) & 0x7FFFFFFFFFFFFFFF


def worker_permutation(index: int, epoch: int, attempt: int, n: int) -> torch.Tensor:
    """The order of worker ``index``'s ``n`` rows in ``epoch``: a CPU
    ``torch.Generator`` permutation seeded from (1234, worker, 7, epoch),
    and 10000 + attempt on a retry (the words the JAX package folds into
    its shuffle key)."""
    words = [1234, index, 7, epoch] + ([10_000 + attempt] if attempt else [])
    return torch.randperm(n, generator=torch.Generator().manual_seed(_seed(*words)))


def dropout_seed(index: int, step: int, attempt: int) -> int:
    """Seed of worker ``index``'s dropout generator at ``step``: (977,
    worker, step), and 10000 + attempt on a retry."""
    return _seed(977, index, step, *([10_000 + attempt] if attempt else []))


def unit_permutation(part: int, epoch: int, n: int) -> np.ndarray:
    """An elastic unit's row order: the JAX package's NumPy permutation
    keyed on (1234, partition, epoch), whichever worker runs it."""
    return np.random.default_rng([1234, part, epoch]).permutation(n)


def unit_dropout_seed(part: int, epoch: int, lo: Optional[int] = None) -> int:
    """Seed of an elastic unit's dropout generator: (977, partition,
    epoch), and a batch range's start ``lo``; never the worker."""
    return _seed(977, part, epoch, *([lo] if lo is not None else []))


class _Handoff:
    """A delta passed from a worker thread to its comms thread. A wire
    push starts the copy to pinned host memory on the worker's stream
    (``HostCopy``); a local push records an event there that the comms
    thread's stream waits for before the buffer takes the delta."""

    __slots__ = ("tree", "event", "device")

    def __init__(self, tree, to_host: bool):
        self.tree, self.event, self.device = tree, None, None
        if to_host:
            self.tree = HostCopy.start(tree)
            return
        for leaf in _tensors(tree):
            if leaf.device.type == "cuda":
                self.device, self.event = leaf.device, torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(leaf.device))
                break

    def resolve(self):
        if self.event is not None:
            torch.cuda.current_stream(self.device).wait_event(self.event)
        return self.tree


def _tensors(tree):
    out = []
    tree_map(out.append, tree)
    return out


class _PullBox:
    """One in-flight prefetched pull: the comms thread fills exactly one
    of value/error, then sets the event."""

    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None


class _CommsPipeline:
    """Per-worker background comms thread: pushes become bounded
    fire-and-forget, pulls become prefetches.

    One FIFO queue, one thread — deltas are applied in the order the
    worker produced them, and a prefetched pull is ordered exactly where
    the worker enqueued it. The queue is bounded (``maxsize=3``): a
    worker outrunning the wire blocks in ``push()``.

    Failure contract: ``ParameterServerUnavailable`` is recorded as fatal
    and re-raised by the worker's next pipeline op, never retried; a
    transient push failure retries the SAME delta up to
    ``max_push_attempts`` (at-least-once, as ``run_unit``); pull failures
    surface to the waiting worker; ``StaleDeltaRejected`` drops the
    delta, forces the next pull onto fresh parameters and halves the
    units-per-push interval. After a fatal the thread drains the queue
    without wire ops, so ``flush``/``close`` never deadlock.

    Adaptive sync interval (AIMD): ``push()`` coalesces deltas (a tree
    sum) and enqueues one wire push per ``round(interval)`` units; a
    rejection halves the interval (floor 1.0), each accepted push adds
    0.25 back up to the baseline. The live value is the
    ``worker_sync_interval`` gauge and is stamped onto the client.

    ``to_host``: deltas cross to the comms thread as pinned host copies
    (the wire transports) or as device tensors behind an event (local).
    """

    _PUSH_RETRY_DELAYS = (0.05, 0.1, 0.2)

    def __init__(self, client, worker_index: int, max_push_attempts: int,
                 sleep=time.sleep, sync_interval: float = 1.0, to_host: bool = True):
        if sync_interval < 1.0:
            raise ValueError(f"sync_interval must be >= 1.0, got {sync_interval}")
        self._client = client
        self._sleep = sleep
        self._to_host = to_host
        self._max_push_attempts = max(1, max_push_attempts)
        self._worker_label = f"w{worker_index}"
        self._queue: queue.Queue = queue.Queue(maxsize=3)
        self._fatal: Optional[BaseException] = None
        self._pending: Optional[_PullBox] = None
        self._push_cond = threading.Condition()
        self._pushes_enqueued = 0
        self._pushes_done = 0
        self._baseline = float(sync_interval)
        self._interval = float(sync_interval)
        self._acc = None
        self._acc_units = 0
        self._repull = threading.Event()
        self.rejections = 0
        self._set_interval(self._interval)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"worker{worker_index}-comms")
        self._thread.start()

    @property
    def sync_interval(self) -> float:
        """The live train-units-per-push interval (AIMD-adjusted)."""
        return self._interval

    def _set_interval(self, value: float) -> None:
        value = float(value)
        self._interval = value
        try:
            self._client.sync_interval = value
        except Exception:
            pass  # a client that refuses the stamp just goes unlabeled
        obs.default_registry().gauge(
            "worker_sync_interval",
            help="adaptive train-units-per-push interval (AIMD: halved "
                 "on a stale-delta rejection, +0.25 per accept up to "
                 "the configured baseline)",
            labelnames=("worker",),
        ).labels(worker=self._worker_label).set(value)

    # -- worker-side API ------------------------------------------------

    def prefetch(self) -> None:
        """Schedule the next pull now so it rides the wire while the
        worker trains; no-op if one is pending or the pipeline is dead."""
        if self._fatal is not None or self._pending is not None:
            return
        box = _PullBox()
        self._pending = box
        self._put(self._item("pull", box))

    def pull(self):
        """Consume the pending prefetch (or pull now), blocking until the
        parameters arrive; after a rejection a pending prefetch is
        discarded for a fresh pull."""
        self._raise_if_fatal()
        box, self._pending = self._pending, None
        if box is not None and self._repull.is_set():
            box.event.wait()
            box = None
        if box is None:
            self._repull.clear()
            box = _PullBox()
            self._put(self._item("pull", box))
        box.event.wait()
        if box.error is not None:
            raise box.error
        return box.value

    def push(self, delta) -> None:
        """Record one unit's delta; enqueues a wire push once
        ``round(interval)`` units have coalesced."""
        self._raise_if_fatal()
        self._acc = delta if self._acc is None else tree_map(torch.add, self._acc, delta)
        self._acc_units += 1
        if self._acc_units >= max(1, int(round(self._interval))):
            self._enqueue_acc()

    def _enqueue_acc(self) -> None:
        delta, self._acc = self._acc, None
        self._acc_units = 0
        with self._push_cond:
            self._pushes_enqueued += 1
        self._put(self._item("push", _Handoff(delta, self._to_host)))

    def flush(self) -> None:
        """Push any coalesced remainder, then wait for every enqueued
        push to complete (not for a pending prefetch)."""
        if self._acc is not None:
            self._enqueue_acc()
        with self._push_cond:
            while self._pushes_done < self._pushes_enqueued:
                self._push_cond.wait(0.05)
        self._raise_if_fatal()

    def close(self) -> None:
        """Stop and join the comms thread (idempotent)."""
        if self._thread is None:
            return
        self._put(("stop", None, None, None))
        self._thread.join()
        self._thread = None

    # -- comms thread ---------------------------------------------------

    @staticmethod
    def _item(kind, payload):
        # Contextvars don't cross the queue hop: carry the worker's trace
        # context and the enqueue time with the item.
        tracer = obs.default_tracer()
        return (kind, payload, obs.current_context(),
                tracer.clock() if tracer.enabled else None)

    def _raise_if_fatal(self) -> None:
        if self._fatal is not None:
            raise self._fatal

    def _put(self, item) -> None:
        while True:
            try:
                self._queue.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _loop(self) -> None:
        while True:
            kind, payload, ctx, enqueue_t = self._queue.get()
            if kind == "stop":
                return
            with obs.activate(ctx):
                tracer = obs.default_tracer()
                if enqueue_t is not None and tracer.enabled:
                    tracer.record("comms/queued", enqueue_t, tracer.clock(),
                                  op=kind, worker=self._worker_label)
                if kind == "pull":
                    self._pull(payload)
                else:
                    try:
                        if self._fatal is None:
                            self._push_with_retry(payload.resolve())
                    finally:
                        with self._push_cond:
                            self._pushes_done += 1
                            self._push_cond.notify_all()

    def _pull(self, box: _PullBox) -> None:
        if self._fatal is not None:
            box.error = self._fatal
        else:
            try:
                box.value = self._client.get_parameters()
            except BaseException as exc:
                box.error = exc
                if isinstance(exc, ParameterServerUnavailable):
                    self._fatal = exc
        box.event.set()

    def _push_with_retry(self, delta) -> None:
        for attempt in range(self._max_push_attempts):
            try:
                self._client.update_parameters(delta)
                if self._interval < self._baseline:
                    self._set_interval(min(self._baseline, self._interval + 0.25))
                return
            except ParameterServerUnavailable as exc:
                self._fatal = exc  # fail-fast contract: never retried
                return
            except StaleDeltaRejected:
                self.rejections += 1
                self._repull.set()
                self._set_interval(max(1.0, self._interval / 2.0))
                return
            except Exception as exc:
                if attempt + 1 >= self._max_push_attempts:
                    self._fatal = exc
                    return
                obs.default_registry().counter(
                    "ps_push_retry_total",
                    help="background same-delta push retries (pipelined comms)",
                    labelnames=("worker",),
                ).labels(worker=self._worker_label).inc()
                self._sleep(self._PUSH_RETRY_DELAYS[
                    min(attempt, len(self._PUSH_RETRY_DELAYS) - 1)])


def default_worker_devices(device: torch.device) -> List[torch.device]:
    """One worker per visible card (the master's device type); one on
    the CPU for a model on the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _taking_turns(step, lock):
    """``step`` run under ``lock`` (None: as it is)."""
    if lock is None:
        return step

    def locked(state, x, y):
        with lock:
            return step(state, x, y)

    return locked


class _WorkerModel:
    """One worker's copy of the model: the module, its optimizer (kept
    across rounds), the train step (eager, or with ``capture`` captured
    as a CUDA graph) and epoch scanner over it (the step under the card's
    dispatch lock, where there is one), its dropout generator, and the
    flat (sorted-name) lists of the tensors a pull fills and a push
    differences."""

    def __init__(self, compiled, device: torch.device, dispatch_lock=None,
                 capture: bool = False):
        self.model = compiled.clone()
        self.model.module.to(device)
        self.device = device
        self.generator = torch.Generator(device=device)
        if hasattr(self.model.module, "dropout_generator"):
            self.model.module.dropout_generator = self.generator
        self.state = TrainState.create(optimizer=self.model.init_opt_state(),
                                       rng=self.generator)
        self.step = build_train_step(self.model, capture)
        self.train_step = _taking_turns(self.step, dispatch_lock)
        self.epoch_fn = make_epoch_scanner(self.train_step)
        params, buffers = store_of(self.model.module)
        self.names = (list(params), list(buffers))
        self.tensors = [*params.values(), *buffers.values()]

    def flat(self, tree) -> List[torch.Tensor]:
        return ([tree["params"][n] for n in self.names[0]]
                + [tree["batch_stats"][n] for n in self.names[1]])

    def tree(self, flat) -> Dict[str, Dict[str, torch.Tensor]]:
        k = len(self.names[0])
        return {"params": dict(zip(self.names[0], flat[:k])),
                "batch_stats": dict(zip(self.names[1], flat[k:]))}

    def load(self, pulled) -> List[torch.Tensor]:
        """Copy a pulled tree into the module; returns the pulled tensors
        on this device (the ``before`` of the delta: never written)."""
        before = [t.to(self.device, non_blocking=True) for t in self.flat(pulled)]
        with torch.no_grad():
            torch._foreach_copy_(self.tensors, before)
        return before

    def delta(self, before) -> List[torch.Tensor]:
        """``before - trained`` over every tensor, out of place."""
        with torch.no_grad():
            return torch._foreach_sub(before, [t.detach() for t in self.tensors])


def store_of(module) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A module's ``(params, batch_stats)``: its parameters and its
    buffers (the BatchNorm statistics), each by sorted name."""
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    return ({n: params[n].detach() for n in sorted(params)},
            {n: buffers[n] for n in sorted(buffers)})


def load_store(module, tree) -> None:
    """Copy a ``{"params", "batch_stats"}`` tree into ``module``."""
    params, buffers = store_of(module)
    dst = [*params.values(), *buffers.values()]
    src = [tree["params"][n] for n in params] + [tree["batch_stats"][n] for n in buffers]
    with torch.no_grad():
        torch._foreach_copy_(dst, [s.to(d.device) for s, d in zip(src, dst)])


def job_mean(per_worker, multi: bool):
    """Each epoch's metrics averaged over every worker of the job, and the
    job's worker count. ``per_worker``: this process's workers' per-epoch
    metric rows (workers × epochs × keys). Across processes each rank's
    per-epoch means are allgathered and weighted by its worker count, so
    every rank gets the mean a single process of the whole job would
    have (every rank calls it: a collective)."""
    local = np.mean(np.asarray(per_worker, dtype=np.float64), axis=0)  # epochs × keys
    if not multi:
        return local, len(per_worker)
    shipped = [json.loads(b) for b in distributed.allgather_bytes(
        json.dumps({"count": len(per_worker), "means": local.tolist()}).encode())]
    counts = np.asarray([d["count"] for d in shipped], dtype=np.float64)
    means = np.asarray([d["means"] for d in shipped], dtype=np.float64)
    return (means * counts[:, None, None]).sum(axis=0) / counts.sum(), int(counts.sum())


class AsyncTrainer:
    def __init__(
        self,
        compiled,
        mesh=None,
        frequency: str = "epoch",
        lock: bool = True,
        parameter_server_mode: str = "local",
        port: int = 4000,
        granularity: str = "tree",
        max_failures: int = 4,
        autotune: bool = False,
        stream_batches: Optional[int] = None,
        pipelined_comms: Optional[bool] = None,
        elastic: bool = False,
        fault_plan=None,
        ps_wal_dir: Optional[str] = None,
        wal_every: int = 1,
        ps_recovery_grace: float = 15.0,
        ps_ops_port: Optional[int] = None,
        ps_shards: Optional[int] = None,
        standby: Optional[int] = None,
        sync_interval: float = 1.0,
        batches_per_unit: Optional[int] = None,
    ):
        """``mesh``: the workers' devices, a list in which a device may
        repeat (several workers on one card, each on its own stream) —
        the port's counterpart of the JAX mesh's data axis. Default: one
        worker per visible card. The parameter server's buffer lives on
        the master model's device.

        ``pipelined_comms``: run each worker's PS traffic on a background
        comms thread (``_CommsPipeline``): pushes become bounded
        fire-and-forget and the next pull prefetches while the unit
        trains ('batch'; 'epoch' prefetches after the push). Default: on
        for the wire transports, off for 'local'. At 'batch' frequency a
        prefetched pull can miss the worker's own just-pushed delta.

        ``granularity`` ('tree'|'leaf'): hogwild apply isolation
        (``ParameterBuffer``). ``max_failures``: attempts per
        frequency-unit before a worker fault fails the fit (Spark's
        ``spark.task.maxFailures``); ``ParameterServerUnavailable`` is
        never retried. ``sync_interval``: baseline train-units-per-push
        of the pipelined comms ratchet (>= 1.0).

        ``elastic``: run ``fit`` on the resilience layer's self-healing
        pool (see the module note); ``frequency='epoch'`` only.
        ``fault_plan``: a ``resilience.FaultPlan`` (seeded drops, delays
        and duplicates of wire frames, worker kills and stalls) installed
        for the elastic fit. ``batches_per_unit``: cut each elastic unit
        into batch ranges of this many batches, so a death mid-epoch
        re-leases only the unfinished ranges. ``ps_recovery_grace``:
        seconds an elastic fit waits for a crashed server to come back.

        ``ps_wal_dir``/``wal_every``: the wire server's write-ahead log:
        accepted pushes are durable before their ack (at most
        ``wal_every - 1`` versions behind), and a server built over the
        same directory warm-restarts from it. ``ps_shards``: shard the
        tree across K wire servers (``parameter.group.ShardGroup``);
        default ``$ELEPHAS_PS_SHARDS`` or unsharded. ``standby``: with
        ``ps_shards`` and ``ps_wal_dir``, one WAL-streamed warm spare a
        shard, promoted when its primary dies; default
        ``$ELEPHAS_PS_STANDBY`` or 0."""
        if frequency not in _FREQUENCIES:
            raise ValueError(
                f"async frequency must be batch|epoch, got {frequency!r} "
                "(the reference's AsynchronousSparkWorker supports the same two)"
            )
        if max_failures < 1:
            raise ValueError(f"max_failures must be >= 1, got {max_failures}")
        if sync_interval < 1.0:
            raise ValueError(f"sync_interval must be >= 1.0, got {sync_interval}")
        if elastic and frequency != "epoch":
            raise ValueError(
                "elastic=True schedules (epoch, partition) ledger units, "
                "which are epoch-granular — use frequency='epoch'"
            )
        if batches_per_unit is not None:
            if batches_per_unit < 1:
                raise ValueError(f"batches_per_unit must be >= 1, got {batches_per_unit}")
            if not elastic:
                raise ValueError(
                    "batches_per_unit cuts ELASTIC ledger units into "
                    "batch ranges — set elastic=True to use it"
                )
        if ps_shards is None:
            ps_shards = int(os.environ.get("ELEPHAS_PS_SHARDS", "0")) or None
        if standby is None:
            standby = int(os.environ.get("ELEPHAS_PS_STANDBY", "0"))
        if ps_shards is not None:
            if ps_shards < 1:
                raise ValueError(f"ps_shards must be >= 1, got {ps_shards}")
            if parameter_server_mode == "local":
                raise ValueError(
                    "ps_shards requires a wire transport (http|socket): "
                    "shards are separate server processes"
                )
        if standby:
            if not ps_shards:
                raise ValueError(
                    "standby is the shard group's hot-spare tier — set "
                    "ps_shards (ps_shards=1 shards trivially) to use it"
                )
            if ps_wal_dir is None:
                raise ValueError(
                    "standby streams each shard's WAL to its spare — "
                    "set ps_wal_dir"
                )
        if stream_batches is not None and stream_batches < 1:
            raise ValueError(f"stream_batches must be >= 1, got {stream_batches}")
        self.compiled = compiled
        self.frequency = frequency
        self.lock = lock
        self.parameter_server_mode = parameter_server_mode
        self.port = port
        self.granularity = granularity
        self.max_failures = max_failures
        self.pipelined_comms = pipelined_comms
        self.sync_interval = float(sync_interval)
        self.autotune = autotune
        self.autotune_choice = None
        self.stream_batches = stream_batches
        self.elastic = elastic
        self.fault_plan = fault_plan
        self.batches_per_unit = batches_per_unit
        self.ps_wal_dir = ps_wal_dir
        self.wal_every = wal_every
        self.ps_recovery_grace = ps_recovery_grace
        self.ps_shards = ps_shards
        self.standby = standby
        self.ps_ops_port = ps_ops_port
        # This process's ops endpoint (``mount_ops``) and what it serves.
        self.ops = None
        self.store = None
        self._ops_history = None
        self._ops_alerts = None
        # The elastic fit's chaos surface: the live server (a harness may
        # kill it and put a warm-restarted one here), the group, the pool.
        self._elastic_server = None
        self._elastic_group = None
        self._elastic_pool = None
        self.elastic_stats = None
        self._capture = False  # the workers' step: autotune's winner
        self.ps_device = next(compiled.module.parameters()).device
        devices = default_worker_devices(self.ps_device) if mesh is None else mesh
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("AsyncTrainer needs at least one worker device")
        self.workers = list(enumerate(self.devices))
        # One dispatch lock per card (see the module note).
        self._dispatch_locks = {d: threading.Lock() for d in self.devices if d.type == "cuda"}
        self.n_workers = len(self.workers)  # this process's workers
        # The job's: set by ``_join_job`` in a group of several processes.
        self.n_global_workers = self.n_workers
        self.epoch_end_times: List[float] = []
        self._eval_model = None
        self._val_cache = DeviceEvalCache()
        self.server = None  # the last fit's parameter server (stopped), for inspection

    def mount_ops(self, port: int = 0, host: Optional[str] = None,
                  store_dir: Optional[str] = None):
        """Mount a live ops endpoint for THIS worker process (role
        ``worker``, id ``w<rank>``): ``/metrics`` serves the process
        registry the training loop feeds, ``/history`` its sampled rings,
        ``/profile`` device capture and memory. Loopback by default;
        idempotent; ``unmount_ops()`` tears it down. ``store_dir`` also
        journals this process's flight notes, alert transitions and
        sampler ticks into a telemetry store (``obs.store``)."""
        if self.ops is not None:
            return self.ops
        worker_id = f"w{distributed.process_index()}"
        self._ops_history = obs.HistorySampler(extra_fn=obs.record_device_memory).start()
        self._ops_alerts = obs.AlertEngine()
        self.store = None
        if store_dir is not None:
            self.store = obs.TelemetryStore(store_dir, role="worker",
                                            flight=obs.default_flight_recorder())
            obs.default_flight_recorder().attach_store(self.store)
            self._ops_alerts.attach_store(self.store)
            self._ops_history.attach_store(self.store)
        self.ops = obs.OpsServer(
            port=port, host=host, role="worker", worker_id=worker_id,
            alerts_fn=self._ops_alerts.scrape,
            history=self._ops_history,
            vars_fn=lambda: {
                "role": "worker",
                "worker_id": worker_id,
                "parameter_server_mode": self.parameter_server_mode,
                "frequency": self.frequency,
                "elastic": self.elastic,
            },
            incidents_fn=self.store.doc if self.store is not None else None,
        ).start()
        return self.ops

    def unmount_ops(self) -> None:
        if self.ops is not None:
            self.ops.stop()
            self.ops = None
        if self._ops_history is not None:
            self._ops_history.stop()
            self._ops_history = None
        if self.store is not None:
            obs.default_flight_recorder().detach_store(self.store)
            if self._ops_alerts is not None:
                self._ops_alerts.detach_store(self.store)
            self.store.close()
            self.store = None

    # -- the job across processes ---------------------------------------------

    def _join_job(self) -> bool:
        """In a group of several processes, number this process's workers
        in the job's global worker list and return True; False alone.
        Every rank calls it (an allgather of the local worker counts)."""
        procs, rank = world()
        if procs == 1:
            return False
        counts = [int(c) for c in distributed.allgather_bytes(str(self.n_workers).encode())]
        offset = sum(counts[:rank])
        self.workers = [(offset + i, dev) for i, dev in enumerate(self.devices)]
        self.n_global_workers = sum(counts)
        return True

    # -- autotune --------------------------------------------------------------

    def _run_autotune(self, dataset, batch_size: int) -> None:
        """The A/B of ``autotune_candidates`` on a 2-batch epoch scan of
        worker 0's first rows, on its device, from a fresh clone of the
        model (the fit keeps no trace of it); the winner becomes every
        worker's step. A partition smaller than 2 batches cannot be timed:
        'skipped', with a warning.

        Across processes the decision is job-wide: rank 0 times and
        ``decide_autotune`` broadcasts its outcome, which every rank
        adopts, so every rank reaches this call."""
        local = None
        procs, rank = world()
        index, device = self.workers[0]
        x, y = dataset.partition(index)
        nb = 2
        if rank == 0 and len(x) >= nb * batch_size:
            usable = nb * batch_size
            xs = torch.as_tensor(np.asarray(x[:usable])).to(device).reshape(
                nb, batch_size, *np.shape(x)[1:])
            ys = torch.as_tensor(np.asarray(y[:usable])).to(device).reshape(
                nb, batch_size, *np.shape(y)[1:])
            lock = self._dispatch_locks.get(device)
            stream = torch.cuda.Stream(device) if device.type == "cuda" else None

            def build(options):
                wm = _WorkerModel(self.compiled, device, lock, options)
                if isinstance(wm.step, CapturedStep):  # its warm-up and capture, untimed
                    for _ in range(CAPTURE_WARMUP_STEPS + 1):
                        wm.train_step(wm.state, xs[0], ys[0])
                return wm

            def run(wm):
                return wm.epoch_fn(wm.state, xs, ys)[1]

            with torch.cuda.stream(stream) if stream is not None else nullcontext():
                local = autotune_compile_options(build, run, lambda m: float(m["loss"]),
                                                 candidates=autotune_candidates(device))
        decided = decide_autotune(local, Mesh(procs, rank, dist.group.WORLD)
                                  if procs > 1 else None)
        if decided is None:
            self.autotune_choice = dict(_AUTOTUNE_SKIPPED)
            logger.warning("autotune=True could not time this workload (partition smaller "
                           "than 2 batches); training with the eager step "
                           "(compile_autotune='skipped')")
            return
        winner, options, table = decided
        self.autotune_choice = {"winner": winner, "ms_per_2batch": table}
        if table:  # more than one candidate was timed
            self._capture = options

    # -- evaluation ------------------------------------------------------------

    def _local_evaluate(self, snapshot, features, labels,
                        batch_size: int = 2048) -> Dict[str, float]:
        """Exact weighted-mean evaluation of a PS snapshot on the buffer's
        device, in chunks of ``batch_size``; a set within the
        ``DeviceEvalCache`` bound is uploaded once per fit."""
        if self._eval_model is None:
            self._eval_model = self.compiled.clone()
            self._eval_step = make_eval_step(self._eval_model)
        load_store(self._eval_model.module, snapshot)
        features, labels = np.asarray(features), np.asarray(labels)
        device = self.ps_device
        cached = self._val_cache.get(
            (features, labels), features.nbytes + labels.nbytes,
            lambda: (torch.as_tensor(features).to(device), torch.as_tensor(labels).to(device)))
        n = len(features)
        usable = (n // batch_size) * batch_size
        spans = [(s, s + batch_size) for s in range(0, usable, batch_size)]
        if usable < n:
            spans.append((usable, n))
        device_metrics = []
        for start, stop in spans:
            if cached is not None:
                x, y = cached[0][start:stop], cached[1][start:stop]
            else:
                x = torch.as_tensor(features[start:stop]).to(device)
                y = torch.as_tensor(labels[start:stop]).to(device)
            metrics = self._eval_step(None, x, y)
            device_metrics.append((list(metrics), torch.stack(list(metrics.values()))))
        # One read back for all chunks.
        values = torch.stack([v for _, v in device_metrics]).tolist()
        names = device_metrics[0][0]
        means = weighted_mean_over_chunks(
            [(s, e, i) for i, (s, e) in enumerate(spans)],
            lambda start, stop, i: dict(zip(names, values[i])), n)
        return dict(sorted(means.items()))  # the JAX package's key order

    # -- the parameter server ----------------------------------------------------

    def _start_server(self, store0, auth_key):
        """This fit's parameter server, started: a ``ShardGroup`` with
        ``ps_shards`` (its monitor running where it has spares), else one
        server with the write-ahead log where ``ps_wal_dir`` asks."""
        if self.ps_shards:
            group = ShardGroup(
                store0, self.ps_shards, mode=self.parameter_server_mode,
                standby=self.standby, wal_root=self.ps_wal_dir, lock=self.lock,
                device=self.ps_device, granularity=self.granularity,
                auth_key=auth_key, wal_every=self.wal_every, ops_port=self.ps_ops_port)
            group.start()
            if self.standby:
                group.start_monitor()
            return group
        server = make_server(
            self.parameter_server_mode, store0, lock=self.lock, port=self.port,
            device=self.ps_device, granularity=self.granularity, auth_key=auth_key,
            wal_dir=self.ps_wal_dir, wal_every=self.wal_every, ops_port=self.ps_ops_port)
        server.start()
        return server

    def _start_job_server(self, store0):
        """Across processes: rank 0's server, bound to ``$ELEPHAS_PS_BIND``
        (default every interface) with auth on by default, and on every
        rank the factory of clients that dial it (module note). Returns
        ``(server or None, client_factory)``."""
        auth_on = os.environ.get("ELEPHAS_PS_AUTH", "on").lower() not in ("off", "0", "false")
        auth_key = None
        host0 = distributed.is_host0()
        if auth_on and host0:
            env_key = os.environ.get("ELEPHAS_PS_AUTH_KEY")
            auth_key = bytes.fromhex(env_key) if env_key else os.urandom(32)
        server, advertised = None, ""
        if host0:
            server = make_server(
                self.parameter_server_mode, store0, lock=self.lock, port=self.port,
                device=self.ps_device, host=os.environ.get("ELEPHAS_PS_BIND", "0.0.0.0"),
                granularity=self.granularity, auth_key=auth_key, wal_dir=self.ps_wal_dir,
                wal_every=self.wal_every, ops_port=self.ps_ops_port)
            server.start()
            # What peers can dial: a pinned bind verbatim, else this host's
            # routable address.
            advertised = (f"{server.host}:{server.port}"
                          if server.host not in ("0.0.0.0", "::", "")
                          else determine_master(server.port))
        address = (os.environ.get("ELEPHAS_PS_ADDRESS")
                   or distributed.broadcast_from_host0(advertised))
        if auth_on:
            auth_key = distributed.broadcast_bytes_from_host0(auth_key or b"") or None
        mode = self.parameter_server_mode
        return server, lambda: make_client(mode, address, auth_key=auth_key)

    # -- fit -------------------------------------------------------------------

    def fit(
        self,
        dataset,
        epochs: int = 10,
        batch_size: int = 32,
        validation_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        verbose: int = 0,
        rng: Optional[torch.Generator] = None,
        callbacks=(),
        initial_step: int = 0,
    ) -> Tuple[TrainState, Dict[str, List[float]]]:
        """Train with one worker thread per device of ``mesh`` against a
        parameter server started for this fit; returns the master's state
        (its module holding the server's final weights) and the history:
        each epoch's metrics averaged over the workers, ``worker_retries``
        where a unit was retried, and one ``val_*`` entry per epoch
        (``val_stale`` says whether it sampled the epoch boundary).
        ``initial_step``: the step of a restored state this fit resumes.
        With ``elastic`` the fit runs on the pool (``_fit_elastic``).
        Across processes every rank calls this (module note)."""
        compiled = self.compiled
        if self.elastic:
            if self.autotune and self.autotune_choice is None and world()[0] == 1:
                self._run_autotune(dataset, batch_size)
            return self._fit_elastic(dataset, epochs, batch_size, validation_data,
                                     verbose, rng, callbacks, initial_step)
        multi = self._join_job()
        if multi and self.parameter_server_mode == "local":
            raise ValueError(
                "multi-host async/hogwild needs parameter_server_mode='http' "
                "or 'socket' — the in-process buffer spans one host"
            )
        if multi and self.ps_shards:
            raise ValueError(
                "ps_shards is single-host for now: the shard directory "
                "lives in the driver process and multi-host fits "
                "broadcast one PS address"
            )
        if multi:
            # Epoch fires run on rank 0 alone: a manager whose saves would
            # need its peers cannot be driven from there.
            from elephas_tpu_torch.checkpoint.checkpoint import _CheckpointCallback

            for cb in callbacks:
                if isinstance(cb, _CheckpointCallback) and not cb._manager.host0_only:
                    raise ValueError(
                        "multi-host async/hogwild checkpointing needs "
                        "CheckpointManager(host0_only=True): epoch barriers "
                        "are host-local, so collective saves deadlock"
                    )
        if dataset.num_partitions != self.n_global_workers:
            dataset = dataset.repartition(self.n_global_workers)
        if self.autotune and self.autotune_choice is None:
            self._run_autotune(dataset, batch_size)
        params, buffers = store_of(compiled.module)
        store0 = {"params": params, "batch_stats": buffers}
        if multi:
            server, client_factory = self._start_job_server(store0)
        else:
            env_key = os.environ.get("ELEPHAS_PS_AUTH_KEY")
            server = self._start_server(store0, bytes.fromhex(env_key) if env_key else None)
            client_factory = server.client
        self.server = server
        if server is not None:
            hand_over = getattr(server, "hand_over", None) or server.buffer.hand_over

        per_worker_metrics: List[Optional[List[Dict[str, float]]]] = [None] * self.n_workers
        errors: List[BaseException] = []
        self.epoch_end_times = []
        # Validation and callbacks run on rank 0 alone (its epoch barrier
        # is its own workers'); the others receive its records.
        is_driver = distributed.is_host0()
        do_val = validation_data is not None and is_driver
        run_callbacks = tuple(callbacks) if is_driver else ()
        epoch_done_counts = [0] * epochs
        epochs_fired = 0
        fire_cond = threading.Condition()
        fire_queue: deque = deque()
        fire_stop = [False]
        fire_errors: List[BaseException] = []
        saturated_warned = [False]
        val_records: List[Optional[Dict[str, float]]] = [None] * epochs

        def do_fire(fire: int, snapshot=None) -> None:
            stale = snapshot is None
            if stale:
                # The drainer fell behind: this epoch's boundary snapshot
                # was never pinned, so it samples the PS as of NOW.
                snapshot = server.get_parameters()
            else:
                hand_over(snapshot)
            if do_val:
                rec = dict(self._local_evaluate(snapshot, *validation_data))
                rec["stale"] = 1.0 if stale else 0.0
                val_records[fire] = rec
            if run_callbacks:
                snap_state = init_train_state(compiled)
                snap_state.step = initial_step + fire + 1
                load_store(compiled.module, snapshot)
                for cb in run_callbacks:
                    cb(fire, snap_state, {})

        def on_epoch_done(epoch: int) -> None:
            # Every epoch's end time is recorded (the JAX package records
            # them only where a fire runs); the fire itself only with
            # callbacks or validation.
            nonlocal epochs_fired
            firing = bool(run_callbacks or do_val)
            if fire_errors:
                raise RuntimeError("epoch-barrier work failed; aborting fit") from fire_errors[0]
            with fire_cond:
                epoch_done_counts[epoch] += 1
                while (epochs_fired < epochs
                       and epoch_done_counts[epochs_fired] == self.n_workers):
                    self.epoch_end_times.append(time.perf_counter())
                    if firing:
                        # Snapshot AT THE EPOCH BOUNDARY (the buffer's
                        # tensors are never written, so holding them is
                        # the snapshot); past 3 queued fires stop pinning
                        # and mark them stale.
                        saturated = len(fire_queue) >= 3
                        if saturated and not saturated_warned[0]:
                            saturated_warned[0] = True
                            logger.warning(
                                "epoch-fire queue saturated at epoch %d (slow "
                                "callback/validation?): snapshots are no longer "
                                "pinned at epoch boundaries — affected epochs' "
                                "validations sample a LATER parameter-server "
                                "state and are marked val_stale=1 in history",
                                epochs_fired,
                            )
                        snapshot = None if saturated else server.get_parameters()
                        fire_queue.append((epochs_fired, snapshot))
                    epochs_fired += 1
                fire_cond.notify_all()

        def fire_drainer() -> None:
            # One epoch's barrier work at a time, in epoch order, off the
            # worker threads: it overlaps the next epoch's training.
            while True:
                with fire_cond:
                    while not fire_queue and not fire_stop[0]:
                        fire_cond.wait()
                    if not fire_queue:
                        return
                    fire, snapshot = fire_queue.popleft()
                try:
                    do_fire(fire, snapshot)
                except BaseException as exc:  # checked at epoch boundaries
                    fire_errors.append(exc)
                    return

        drainer = None
        if run_callbacks or do_val:
            if do_val:
                # Build the evaluator and upload the validation set before
                # training starts, so the first fire does not stall.
                self._local_evaluate(server.get_parameters(), *validation_data)
            drainer = threading.Thread(target=fire_drainer, daemon=True)
            drainer.start()

        def worker(slot: int, index: int, device: torch.device) -> None:
            try:
                stream = torch.cuda.Stream(device) if device.type == "cuda" else None
                with torch.cuda.stream(stream) if stream is not None else nullcontext():
                    client = client_factory()
                    if hasattr(client, "worker_id"):
                        client.worker_id = f"w{index}"
                    per_worker_metrics[slot] = self._run_worker(
                        index, device, client, dataset, epochs, batch_size,
                        on_epoch_done=on_epoch_done)
                    if stream is not None:
                        stream.synchronize()
            except BaseException as exc:  # surfaced after join
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(slot, g, dev), daemon=True)
                   for slot, (g, dev) in enumerate(self.workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if drainer is not None:
            with fire_cond:
                fire_stop[0] = True
                fire_cond.notify_all()
            drainer.join()

        if errors or fire_errors:
            # Across processes this fails the rank fast; its peers' teardown
            # barriers time out.
            if server is not None:
                server.stop()
            raise (fire_errors or errors)[0]

        # The server's final weights folded back into the master.
        if multi:
            final = self._job_teardown(server, client_factory)
        else:
            final = server.get_parameters()
        load_store(compiled.module, final)
        if self.ps_device.type == "cuda":
            torch.cuda.synchronize(self.ps_device)
        if server is not None:
            server.stop()
        state = init_train_state(compiled, rng=rng)
        state.step = initial_step + epochs

        keys = sorted(per_worker_metrics[0][0].keys())
        means, total_workers = job_mean(
            [[[m[e][k] for k in keys] for e in range(epochs)] for m in per_worker_metrics],
            multi)
        history: Dict[str, List[float]] = {
            k: [float(means[e, i]) for e in range(epochs)] for i, k in enumerate(keys)}
        if "_retries" in history:
            # A per-worker mean; the job-wide count is it times the workers.
            history["worker_retries"] = [int(round(v * total_workers))
                                         for v in history.pop("_retries")]
        records = None
        if do_val:
            fallback = None
            records = list(val_records)
            for epoch, val in enumerate(records):
                if val is None:  # defensive: evaluate the final state once
                    if fallback is None:
                        fallback = dict(self._local_evaluate(final, *validation_data))
                        fallback["stale"] = 1.0
                    records[epoch] = fallback
        if multi:
            # Every rank reaches this broadcast whatever its own
            # validation_data: rank 0 decides whether val history exists.
            records = json.loads(distributed.broadcast_bytes_from_host0(
                json.dumps(records).encode()).decode())
        for val in records or ():
            for k, v in val.items():
                history.setdefault(f"val_{k}", []).append(v)
        if verbose:
            last = {k: round(v[-1], 4) for k, v in history.items()}
            print(f"[{'async' if self.lock else 'hogwild'}] done: {last}")
        return state, history

    @staticmethod
    def _job_teardown(server, client_factory):
        """The teardown across processes, through PS-backed barriers (not
        collectives: asynchronous ranks may drift far past a collective's
        deadline). Every rank waits on ``elephas:pushes_done`` and pulls
        the final weights; rank 0 then waits on ``elephas:final_read``
        before its server may stop, the others only arrive (waiting would
        race the shutdown). A dead peer surfaces as ``wait_barrier``'s
        ``TimeoutError`` (``$ELEPHAS_BARRIER_TIMEOUT``); the server is
        always stopped on the way out of an error."""
        procs = world()[0]
        ctl = None
        try:
            ctl = client_factory()
            ctl.wait_barrier("elephas:pushes_done", procs)
            final = server.get_parameters() if server is not None else ctl.get_parameters()
            if server is not None:
                ctl.wait_barrier("elephas:final_read", procs)
            else:
                ctl.barrier_arrive("elephas:final_read")
        except BaseException:
            if server is not None:
                server.stop()
            raise
        finally:
            if ctl is not None and hasattr(ctl, "close"):
                ctl.close()
        return final

    # -- the elastic fit ---------------------------------------------------------

    def _fit_elastic(self, dataset, epochs: int, batch_size: int, validation_data,
                     verbose: int, rng, callbacks, initial_step: int):
        """The elastic fit: every ``(epoch, partition)`` unit — or every
        ``(epoch, partition, (lo, hi))`` batch range with
        ``batches_per_unit`` — is leased from a ``UnitLedger`` to
        whichever worker thread is alive; a dead worker's units go to
        survivors, the epoch fire runs when the ledger says the epoch is
        complete, and a PS crash is ridden out against a warm restart on
        the same address (or a standby's promotion in a group).

        Chaos surface: ``self._elastic_server`` (kill it, warm-restart on
        the same port and WAL directory, put the new server here),
        ``self._elastic_group`` and ``self._elastic_pool``
        (``join_worker``). ``self.elastic_stats`` holds the pool's stats
        after the fit; the history is each epoch's metrics averaged over
        the partitions."""
        compiled = self.compiled
        if world()[0] > 1:
            raise ValueError(
                "elastic fit is single-host for now: one process leases "
                "units for all of its chips (multi-host elasticity needs "
                "a cross-host ledger)"
            )
        params, buffers = store_of(compiled.module)
        store0 = {"params": params, "batch_stats": buffers}
        env_key = os.environ.get("ELEPHAS_PS_AUTH_KEY")
        auth_key = bytes.fromhex(env_key) if env_key else None
        server = self._start_server(store0, auth_key)
        self._elastic_server = self.server = server
        if self.ps_shards:
            self._elastic_group = server

        mode = self.parameter_server_mode
        if self.ps_shards:
            def client_factory(worker_id):
                # The group directory is the re-resolution point: after a
                # failover the generation bump re-dials the promoted spare.
                client = self._elastic_group.client()
                client.worker_id = str(worker_id)
                return client
        elif mode == "local":
            def client_factory(worker_id):
                # In-process: the buffer cannot restart, so the live handle.
                return self._elastic_server.client()
        else:
            # Dial the ADDRESS, not the server object: after a kill and a
            # warm restart a NEW server owns the same port.
            address = f"{_dial_host(server.host)}:{server.port}"

            def client_factory(worker_id):
                client = make_client(mode, address, auth_key=auth_key)
                client.worker_id = str(worker_id)
                return client

        injector = None
        if self.fault_plan is not None:
            injector = FaultInjector(self.fault_plan)
            install(injector)

        partitions = list(range(self.n_workers))
        devices = self.devices

        def device_for(worker_id: str) -> torch.device:
            # Late joiners share the device list round-robin.
            try:
                i = int(str(worker_id).lstrip("w"))
            except ValueError:
                i = abs(hash(worker_id))
            return devices[i % len(devices)]

        data_lock = threading.Lock()
        host_rows: Dict[int, tuple] = {}      # partition -> (x, y, nb, usable)
        device_rows: Dict[tuple, tuple] = {}  # (worker, partition) -> tensors
        workers: Dict[str, tuple] = {}        # worker -> (_WorkerModel, stream)

        def partition_rows(part: int):
            with data_lock:
                if part not in host_rows:
                    x, y = dataset.partition(part)
                    nb = len(x) // batch_size
                    if nb == 0:
                        raise ValueError(
                            f"partition {part}: {len(x)} rows < batch_size {batch_size}")
                    usable = nb * batch_size
                    host_rows[part] = (np.asarray(x[:usable]), np.asarray(y[:usable]),
                                       nb, usable)
                return host_rows[part]

        def worker_model(worker_id: str):
            """The worker's clone, optimizer and stream, built at its
            first unit (a late joiner's too) and kept across units."""
            with data_lock:
                if worker_id not in workers:
                    device = device_for(worker_id)
                    stream = None
                    if device.type == "cuda":
                        # The clone is made on the worker's stream, after
                        # the work that wrote the master's weights.
                        stream = torch.cuda.Stream(device)
                        stream.wait_stream(torch.cuda.current_stream(device))
                    with torch.cuda.stream(stream) if stream is not None else nullcontext():
                        wm = _WorkerModel(compiled, device, self._dispatch_locks.get(device),
                                          self._capture)
                    workers[worker_id] = (wm, stream)
                return workers[worker_id]

        if self.batches_per_unit is not None:
            ledger = UnitLedger(epochs, partitions,
                                n_batches={p: partition_rows(p)[2] for p in partitions},
                                batches_per_unit=self.batches_per_unit)
        else:
            ledger = UnitLedger(epochs, partitions)
        tracer = obs.default_tracer()

        def run_unit(worker_id: str, client, unit):
            # Each unit roots its own trace: pull, train, push and the
            # server's apply (across a warm restart too) are one tree.
            span_args = {"batches": f"{unit[2][0]}:{unit[2][1]}"} if len(unit) > 2 else {}
            ctx = obs.new_context() if tracer.enabled else None
            with obs.activate(ctx), tracer.span(
                    "async/unit", epoch=unit[0], partition=unit[1], worker=worker_id,
                    **span_args) as usp:
                wm, stream = worker_model(worker_id)
                with torch.cuda.stream(stream) if stream is not None else nullcontext():
                    return unit_body(worker_id, wm, client, unit, usp)

        def unit_body(worker_id: str, wm, client, unit, usp):
            epoch, part = unit[0], unit[1]
            batch_range = unit[2] if len(unit) > 2 else None
            x, y, nb, usable = partition_rows(part)
            key = (worker_id, part)
            if key not in device_rows:
                device_rows[key] = (torch.as_tensor(x).to(wm.device),
                                    torch.as_tensor(y).to(wm.device))
            x_d, y_d = device_rows[key]
            # Batch range [lo, hi) of the (partition, epoch)-keyed shuffle:
            # the ranges of an epoch partition the stream a whole unit
            # would train.
            lo, hi = (0, nb) if batch_range is None else batch_range
            perm = torch.as_tensor(unit_permutation(part, epoch, usable)[
                lo * batch_size:hi * batch_size]).to(wm.device)
            ex = x_d[perm].reshape(hi - lo, batch_size, *x_d.shape[1:])
            ey = y_d[perm].reshape(hi - lo, batch_size, *y_d.shape[1:])
            pulled = client.get_parameters()
            before = wm.load(pulled)
            wm.generator.manual_seed(unit_dropout_seed(
                part, epoch, lo if batch_range is not None else None))
            wm.state.step = epoch * nb + lo
            with tracer.span("async/train", worker=worker_id, epoch=epoch):
                _, metrics = wm.epoch_fn(wm.state, ex, ey)
                # Read the metrics BEFORE the push: a device fault kills
                # this unit (the pool re-queues it), never the buffer.
                fetched = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            delta = wm.tree(wm.delta(before))
            try:
                client.update_parameters(delta)
            except StaleDeltaRejected as exc:
                # The admission policy's definitive answer, not a fault: a
                # re-run would push an even staler delta. The unit counts
                # done; the next unit's pull is the re-pull it asks for.
                if usp is not None:
                    usp.note(admission="reject", lag=exc.lag)
            obs.record_unit_dynamics(
                obs.default_registry(), worker_id, loss=fetched.get("loss"),
                delta_norm=obs.tree_norm(delta["params"]),
                param_norm=obs.tree_norm(wm.tree(before)["params"]), span=usp)
            return fetched

        val_records: List[Optional[Dict[str, float]]] = [None] * epochs
        run_callbacks = tuple(callbacks)
        do_val = validation_data is not None

        def on_epoch_complete(epoch: int) -> None:
            if not run_callbacks and not do_val:
                return
            # A fresh client per fire: the server may have been killed
            # and warm-restarted since the last epoch.
            fire_client = client_factory("fire")
            try:
                snapshot = fire_client.get_parameters()
            finally:
                fire_client.close()
            if do_val:
                val_records[epoch] = dict(self._local_evaluate(snapshot, *validation_data))
            if run_callbacks:
                snap_state = init_train_state(compiled)
                snap_state.step = initial_step + epoch + 1
                load_store(compiled.module, snapshot)
                for cb in run_callbacks:
                    cb(epoch, snap_state, {})

        if do_val:
            # Build the evaluator and upload the set before the pool runs.
            self._local_evaluate(store0, *validation_data)
        pool = ElasticWorkerPool(
            ledger, run_unit, client_factory, [f"w{slot}" for slot in range(self.n_workers)],
            on_epoch_complete=on_epoch_complete, injector=injector,
            ps_recovery_grace=self.ps_recovery_grace)
        pool.start()
        self._elastic_pool = pool  # published once started: join_worker may follow
        try:
            stats = pool.wait()
            # The final weights through the client (the first server may
            # be a corpse a harness replaced), riding an in-flight warm
            # restart under the workers' grace budget.
            deadline = time.monotonic() + self.ps_recovery_grace
            while True:
                final_client = client_factory("final")
                try:
                    final = final_client.get_parameters()
                    load_store(compiled.module, final)
                    break
                except ParameterServerUnavailable:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.1)
                finally:
                    final_client.close()
            if self.ps_device.type == "cuda":
                torch.cuda.synchronize(self.ps_device)
        finally:
            if injector is not None:
                install(None)
            self._elastic_pool = None
            live, self._elastic_server = self._elastic_server, None
            self._elastic_group = None
            if live is not None:
                try:
                    live.stop()  # a ShardGroup stops every member
                except Exception:
                    logger.exception("stopping the elastic fit's parameter server")

        self.elastic_stats = stats
        em = pool.epoch_metrics()
        keys = sorted(next(iter(em[0].values())).keys())
        history: Dict[str, List[float]] = {
            k: [float(np.mean([em[e][p][k] for p in sorted(em[e])])) for e in range(epochs)]
            for k in keys}
        if do_val:
            fallback = None
            for epoch, val in enumerate(val_records):
                if val is None:  # defensive: every completed epoch fires
                    if fallback is None:  # store0 views the module: the final weights
                        fallback = dict(self._local_evaluate(store0, *validation_data))
                    val = fallback
                for k, v in val.items():
                    history.setdefault(f"val_{k}", []).append(v)
        state = init_train_state(compiled, rng=rng)
        state.step = initial_step + epochs
        if verbose:
            last = {k: round(v[-1], 4) for k, v in history.items()}
            print(f"[elastic] done: {last} (requeued={stats['requeued_units']}, "
                  f"deaths={len(stats['worker_deaths'])}, "
                  f"late_joins={len(stats['late_joins'])})")
        return state, history

    # -- the worker ------------------------------------------------------------

    def _run_worker(self, index: int, device: torch.device, client, dataset, epochs: int,
                    batch_size: int, on_epoch_done=None) -> List[Dict[str, float]]:
        """``index`` is the worker's slot: it selects the dataset partition
        and seeds the worker's streams."""
        x, y = dataset.partition(index)
        nb = len(x) // batch_size
        if nb == 0:
            raise ValueError(
                f"worker {index}: partition of {len(x)} rows < batch_size {batch_size}")
        usable = nb * batch_size
        pipelined = (self.pipelined_comms if self.pipelined_comms is not None
                     else self.parameter_server_mode != "local")
        comms = _CommsPipeline(
            client, index, self.max_failures, sync_interval=self.sync_interval,
            to_host=self.parameter_server_mode != "local") if pipelined else None
        try:
            return self._run_worker_units(index, device, client, comms,
                                          np.asarray(x[:usable]), np.asarray(y[:usable]),
                                          nb, epochs, batch_size, on_epoch_done)
        finally:
            if comms is not None:
                comms.close()

    def _run_worker_units(self, index: int, device: torch.device, client, comms, x, y,
                          nb: int, epochs: int, batch_size: int,
                          on_epoch_done=None) -> List[Dict[str, float]]:
        wm = _WorkerModel(self.compiled, device, self._dispatch_locks.get(device),
                          self._capture)
        epoch_metrics: List[Dict[str, float]] = []
        tracer = obs.default_tracer()
        usable = nb * batch_size

        def pull_state(step: int, attempt: int = 0):
            """A fresh pull into the worker's module; returns the state and
            the pulled tensors (the delta's ``before``)."""
            with tracer.span("async/pull", worker=index, step=step):
                pulled = comms.pull() if comms is not None else client.get_parameters()
                if comms is not None:
                    if self.frequency == "batch":
                        comms.prefetch()  # the next unit's pull rides the wire now
                    if hasattr(client, "hand_over"):  # pulled on the comms thread
                        client.hand_over(pulled)
                before = wm.load(pulled)
                wm.generator.manual_seed(dropout_seed(index, step, attempt))
                wm.state.step = step
                return wm.state, before

        def push_delta(before) -> None:
            with tracer.span("async/push", worker=index) as psp:
                delta = wm.tree(wm.delta(before))
                if self.frequency == "epoch":
                    # Dynamics at epoch granularity only: the norms read
                    # the device once.
                    obs.record_unit_dynamics(
                        obs.default_registry(), f"w{index}",
                        delta_norm=obs.tree_norm(delta["params"]),
                        param_norm=obs.tree_norm(wm.tree(before)["params"]),
                        span=psp)
                if comms is None:
                    client.update_parameters(delta)
                    return
                comms.push(delta)  # fire-and-forget, bounded backpressure
                if self.frequency == "epoch":
                    # Epoch pulls prefetch AFTER the push, so the next
                    # epoch's base includes this worker's own epoch.
                    comms.prefetch()

        epoch_retries = 0

        def run_unit(unit, **unit_args):
            """Spark's ``spark.task.maxFailures`` analogue: ``unit(attempt)``
            runs one frequency-unit from a fresh pull; a transient
            exception retries it (re-seeded) up to ``max_failures``
            attempts. PS death propagates at once. At-least-once: a unit
            that fails after its push landed pushes again on the retry
            (one more small SGD step)."""
            nonlocal epoch_retries
            for attempt in range(self.max_failures):
                try:
                    ctx = obs.new_context() if tracer.enabled else None
                    with obs.activate(ctx), tracer.span(
                            "async/unit", worker=index, attempt=attempt, **unit_args):
                        return unit(attempt)
                except ParameterServerUnavailable:
                    raise
                except Exception:
                    if attempt + 1 >= self.max_failures:
                        raise
                    epoch_retries += 1
                    obs.default_registry().counter(
                        "worker_retry_total",
                        help="frequency-unit retries across all workers",
                    ).inc()

        def finish_epoch(entry, epoch: int) -> None:
            nonlocal epoch_retries
            if comms is not None:
                # Every push of this epoch is server-side before the
                # barrier counts the epoch done.
                comms.flush()
            obs.record_unit_dynamics(obs.default_registry(), f"w{index}",
                                     loss=entry.get("loss"))
            entry["_retries"] = float(epoch_retries)
            epoch_retries = 0
            epoch_metrics.append(entry)
            if on_epoch_done is not None:
                on_epoch_done(epoch)

        def finish_worker() -> List[Dict[str, float]]:
            if comms is not None:
                comms.close()  # before the client: a stray prefetch must not race it
            if hasattr(client, "close"):
                client.close()
            return epoch_metrics

        if self.stream_batches is not None:
            self._stream_units(index, device, x, y, nb, epochs, batch_size, wm, pull_state,
                               push_delta, run_unit, finish_epoch)
            return finish_worker()

        # The partition is uploaded to the worker's device ONCE and
        # shuffled there each epoch.
        x_d = torch.as_tensor(x).to(device)
        y_d = torch.as_tensor(y).to(device)
        global_step = 0
        for epoch in range(epochs):
            if self.frequency == "epoch":

                def epoch_unit(attempt, epoch=epoch):
                    perm = worker_permutation(index, epoch, attempt, usable).to(device)
                    ex = x_d[perm].reshape(nb, batch_size, *x_d.shape[1:])
                    ey = y_d[perm].reshape(nb, batch_size, *y_d.shape[1:])
                    state, before = pull_state(global_step, attempt)
                    with tracer.span("async/train", worker=index, epoch=epoch):
                        state, metrics = wm.epoch_fn(state, ex, ey)
                        # Reading the metrics waits for the whole epoch, so
                        # a device fault raises HERE (retryable), before a
                        # poisoned delta could reach the server.
                        fetched = dict(zip(metrics, torch.stack(
                            list(metrics.values())).tolist()))
                    push_delta(before)
                    return fetched

                entry = run_unit(epoch_unit, epoch=epoch, partition=index)
                global_step += nb
            else:  # 'batch': pull/push every step (the reference's cadence)
                perm = worker_permutation(index, epoch, 0, usable).to(device)
                device_metrics = []
                for b in range(nb):

                    def batch_unit(attempt, b=b):
                        idx = perm[b * batch_size:(b + 1) * batch_size]
                        xb, yb = x_d[idx], y_d[idx]
                        state, before = pull_state(global_step, attempt)
                        state, metrics = wm.train_step(state, xb, yb)
                        push_delta(before)
                        return metrics

                    device_metrics.append(run_unit(batch_unit, epoch=epoch, partition=index,
                                                   step=global_step))
                    global_step += 1
                # Metrics stay on the device per step; one read per epoch.
                entry = _mean_of_steps(device_metrics)
            finish_epoch(entry, epoch)
        return finish_worker()

    def _stream_units(self, index, device, x, y, nb, epochs, batch_size, wm, pull_state,
                      push_delta, run_unit, finish_epoch) -> None:
        """The worker's epochs over its streamed partition: chunks of
        ``stream_batches`` batches (the last may be short) through a
        ``ChunkStream``, in the JAX package's NumPy orders, keyed as the
        resident shuffle (``[1234, worker, 7, epoch]``, and 10000 +
        attempt on a retried epoch unit). Before a third chunk enters
        flight the metrics of chunk i-1 are read, so its steps have run
        and its memory can go. An 'epoch' unit streams the whole
        partition from one pull (a retry re-streams it in a re-seeded
        order); a 'batch' unit is one step on a batch of the chunk."""
        usable = nb * batch_size
        chunk_rows = min(self.stream_batches, nb) * batch_size
        spans = [(s, min(s + chunk_rows, usable)) for s in range(0, usable, chunk_rows)]
        stream = ChunkStream(x, y, chunk_rows, device)
        tracer = obs.default_tracer()

        def order(epoch: int, attempt: int) -> np.ndarray:
            words = [1234, index, 7, epoch] + ([10_000 + attempt] if attempt else [])
            return np.random.default_rng(words).permutation(usable)

        global_step = 0
        for epoch in range(epochs):
            if self.frequency == "epoch":

                def epoch_unit(attempt, epoch=epoch):
                    perm = order(epoch, attempt)
                    state, before = pull_state(global_step, attempt)
                    chunk_metrics = []
                    with tracer.span("async/train", worker=index, epoch=epoch):
                        nxt = stream.put(perm[slice(*spans[0])])
                        for ci in range(len(spans)):
                            if ci >= 1:  # backpressure: chunk ci-1 has run
                                chunk_metrics[ci - 1] = chunk_metrics[ci - 1].tolist()
                            cur = nxt
                            if ci + 1 < len(spans):
                                nxt = stream.put(perm[slice(*spans[ci + 1])])
                            cx, cy = cur.arrays(batch_size)
                            state, metrics = wm.epoch_fn(state, cx, cy)
                            chunk_metrics.append(torch.stack(list(metrics.values())))
                            del cur, cx, cy
                        # Reading every chunk's metrics waits for the epoch:
                        # a device fault raises here (retryable), before the
                        # delta could reach the server.
                        fetched = [m if isinstance(m, list) else m.tolist()
                                   for m in chunk_metrics]
                    out = weighted_mean_over_chunks(
                        [(s, e, i) for i, (s, e) in enumerate(spans)],
                        lambda start, stop, i: dict(zip(metrics, fetched[i])), usable)
                    push_delta(before)
                    return out

                entry = run_unit(epoch_unit, epoch=epoch, partition=index)
                global_step += nb
            else:
                perm = order(epoch, 0)
                device_metrics = []
                last_of_chunk = None
                nxt = stream.put(perm[slice(*spans[0])])
                for ci in range(len(spans)):
                    cur = nxt
                    if ci + 1 < len(spans):
                        if last_of_chunk is not None:  # backpressure: chunk ci-1 has run
                            float(device_metrics[last_of_chunk]["loss"])
                        nxt = stream.put(perm[slice(*spans[ci + 1])])
                    cxb, cyb = cur.arrays(batch_size)
                    for b in range(len(cxb)):

                        def batch_unit(attempt, xb=cxb[b], yb=cyb[b]):
                            state, before = pull_state(global_step, attempt)
                            state, metrics = wm.train_step(state, xb, yb)
                            push_delta(before)
                            return metrics

                        device_metrics.append(run_unit(batch_unit, epoch=epoch,
                                                       partition=index, step=global_step))
                        global_step += 1
                    last_of_chunk = len(device_metrics) - 1
                    del cur, cxb, cyb
                entry = _mean_of_steps(device_metrics)
            finish_epoch(entry, epoch)


def _mean_of_steps(device_metrics) -> Dict[str, float]:
    """The mean of each metric over an epoch's steps, read back once."""
    names = list(device_metrics[0])
    table = torch.stack([torch.stack([m[k] for k in names])
                         for m in device_metrics]).double().mean(0).tolist()
    return dict(zip(names, table))
