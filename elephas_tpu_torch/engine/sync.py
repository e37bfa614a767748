"""Synchronous data-parallel trainer (counterpart of ``elephas_tpu/engine/sync.py``).

Reference semantics (SURVEY.md §3.1): each ``SparkWorker`` trains on its
partition, the driver averages the workers' weights. The JAX package runs
an epoch as one SPMD program over the mesh's ``'data'`` axis. The port
runs one process per device in a ``torch.distributed`` group
(``parallel/mesh.py``): each rank uploads only its own rows (its column
block of ``stack_epoch``'s layout), trains on them, and the ranks meet in
collectives:

- ``frequency='batch'``: gradients are averaged every step (lockstep
  data parallelism; ``make_train_step(pmean_axis=...)``);
- ``frequency='epoch'``: ranks train an epoch independently, then the
  parameters and the float optimizer state are averaged and the integer
  optimizer state (step counts) takes the max;
- ``frequency='fit'``: independent local training with one average at
  the end, the reference's coarsest granularity.

In every frequency the BatchNorm statistics are each rank's own and are
averaged at the end of the epoch (at the end of the fit for ``'fit'``).
Each rank reshuffles its rows every epoch (``shard_permutation``), by
the state's epoch count, so a fit resumed from a checkpoint draws the
orders the uninterrupted fit would have drawn.
Evaluation and prediction split the rows across the ranks and give the
exact weighted mean, and every prediction, on every rank.

A group of one process (no process group initialised) runs no
collective.

- ``stream_batches``: each rank streams its rows to the device in chunks
  of that many batches through a double-buffered pipeline
  (``ChunkStream``) instead of uploading them once, for data larger than
  the card; the rows follow the JAX package's NumPy orders exactly.
- ``autotune``: at the start of the fit the eager step is timed against
  the same step captured as a CUDA graph on a 2-batch slice of the
  rank's rows (``utils/compiler.py``), and rank 0's winner trains. A
  fit of several ranks on cards keeps the eager step, with a note.
- Every epoch is a ``train/epoch`` span (validation ``train/eval``), a
  ``train_epoch_seconds`` observation and one ``record_unit_dynamics``
  row (loss, delta norm, parameter norm), from one host read.

``mount_ops`` mounts the trainer process's ops endpoint
(``obs.opsd.OpsServer``, role ``worker``): its registry, sampled history,
``torch.profiler`` capture and the card's memory.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elephas_tpu_torch import native, obs
from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.parallel import distributed
from elephas_tpu_torch.engine.step import (
    CAPTURE_WARMUP_STEPS,
    CapturedStep,
    DeviceEvalCache,
    build_train_step,
    init_train_state,
    make_eval_step,
    make_predict_step,
)
from elephas_tpu_torch.utils.compiler import autotune_candidates, autotune_compile_options

_PER_FIT = "fit"
_PER_EPOCH = "epoch"
_PER_BATCH = "batch"

logger = logging.getLogger(__name__)

_AUTOTUNE_SKIPPED = {"winner": "skipped", "ms_per_2batch": {}}
# Why a fit of several ranks on cards A/Bs the eager step alone.
_MULTI_RANK_EAGER = ("a step captured on several ranks' cards is not checked yet (the "
                     "'batch' step's NCCL all-reduce inside the graph; ROADMAP queue 1 item 2)")


def decide_autotune(local, mesh=None):
    """Adopt one autotune outcome group-wide: ``local`` is this rank's
    ``(winner, options, table)`` or None; in a group of several
    processes rank 0's is broadcast and every rank adopts it (per-rank
    timings straddle noise, and ranks in lockstep must step alike). Every
    rank of ``mesh`` calls this (the broadcast is a collective)."""
    if mesh is None or mesh.size == 1:
        return local
    shipped = [local if mesh.rank == 0 else None]
    dist.broadcast_object_list(shipped, src=0, group=mesh.group)
    return shipped[0]


class ChunkStream:
    """Host-to-device chunks of a partition's rows, double-buffered.

    ``put(rows)`` gathers those rows of ``x`` and ``y`` (``native.
    gather_rows``) into the next of two pinned staging buffers, used in
    turn, and copies them with ``non_blocking`` on a side stream into a
    chunk allocated there and ``record_stream``-ed on the compute stream
    (the stream current at ``put``), so the allocator keeps it until the
    compute stream is done with it. A staging buffer is refilled only
    after its previous copy's event has completed. The returned
    ``Chunk``'s ``arrays()`` makes the compute stream wait for the copy's
    event, then gives the device tensors: call it where the chunk is
    used, so the copy overlaps the work queued before it. Off the card
    the chunk is the gathered rows on the CPU.
    """

    def __init__(self, x, y, max_rows: int, device: torch.device):
        self.x, self.y, self.device = np.asarray(x), np.asarray(y), device
        self._turn = 0
        if device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(device)
            self._stages = [tuple(torch.empty((max_rows, *a.shape[1:]),
                                              dtype=torch.from_numpy(a[:0]).dtype,
                                              pin_memory=True)
                                  for a in (self.x, self.y)) for _ in range(2)]
            self._copied: List[Optional[torch.cuda.Event]] = [None, None]

    def put(self, rows: np.ndarray) -> "Chunk":
        n = len(rows)
        if self.device.type != "cuda":
            gx, gy = native.gather_rows(self.x, self.y, rows)
            return Chunk(torch.from_numpy(gx), torch.from_numpy(gy), None)
        turn, self._turn = self._turn, 1 - self._turn
        if self._copied[turn] is not None:
            self._copied[turn].synchronize()
        sx, sy = (t[:n] for t in self._stages[turn])
        native.gather_rows(self.x, self.y, rows, out=(sx.numpy(), sy.numpy()))
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            cx = sx.to(self.device, non_blocking=True)
            cy = sy.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        cx.record_stream(compute)
        cy.record_stream(compute)
        self._copied[turn] = copied
        return Chunk(cx, cy, copied)

    def mark(self) -> Optional[torch.cuda.Event]:
        """An event on the compute stream after the work queued so far
        (None off the card): once it has completed, the chunks that work
        used are off the card."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done


class Chunk:
    """One uploaded chunk (``ChunkStream.put``)."""

    __slots__ = ("x", "y", "copied")

    def __init__(self, x, y, copied):
        self.x, self.y, self.copied = x, y, copied

    @property
    def nbytes(self) -> int:
        return self.x.nbytes + self.y.nbytes

    def arrays(self, batch_size: int):
        """``(x, y)`` as (batches, batch_size, ...), once the copy is done
        on the current stream's timeline."""
        if self.copied is not None:
            torch.cuda.current_stream(self.x.device).wait_event(self.copied)
        k = len(self.x) // batch_size
        return (self.x.reshape(k, batch_size, *self.x.shape[1:]),
                self.y.reshape(k, batch_size, *self.y.shape[1:]))


def _global_norm(tensors) -> torch.Tensor:
    """The L2 norm over every element of ``tensors``, on their device."""
    return torch.linalg.vector_norm(torch.stack([n.float() for n in torch._foreach_norm(tensors)]))


def stack_epoch(features, labels, n_shards: int, batch_size: int):
    """Lay out an epoch as (num_batches, n_shards*batch_size, ...) so that
    column block ``d`` of every batch holds rows from partition ``d`` —
    partition-faithful to the reference's "one RDD partition per worker".
    """
    global_bs = n_shards * batch_size
    usable = (len(features) // global_bs) * global_bs
    if usable == 0:
        raise ValueError(
            f"dataset of {len(features)} rows too small for "
            f"{n_shards} shards × batch_size {batch_size}"
        )
    nb = usable // global_bs

    def lay_out(arr):
        arr = arr[:usable]
        # (n, nb, bs, ...): partition-major, then interleave to (nb, n*bs, ...).
        arr = arr.reshape(n_shards, nb, batch_size, *arr.shape[1:])
        arr = np.swapaxes(arr, 0, 1)
        return arr.reshape(nb, global_bs, *arr.shape[3:])

    return lay_out(np.asarray(features)), lay_out(np.asarray(labels)), nb


def shard_block(features, labels, n_shards: int, batch_size: int, shard: int):
    """Column block ``shard`` of ``stack_epoch``'s layout, (num_batches,
    batch_size, ...) each, without laying out the other shards' rows:
    the ``num_batches * batch_size`` rows of partition ``shard``."""
    global_bs = n_shards * batch_size
    nb = len(features) // global_bs
    if nb == 0:
        raise ValueError(
            f"dataset of {len(features)} rows too small for "
            f"{n_shards} shards × batch_size {batch_size}"
        )
    lo, hi = shard * nb * batch_size, (shard + 1) * nb * batch_size

    def block(arr):
        arr = np.asarray(arr)[lo:hi]
        return arr.reshape(nb, batch_size, *arr.shape[1:])

    return block(features), block(labels), nb


def shard_permutation(seed: int, epoch: int, shard: int, n: int) -> torch.Tensor:
    """The order of shard ``shard``'s ``n`` rows in epoch ``epoch``: a
    ``torch.Generator`` permutation seeded from (seed, epoch, shard) (the
    JAX package folds the epoch and the shard into its key; torch's Philox
    cannot reproduce those keys, so the streams differ)."""
    key = np.random.SeedSequence([seed, epoch, shard]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(key) & 0x7FFFFFFFFFFFFFFF)
    return torch.randperm(n, generator=gen)


class SyncTrainer:
    def __init__(self, compiled, mesh, frequency: str = _PER_EPOCH, autotune: bool = False):
        """``autotune``: at the start of a fit, time each candidate of
        ``utils.compiler.autotune_candidates`` (the eager step, and on a
        card the captured one) on a 2-batch slice of this rank's rows and
        train with rank 0's winner; ``autotune_choice`` (and the fit
        history's ``compile_autotune``) records it."""
        if frequency not in (_PER_BATCH, _PER_EPOCH, _PER_FIT):
            raise ValueError(f"sync frequency must be batch|epoch|fit, got {frequency!r}")
        self.compiled = compiled
        self.mesh = mesh
        self.frequency = frequency
        self.autotune = autotune
        self.autotune_choice = None
        self.n_shards = mesh.size
        self.rank = mesh.rank
        self._pmean = mesh if frequency == _PER_BATCH else None
        self._train_step = build_train_step(compiled, pmean_axis=self._pmean)
        self._eval_step = make_eval_step(compiled)
        self._predict_step = make_predict_step(compiled)
        self._eval_cache = DeviceEvalCache()
        self.ops = None  # OpsServer, mounted on demand (mount_ops)
        self.store = None
        self._ops_history = None

    @property
    def device(self) -> torch.device:
        return next(self.compiled.module.parameters()).device

    # -- observability ---------------------------------------------------------

    def mount_ops(self, port: int = 0, host: Optional[str] = None,
                  store_dir: Optional[str] = None):
        """Mount a live introspection endpoint for this trainer's process
        (role ``worker``, id ``w<rank>``): ``/metrics`` serves the process
        registry the step counters feed, ``/history`` its sampled rings,
        ``/profile`` ``torch.profiler`` capture and the card's memory.
        Loopback by default; idempotent; ``unmount_ops()`` tears it down.
        ``store_dir`` also journals flight notes and sampler ticks into a
        durable telemetry store (``obs.store``) for post-mortems."""
        if self.ops is not None:
            return self.ops
        worker_id = f"w{distributed.process_index()}"
        self._ops_history = obs.HistorySampler(extra_fn=obs.record_device_memory).start()
        self.store = None
        if store_dir is not None:
            self.store = obs.TelemetryStore(store_dir, role="worker",
                                            flight=obs.default_flight_recorder())
            obs.default_flight_recorder().attach_store(self.store)
            self._ops_history.attach_store(self.store)
        self.ops = obs.OpsServer(
            port=port, host=host, role="worker", worker_id=worker_id,
            history=self._ops_history,
            vars_fn=lambda: {
                "role": "worker",
                "worker_id": worker_id,
                "frequency": self.frequency,
                "n_shards": self.n_shards,
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
            self.store.close()
            self.store = None

    # -- collectives -----------------------------------------------------------

    def _average_state(self, state: TrainState, params: bool) -> None:
        """Re-replicate across the group, in place: float tensors
        (BatchNorm statistics; with ``params``, also the parameters and
        the float optimizer state) are averaged, integer ones
        (``num_batches_tracked``; the optimizer's step counts) take the
        max."""
        module = self.compiled.module
        tensors = [b for b in module.buffers()]
        if params:
            tensors += [p.data for p in module.parameters()]
            for per_param in state.optimizer.state.values():
                tensors += [v for v in per_param.values() if torch.is_tensor(v)]
        floats = [t for t in tensors if t.is_floating_point()]
        ints = [t for t in tensors if not t.is_floating_point()]
        groups = state.optimizer.param_groups if params else []
        if groups:
            ints.append(torch.tensor([g["count"] for g in groups], device=self.device))
        self.mesh.all_reduce_(floats, "mean")
        self.mesh.all_reduce_(ints, "max")
        for g, count in zip(groups, ints[-1].tolist() if groups else ()):
            g["count"] = count

    # -- autotune --------------------------------------------------------------

    def _run_autotune(self, xs, ys) -> None:
        """The A/B of ``autotune_candidates`` on this rank's first two
        batches, each candidate on a clone of the model (the fit's state
        keeps no trace of it), every rank in lockstep (the 'batch' step
        all-reduces); rank 0's outcome decides (``decide_autotune``) and
        its winner becomes the fit's step."""
        mini_x, mini_y = xs[:2], ys[:2]

        def build(options):
            clone = self.compiled.clone()
            step = build_train_step(clone, options, pmean_axis=self._pmean)
            state = init_train_state(clone)
            if isinstance(step, CapturedStep):  # its warm-up and capture, untimed
                for _ in range(CAPTURE_WARMUP_STEPS + 1):
                    state, _ = step(state, mini_x[0], mini_y[0])
            return step, state

        def run(built):
            step, state = built
            for x, y in zip(mini_x, mini_y):
                _, metrics = step(state, x, y)
            return metrics

        candidates = autotune_candidates(self.device)
        eager_only = self.mesh.size > 1 and self.device.type == "cuda"
        if eager_only:
            candidates = candidates[:1]
            logger.warning("autotune=True: %s; training with the eager step", _MULTI_RANK_EAGER)
        local = autotune_compile_options(build, run, lambda m: float(m["loss"]),
                                         candidates=candidates)
        winner, options, table = decide_autotune(local, self.mesh)
        self.autotune_choice = {"winner": winner, "ms_per_2batch": table}
        if eager_only:
            self.autotune_choice["note"] = _MULTI_RANK_EAGER
        if table:  # more than one candidate was timed
            self._train_step = build_train_step(self.compiled, options, pmean_axis=self._pmean)

    def _skip_autotune(self, why: str) -> None:
        if self.autotune and self.autotune_choice is None:
            # Visibly: the history says the fit kept the eager step.
            self.autotune_choice = dict(_AUTOTUNE_SKIPPED)
            logger.warning("autotune=True is not supported with %s; training with the "
                           "eager step (compile_autotune='skipped')", why)

    # -- host-side driver ------------------------------------------------------

    def _upload(self, dataset, batch_size: int):
        """This rank's (num_batches, batch_size, ...) rows on the device."""
        x, y, nb = shard_block(dataset.features, dataset.labels, self.n_shards,
                               batch_size, self.rank)
        return (torch.as_tensor(x).to(self.device), torch.as_tensor(y).to(self.device), nb)

    def _steps(self, state, xs, ys, total=None):
        """``xs``/``ys``'s batches through the train step; returns the
        state and the sum of each step's metrics (a stacked tensor, added
        to ``total``) and their names."""
        for x, y in zip(xs, ys):
            state, metrics = self._train_step(state, x, y)
            values = torch.stack(list(metrics.values()))
            total = values if total is None else total + values
        return state, total, list(metrics)

    def _local_epoch(self, state, xs, ys, seed: int, epoch: int):
        """One pass over this rank's rows, reshuffled; returns the state
        and the per-batch mean of each metric, as tensors."""
        nb, bs = xs.shape[0], xs.shape[1]
        perm = shard_permutation(seed, epoch, self.rank, nb * bs).to(self.device)
        xs = xs.reshape(nb * bs, *xs.shape[2:])[perm].reshape(xs.shape)
        ys = ys.reshape(nb * bs, *ys.shape[2:])[perm].reshape(ys.shape)
        state, total, names = self._steps(state, xs, ys)
        return state, dict(zip(names, (total / nb).unbind()))

    def _end_epoch(self, state, metrics, before, span) -> Dict[str, float]:
        """Epoch-end averaging, then one host read: the metrics (averaged
        across the group at 'epoch' frequency) and the norms of the
        epoch's update and of the parameters before it, recorded as the
        epoch's dynamics (``obs.record_unit_dynamics``, the "driver"
        row)."""
        state.epoch += 1
        values = torch.stack(list(metrics.values()))
        if self.frequency == _PER_EPOCH:
            self._average_state(state, params=True)
            self.mesh.all_reduce_([values])
        else:
            self._average_state(state, params=False)
        params = [p.detach() for p in self.compiled.module.parameters()]
        norms = torch.stack([_global_norm(torch._foreach_sub(before, params)),
                             _global_norm(before)])
        host = torch.cat([values.double(), norms.double()]).tolist()
        out = dict(zip(metrics, host[:-2]))
        obs.record_unit_dynamics(obs.default_registry(), loss=out.get("loss"),
                                 delta_norm=host[-2], param_norm=host[-1], span=span)
        return out

    def _after_epoch(self, state, epoch, epochs, metrics, history, validation_data,
                     batch_size, callbacks, verbose, tag) -> None:
        if validation_data is not None:
            # Chunks of at least 512 whatever the training batch.
            with obs.default_tracer().span("train/eval", epoch=epoch):
                val = self.evaluate_state(state, *validation_data,
                                          batch_size=max(batch_size, 512))
            metrics.update({f"val_{k}": v for k, v in val.items()})
        for key, value in metrics.items():
            history.setdefault(key, []).append(value)
        for cb in callbacks:
            cb(epoch, state, metrics)
        if verbose and self.rank == 0:
            desc = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
            print(f"[{tag}] epoch {epoch + 1}/{epochs} {desc}")

    def _parameters_copy(self) -> List[torch.Tensor]:
        return [p.detach().clone() for p in self.compiled.module.parameters()]

    def fit(
        self,
        dataset,
        epochs: int = 10,
        batch_size: int = 32,
        validation_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        verbose: int = 0,
        initial_state: Optional[TrainState] = None,
        rng: Optional[torch.Generator] = None,
        callbacks=(),
        stream_batches: Optional[int] = None,
    ) -> Tuple[TrainState, Dict[str, List[float]]]:
        """``stream_batches``: stream each epoch to the device in chunks of
        that many batches (``_fit_streaming``) instead of uploading the
        rank's rows once."""
        if stream_batches is not None:
            if self.frequency == _PER_FIT:
                raise ValueError("streaming is not supported with frequency='fit' (the "
                                 "parity mode trains every epoch on resident rows)")
            if stream_batches < 1:
                raise ValueError(f"stream_batches must be >= 1, got {stream_batches}")
            self._skip_autotune("stream_batches")
            return self._fit_streaming(dataset, epochs, batch_size, stream_batches,
                                       validation_data, verbose, initial_state, rng, callbacks)
        state = initial_state or init_train_state(self.compiled, rng=rng)
        seed = state.rng.initial_seed()
        xs, ys, _ = self._upload(dataset, batch_size)
        if self.frequency == _PER_FIT:
            # The parity mode trains all epochs before it averages; an A/B
            # of its per-step proxy would record a choice it never used.
            self._skip_autotune("frequency='fit'")
            return self._fit_parity(state, xs, ys, seed, epochs, validation_data, verbose)
        if self.autotune and self.autotune_choice is None:
            self._run_autotune(xs, ys)

        tracer = obs.default_tracer()
        epoch_hist = obs.default_registry().histogram(
            "train_epoch_seconds", help="wall seconds per dispatched training epoch")
        history: Dict[str, List[float]] = {}
        for epoch in range(epochs):
            t_ep = time.perf_counter()
            with tracer.span("train/epoch", mode="sync", epoch=epoch) as span:
                before = self._parameters_copy()
                state, metrics = self._local_epoch(state, xs, ys, seed, state.epoch)
                metrics = self._end_epoch(state, metrics, before, span)
            epoch_hist.observe(time.perf_counter() - t_ep)
            self._after_epoch(state, epoch, epochs, metrics, history, validation_data,
                              batch_size, callbacks, verbose, "sync")
        return state, history

    # -- streaming (data beyond the card) --------------------------------------

    def _fit_streaming(self, dataset, epochs, batch_size, stream_batches, validation_data,
                       verbose, initial_state, rng, callbacks):
        """Each rank streams its partition (``shard_block``'s rows) in
        chunks of ``stream_batches`` batches through a ``ChunkStream``:
        chunk i+1 is gathered and its copy started before chunk i's steps
        are launched, and it enters flight only once chunk i-2's steps
        have run, so at most three chunks are on the device.

        The row orders are the JAX package's, exactly: a NumPy generator
        seeded with the low 31 bits of the state's seed (the reference's
        key's last word) draws one permutation per shard per epoch, in
        shard order, and this rank takes its own. A fit resumed at
        ``state.epoch`` replays the earlier epochs' draws first. Each
        epoch's metrics are the mean over its batches (the reference's
        chunk-weighted mean of the chunks' means); the epoch ends as the
        resident path's does."""
        state = initial_state or init_train_state(self.compiled, rng=rng)
        features, labels = np.asarray(dataset.features), np.asarray(dataset.labels)
        nb = len(features) // (self.n_shards * batch_size)
        if nb == 0:
            raise ValueError(f"dataset of {len(features)} rows too small for "
                             f"{self.n_shards} shards × batch_size {batch_size}")
        rows = nb * batch_size
        lo = self.rank * rows
        stream = ChunkStream(features[lo:lo + rows], labels[lo:lo + rows],
                             min(stream_batches, nb) * batch_size, self.device)
        host_rng = np.random.default_rng(state.rng.initial_seed() & 0x7FFFFFFF)
        for _ in range(state.epoch * self.n_shards):
            host_rng.permutation(rows)
        bounds = list(range(0, nb, stream_batches)) + [nb]
        spans = list(zip(bounds[:-1], bounds[1:]))

        tracer = obs.default_tracer()
        epoch_hist = obs.default_registry().histogram(
            "train_epoch_seconds", help="wall seconds per dispatched training epoch")
        history: Dict[str, List[float]] = {}
        for epoch in range(epochs):
            perm = [host_rng.permutation(rows) for _ in range(self.n_shards)][self.rank]
            t_ep = time.perf_counter()
            with tracer.span("train/epoch", mode="sync-stream", epoch=epoch) as span:
                before = self._parameters_copy()
                ran: deque = deque()  # events after each queued chunk's steps
                nxt = stream.put(perm[spans[0][0] * batch_size:spans[0][1] * batch_size])
                total = None
                for i in range(len(spans)):
                    cur = nxt
                    if i + 1 < len(spans):
                        while len(ran) > 1:  # chunk i-2 has run: a third may enter flight
                            ran.popleft().synchronize()
                        c0, c1 = spans[i + 1]
                        nxt = stream.put(perm[c0 * batch_size:c1 * batch_size])
                    xs, ys = cur.arrays(batch_size)
                    state, total, names = self._steps(state, xs, ys, total)
                    del cur, xs, ys
                    done = stream.mark()
                    if done is not None:
                        ran.append(done)
                metrics = self._end_epoch(state, dict(zip(names, (total / nb).unbind())),
                                          before, span)
            epoch_hist.observe(time.perf_counter() - t_ep)
            self._after_epoch(state, epoch, epochs, metrics, history, validation_data,
                              batch_size, callbacks, verbose, "sync/stream")
        return state, history

    def _fit_parity(self, state, xs, ys, seed, epochs, validation_data, verbose):
        """frequency='fit': independent local training, one final average."""
        per_epoch = []
        for _ in range(epochs):
            state, metrics = self._local_epoch(state, xs, ys, seed, state.epoch)
            state.epoch += 1
            per_epoch.append(torch.stack(list(metrics.values())))
        self._average_state(state, params=True)
        table = torch.stack(per_epoch)
        self.mesh.all_reduce_([table])
        history = {k: [float(v) for v in column]
                   for k, column in zip(metrics, table.T.cpu())}
        if validation_data is not None:
            val = self.evaluate_state(state, *validation_data)
            for k, v in val.items():
                history.setdefault(f"val_{k}", []).append(v)
        if verbose and self.rank == 0:
            print(f"[sync/fit-parity] {epochs} epochs done")
        return state, history

    # -- eval / predict --------------------------------------------------------

    def _rows(self, n: int):
        """This rank's block ``[lo, hi)`` of the first ``usable`` rows
        (a multiple of the group size), and ``usable``."""
        per = n // self.n_shards
        return self.rank * per, (self.rank + 1) * per, per * self.n_shards

    def evaluate_state(self, state, features, labels, batch_size: int = 256) -> Dict[str, float]:
        """Exact weighted mean of the loss and metrics over ALL rows: each
        rank evaluates its block of the rows in chunks of ``batch_size``,
        rank 0 also the remainder that does not split evenly, and one
        all-reduce sums the weighted totals. A set within the
        ``DeviceEvalCache`` bound is uploaded once and sliced on the
        device in later calls."""
        features, labels = np.asarray(features), np.asarray(labels)
        n = len(features)
        lo, hi, usable = self._rows(n)
        nbytes = (features[lo:hi].nbytes + labels[lo:hi].nbytes)
        cached = self._eval_cache.get(
            (features, labels, usable), nbytes,
            lambda: (torch.as_tensor(features[lo:hi]).to(self.device),
                     torch.as_tensor(labels[lo:hi]).to(self.device)))
        spans = [(s, min(s + batch_size, hi)) for s in range(lo, hi, batch_size)]
        if self.rank == 0 and usable < n:
            spans.append((usable, n))

        def chunk(start, stop):
            if cached is not None and stop <= hi:
                x, y = cached[0][start - lo:stop - lo], cached[1][start - lo:stop - lo]
            else:
                x = torch.as_tensor(features[start:stop]).to(self.device)
                y = torch.as_tensor(labels[start:stop]).to(self.device)
            return self._eval_step(state, x, y)

        names, totals = None, torch.zeros(0, device=self.device)
        for start, stop in spans:
            metrics = chunk(start, stop)
            values = torch.stack(list(metrics.values())).double() * (stop - start)
            names, totals = list(metrics), (values if totals.numel() == 0 else totals + values)
        if names is None:  # a rank with no rows still joins the reduction
            names = ["loss", *self.compiled.metric_names]
            totals = torch.zeros(len(names), dtype=torch.float64, device=self.device)
        self.mesh.all_reduce_([totals], "sum")
        return dict(zip(names, (totals / n).tolist()))

    def predict_state(self, state, features, batch_size: int = 256) -> np.ndarray:
        """Every row's prediction, on every rank: each rank predicts its
        block in chunks of ``batch_size`` and the blocks are gathered; the
        remainder that does not split evenly is predicted by every rank."""
        features = np.asarray(features)
        n = len(features)
        lo, hi, usable = self._rows(n)

        def predict(start, stop):
            outs = [self._predict_step(state, torch.as_tensor(features[s:min(s + batch_size,
                                                                               stop)])
                                       .to(self.device))
                    for s in range(start, stop, batch_size)]
            return torch.cat(outs) if outs else None

        mine = predict(lo, hi)
        if self.n_shards > 1 and mine is not None:
            blocks = [torch.empty_like(mine) for _ in range(self.n_shards)]
            dist.all_gather(blocks, mine.contiguous(), group=self.mesh.group)
            mine = torch.cat(blocks)
        parts = [mine] if mine is not None else []
        if usable < n:
            parts.append(predict(usable, n))
        return torch.cat(parts).cpu().numpy()
