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
Each rank reshuffles its rows every epoch (``shard_permutation``).
Evaluation and prediction split the rows across the ranks and give the
exact weighted mean, and every prediction, on every rank.

A group of one process (no process group initialised) runs no
collective. Not ported yet: streaming (``stream_batches`` raises),
compile autotuning, and the ``obs`` spans, gauges and ops endpoint
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.engine.step import (
    DeviceEvalCache,
    init_train_state,
    make_eval_step,
    make_predict_step,
    make_train_step,
)

_PER_FIT = "fit"
_PER_EPOCH = "epoch"
_PER_BATCH = "batch"

_LEFT_OUT = "is not ported yet (ROADMAP.md, queue 1: the sync fit slice's left-outs)"


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
    def __init__(self, compiled, mesh, frequency: str = _PER_EPOCH):
        if frequency not in (_PER_BATCH, _PER_EPOCH, _PER_FIT):
            raise ValueError(f"sync frequency must be batch|epoch|fit, got {frequency!r}")
        self.compiled = compiled
        self.mesh = mesh
        self.frequency = frequency
        self.n_shards = mesh.size
        self.rank = mesh.rank
        self._train_step = make_train_step(
            compiled, pmean_axis=mesh if frequency == _PER_BATCH else None)
        self._eval_step = make_eval_step(compiled)
        self._predict_step = make_predict_step(compiled)
        self._eval_cache = DeviceEvalCache()

    @property
    def device(self) -> torch.device:
        return next(self.compiled.module.parameters()).device

    # -- collectives -----------------------------------------------------------

    def _average_state(self, state: TrainState, params: bool) -> None:
        """Re-replicate across the group: float tensors (BatchNorm
        statistics; with ``params``, also the parameters and the float
        optimizer state) are averaged, integer ones (``num_batches_tracked``;
        the optimizer's step counts) take the max."""
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

    # -- host-side driver ------------------------------------------------------

    def _upload(self, dataset, batch_size: int):
        """This rank's (num_batches, batch_size, ...) rows on the device."""
        x, y, nb = shard_block(dataset.features, dataset.labels, self.n_shards,
                               batch_size, self.rank)
        return (torch.as_tensor(x).to(self.device), torch.as_tensor(y).to(self.device), nb)

    def _local_epoch(self, state, xs, ys, seed: int, epoch: int):
        """One pass over this rank's rows, reshuffled; returns the state
        and the per-batch mean of each metric, as tensors."""
        nb, bs = xs.shape[0], xs.shape[1]
        perm = shard_permutation(seed, epoch, self.rank, nb * bs).to(self.device)
        xs = xs.reshape(nb * bs, *xs.shape[2:])[perm].reshape(xs.shape)
        ys = ys.reshape(nb * bs, *ys.shape[2:])[perm].reshape(ys.shape)
        total = None
        for x, y in zip(xs, ys):
            state, metrics = self._train_step(state, x, y)
            values = torch.stack(list(metrics.values()))
            total = values if total is None else total + values
        return state, dict(zip(metrics, (total / nb).unbind()))

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
        if stream_batches is not None:
            raise NotImplementedError(f"stream_batches (streamed epochs) {_LEFT_OUT}")
        state = initial_state or init_train_state(self.compiled, rng=rng)
        seed = state.rng.initial_seed()
        xs, ys, _ = self._upload(dataset, batch_size)
        if self.frequency == _PER_FIT:
            return self._fit_parity(state, xs, ys, seed, epochs, validation_data, verbose)

        history: Dict[str, List[float]] = {}
        for epoch in range(epochs):
            state, metrics = self._local_epoch(state, xs, ys, seed, epoch)
            if self.frequency == _PER_EPOCH:
                self._average_state(state, params=True)
                values = torch.stack(list(metrics.values()))
                self.mesh.all_reduce_([values])
                metrics = dict(zip(metrics, values.unbind()))
            else:
                self._average_state(state, params=False)
            metrics = {k: float(v) for k, v in metrics.items()}
            if validation_data is not None:
                val = self.evaluate_state(state, *validation_data,
                                          batch_size=max(batch_size, 512))
                metrics.update({f"val_{k}": v for k, v in val.items()})
            for key, value in metrics.items():
                history.setdefault(key, []).append(value)
            for cb in callbacks:
                cb(epoch, state, metrics)
            if verbose and self.rank == 0:
                desc = " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                print(f"[sync] epoch {epoch + 1}/{epochs} {desc}")
        return state, history

    def _fit_parity(self, state, xs, ys, seed, epochs, validation_data, verbose):
        """frequency='fit': independent local training, one final average."""
        per_epoch = []
        for epoch in range(epochs):
            state, metrics = self._local_epoch(state, xs, ys, seed, epoch)
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
