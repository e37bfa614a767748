"""Train/eval/predict step builders (counterpart of ``elephas_tpu/engine/step.py``).

The JAX package builds pure functions that XLA compiles once; the port's
steps run eagerly. A train step updates the module's parameters and the
optimizer's state in place and returns the same ``TrainState`` with its
step advanced.

Losses are computed in float32 on the outputs, whatever the compute
dtype, and per-example losses are meaned. Metrics come back as 0-d
tensors on the model's device: reading them (``float``) synchronises
with the device, so a training loop reads them when it needs them, not
every step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.parallel.mesh import DATA_AXIS, build_mesh


def make_loss_fn(compiled) -> Callable:
    """``loss_fn(x, y) -> (loss, outputs)``: the training-mode forward and
    the per-example loss's mean, with autograd."""

    def loss_fn(x, y):
        outputs = compiled.apply_train(x)
        return compiled.loss_fn(outputs.float(), y).mean(), outputs

    return loss_fn


def _metrics_dict(compiled, loss, outputs, y) -> Dict[str, torch.Tensor]:
    metrics = {"loss": loss}
    for name, fn in zip(compiled.metric_names, compiled.metric_fns):
        metrics[name] = fn(outputs.float(), y).mean()
    return metrics


def make_train_step(compiled, pmean_axis=None) -> Callable:
    """Build ``step(state, x, y) -> (state, metrics)``.

    ``pmean_axis``: None, or the data group to average over, the JAX
    package's ``lax.pmean`` over the mesh's data axis: a
    ``parallel.mesh.Mesh``, or ``DATA_AXIS`` for every process of the
    default group. Every gradient is averaged across the group before the
    optimizer step, and the metrics after it. Batch statistics stay per
    rank, as in the JAX package. Other axes (sequence parallelism) are not
    ported yet and raise.
    """
    if isinstance(pmean_axis, str):
        if pmean_axis != DATA_AXIS:
            raise NotImplementedError(
                f"pmean_axis={pmean_axis!r}: only the data axis is ported; sequence "
                "parallelism arrives with the LM-parallelism item of ROADMAP.md, queue 1"
            )
        pmean_axis = build_mesh()
    loss_fn = make_loss_fn(compiled)
    mesh = pmean_axis if pmean_axis is not None and pmean_axis.size > 1 else None

    def train_step(state: TrainState, x, y):
        state.optimizer.zero_grad(set_to_none=True)
        loss, outputs = loss_fn(x, y)
        loss.backward()
        if mesh is not None:
            mesh.all_reduce_([p.grad for p in compiled.module.parameters()
                              if p.grad is not None])
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            metrics = _metrics_dict(compiled, loss.detach(), outputs.detach(), y)
        if mesh is not None:
            values = torch.stack(list(metrics.values()))
            mesh.all_reduce_([values])
            metrics = dict(zip(metrics, values.unbind()))
        return state, metrics

    return train_step


def make_eval_step(compiled) -> Callable:
    """Build ``eval_step(state, x, y) -> metrics`` (inference mode)."""

    def eval_step(state: TrainState, x, y) -> Dict[str, torch.Tensor]:
        outputs = compiled.apply_eval(x)
        loss = compiled.loss_fn(outputs.float(), y).mean()
        return _metrics_dict(compiled, loss, outputs, y)

    return eval_step


def weighted_mean_over_chunks(spans, eval_chunk, n: int) -> Dict[str, float]:
    """Exact weighted mean of per-chunk metric dicts over ``n`` rows.

    ``spans`` yields tuples whose first two elements are (start, stop);
    ``eval_chunk(*span)`` returns a metrics dict for those rows.
    """
    totals: Dict[str, float] = {}
    for span in spans:
        start, stop = span[0], span[1]
        metrics = eval_chunk(*span)
        for k, v in metrics.items():
            totals[k] = totals.get(k, 0.0) + float(v) * (stop - start)
    return {k: v / n for k, v in totals.items()}


_EVAL_CACHE_MAX_BYTES = 1 << 30  # keep eval sets up to 1 GiB on the device
_EVAL_CACHE_SLOTS = 4  # a validation split and a manual evaluate each keep theirs


class DeviceEvalCache:
    """Small LRU device cache for arrays evaluated repeatedly (per-epoch
    validation): each set is uploaded once and sliced on the device,
    instead of re-uploaded every epoch. ``_EVAL_CACHE_SLOTS`` entries let
    alternating sets (a validation split and a manual ``evaluate``) each
    keep theirs.

    Keyed by object identity for arrays (the host arrays are kept, so a
    recycled ``id`` never serves a stale copy) and by equality for
    scalars: callers must not mutate a cached array in place between
    calls. A set larger than ``_EVAL_CACHE_MAX_BYTES`` is not cached
    (``get`` returns None and the caller streams chunks); cached entries
    together stay within the same budget, evicted least recently used
    first before the new set uploads.
    """

    def __init__(self):
        self._entries: list = []  # [(key, nbytes, device_value)], most recent last

    @staticmethod
    def _same(a, b):
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return a is b
        return a == b

    def _match(self, key: tuple) -> Optional[int]:
        for i, (k, _, _) in enumerate(self._entries):
            if len(k) == len(key) and all(self._same(a, b) for a, b in zip(k, key)):
                return i
        return None

    def get(self, key: tuple, nbytes: int, make: Callable):
        if nbytes > _EVAL_CACHE_MAX_BYTES:
            return None
        i = self._match(key)
        if i is not None:
            entry = self._entries.pop(i)
            self._entries.append(entry)  # refresh LRU position
            return entry[2]
        while self._entries and (
            len(self._entries) >= _EVAL_CACHE_SLOTS
            or sum(e[1] for e in self._entries) + nbytes > _EVAL_CACHE_MAX_BYTES
        ):
            self._entries.pop(0)
        dev = make()
        self._entries.append((key, nbytes, dev))
        return dev


def make_predict_step(compiled) -> Callable:
    def predict_step(state: TrainState, x):
        return compiled.apply_eval(x)

    return predict_step


def make_epoch_scanner(train_step: Callable) -> Callable:
    """Build ``scan_epoch(state, xs, ys) -> (state, mean_metrics)``.

    xs/ys are (num_batches, batch, ...) stacks; the batches run in order
    in a Python loop (the JAX package's ``lax.scan``) and each metric is
    the mean over the batches.
    """

    def scan_epoch(state: TrainState, xs, ys):
        history = []
        for x, y in zip(xs, ys):
            state, metrics = train_step(state, x, y)
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}

    return scan_epoch


def init_train_state(compiled, rng: Optional[torch.Generator] = None) -> TrainState:
    """Fresh TrainState over a CompiledModel's current weights."""
    return TrainState.create(optimizer=compiled.init_opt_state(), rng=rng)
