"""Train/eval/predict step builders (counterpart of ``elephas_tpu/engine/step.py``).

The JAX package builds pure functions that XLA compiles once; the port's
steps run eagerly. A train step updates the module's parameters and the
optimizer's state in place and returns the same ``TrainState`` with its
step advanced.

Losses are computed in float32 on the outputs, whatever the compute
dtype, and per-example losses are meaned. Metrics come back as 0-d
tensors on the model's device: reading them (``float``) synchronises
with the device, so a training loop reads them when it needs them, not
every step. On a card a step may instead be captured once as a CUDA
graph and replayed (``CapturedStep``, chosen by the trainers' autotune).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from elephas_tpu_torch.engine.losses import VOCAB_PARALLEL_LOSSES
from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.parallel.collectives import all_gather
from elephas_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    _axis_names,
    bound_mesh,
    build_mesh,
)


def _logits_mesh(compiled):
    """The model group over which a tensor-parallel module's outputs stay
    vocab-sharded into the loss (``parallel.tensor_parallel``), or None:
    a module that is not sharded so, or a loss with no vocab-parallel
    counterpart (that one takes the gathered outputs)."""
    tp = getattr(compiled.module, "_tensor_parallel", None)
    if tp is None or tp.logits_mesh is None or compiled.loss_name not in VOCAB_PARALLEL_LOSSES:
        return None
    return tp.logits_mesh


def _loss_and_outputs(compiled, x, y, train: bool):
    mesh = _logits_mesh(compiled)
    apply = compiled.apply_train if train else compiled.apply_eval
    if mesh is None:
        outputs = apply(x)
        return compiled.loss_fn(outputs.float(), y).mean(), outputs
    outputs = apply(x, local_logits=True)
    loss = VOCAB_PARALLEL_LOSSES[compiled.loss_name](outputs.float(), y, mesh)
    return loss.mean(), outputs


def make_loss_fn(compiled) -> Callable:
    """``loss_fn(x, y) -> (loss, outputs)``: the training-mode forward and
    the per-example loss's mean, with autograd. A module whose logits are
    vocab-sharded (tensor parallelism) returns this rank's columns and
    takes the vocab-parallel loss."""

    def loss_fn(x, y):
        return _loss_and_outputs(compiled, x, y, train=True)

    return loss_fn


def _metrics_dict(compiled, loss, outputs, y) -> Dict[str, torch.Tensor]:
    metrics = {"loss": loss}
    mesh = _logits_mesh(compiled)
    if mesh is not None and compiled.metric_fns:
        outputs = all_gather(outputs, mesh, -1)  # metrics take the full logits
    for name, fn in zip(compiled.metric_names, compiled.metric_fns):
        metrics[name] = fn(outputs.float(), y).mean()
    return metrics


def _reducer(pmean_axis) -> Callable:
    """``group()`` giving the one-axis ``Mesh`` that ``pmean_axis`` names
    at the call, or None where nothing is averaged.

    ``pmean_axis``: None; a ``parallel.mesh.Mesh`` (its data group); or an
    axis name or tuple of names (``DATA_AXIS``, ``SEQ_AXIS``,
    ``MODEL_AXIS``), resolved at each call against the mesh bound there
    (``parallel.mesh.bind_mesh``, as ``shard_map`` binds the JAX
    package's axis names). Unbound, the data axis is every process of
    the default group, and the seq and model axes raise ``NameError`` as
    ``lax.pmean`` does on an unbound axis name: averaging nothing there
    would leave each rank training alone."""
    if pmean_axis is None or isinstance(pmean_axis, Mesh):
        fixed = pmean_axis if pmean_axis is not None and pmean_axis.size > 1 else None
        return lambda: fixed
    axes = tuple(_axis_names(pmean_axis))
    default = build_mesh()

    def group():
        bound = bound_mesh()
        unbound = [a for a in (SEQ_AXIS, MODEL_AXIS) if a in axes]
        if bound is None and unbound:
            raise NameError(f"unbound axis name: {unbound[0]}; average over it inside a bound "
                            "mesh (parallel.mesh.bind_mesh, as "
                            "seq_parallel.make_lm_train_step binds it)")
        mesh = (bound or default).over(axes)
        return mesh if mesh.size > 1 else None

    return group


def _pmean_metrics(mesh, metrics):
    if mesh is None:
        return metrics
    values = torch.stack(list(metrics.values()))
    mesh.all_reduce_([values])
    return dict(zip(metrics, values.unbind()))


def make_train_step(compiled, pmean_axis=None) -> Callable:
    """Build ``step(state, x, y) -> (state, metrics)``.

    ``pmean_axis``: None, or what to average over, the JAX package's
    ``lax.pmean``: a ``parallel.mesh.Mesh`` (its data group), or axis
    names, ``DATA_AXIS`` or ``(DATA_AXIS, SEQ_AXIS)``, over the group of
    the mesh bound at the call; unbound, the data axis is every process
    of the default group and the seq axis raises. Every gradient is
    averaged across the group before the optimizer step, and the metrics
    after it: over data × seq that is the global mean when every rank's
    shard has the same size. Batch statistics stay per rank, as in the
    JAX package. Under tensor parallelism the data (or data × seq) group
    is that of the rank's own model index, so each shard is averaged
    with its peers; replicated parameters get the same gradient on every
    model rank and are not reduced over the model group.
    """
    reducer = _reducer(pmean_axis)
    loss_fn = make_loss_fn(compiled)

    def train_step(state: TrainState, x, y):
        mesh = reducer()
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
        return state, _pmean_metrics(mesh, metrics)

    return train_step


#: Eager steps a captured step runs (on a side stream) before it captures.
CAPTURE_WARMUP_STEPS = 3


class CapturedStep:
    """``make_train_step``'s step, captured once as one CUDA graph:
    ``step(state, x, y) -> (state, metrics)`` with the same signature and
    results, one launch a step after the capture.

    - The first ``CAPTURE_WARMUP_STEPS`` calls run ``train_step`` eagerly on a
      side stream: the capture's warm-up (cuDNN and cuBLAS choose and
      allocate there, and the optimizer creates its state). They are
      real steps of the caller's loop, so a captured loop takes the eager
      loop's steps.
    - The next call copies its batch into static inputs, switches the
      optimizer to capturable mode (``api.optim``), clears the gradients
      (the captured backward then allocates them once, in the graph's
      pool, and every replay writes them there), captures the step,
      which executes nothing, and replays it.
    - Every later call copies its batch in, runs the optimizer's host
      part (``advance``: count, schedule, learning rate and bias
      corrections written in place) and replays.

    The parameters, buffers and optimizer state are the graph's operands
    and must keep their addresses: load weights in place
    (``load_state_dict``, ``torch._foreach_copy_``), never rebind them.
    The module's ``dropout_generator``, where it is a CUDA generator, is
    registered with the graph, so a replay after ``manual_seed`` draws
    the masks the eager step would (the default CUDA generator is
    registered by PyTorch). The metrics come back as fresh tensors (one
    copy a step), so the caller may keep them across steps. A step that
    fails to capture raises; it is never run eagerly in the graph's
    place. Only the first state given may be stepped, and only batches
    of the captured shape.
    """

    def __init__(self, compiled, train_step: Callable):
        device = next(compiled.module.parameters()).device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph captures a step on a card; the model is on {device}")
        self.compiled, self.train_step, self.device = compiled, train_step, device
        self.captures = 0
        self._side = torch.cuda.Stream(device)
        self._calls = 0
        self._graph = self._optimizer = self._x = self._y = None

    def _warmup(self, state, x, y):
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            state, metrics = self.train_step(state, x, y)
        current.wait_stream(self._side)
        return state, metrics

    def _capture(self, state, x, y):
        optimizer = state.optimizer.capturable()
        self._optimizer = optimizer
        self._x, self._y = x.detach().clone(), y.detach().clone()
        graph = torch.cuda.CUDAGraph()
        generator = getattr(self.compiled.module, "dropout_generator", None)
        if isinstance(generator, torch.Generator) and generator.device.type == "cuda":
            graph.register_generator_state(generator)
        optimizer.zero_grad(set_to_none=True)
        optimizer.advance()
        with optimizer.in_graph(), torch.cuda.graph(graph, stream=self._side,
                                                    capture_error_mode="thread_local"):
            state, metrics = self.train_step(state, self._x, self._y)
            self._names = list(metrics)
            self._packed = torch.stack([v.reshape(()) for v in metrics.values()])
        self._graph = graph
        self.captures += 1

    def __call__(self, state, x, y):
        self._calls += 1
        if self._calls <= CAPTURE_WARMUP_STEPS:
            return self._warmup(state, x, y)
        if self._graph is None:
            self._capture(state, x, y)  # advances the step (state.step) once
        else:
            if state.optimizer is not self._optimizer:
                raise ValueError("a captured step trains the state it was captured with")
            if x.shape != self._x.shape or y.shape != self._y.shape:
                raise ValueError(f"a captured step takes batches of {tuple(self._x.shape)} "
                                 f"and {tuple(self._y.shape)}, got {tuple(x.shape)} and "
                                 f"{tuple(y.shape)}")
            self._x.copy_(x)
            self._y.copy_(y)
            self._optimizer.advance()
            state.step += 1
        self._graph.replay()
        return state, dict(zip(self._names, self._packed.clone().unbind()))


def build_train_step(compiled, capture: bool = False, pmean_axis=None) -> Callable:
    """The train step an autotune candidate names (``utils.compiler``):
    the eager ``make_train_step``, or with ``capture`` that step captured
    (``CapturedStep``)."""
    step = make_train_step(compiled, pmean_axis=pmean_axis)
    return CapturedStep(compiled, step) if capture else step


def make_eval_step(compiled, pmean_axis=None) -> Callable:
    """Build ``eval_step(state, x, y) -> metrics`` (inference mode), the
    metrics averaged over ``pmean_axis`` as ``make_train_step`` averages
    them."""
    reducer = _reducer(pmean_axis)

    def eval_step(state: TrainState, x, y) -> Dict[str, torch.Tensor]:
        loss, outputs = _loss_and_outputs(compiled, x, y, train=False)
        return _pmean_metrics(reducer(), _metrics_dict(compiled, loss, outputs, y))

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
    return TrainState.create(optimizer=compiled.init_opt_state(), rng=rng,
                             module=compiled.module)
