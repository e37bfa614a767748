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

import torch

from elephas_tpu_torch.engine.state import TrainState


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


def make_train_step(compiled, pmean_axis: Optional[str] = None) -> Callable:
    """Build ``step(state, x, y) -> (state, metrics)``.

    ``pmean_axis`` (the JAX package's gradient all-reduce over mesh
    axes) is not ported: data and sequence parallelism arrive with the
    ``fit`` and LM-parallelism items of ROADMAP.md.
    """
    if pmean_axis is not None:
        raise NotImplementedError(
            "pmean_axis (data/sequence-parallel gradient averaging) is not "
            "ported yet; it arrives with the fit and LM-parallelism items of "
            "ROADMAP.md, queue 1"
        )
    loss_fn = make_loss_fn(compiled)

    def train_step(state: TrainState, x, y):
        state.optimizer.zero_grad(set_to_none=True)
        loss, outputs = loss_fn(x, y)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        with torch.no_grad():
            metrics = _metrics_dict(compiled, loss.detach(), outputs.detach(), y)
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
