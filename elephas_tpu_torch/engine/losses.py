"""Named losses and metrics (counterpart of ``elephas_tpu/engine/losses.py``).

Keras-compatible string identifiers resolved to pure tensor functions.
All take ``(logits_or_preds, targets)`` batched and return per-example
values; reduction is the caller's, so global-batch means stay exact.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _categorical_crossentropy(logits, targets):
    """One-hot targets, logits in; softmax cross-entropy."""
    return -(targets * F.log_softmax(logits, dim=-1)).sum(dim=-1)


def _sparse_categorical_crossentropy(logits, targets):
    log_probs = F.log_softmax(logits, dim=-1)
    return -log_probs.gather(-1, targets.long()[..., None])[..., 0]


def _binary_crossentropy(logits, targets):
    """Sigmoid cross-entropy on logits; targets in {0,1} (any shape)."""
    losses = -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
    return losses.reshape(losses.shape[0], -1).mean(dim=-1)


_EPS = 1e-7  # Keras' epsilon for clipping probabilities


def _categorical_crossentropy_probs(probs, targets):
    """One-hot targets, softmax *probabilities* in."""
    p = probs.clamp(_EPS, 1.0)
    return -(targets * torch.log(p)).sum(dim=-1)


def _sparse_categorical_crossentropy_probs(probs, targets):
    p = probs.clamp(_EPS, 1.0)
    return -torch.log(p.gather(-1, targets.long()[..., None]))[..., 0]


def _binary_crossentropy_probs(probs, targets):
    """Sigmoid *probabilities* in; targets in {0,1}."""
    p = probs.clamp(_EPS, 1.0 - _EPS)
    losses = -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p))
    return losses.reshape(losses.shape[0], -1).mean(dim=-1)


def _mse(preds, targets):
    err = torch.square(preds - targets)
    return err.reshape(err.shape[0], -1).mean(dim=-1)


def _mae(preds, targets):
    err = torch.abs(preds - targets)
    return err.reshape(err.shape[0], -1).mean(dim=-1)


LOSSES: Dict[str, Callable] = {
    "categorical_crossentropy": _categorical_crossentropy,
    "sparse_categorical_crossentropy": _sparse_categorical_crossentropy,
    "binary_crossentropy": _binary_crossentropy,
    "categorical_crossentropy_probs": _categorical_crossentropy_probs,
    "sparse_categorical_crossentropy_probs": _sparse_categorical_crossentropy_probs,
    "binary_crossentropy_probs": _binary_crossentropy_probs,
    "mse": _mse,
    "mean_squared_error": _mse,
    "mae": _mae,
    "mean_absolute_error": _mae,
}


def resolve_loss(loss) -> Callable:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(f"unknown loss {loss!r}; known: {sorted(LOSSES)}") from None


def _accuracy(logits, targets):
    """Works for one-hot or integer targets (categorical accuracy)."""
    pred = torch.argmax(logits, dim=-1)
    if targets.dim() == logits.dim():  # one-hot
        true = torch.argmax(targets, dim=-1)
    else:
        true = targets.to(pred.dtype)
    return (pred == true).float()


def _binary_accuracy(logits, targets):
    pred = (logits > 0).float()  # logits: sigmoid(0.0) == 0.5
    acc = (pred == targets).float()
    return acc.reshape(acc.shape[0], -1).mean(dim=-1)


def _binary_accuracy_probs(probs, targets):
    pred = (probs > 0.5).float()
    acc = (pred == targets).float()
    return acc.reshape(acc.shape[0], -1).mean(dim=-1)


METRICS: Dict[str, Callable] = {
    "acc": _accuracy,
    "accuracy": _accuracy,
    "categorical_accuracy": _accuracy,
    "sparse_categorical_accuracy": _accuracy,
    "binary_accuracy": _binary_accuracy,
    "binary_accuracy_probs": _binary_accuracy_probs,
    "mae": _mae,
    "mse": _mse,
}


def resolve_metric(metric) -> Callable:
    if callable(metric):
        return metric
    try:
        return METRICS[metric]
    except KeyError:
        raise ValueError(f"unknown metric {metric!r}; known: {sorted(METRICS)}") from None
