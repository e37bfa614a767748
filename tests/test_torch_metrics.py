"""Parity of the port's loss/metric tables and FLOPs accounting
(``elephas_tpu_torch.engine.losses``, ``elephas_tpu_torch.metrics.flops``)
with the JAX package's, on the same NumPy inputs."""

import numpy as np
import pytest
import torch

from elephas_tpu.engine import losses as jax_losses
from elephas_tpu.metrics import flops as jax_flops
from elephas_tpu_torch.engine import losses
from elephas_tpu_torch.metrics import flops


def _inputs(name, rng):
    """(predictions, targets) of the kind each loss/metric expects."""
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    if name.startswith("sparse_categorical_crossentropy") or name in (
        "acc", "accuracy", "categorical_accuracy", "sparse_categorical_accuracy",
    ):
        preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True) \
            if name.endswith("_probs") else logits
        return preds, labels.astype(np.int32)
    if name.startswith("categorical_crossentropy"):
        preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True) \
            if name.endswith("_probs") else logits
        return preds, np.eye(5, dtype=np.float32)[labels]
    if name.startswith("binary"):
        bits = rng.integers(0, 2, (6, 3)).astype(np.float32)
        raw = rng.standard_normal((6, 3)).astype(np.float32)
        return (1 / (1 + np.exp(-raw)) if name.endswith("_probs") else raw), bits
    return logits, rng.standard_normal((6, 5)).astype(np.float32)  # mse / mae


@pytest.mark.parametrize("table,name", [("LOSSES", n) for n in sorted(losses.LOSSES)]
                         + [("METRICS", n) for n in sorted(losses.METRICS)])
def test_loss_and_metric_tables_match_jax(table, name):
    assert sorted(getattr(losses, table)) == sorted(getattr(jax_losses, table))
    preds, targets = _inputs(name, np.random.default_rng(len(name)))
    want = np.asarray(getattr(jax_losses, table)[name](preds, targets))
    got = getattr(losses, table)[name](torch.from_numpy(preds), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_resolve_rejects_unknown_names():
    with pytest.raises(ValueError):
        losses.resolve_loss("hinge")
    with pytest.raises(ValueError):
        losses.resolve_metric("auc")
    assert losses.resolve_loss(losses.LOSSES["mse"]) is losses.LOSSES["mse"]


@pytest.mark.parametrize("backward", [False, True])
def test_flops_accounting_matches_jax(backward):
    args = (16_777_216, 4, 256, 2048)
    assert flops.transformer_flops_per_token(*args, backward=backward) == \
        jax_flops.transformer_flops_per_token(*args, backward=backward)
    assert flops.mfu(1e6, 3e7, 989e12) == jax_flops.mfu(1e6, 3e7, 989e12)


def test_peak_flops_keeps_the_nvidia_rows():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_flops("NVIDIA A100-SXM4-40GB") == 312e12
    assert flops.peak_flops("TPU v5 lite") is None
    assert flops.mfu(1e6, 1e9, 0) is None
