"""Parity of the port's loss/metric tables, FLOPs accounting and metrics
logging (``elephas_tpu_torch.engine.losses``, ``metrics.flops``,
``metrics.logging``) with the JAX package's, on the same NumPy inputs."""

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


def test_logging_records_as_the_jax_package(tmp_path):
    """``metrics.logging``: the JSONL sink writes the JAX package's record
    (step, time, floats; what JSON cannot carry as a string) from rank 0,
    the one process here; the logger is rank 0's; the throughput meter
    counts samples over its wall; ``trace`` leaves a Chrome trace."""
    import json
    import time

    from elephas_tpu.metrics.logging import JsonlSink as JaxJsonlSink
    from elephas_tpu_torch.metrics import logging as port_logging

    rows = []
    for sink_type, name in ((port_logging.JsonlSink, "port"), (JaxJsonlSink, "jax")):
        path = tmp_path / f"{name}.jsonl"
        with sink_type(str(path)) as sink:
            sink.log(3, loss=np.float32(0.5), acc=torch.tensor(0.25), tag="x",
                     blob=object())
        rows.append(json.loads(path.read_text().splitlines()[0]))
    for row in rows:
        assert row.pop("time") > 0 and row.pop("blob").startswith("<object")
    assert rows[0] == rows[1] == {"step": 3, "loss": 0.5, "acc": 0.25, "tag": "x"}

    logger = port_logging.host0_logger("elephas_tpu_torch.test")
    assert logger.propagate and not logger.handlers

    meter = port_logging.Throughput()
    with pytest.raises(RuntimeError, match="start"):
        meter.elapsed()
    meter.start(wall=torch.zeros(1))
    meter.add(64)
    meter.add(64)
    time.sleep(0.01)
    assert 0 < meter.rate(wall={"loss": torch.zeros(())}) < 128 / 0.01

    with port_logging.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
