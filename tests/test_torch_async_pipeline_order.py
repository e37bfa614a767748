"""The order of a worker's parameter-server operations with the comms
pipeline on and off, in the JAX ``AsyncTrainer``
(``elephas_tpu/engine/async_engine.py``) and in the port's
(``elephas_tpu_torch/engine/async_engine.py``).

A recording client stands in for each package's ``LocalClient`` and logs
every pull and push a worker issues. With ``pipelined_comms=True`` at
batch frequency, pull k+1 is issued before push k: each unit trains
from a base that lacks the worker's own last delta. That is the JAX
package's semantics, and the port's sequence must be the same one. With
the pipeline off, every pull follows the previous push. At epoch
frequency the pipelined pull is issued after the epoch's push.
"""

import threading

import numpy as np
import pytest

import elephas_tpu_torch as et
from elephas_tpu import compile_model as jax_compile_model
from elephas_tpu import to_simple_rdd as jax_to_simple_rdd
from elephas_tpu.engine.async_engine import AsyncTrainer as JaxAsyncTrainer
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parallel.mesh import build_mesh
from elephas_tpu.parameter import client as jax_client
from elephas_tpu_torch.engine.async_engine import AsyncTrainer
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parameter import client as port_client

DIM, CLASSES, ROWS, BATCH = 8, 3, 96, 16  # 6 batches a worker


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ROWS, DIM)).astype(np.float32)
    return x, np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, ROWS)]


def _recording(monkeypatch, module):
    """Log every ``LocalClient`` pull and push, per client object."""
    log, lock = [], threading.Lock()
    cls = module.LocalClient
    real_get, real_update = cls.get_parameters, cls.update_parameters

    def get_parameters(self, *args, **kwargs):
        with lock:
            log.append((id(self), "pull"))
        return real_get(self, *args, **kwargs)

    def update_parameters(self, *args, **kwargs):
        with lock:
            log.append((id(self), "push"))
        return real_update(self, *args, **kwargs)

    monkeypatch.setattr(cls, "get_parameters", get_parameters)
    monkeypatch.setattr(cls, "update_parameters", update_parameters)
    return log


def _worker_ops(log):
    """The one worker client's operations, in order."""
    pushers = {c for c, op in log if op == "push"}
    assert len(pushers) == 1
    (worker,) = pushers
    return [op for c, op in log if c == worker]


def _jax_ops(monkeypatch, frequency, pipelined, epochs):
    log = _recording(monkeypatch, jax_client)
    net = jax_compile_model(jax_get_model("mlp", features=(8,), num_classes=CLASSES),
                            optimizer={"name": "sgd", "learning_rate": 0.05},
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(DIM,), seed=0)
    trainer = JaxAsyncTrainer(net, build_mesh(num_data=1), frequency=frequency,
                              pipelined_comms=pipelined)
    x, y = _data()
    trainer.fit(jax_to_simple_rdd(None, x, y, 1), epochs=epochs, batch_size=BATCH)
    return _worker_ops(log)


def _port_ops(monkeypatch, frequency, pipelined, epochs):
    log = _recording(monkeypatch, port_client)
    net = et.compile_model(get_model("mlp", features=(8,), num_classes=CLASSES, device="cpu"),
                           optimizer={"name": "sgd", "learning_rate": 0.05},
                           loss="categorical_crossentropy", metrics=["acc"],
                           input_shape=(DIM,), seed=0)
    trainer = AsyncTrainer(net, ["cpu"], frequency=frequency, pipelined_comms=pipelined)
    x, y = _data()
    trainer.fit(et.data.rdd.ShardedDataset(x, y, 1), epochs=epochs, batch_size=BATCH)
    return _worker_ops(log)


@pytest.mark.parametrize("frequency,pipelined", [("batch", True), ("batch", False),
                                                 ("epoch", True), ("epoch", False)])
def test_the_port_issues_the_jax_sequence_of_pulls_and_pushes(monkeypatch, frequency,
                                                               pipelined):
    epochs = 2
    want = _jax_ops(monkeypatch, frequency, pipelined, epochs)
    monkeypatch.undo()
    got = _port_ops(monkeypatch, frequency, pipelined, epochs)
    assert got == want
    units = epochs * (ROWS // BATCH if frequency == "batch" else 1)
    assert got.count("push") == units


def test_pipelined_pull_k_plus_1_is_issued_before_push_k(monkeypatch):
    ops = _port_ops(monkeypatch, "batch", True, epochs=1)
    pushes = [i for i, op in enumerate(ops) if op == "push"]
    pulls = [i for i, op in enumerate(ops) if op == "pull"]
    # pull 0, pull 1, push 0, pull 2, push 1, ...: the base of unit k+1
    # left the server before unit k's delta reached it.
    for k in range(len(pushes) - 1):
        assert pulls[k + 1] < pushes[k]
    assert ops[:3] == ["pull", "pull", "push"]


def test_unpipelined_pulls_follow_the_previous_push(monkeypatch):
    ops = _port_ops(monkeypatch, "batch", False, epochs=1)
    assert ops == ["pull", "push"] * (ROWS // BATCH)
