"""The port's asynchronous and hogwild training
(``elephas_tpu_torch/engine/async_engine.py`` behind
``SparkModel(mode="asynchronous" | "hogwild")``) on the CPU, with the
workers on ``mesh=["cpu"] * n``.

- Exact parity: one worker, ``lock=True``, the local server, unpipelined,
  frequency epoch and batch, the MLP and the CNN at small width, on the
  JAX package's row orders (``_jax_perm``, injected for
  ``worker_permutation``): the history, the final weights and ``val_*``
  equal the JAX package's ``AsyncTrainer`` fit within float32 limits —
  each loss and metric 1e-5 relative (2e-5 for the CNN), each final
  tensor 1e-5 of its norm (1e-4 for the CNN's float32 conv sums).
- The JAX package's convergence matrix (``tests/test_spark_model.py``):
  async over local, http and socket, hogwild over local, the batch
  frequency and the hogwild leaf granularity, with 2-4 workers.
- One val entry per epoch, and the stale-fire surfacing.
- The comms pipeline's contracts, retries, tracing spans, the elastic,
  WAL and group options' validation (the JAX package's ``ValueError``s)
  and every option still left out raising ``NotImplementedError`` naming
  its ROADMAP item.
"""

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_blobs

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.data.rdd import to_simple_rdd as jax_to_simple_rdd
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu_torch import obs
from elephas_tpu_torch.convert import from_flax_params, to_flax_params
from elephas_tpu_torch.engine import async_engine
from elephas_tpu_torch.engine.async_engine import AsyncTrainer, _CommsPipeline
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parameter.client import (
    LocalClient,
    ParameterServerUnavailable,
    StaleDeltaRejected,
    to_host,
)

NUM_CLASSES, DIM = 4, 16
ADAM = {"name": "adam", "learning_rate": 0.01}


def _port_mlp(seed=0):
    return et.compile_model(get_model("mlp", features=(32,), num_classes=NUM_CLASSES,
                                      device="cpu"),
                            optimizer=ADAM, loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(DIM,), seed=seed)


@pytest.fixture(scope="module")
def data():
    return make_blobs(n=512, num_classes=NUM_CLASSES, dim=DIM, seed=3)


# -- exact parity with the JAX package ---------------------------------------


def _jax_perm(index, epoch, n):
    """The JAX worker's row order: ``fold_in(fold_in(fold_in(PRNGKey(1234),
    index), 7), epoch)``, then ``permutation``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(1234), index), 7), epoch)
    return np.array(jax.random.permutation(key, n))  # a writable copy


CASES = {
    "mlp": ({"features": (32,), "num_classes": 4}, (20,), make_blobs(n=256), 32, 1e-5, 1e-5),
    "cnn": ({"channels": (4, 8), "dense_width": 16, "num_classes": 4}, (12, 12, 1),
            None, 16, 2e-5, 1e-4),
}


def _case(name):
    kwargs, shape, xy, batch, loss_tol, weight_tol = CASES[name]
    if xy is None:
        rng = np.random.default_rng(5)
        labels = rng.integers(0, 4, 192)
        x = (rng.random((192, *shape)) * 0.5).astype(np.float32)
        x[np.arange(192), labels * 3, labels * 3, 0] += 2.0  # a class-coded pixel
        xy = (x, np.eye(4, dtype=np.float32)[labels])
    return kwargs, shape, xy, batch, loss_tol, weight_tol


@pytest.mark.parametrize("frequency", ["epoch", "batch"])
@pytest.mark.parametrize("model", ["mlp", "cnn"])
def test_one_worker_fit_equals_jax(model, frequency, monkeypatch):
    kwargs, shape, (x, y), batch, loss_tol, weight_tol = _case(model)
    flax_model = jax_get_model(model, **kwargs)
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, *shape)))
                            ["params"])
    val = (x[:64], y[:64])
    jm = JaxCompiledModel(flax_model, params, optimizer=ADAM, loss="categorical_crossentropy",
                          metrics=["acc"])
    want_model = JaxSparkModel(jm, mode="asynchronous", frequency=frequency, num_workers=1,
                               pipelined_comms=False)
    want = want_model.fit(jax_to_simple_rdd(None, x, y, 1), epochs=3, batch_size=batch,
                          validation_data=val)

    module = get_model(model, device="cpu", **kwargs)
    compiled = et.CompiledModel(module, from_flax_params(params, module), optimizer=ADAM,
                                loss="categorical_crossentropy", metrics=["acc"])
    monkeypatch.setattr(async_engine, "worker_permutation",
                        lambda index, epoch, attempt, n: torch.as_tensor(_jax_perm(index, epoch, n)))
    port_model = et.SparkModel(compiled, mode="asynchronous", frequency=frequency,
                               mesh=["cpu"], pipelined_comms=False)
    got = port_model.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=batch,
                         validation_data=val)

    assert list(got) == list(want)  # the same keys in the same order
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=loss_tol, atol=1e-7, err_msg=key)
    trained = to_flax_params(port_model.get_weights(), module)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(trained),
                                 jax.tree_util.tree_leaves_with_path(
                                     jax.device_get(want_model.master_network.params))):
        b = np.asarray(b)
        assert np.linalg.norm(np.asarray(a) - b) <= weight_tol * np.linalg.norm(b), \
            jax.tree_util.keystr(path)
    assert port_model.async_trainer.server.buffer.version == \
        (3 if frequency == "epoch" else 3 * (len(x) // batch))
    ev = port_model.evaluate(*val)
    assert ev["loss"] == pytest.approx(got["val_loss"][-1], rel=1e-5)


# -- convergence --------------------------------------------------------------


@pytest.mark.parametrize("mode,ps_mode,frequency,workers,granularity", [
    ("asynchronous", "local", "epoch", 4, "tree"),
    ("asynchronous", "http", "epoch", 4, "tree"),
    ("asynchronous", "socket", "epoch", 4, "tree"),
    ("hogwild", "local", "epoch", 4, "tree"),
    ("asynchronous", "local", "batch", 2, "tree"),
    ("hogwild", "local", "batch", 4, "leaf"),
    ("hogwild", "socket", "batch", 2, "leaf"),
])
def test_async_modes_converge(data, mode, ps_mode, frequency, workers, granularity):
    x, y = data
    model = et.SparkModel(_port_mlp(), mode=mode, frequency=frequency,
                          parameter_server_mode=ps_mode, port=0, mesh=["cpu"] * workers,
                          hogwild_granularity=granularity)
    assert model.num_workers == workers
    history = model.fit(et.to_simple_rdd(None, x, y, workers), epochs=4, batch_size=16)
    assert model.evaluate(x, y)["acc"] > 0.8
    assert len(history["loss"]) == 4 and history["worker_retries"] == [0, 0, 0, 0]
    assert model.predict(x[:13]).shape == (13, NUM_CLASSES)
    buffer = model.async_trainer.server.buffer
    if mode == "asynchronous":
        assert buffer.applied_share() == 1.0
    assert 0.0 < buffer.applied_share() <= 1.0


def test_default_mode_is_asynchronous_and_trains(data):
    x, y = data
    model = et.SparkModel(_port_mlp())  # mode="asynchronous", frequency="epoch"
    assert (model.mode, model.frequency, model.num_workers) == ("asynchronous", "epoch", 1)
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16)
    assert history["loss"][-1] < history["loss"][0]
    assert model.evaluate(x, y)["acc"] > 0.8
    assert len(model.last_epoch_end_times) == 3


def test_workers_capped_to_the_device_list(data, caplog):
    with caplog.at_level(logging.WARNING):
        model = et.SparkModel(_port_mlp(), mode="hogwild", num_workers=6, mesh=["cpu"] * 3)
    assert model.num_workers == 3 and "capping" in caplog.text
    model = et.SparkModel(_port_mlp(), mode="hogwild", num_workers=2, mesh=["cpu"] * 3)
    assert model.num_workers == 2


def test_worker_devices_take_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncTrainer(_port_mlp(), ["cuda:0"])


# -- epoch history ------------------------------------------------------------


def test_async_val_history_one_entry_per_epoch(data):
    x, y = data
    model = et.SparkModel(_port_mlp(), mode="asynchronous", frequency="epoch",
                          mesh=["cpu"] * 2)
    history = model.fit(et.to_simple_rdd(None, x, y, 2), epochs=3, batch_size=16,
                        validation_split=0.2)
    for key in ("acc", "val_acc", "val_loss", "val_stale"):
        assert len(history[key]) == 3, key
    assert history["val_acc"][-1] > 0.7


def test_async_stale_fire_surfaced_in_history(data, caplog):
    """A slow callback wedges the fire drainer: snapshots stop being
    pinned after 3 queued fires, a one-time warning says so, and each
    affected epoch's validation is marked ``val_stale``."""
    x, y = data
    seen = []

    def slow_callback(epoch, state, metrics):
        seen.append((epoch, state.step))
        time.sleep(0.4)

    model = et.SparkModel(_port_mlp(), mode="asynchronous", frequency="epoch",
                          mesh=["cpu"] * 2)
    with caplog.at_level(logging.WARNING):
        history = model.fit(et.to_simple_rdd(None, x, y, 2), epochs=8, batch_size=16,
                            validation_split=0.2, callbacks=[slow_callback])
    assert len(history["val_stale"]) == 8 and sum(history["val_stale"]) >= 1
    assert any("fire queue saturated" in r.message for r in caplog.records)
    assert seen == [(e, e + 1) for e in range(8)]
    fast = et.SparkModel(_port_mlp(), mode="asynchronous", frequency="epoch", mesh=["cpu"] * 2)
    assert fast.fit(et.to_simple_rdd(None, x, y, 2), epochs=3, batch_size=16,
                    validation_split=0.2)["val_stale"] == [0.0, 0.0, 0.0]


# -- retries, tracing ---------------------------------------------------------


def test_unit_retry_is_counted_in_history(data, monkeypatch):
    """A transient fault in a unit retries it from a fresh pull with a
    re-seeded order; the history counts it in ``worker_retries``."""
    x, y = data
    calls, orders = [0], []
    real = async_engine.worker_permutation

    def flaky(index, epoch, attempt, n):
        orders.append((epoch, attempt))
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected transient fault")
        return real(index, epoch, attempt, n)

    monkeypatch.setattr(async_engine, "worker_permutation", flaky)
    model = et.SparkModel(_port_mlp(), mode="asynchronous", frequency="epoch", mesh=["cpu"])
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16)
    assert history["worker_retries"] == [0, 1, 0]
    assert orders == [(0, 0), (1, 0), (1, 1), (2, 0)]
    assert model.async_trainer.server.buffer.version == 3


def test_ps_death_is_not_retried(data, monkeypatch):
    x, y = data

    def dead(self):
        raise ParameterServerUnavailable("gone")

    monkeypatch.setattr(LocalClient, "get_parameters", dead)
    model = et.SparkModel(_port_mlp(), mode="asynchronous", frequency="batch", mesh=["cpu"],
                          max_failures=4)
    with pytest.raises(ParameterServerUnavailable):
        model.fit(et.to_simple_rdd(None, x, y), epochs=1, batch_size=16)


def test_async_spans_are_recorded(data):
    x, y = data
    tracer = obs.enable_tracing(annotate_device=False)
    try:
        model = et.SparkModel(_port_mlp(), mode="asynchronous", frequency="epoch",
                              parameter_server_mode="socket", port=0, mesh=["cpu"] * 2)
        model.fit(et.to_simple_rdd(None, x, y, 2), epochs=2, batch_size=16)
        names = {e.name for e in tracer.events()}
        assert {"async/unit", "async/pull", "async/train", "async/push", "ps/pull",
                "ps/push", "ps/handle_pull", "ps/handle_push", "ps/apply"} <= names
        lanes = {e.args.get("worker") for e in tracer.events() if e.name == "async/train"}
        assert lanes == {0, 1}
    finally:
        obs.disable_tracing()
    snap = obs.default_registry().snapshot()
    assert any(k.startswith("train_unit_loss") for k in snap)


# -- the comms pipeline -------------------------------------------------------


class _FakeClient:
    def __init__(self, reject_first=0, fail_first=0):
        self.pushes, self.pulls = [], 0
        self.reject_first, self.fail_first = reject_first, fail_first
        self.sync_interval = None

    def get_parameters(self):
        self.pulls += 1
        return {"v": torch.tensor(float(self.pulls))}

    def update_parameters(self, delta):
        delta = to_host(delta)  # a wire push arrives as a HostCopy
        if self.fail_first:
            self.fail_first -= 1
            raise OSError("flaky")
        if self.reject_first:
            self.reject_first -= 1
            raise StaleDeltaRejected("fake", 9, 5, 2)
        self.pushes.append(float(delta["v"]))


def test_comms_pipeline_orders_coalesces_and_ratchets():
    client = _FakeClient(reject_first=1)
    comms = _CommsPipeline(client, 0, max_push_attempts=3, sleep=lambda s: None,
                           sync_interval=2.0, to_host=True)
    try:
        for i in range(4):
            comms.push({"v": torch.tensor(float(i + 1))})
            if i == 1:
                comms.flush()  # the coalesced 1+2 is answered before 3 is pushed
        comms.flush()
        # 1+2 coalesced and rejected (interval 2 → 1), then 3 and 4 one by one
        assert client.pushes == [3.0, 4.0] and comms.rejections == 1
        assert comms.sync_interval == 1.5 and client.sync_interval == 1.5
        comms.prefetch()  # after a rejection the prefetch is discarded for a fresh pull
        assert comms.pull() == {"v": torch.tensor(2.0)} and client.pulls == 2
        comms.prefetch()
        assert comms.pull() == {"v": torch.tensor(3.0)} and client.pulls == 3
    finally:
        comms.close()


def test_comms_pipeline_retries_then_fails_fast():
    client = _FakeClient(fail_first=2)
    comms = _CommsPipeline(client, 0, max_push_attempts=3, sleep=lambda s: None)
    comms.push({"v": torch.tensor(5.0)})
    comms.flush()
    assert client.pushes == [5.0]
    comms.close()
    failing = _FakeClient(fail_first=5)
    comms = _CommsPipeline(failing, 0, max_push_attempts=2, sleep=lambda s: None)
    comms.push({"v": torch.tensor(1.0)})
    with pytest.raises(OSError):
        comms.flush()
    comms.close()
    with pytest.raises(ValueError, match="sync_interval"):
        _CommsPipeline(client, 0, 1, sync_interval=0.5)


# -- left out -----------------------------------------------------------------


@pytest.mark.parametrize("kwargs,item", [
    ({"elastic": True, "frequency": "batch"}, "frequency='epoch'"),
    ({"elastic": True, "batches_per_unit": 0}, "batches_per_unit must be >= 1"),
    ({"batches_per_unit": 2}, "set elastic=True"),
    ({"ps_shards": 2}, "requires a wire transport"),
    ({"standby": 1, "parameter_server_mode": "socket"}, "set ps_shards"),
    ({"standby": 1, "ps_shards": 2, "parameter_server_mode": "socket"}, "set ps_wal_dir"),
    ({"ps_ops_port": 0}, "item 7"),
])
def test_left_out_options_raise(kwargs, item):
    """The ops endpoint is still left out (item 7); the elastic, WAL and
    group options raise the JAX package's ``ValueError`` where it does,
    for the same arguments."""
    if item.startswith("item"):
        with pytest.raises(NotImplementedError, match=item):
            AsyncTrainer(_port_mlp(), ["cpu"], **kwargs)
        return
    with pytest.raises(ValueError, match=item):
        AsyncTrainer(_port_mlp(), ["cpu"], **kwargs)
    from elephas_tpu.engine.async_engine import AsyncTrainer as JaxAsyncTrainer
    from elephas_tpu.parallel.mesh import build_mesh

    with pytest.raises(ValueError, match=item):
        JaxAsyncTrainer(None, build_mesh(num_data=1), **kwargs)


def test_left_out_spark_model_options_raise(data, monkeypatch):
    """What is still left out raises; ``stream_batches`` and ``autotune``
    are ported and train."""
    x, y = data
    model = et.SparkModel(_port_mlp(), mode="hogwild", mesh=["cpu"])
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=1, stream_batches=2)
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])
    tuned = et.SparkModel(_port_mlp(), mode="asynchronous", autotune=True, mesh=["cpu"])
    assert tuned.fit(et.to_simple_rdd(None, x, y), epochs=1)["compile_autotune"] == "default"
    with pytest.raises(NotImplementedError, match="item 7"):
        AsyncTrainer(_port_mlp(), ["cpu"]).mount_ops()
    monkeypatch.setenv("ELEPHAS_PS_SHARDS", "2")
    with pytest.raises(ValueError, match="wire transport"):  # a group over the local mode
        AsyncTrainer(_port_mlp(), ["cpu"])
    assert AsyncTrainer(_port_mlp(), ["cpu"], parameter_server_mode="socket").ps_shards == 2
    with pytest.raises(ValueError, match="batch|epoch"):
        AsyncTrainer(_port_mlp(), ["cpu"], frequency="fit")
