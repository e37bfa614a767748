"""The port's streamed fits (``fit(stream_batches=N)``) against the JAX
package's, on the CPU, and the JAX package's own streaming tests
(``tests/test_streaming.py``, the streamed rows of
``test_spark_model.py`` and ``test_fault_tolerance.py``) ported.

The synchronous streamed fit draws the JAX package's NumPy row orders,
so the two packages train on the same batches with no injected
permutation: at world size 1 in this process, at 4 in gloo processes
(``tests/test_torch_dist_worker.py``), with a ragged last chunk. Limits
as ``test_torch_fit.py``'s: each epoch's loss within 1e-5 (times max(1,
|loss|)) and the final weights within 1e-4 of each tensor's norm. One
asynchronous worker's streamed fit against the JAX package's at the
async parity test's limits (loss 1e-5, weights 1e-5 by norm).
"""

import importlib.util
import pathlib
import threading

import jax
import numpy as np
import pytest
import torch
from conftest import make_blobs
from test_torch_fit import ADAM, MLP, _assert_match, _jax_model, _job, _port_state, _spawn

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu.data.rdd import to_simple_rdd as jax_to_simple_rdd
from elephas_tpu_torch.convert import to_flax_params
from elephas_tpu_torch.data.rdd import ShardedDataset
from elephas_tpu_torch.engine import async_engine, sync
from elephas_tpu_torch.engine.async_engine import AsyncTrainer
from elephas_tpu_torch.engine.step import init_train_state
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parallel.mesh import build_mesh

NUM_CLASSES, DIM = 4, 20
EPOCHS = 3


def chip_smoke():
    """``chip_smoke.py`` (at the repository's root) as a module."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fresh_model(features=(32,)):
    return et.compile_model(get_model("mlp", device="cpu", features=features,
                                      num_classes=NUM_CLASSES),
                            optimizer={"name": "adam", "learning_rate": 0.01},
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(DIM,))


# -- parity with the JAX package's streamed fits ---------------------------------


def _jax_stream_fit(jm, x, y, n, frequency, batch_size, stream_batches):
    model = JaxSparkModel(jm.clone(), mode="synchronous", frequency=frequency, num_workers=n)
    history = model.fit(jax_to_simple_rdd(None, x, y, n), epochs=EPOCHS, batch_size=batch_size,
                        stream_batches=stream_batches)
    return {"history": history, "params": jax.device_get(model.master_network.params),
            "batch_stats": jax.device_get(model.master_network.batch_stats),
            "evaluate": model.evaluate(x[:-2], y[:-2], batch_size=64),
            "predict": model.predict(x[:-2], batch_size=64)}


def _port_stream_fit(state, x, y, frequency, batch_size, stream_batches):
    compiled = et.CompiledModel(get_model("mlp", device="cpu", **MLP), state, optimizer=ADAM,
                                loss="categorical_crossentropy", metrics=["acc"])
    sm = et.SparkModel(compiled, mode="synchronous", frequency=frequency)
    history = sm.fit(et.to_simple_rdd(None, x, y), epochs=EPOCHS, batch_size=batch_size,
                     stream_batches=stream_batches)
    return {"history": history, "weights": sm.get_weights(),
            "evaluate": sm.evaluate(x[:-2], y[:-2], batch_size=64),
            "predict": sm.predict(x[:-2], batch_size=64)}


@pytest.fixture(scope="module")
def stream_case():
    x, y = make_blobs(n=512)
    jm = _jax_model("mlp", {"features": (32,), "num_classes": 4}, ADAM, (20,))
    return x, y, jm, _port_state(jm, "mlp", MLP)


@pytest.fixture(scope="module")
def stream_world4(stream_case, tmp_path_factory):
    """The port at world size 4, batch 16 a shard: 8 batches a shard an
    epoch in chunks of 3, 3 and 2."""
    x, y, _, state = stream_case
    tmp = tmp_path_factory.mktemp("stream4")
    jobs = []
    for f in ("batch", "epoch"):
        job = _job(tmp, f, state, x, y, f, 16)
        job["stream_batches"] = 3
        jobs.append(job)
    return dict(zip(("batch", "epoch"), _spawn(tmp, 4, jobs)))


@pytest.mark.parametrize("frequency", ["batch", "epoch"])
def test_streamed_fit_matches_jax_world_1(stream_case, frequency):
    """32 batches an epoch in chunks of 3 (the last of 2)."""
    x, y, jm, state = stream_case
    want = _jax_stream_fit(jm, x, y, 1, frequency, 16, 3)
    port = _port_stream_fit(state, x, y, frequency, 16, 3)
    _assert_match(port, want, get_model("mlp", device="cpu", **MLP))
    for k, v in want["evaluate"].items():
        assert port["evaluate"][k] == pytest.approx(v, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("frequency", ["batch", "epoch"])
def test_streamed_fit_matches_jax_world_4(stream_case, stream_world4, frequency):
    x, y, jm, _ = stream_case
    want = _jax_stream_fit(jm, x, y, 4, frequency, 16, 3)
    _assert_match(stream_world4[frequency], want, get_model("mlp", device="cpu", **MLP))
    np.testing.assert_allclose(stream_world4[frequency]["predict"], want["predict"],
                               rtol=1e-4, atol=1e-4)


def test_streamed_fit_resumes_where_it_stopped():
    """A fit resumed from a state at epoch 2 replays the earlier epochs'
    draws, so it equals the uninterrupted fit to the bit."""
    x, y = make_blobs(n=256, seed=4)
    whole = fresh_model()
    start = whole.get_weights()
    sm = et.SparkModel(whole, mode="synchronous", frequency="batch")
    sm.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16, stream_batches=3)
    parted = fresh_model()
    parted.set_weights(start)
    first = et.SparkModel(parted, mode="synchronous", frequency="batch")
    first.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=16, stream_batches=3)
    state = first._state
    assert state.epoch == 2
    first.fit(et.to_simple_rdd(None, x, y), epochs=1, batch_size=16, stream_batches=3,
              initial_state=state)
    for name, value in sm.get_weights().items():
        assert torch.equal(value, first.get_weights()[name]), name


@pytest.mark.parametrize("frequency", ["epoch", "batch"])
def test_one_worker_streamed_async_fit_equals_jax(frequency):
    """The streamed worker draws the JAX package's NumPy orders: no
    injected permutation. 256 rows at batch 32 in chunks of 3 batches
    (3, 3 and 2)."""
    from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
    from elephas_tpu.models import get_model as jax_get_model
    from elephas_tpu_torch.convert import from_flax_params

    x, y = make_blobs(n=256)
    flax_model = jax_get_model("mlp", features=(32,), num_classes=4)
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(0), np.zeros((1, 20)))["params"])
    val = (x[:64], y[:64])
    jm = JaxCompiledModel(flax_model, params, optimizer=ADAM, loss="categorical_crossentropy",
                          metrics=["acc"])
    want_model = JaxSparkModel(jm, mode="asynchronous", frequency=frequency, num_workers=1,
                               pipelined_comms=False)
    want = want_model.fit(jax_to_simple_rdd(None, x, y, 1), epochs=3, batch_size=32,
                          validation_data=val, stream_batches=3)
    module = get_model("mlp", device="cpu", features=(32,), num_classes=4)
    compiled = et.CompiledModel(module, from_flax_params(params, module), optimizer=ADAM,
                                loss="categorical_crossentropy", metrics=["acc"])
    port_model = et.SparkModel(compiled, mode="asynchronous", frequency=frequency,
                               mesh=["cpu"], pipelined_comms=False)
    got = port_model.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=32,
                         validation_data=val, stream_batches=3)
    assert list(got) == list(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=1e-5, atol=1e-7, err_msg=key)
    trained = to_flax_params(port_model.get_weights(), module)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(trained),
                                 jax.tree_util.tree_leaves_with_path(
                                     jax.device_get(want_model.master_network.params))):
        b = np.asarray(b)
        assert np.linalg.norm(np.asarray(a) - b) <= 1e-5 * np.linalg.norm(b), \
            jax.tree_util.keystr(path)


# -- tests/test_streaming.py, ported ----------------------------------------------


@pytest.mark.parametrize("frequency", ["batch", "epoch"])
def test_streaming_converges(frequency):
    x, y = make_blobs(n=1024, num_classes=NUM_CLASSES, dim=DIM, seed=5)
    model = et.SparkModel(fresh_model(), mode="synchronous", frequency=frequency)
    # 922 training rows / 16 = 57 batches; streamed 3 at a time, the last
    # chunk ragged.
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=4, batch_size=16,
                        validation_split=0.1, stream_batches=3)
    assert history["acc"][-1] > 0.8
    assert len(history["val_acc"]) == 4
    assert model.evaluate(x, y)["acc"] > 0.8


def test_streaming_matches_resident_quality():
    x, y = make_blobs(n=512, num_classes=NUM_CLASSES, dim=DIM, seed=6)
    resident = et.SparkModel(fresh_model(), mode="synchronous", frequency="batch")
    h_res = resident.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16)
    streamed = et.SparkModel(fresh_model(), mode="synchronous", frequency="batch")
    h_str = streamed.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16,
                         stream_batches=2)
    # Different row orders, the same algorithm: the same quality.
    assert abs(h_res["acc"][-1] - h_str["acc"][-1]) < 0.1
    assert h_str["acc"][-1] > 0.85


class LaggingCard:
    """A device that runs queued work only when the host waits for it:
    ``mark`` stands in for ``ChunkStream.mark``, an event after the
    chunks whose steps are queued so far (counted at ``Chunk.arrays``),
    complete once the host has synchronized it or a later one."""

    def __init__(self):
        self.queued = self.ran = 0

    def mark(self):
        card, position = self, self.queued

        class Event:
            def query(self):
                return card.ran >= position

            def synchronize(self):
                card.ran = max(card.ran, position)

        return Event()


@pytest.mark.parametrize("mode", ["synchronous", "asynchronous"])
def test_streaming_residency_is_bounded(monkeypatch, mode):
    """Each upload is one chunk, never near the epoch, and the chunks
    the device holds (``chip_smoke.ResidencyProbe``: from upload until the
    work that used them has run) stay within three. The synchronous fit
    streams to a ``LaggingCard``, so only its own waits bound what it
    holds; the asynchronous worker waits by reading chunk metrics, which
    the CPU has computed at once."""
    x, y = make_blobs(n=2048, num_classes=NUM_CLASSES, dim=DIM, seed=7)
    sizes = []
    real_put, real_arrays = sync.ChunkStream.put, sync.Chunk.arrays

    def counting_put(self, rows):
        chunk = real_put(self, rows)
        sizes.append(chunk.nbytes)
        return chunk

    monkeypatch.setattr(sync.ChunkStream, "put", counting_put)
    if mode == "synchronous":
        card = LaggingCard()

        def queued_arrays(chunk, batch_size):
            card.queued += 1
            return real_arrays(chunk, batch_size)

        monkeypatch.setattr(sync.ChunkStream, "mark", lambda stream: card.mark())
        monkeypatch.setattr(sync.Chunk, "arrays", queued_arrays)
    model = et.SparkModel(fresh_model(), mode=mode, frequency="batch",
                          **({} if mode == "synchronous" else {"mesh": ["cpu"]}))
    with chip_smoke().ResidencyProbe(sync) as probe:
        model.fit(et.to_simple_rdd(None, x, y), epochs=1, batch_size=16, stream_batches=4)
    # 2048 rows of 20 f32 features and 4 f32 labels: 196,608 bytes; a
    # chunk is 4 batches of 16 rows, 6,144 bytes.
    chunk = 4 * 16 * (DIM + NUM_CLASSES) * 4
    assert sizes and max(sizes) == chunk
    assert max(sizes) < (x.nbytes + y.nbytes) / 3
    assert len(sizes) == 2048 // 64
    assert len(probe.peak) == 1 and 0 < max(probe.peak.values()) <= 3 * chunk


def test_streaming_rejects_fit_parity_mode():
    x, y = make_blobs(n=256, num_classes=NUM_CLASSES, dim=DIM, seed=8)
    model = et.SparkModel(fresh_model(), mode="synchronous", frequency="fit")
    with pytest.raises(ValueError, match="stream"):
        model.fit(et.to_simple_rdd(None, x, y), epochs=1, batch_size=16, stream_batches=2)


def test_streaming_async_supported_and_validates():
    """Async and hogwild accept ``stream_batches``; a chunk size below 1
    fails at construction."""
    net = et.compile_model(get_model("mlp", device="cpu", features=(8,),
                                     num_classes=NUM_CLASSES),
                           optimizer="sgd", loss="categorical_crossentropy", metrics=[],
                           input_shape=(DIM,))
    with pytest.raises(ValueError, match="stream_batches"):
        AsyncTrainer(net, ["cpu", "cpu"], stream_batches=0)
    x, y = make_blobs(n=256, num_classes=NUM_CLASSES, dim=DIM, seed=8)
    model = et.SparkModel(fresh_model(), mode="asynchronous", mesh=["cpu"] * 4)
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=16,
                        stream_batches=2)
    assert len(history["loss"]) == 2


# -- test_spark_model.py and test_fault_tolerance.py's streamed rows, ported --------


@pytest.mark.parametrize("mode,frequency",
                         [("asynchronous", "epoch"), ("hogwild", "epoch"),
                          ("asynchronous", "batch")])
def test_async_streamed_partitions_converge(mode, frequency):
    x, y = make_blobs(n=1024, num_classes=NUM_CLASSES, dim=DIM, seed=0)
    model = et.SparkModel(fresh_model(), mode=mode, frequency=frequency, mesh=["cpu"] * 2)
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=4, batch_size=16,
                        stream_batches=3, validation_split=0.1)
    assert history["acc"][-1] > 0.8
    assert len(history["val_acc"]) == 4
    assert model.evaluate(x, y)["acc"] > 0.8


def test_transient_fault_retries_under_streaming(monkeypatch):
    """A chunk's fault re-streams the whole epoch from a fresh pull in a
    re-seeded order, and the history counts the retry."""
    x, y = make_blobs(n=256, num_classes=3, dim=8, seed=3)
    net = et.compile_model(get_model("mlp", device="cpu", features=(16,), num_classes=3),
                           optimizer={"name": "sgd", "learning_rate": 0.05},
                           loss="categorical_crossentropy", metrics=["acc"], input_shape=(8,))
    fails, gate = {"left": 1}, threading.Lock()
    real_scanner = async_engine.make_epoch_scanner

    def flaky_scanner(step):
        scan = real_scanner(step)

        def flaky(state, xb, yb):
            with gate:
                inject = fails["left"] > 0
                if inject:
                    fails["left"] -= 1
            if inject:
                raise RuntimeError("injected transient chunk fault")
            return scan(state, xb, yb)

        return flaky

    monkeypatch.setattr(async_engine, "make_epoch_scanner", flaky_scanner)
    trainer = AsyncTrainer(net, ["cpu", "cpu"], frequency="epoch", max_failures=4,
                           stream_batches=3)
    state, history = trainer.fit(ShardedDataset(x, y, 2), epochs=3, batch_size=16)
    assert fails["left"] == 0
    assert history["worker_retries"] == [1, 0, 0]
    assert history["acc"][-1] > 0.6


def test_streamed_async_order_is_the_jax_packages():
    """The streamed worker's epoch order is NumPy's generator keyed as
    the JAX package keys it, and a retry's order differs."""
    seen = []
    real_put = sync.ChunkStream.put

    def recording_put(self, rows):
        seen.append(np.asarray(rows).copy())
        return real_put(self, rows)

    x, y = make_blobs(n=128, num_classes=NUM_CLASSES, dim=DIM, seed=2)
    trainer = AsyncTrainer(fresh_model(), ["cpu"], frequency="epoch", stream_batches=2)
    try:
        sync.ChunkStream.put = recording_put
        trainer.fit(ShardedDataset(x, y, 1), epochs=2, batch_size=16)
    finally:
        sync.ChunkStream.put = real_put
    for epoch in range(2):
        want = np.random.default_rng([1234, 0, 7, epoch]).permutation(128)
        np.testing.assert_array_equal(np.concatenate(seen[4 * epoch:4 * epoch + 4]), want)
    assert not np.array_equal(np.random.default_rng([1234, 0, 7, 0, 10001]).permutation(128),
                              np.random.default_rng([1234, 0, 7, 0]).permutation(128))


def test_streamed_sync_orders_follow_the_state_seed():
    """The state's seed keys the host generator: another seed, other
    orders; the same seed, the same fit."""
    x, y = make_blobs(n=256, seed=9)

    def fit(seed):
        net = fresh_model()
        state = init_train_state(net, rng=torch.Generator().manual_seed(seed))
        trainer = sync.SyncTrainer(net, build_mesh(), frequency="batch")
        trainer.fit(ShardedDataset(x, y, 1), epochs=1, batch_size=16, stream_batches=4,
                    initial_state=state)
        return net.get_weights()

    a, b, c = fit(0), fit(0), fit(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
