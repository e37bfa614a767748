"""``AsyncTrainer(elastic=True)`` under seeded chaos
(``elephas_tpu_torch/engine/async_engine.py::_fit_elastic``), on the CPU,
on the JAX package's blobs MLP (``tests/test_chaos.py``'s setup: 2
partitions, 3 epochs, batch 16, SGD at lr 0.05, a socket server).

- The JAX package's chaos scenarios: a killed worker (exact units,
  deaths ``["w1"]``, the final loss within 0.02 of the undisturbed fit,
  equal plan digests over two runs), a killed parameter server
  warm-restarted on the same port from its WAL after a 4 s outage
  (nothing acked lost, every outage recovered, the loss within 0.02), a
  partition window (exact units, the loss within 0.02, equal digests),
  and two traced runs whose completed units and span joins agree.
- Exact parity: one pool worker, ``batches_per_unit=2`` (a deterministic
  lease order) on the local server, against the JAX package's
  ``AsyncTrainer(elastic=True)``: each epoch's loss and accuracy within
  1e-5 relative, the final weights within 1e-5 of their norm.
- The group path: ``ps_shards=2, standby=1`` with shard 0's primary
  killed mid-fit completes with exact units, through a promotion.
- Batch ranges, late joins, the epoch fire's validation, and the
  autotune's decision on the CPU.
"""

import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_blobs

import elephas_tpu_torch as et
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.data.rdd import ShardedDataset as JaxShardedDataset
from elephas_tpu.engine.async_engine import AsyncTrainer as JaxAsyncTrainer
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parallel.mesh import build_mesh
from elephas_tpu_torch import obs
from elephas_tpu_torch.convert import from_flax_params, to_flax_params
from elephas_tpu_torch.data.rdd import ShardedDataset
from elephas_tpu_torch.engine.async_engine import AsyncTrainer, store_of, unit_permutation
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parameter.server import make_server
from elephas_tpu_torch.resilience import FaultPlan, SnapshotWAL, UnitLedger

EPOCHS = 3
PARTITIONS = 2
UNITS = EPOCHS * PARTITIONS
LOSS_TOL = 0.02  # the JAX package's chaos tolerance on the final loss


def _net():
    return et.compile_model(get_model("mlp", features=(16,), num_classes=3, device="cpu"),
                            optimizer={"name": "sgd", "learning_rate": 0.05},
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(8,), seed=0)


def _trainer(**kw):
    kw.setdefault("parameter_server_mode", "socket")
    return AsyncTrainer(_net(), ["cpu"] * PARTITIONS, frequency="epoch", port=0,
                        elastic=True, **kw)


@pytest.fixture(scope="module")
def blobs_xy():
    return make_blobs(n=256, num_classes=3, dim=8, seed=3)


def _fit(trainer, xy, **kw):
    x, y = xy
    return trainer.fit(ShardedDataset(x, y, PARTITIONS), epochs=EPOCHS, batch_size=16, **kw)


@pytest.fixture(scope="module")
def baseline_loss(blobs_xy):
    """The undisturbed elastic fit: every chaos arm's tolerance anchor."""
    trainer = _trainer()
    _, history = _fit(trainer, blobs_xy)
    assert trainer.elastic_stats["completed_units"] == UNITS
    assert trainer.elastic_stats["requeued_units"] == 0
    assert history["loss"][-1] < history["loss"][0]
    return float(history["loss"][-1])


def _kill_plan():
    """Kill w1 at its first lease, with w0 stalled at its own first unit
    so that w1 always gets that lease (the JAX package's plan)."""
    return FaultPlan(seed=11, kill_worker_at={"w1": 0}, stall_worker_at={"w0": 0},
                     stall_seconds=0.4)


def test_elastic_requires_epoch_frequency():
    with pytest.raises(ValueError, match="epoch"):
        AsyncTrainer(_net(), ["cpu"] * PARTITIONS, frequency="batch", elastic=True)


def test_kill_worker_exact_accounting_and_tolerant_loss(blobs_xy, baseline_loss):
    trainer = _trainer(fault_plan=_kill_plan())
    _, history = _fit(trainer, blobs_xy)
    stats = trainer.elastic_stats
    assert stats["completed_units"] == UNITS  # exact despite the death
    assert stats["requeued_units"] >= 1
    deaths = stats["worker_deaths"]
    assert [d["worker"] for d in deaths] == ["w1"]
    assert deaths[0]["reason"] == "injected kill"
    assert len(history["loss"]) == EPOCHS
    assert abs(history["loss"][-1] - baseline_loss) < LOSS_TOL


def test_kill_worker_replays_byte_identically(blobs_xy):
    digests = []
    for _ in range(2):
        plan = _kill_plan()
        trainer = _trainer(fault_plan=plan)
        _fit(trainer, blobs_xy)
        stats = trainer.elastic_stats
        assert stats["completed_units"] == UNITS
        assert [d["worker"] for d in stats["worker_deaths"]] == ["w1"]
        digests.append(plan.trace_digest())
    assert digests[0] == digests[1]


def test_kill_ps_warm_restart_completes_within_tolerance(blobs_xy, baseline_loss):
    """Crash the PS once a few pushes are durable, hold it down past the
    client's retry budget (~2.8 s), warm-restart it on the same port
    from the same WAL directory and a cold init: the fit rides it out,
    resumes from the durable version (its state that frame, bitwise)
    and lands within tolerance of the undisturbed loss."""
    with tempfile.TemporaryDirectory() as wal_dir:
        trainer = _trainer(ps_wal_dir=wal_dir, ps_recovery_grace=30.0)
        result = {}

        def run():
            result["out"] = _fit(trainer, blobs_xy)

        fit_thread = threading.Thread(target=run)
        fit_thread.start()
        try:
            deadline = time.monotonic() + 30.0
            while trainer._elastic_server is None:
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.005)
            server = trainer._elastic_server
            while server.buffer.version < 2:  # some updates are durable
                assert fit_thread.is_alive(), "fit died before the kill"
                time.sleep(0.005)
            server.kill()
            killed_at = server.buffer.version
            time.sleep(4.0)  # outage > retry budget: failures surface
            params, buffers = store_of(_net().module)  # a cold init
            fresh = make_server("socket", {"params": params, "batch_stats": buffers},
                                port=server.port, device="cpu", wal_dir=wal_dir)
            # The WAL superseded the cold init at construction.
            assert fresh.buffer.version >= killed_at  # nothing acked lost
            version, frame = SnapshotWAL(wal_dir).restore_latest()
            assert fresh.buffer.version == version
            got = fresh.get_parameters()
            for group in frame:
                for name, leaf in frame[group].items():
                    assert torch.equal(got[group][name], leaf), name
            fresh.start()
            trainer._elastic_server = fresh
        finally:
            fit_thread.join(timeout=120)
        assert not fit_thread.is_alive(), "fit hung after the restart"
        _, history = result["out"]
    stats = trainer.elastic_stats
    assert stats["completed_units"] == UNITS
    assert stats["ps_outages"], "no worker observed the outage"
    assert all(o["recovered"] for o in stats["ps_outages"])
    assert stats["mttr_samples"], "MTTR was not measured"
    assert len(history["loss"]) == EPOCHS
    assert abs(history["loss"][-1] - baseline_loss) < LOSS_TOL


def test_traced_chaos_units_and_joins_are_replay_stable(blobs_xy):
    """Two traced fits under the kill plan: every (epoch, partition) unit
    has an ``async/unit`` span, and the server's ``ps/apply`` spans join
    the workers' unit traces across the socket."""
    unit_sets = []
    for _ in range(2):
        tracer = obs.enable_tracing(capacity=65536)
        try:
            trainer = _trainer(fault_plan=_kill_plan())
            _fit(trainer, blobs_xy)
            assert trainer.elastic_stats["completed_units"] == UNITS
            events = tracer.events()
        finally:
            obs.disable_tracing()
        units = {(e.args["epoch"], e.args["partition"]) for e in events
                 if e.name == "async/unit"}
        pushes = {e.trace_id for e in events if e.name == "ps/push"}
        applies = {e.trace_id for e in events if e.name == "ps/apply"}
        assert len(units) == UNITS
        assert pushes & applies
        unit_sets.append(units)
    assert unit_sets[0] == unit_sets[1]


def test_partition_window_is_ridden_out(blobs_xy, baseline_loss):
    digests = []
    for _ in range(2):
        plan = FaultPlan(seed=23, partition={"*": (6, 14)})
        trainer = _trainer(fault_plan=plan)
        _, history = _fit(trainer, blobs_xy)
        assert trainer.elastic_stats["completed_units"] == UNITS
        assert abs(history["loss"][-1] - baseline_loss) < LOSS_TOL
        digests.append(plan.trace_digest())
    assert digests[0] == digests[1]


# -- exact parity with the JAX package -------------------------------------------------


def test_one_worker_elastic_fit_equals_jax():
    x, y = make_blobs(n=256, num_classes=3, dim=8, seed=3)
    adam = {"name": "adam", "learning_rate": 0.01}
    flax_model = jax_get_model("mlp", features=(16,), num_classes=3)
    params = jax.device_get(flax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))["params"])
    jm = JaxCompiledModel(flax_model, params, optimizer=adam,
                          loss="categorical_crossentropy", metrics=["acc"])
    jax_trainer = JaxAsyncTrainer(jm, build_mesh(num_data=1), frequency="epoch",
                                  elastic=True, batches_per_unit=2)
    jax_state, want = jax_trainer.fit(JaxShardedDataset(x, y, 1), epochs=EPOCHS, batch_size=32)

    module = get_model("mlp", features=(16,), num_classes=3, device="cpu")
    compiled = et.CompiledModel(module, from_flax_params(params, module), optimizer=adam,
                                loss="categorical_crossentropy", metrics=["acc"])
    trainer = AsyncTrainer(compiled, ["cpu"], frequency="epoch", elastic=True,
                           batches_per_unit=2)
    _, got = trainer.fit(ShardedDataset(x, y, 1), epochs=EPOCHS, batch_size=32)

    assert list(got) == list(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=1e-5, atol=1e-7, err_msg=key)
    assert trainer.elastic_stats["completed_units"] == \
        jax_trainer.elastic_stats["completed_units"] == EPOCHS * 4
    trained = to_flax_params(compiled.get_weights(), module)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(trained),
                                 jax.tree_util.tree_leaves_with_path(
                                     jax.device_get(jax_state.params))):
        b = np.asarray(b)
        assert np.linalg.norm(np.asarray(a) - b) <= 1e-5 * np.linalg.norm(b), \
            jax.tree_util.keystr(path)


def test_unit_permutation_is_the_jax_packages():
    assert np.array_equal(unit_permutation(1, 2, 50),
                          np.random.default_rng([1234, 1, 2]).permutation(50))


# -- the group path, batch ranges, late joins, validation ---------------------------------


def test_group_failover_mid_fit_completes_with_exact_units(blobs_xy):
    with tempfile.TemporaryDirectory() as wal_root:
        trainer = _trainer(ps_shards=2, standby=1, ps_wal_dir=wal_root,
                           ps_recovery_grace=30.0)
        result = {}

        def run():
            result["out"] = _fit(trainer, blobs_xy)

        fit_thread = threading.Thread(target=run)
        fit_thread.start()
        try:
            deadline = time.monotonic() + 30.0
            while trainer._elastic_group is None:
                assert time.monotonic() < deadline, "group never came up"
                time.sleep(0.005)
            group = trainer._elastic_group
            while group.primary(0).buffer.version < 2:
                assert fit_thread.is_alive(), "fit died before the kill"
                time.sleep(0.005)
            group.kill_primary(0)
            fit_thread.join(timeout=120)
            assert group.promotions and group.promotions[0]["shard"] == 0
        finally:
            fit_thread.join(timeout=120)
        assert not fit_thread.is_alive(), "fit hung after the failover"
        _, history = result["out"]
    assert trainer.elastic_stats["completed_units"] == UNITS
    assert len(history["loss"]) == EPOCHS and np.isfinite(history["loss"]).all()


def test_batch_range_units_and_validation(blobs_xy):
    x, y = blobs_xy
    trainer = _trainer(batches_per_unit=4, parameter_server_mode="local")
    _, history = _fit(trainer, blobs_xy, validation_data=(x[:64], y[:64]))
    ledger = UnitLedger(EPOCHS, list(range(PARTITIONS)),
                        n_batches={p: len(x) // PARTITIONS // 16 for p in range(PARTITIONS)},
                        batches_per_unit=4)
    assert trainer.elastic_stats["completed_units"] == ledger.total_units == 12
    assert len(history["loss"]) == EPOCHS
    assert len(history["val_loss"]) == len(history["val_acc"]) == EPOCHS
    assert history["loss"][-1] < history["loss"][0]


def test_late_joiner_takes_units(blobs_xy):
    trainer = _trainer(fault_plan=FaultPlan(seed=3, stall_worker_at={"w0": 0, "w1": 0},
                                            stall_seconds=0.5))
    result = {}

    def run():
        result["out"] = _fit(trainer, blobs_xy)

    fit_thread = threading.Thread(target=run)
    fit_thread.start()
    try:
        deadline = time.monotonic() + 30.0
        while trainer._elastic_pool is None:
            assert time.monotonic() < deadline, "pool never came up"
            time.sleep(0.005)
        trainer._elastic_pool.join_worker("w2")
    finally:
        fit_thread.join(timeout=120)
    assert not fit_thread.is_alive()
    stats = trainer.elastic_stats
    assert stats["late_joins"] == ["w2"] and stats["completed_units"] == UNITS


def test_elastic_autotune_on_the_cpu(blobs_xy):
    trainer = _trainer(autotune=True, parameter_server_mode="local")
    _fit(trainer, blobs_xy)
    assert trainer.autotune_choice["winner"] == "default"
    assert trainer.elastic_stats["completed_units"] == UNITS


@pytest.mark.parametrize("option", ["ps_wal_dir", "ps_shards"])
def test_fixed_pool_runs_over_a_wal_and_a_group(option, blobs_xy, tmp_path):
    """Without ``elastic`` the fixed pool takes the same server options:
    a WAL that holds every push, or a two-shard group."""
    kw = {"ps_wal_dir": str(tmp_path)} if option == "ps_wal_dir" else {"ps_shards": 2}
    trainer = AsyncTrainer(_net(), ["cpu"] * PARTITIONS, frequency="epoch",
                           parameter_server_mode="socket", port=0, **kw)
    _, history = _fit(trainer, blobs_xy)
    assert len(history["loss"]) == EPOCHS and history["loss"][-1] < history["loss"][0]
    if option == "ps_wal_dir":
        assert SnapshotWAL(str(tmp_path)).latest_version() == trainer.server.buffer.version \
            == UNITS
    else:
        assert [trainer.server.primary(i).buffer.version for i in range(2)] == [UNITS] * 2
