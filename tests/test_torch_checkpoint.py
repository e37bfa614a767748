"""The port's checkpoints (``checkpoint/``) on the CPU: the JAX package's
checkpoint tests (``tests/test_checkpoint.py``), ported, and a
synchronous fit resumed from its epoch-1 snapshot ending bit-identical
to the uninterrupted fit (weights, optimizer state, history), under a
learning-rate schedule whose update count the snapshot carries.
"""

import os

import pytest
import torch
from conftest import make_blobs

import elephas_tpu_torch as et
from elephas_tpu_torch.checkpoint import (
    CheckpointManager,
    NoCheckpointError,
    latest_step,
    restore_train_state,
    save_train_state,
)
from elephas_tpu_torch.engine.step import init_train_state, make_train_step
from elephas_tpu_torch.models import get_model

DECAY = {"schedule": "exponential_decay", "init_value": 0.02, "transition_steps": 4,
         "decay_rate": 0.5}


def _compiled(seed=0, optimizer=None):
    return et.CompiledModel(get_model("mlp", device="cpu", features=(16,), num_classes=3),
                            optimizer=optimizer or {"name": "adam", "learning_rate": 0.01},
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(8,), seed=seed)


def _equal_states(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def test_one_shot_save_restore(tmp_path):
    compiled = _compiled()
    state = init_train_state(compiled)
    state.step += 7
    save_train_state(str(tmp_path), state)
    other = _compiled(seed=9)  # different weights
    restored = restore_train_state(str(tmp_path), init_train_state(other))
    assert restored.step == 7 and restored.module is other.module
    assert _equal_states(other.module.state_dict(), compiled.module.state_dict())


def test_restore_missing_raises_typed_error(tmp_path):
    """Cold start is a typed condition (``NoCheckpointError``, a
    ``FileNotFoundError``) whose message says what to do."""
    target = init_train_state(_compiled())
    with pytest.raises(NoCheckpointError, match="cold start"):
        restore_train_state(str(tmp_path / "missing"), target)
    with pytest.raises(FileNotFoundError):
        restore_train_state(str(tmp_path / "missing"), target)
    (tmp_path / "empty").mkdir()
    with pytest.raises(NoCheckpointError):
        restore_train_state(str(tmp_path / "empty"), target)
    mgr = CheckpointManager(str(tmp_path / "empty"), keep=2)
    with pytest.raises(NoCheckpointError):
        mgr.restore(target)
    with pytest.raises(NoCheckpointError, match="step 4"):
        mgr.restore(target, step=4)
    mgr.close()


def test_module_level_latest_step(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    (tmp_path / "not-a-step").mkdir()
    assert latest_step(str(tmp_path)) is None
    mgr = CheckpointManager(str(tmp_path), keep=3)
    state = init_train_state(_compiled())
    for step in (2, 5):
        mgr.save(state, step=step)
    mgr.close()
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path / "5")) == ["state.pt"]


def test_manager_rotation_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    compiled = _compiled()
    state = init_train_state(compiled)
    for step in (1, 2, 3):
        mgr.save(state, step=step)
    assert mgr.latest_step() == 3
    assert sorted(int(d) for d in os.listdir(tmp_path)) == [2, 3]  # the oldest dropped
    other = _compiled(seed=4)
    mgr.restore(init_train_state(other))
    assert _equal_states(other.module.state_dict(), compiled.module.state_dict())
    mgr.close()


def test_snapshot_is_taken_at_save(tmp_path):
    """Training goes on changing the tensors in place after ``save``
    returns; the snapshot holds the values of the moment it was asked for."""
    compiled = _compiled()
    state = init_train_state(compiled)
    before = {k: v.clone() for k, v in compiled.module.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    with torch.no_grad():
        for p in compiled.module.parameters():
            p.add_(1.0)
    mgr.wait()
    other = _compiled(seed=3)
    mgr.restore(init_train_state(other))
    assert _equal_states(other.module.state_dict(), before)


def test_optimizer_state_and_schedule_count_carry(tmp_path):
    """Adam's moments, the update count a schedule reads, the generator
    and the epoch count come back; the schedule itself stays the
    target's."""
    x, y = make_blobs(n=32, num_classes=3, dim=8, seed=1)
    compiled = _compiled(optimizer={"name": "adam", "learning_rate": DECAY})
    state, step = init_train_state(compiled), make_train_step(compiled)
    for _ in range(5):
        state, _ = step(state, torch.as_tensor(x), torch.as_tensor(y))
    state.epoch = 2
    torch.rand(3, generator=state.rng)
    save_train_state(str(tmp_path), state)
    other = _compiled(seed=2, optimizer={"name": "adam", "learning_rate": DECAY})
    restored = restore_train_state(str(tmp_path), init_train_state(other))
    assert (restored.step, restored.epoch) == (5, 2)
    group = restored.optimizer.param_groups[0]
    assert group["count"] == 5 and callable(group["schedule"])
    assert group["lr"] == state.optimizer.param_groups[0]["lr"]
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    mine = state.optimizer.state_dict()["state"]
    theirs = restored.optimizer.state_dict()["state"]
    assert all(torch.equal(mine[i][k], theirs[i][k]) for i in mine for k in mine[i])


def test_sync_fit_resumed_equals_uninterrupted(tmp_path):
    x, y = make_blobs(n=96, num_classes=3, dim=8, seed=2)
    opt = {"name": "adam", "learning_rate": DECAY}
    whole = et.SparkModel(_compiled(optimizer=opt), mode="synchronous", frequency="batch")
    want = whole.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16)

    mgr = CheckpointManager(str(tmp_path), keep=2, save_every_epochs=1)
    first = et.SparkModel(_compiled(optimizer=opt), mode="synchronous", frequency="batch")
    first.fit(et.to_simple_rdd(None, x, y), epochs=1, batch_size=16, callbacks=[mgr.callback()])
    assert mgr.latest_step() == 6  # 96 rows at batch 16

    resumed = _compiled(seed=5, optimizer=opt)
    model = et.SparkModel(resumed, mode="synchronous", frequency="batch")
    state = mgr.restore(init_train_state(resumed))
    got = model.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=16, initial_state=state)
    assert state.epoch == 3 and state.step == 18
    assert _equal_states(model.get_weights(), whole.get_weights())
    for key in want:
        assert got[key] == want[key][1:], key
    with pytest.raises(ValueError, match="another module"):
        model.fit(et.to_simple_rdd(None, x, y), epochs=1, batch_size=16,
                  initial_state=init_train_state(_compiled()))
    mgr.close()


def test_async_fit_checkpoints_advance_steps(tmp_path):
    """Each epoch of an asynchronous fit saves its own step, with the
    server's weights folded into the master's module."""
    x, y = make_blobs(n=128, num_classes=3, dim=8, seed=3)
    mgr = CheckpointManager(str(tmp_path), keep=5)
    model = et.SparkModel(_compiled(), mode="asynchronous", frequency="epoch", mesh=["cpu"])
    model.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16,
              callbacks=[mgr.callback()])
    assert sorted(int(d) for d in os.listdir(tmp_path)) == [1, 2, 3]
    other = _compiled(seed=8)
    mgr.restore(init_train_state(other))
    assert _equal_states(other.module.state_dict(), model.master_network.module.state_dict())
    mgr.close()


def test_failed_write_surfaces_on_wait(tmp_path):
    target = tmp_path / "file"
    target.write_text("not a directory")
    mgr = CheckpointManager(str(tmp_path))
    mgr.directory = str(target)  # writes under a file fail
    mgr.save(init_train_state(_compiled()))
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        mgr.wait()
    mgr.wait()  # reported once
