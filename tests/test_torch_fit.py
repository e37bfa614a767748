"""Parity of the port's ``SparkModel.fit(mode="synchronous")`` with the JAX
package's, on the CPU, at world sizes 1 and 4 and frequencies batch,
epoch and fit.

The JAX side is ``elephas_tpu.SparkModel(num_workers=N)`` on the virtual
CPU mesh; the port runs N processes of a gloo group
(``tests/test_torch_dist_worker.py``, spawned here with a ``file://`` store
under ``tmp_path``), or the test's own process at N = 1. Both start from
the same weights (the flax init, converted); evaluation and prediction
run on all rows but the last two. With one batch per shard
per epoch the per-shard shuffle only permutes rows within a batch, which
cannot change its mean; the cases with several batches per shard replace
the port's permutation with the JAX package's own (``_jax_perms``).
Limits: each epoch's loss within 1e-5 (times max(1, |loss|)) and the
final weights within 1e-4 of each tensor's norm.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

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
from elephas_tpu.engine.sync import stack_epoch as jax_stack_epoch
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu_torch.convert import from_flax_params, to_flax_batch_stats, to_flax_params
from elephas_tpu_torch.engine import sync
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parallel.mesh import Mesh, build_mesh

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "test_torch_dist_worker.py"
EPOCHS = 3
ADAM = {"name": "adam", "learning_rate": 0.01}
MLP = {"features": [32], "num_classes": 4}
FREQUENCIES = ("batch", "epoch", "fit")


def _jax_model(name, kwargs, optimizer, input_shape):
    module = jax_get_model(name, **kwargs)
    variables = jax.jit(module.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, *input_shape)), train=False)
    return JaxCompiledModel(module, variables["params"], optimizer=optimizer,
                            loss="categorical_crossentropy", metrics=["acc"],
                            batch_stats=variables.get("batch_stats", {}))


def _port_state(jm, name, kwargs):
    module = get_model(name, device="cpu", **kwargs)
    return from_flax_params(jax.device_get(jm.params), module,
                            jax.device_get(jm.batch_stats))


def _jax_fit(jm, x, y, n, frequency, batch_size, epochs=EPOCHS, eval_batch=64):
    model = JaxSparkModel(jm.clone(), mode="synchronous", frequency=frequency, num_workers=n)
    history = model.fit(jax_to_simple_rdd(None, x, y, n), epochs=epochs, batch_size=batch_size)
    return {"history": history, "params": jax.device_get(model.master_network.params),
            "batch_stats": jax.device_get(model.master_network.batch_stats),
            "evaluate": model.evaluate(x[:-2], y[:-2], batch_size=eval_batch),
            "predict": model.predict(x[:-2], batch_size=eval_batch)}


def _jax_perms(n_shards, rows, epochs):
    """The JAX package's per-shard row orders (``engine/sync.py``): epoch
    e's key is ``fold_in(fold_in(base, e), shard)``, split in two, the
    first half drawing ``permutation(rows)``; the base key starts at
    ``PRNGKey(0)`` and becomes ``fold_in(base, e + 1)`` after epoch e."""
    base, out = jax.random.PRNGKey(0), []
    for epoch in range(epochs):
        keys = [jax.random.split(jax.random.fold_in(jax.random.fold_in(base, epoch), d))[0]
                for d in range(n_shards)]
        out.append([np.asarray(jax.random.permutation(k, rows)) for k in keys])
        base = jax.random.fold_in(base, epoch + 1)
    return np.asarray(out)


def _port_fit(state, x, y, frequency, batch_size, model="mlp", kwargs=MLP, optimizer=ADAM,
              epochs=EPOCHS, eval_batch=64):
    compiled = et.CompiledModel(get_model(model, device="cpu", **kwargs), state,
                               optimizer=optimizer, loss="categorical_crossentropy",
                               metrics=["acc"])
    sm = et.SparkModel(compiled, mode="synchronous", frequency=frequency)
    history = sm.fit(et.to_simple_rdd(None, x, y), epochs=epochs, batch_size=batch_size)
    return {"history": history, "weights": sm.get_weights(),
            "evaluate": sm.evaluate(x[:-2], y[:-2], batch_size=eval_batch),
            "predict": sm.predict(x[:-2], batch_size=eval_batch)}


def _spawn(tmp_path, world, jobs, timeout=240):
    """Run ``jobs`` in ``world`` gloo processes; rank 0's results."""
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"store": str(tmp_path / "store"), "world": world,
                                  "jobs": jobs}))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(config), str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=ROOT)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    assert codes == [0] * world, [(tmp_path / f"rank{r}.log").read_text()[-3000:]
                                  for r in range(world)]
    return [torch.load(job["out"], weights_only=False) for job in jobs]


def _job(tmp_path, tag, state, x, y, frequency, batch_size, model="mlp", kwargs=MLP,
         optimizer=ADAM, perms=None, epochs=EPOCHS, eval_batch=64):
    np.savez(tmp_path / f"{tag}.npz", x=x, y=y)
    torch.save(state, tmp_path / f"{tag}.pt")
    job = {"data": str(tmp_path / f"{tag}.npz"), "weights": str(tmp_path / f"{tag}.pt"),
           "model": model, "kwargs": kwargs, "optimizer": optimizer, "loss":
           "categorical_crossentropy", "frequency": frequency, "epochs": epochs,
           "batch_size": batch_size, "eval_batch": eval_batch,
           "out": str(tmp_path / f"{tag}.out.pt")}
    if perms is not None:
        np.save(tmp_path / f"{tag}.perms.npy", perms)
        job["perms"] = str(tmp_path / f"{tag}.perms.npy")
    return job


def _assert_match(port, want, module):
    """Each epoch's loss within 1e-5, every history key present, and the
    final weights within 1e-4 of each tensor's norm."""
    assert port["history"].keys() == want["history"].keys()
    assert len(port["history"]["loss"]) == len(want["history"]["loss"])
    for got, ref in zip(port["history"]["loss"], want["history"]["loss"]):
        assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref)), (port["history"], want["history"])
    trees = {"params": to_flax_params(port["weights"], module)}
    refs = {"params": want["params"]}
    if want["batch_stats"]:
        trees["batch_stats"] = to_flax_batch_stats(port["weights"], module)
        refs["batch_stats"] = want["batch_stats"]
    for kind, tree in trees.items():
        ref_leaves = jax.tree_util.tree_leaves_with_path(refs[kind])
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(got_leaves) == len(ref_leaves)
        for path, ref in ref_leaves:
            got, ref = np.asarray(got_leaves[path]), np.asarray(ref)
            err = np.linalg.norm(got - ref)
            assert err <= 1e-4 * np.linalg.norm(ref), (kind, jax.tree_util.keystr(path), err)


@pytest.fixture(scope="module")
def blobs_case():
    x, y = make_blobs(n=512)
    jm = _jax_model("mlp", {"features": (32,), "num_classes": 4}, ADAM, (20,))
    return x, y, jm, _port_state(jm, "mlp", MLP)


@pytest.fixture(scope="module")
def world4(blobs_case, tmp_path_factory):
    """The port at world size 4: one batch of 128 per shard per epoch at
    each frequency, and 4 batches of 32 per shard (frequency epoch) on the
    JAX package's row orders."""
    x, y, jm, state = blobs_case
    tmp = tmp_path_factory.mktemp("world4")
    jobs = [_job(tmp, f, state, x, y, f, 128) for f in FREQUENCIES]
    jobs.append(_job(tmp, "shuffled", state, x, y, "epoch", 32,
                     perms=_jax_perms(4, 128, EPOCHS)))
    return dict(zip([*FREQUENCIES, "shuffled"], _spawn(tmp, 4, jobs)))


@pytest.mark.parametrize("frequency", FREQUENCIES)
def test_fit_matches_jax_world_1(blobs_case, frequency):
    x, y, jm, state = blobs_case
    want = _jax_fit(jm, x, y, 1, frequency, 512)
    port = _port_fit(state, x, y, frequency, 512)
    _assert_match(port, want, get_model("mlp", device="cpu", **MLP))


@pytest.mark.parametrize("frequency", FREQUENCIES)
def test_fit_matches_jax_world_4(blobs_case, world4, frequency):
    x, y, jm, _ = blobs_case
    want = _jax_fit(jm, x, y, 4, frequency, 128)
    _assert_match(world4[frequency], want, get_model("mlp", device="cpu", **MLP))


@pytest.mark.parametrize("world", [1, 4])
def test_shuffled_batches_match_jax(blobs_case, world4, monkeypatch, world):
    """Several batches per shard: the port's per-shard orders replaced by
    the JAX package's keys give the same epochs and weights."""
    x, y, jm, state = blobs_case
    want = _jax_fit(jm, x, y, world, "epoch", 32 if world == 4 else 64)
    if world == 4:
        port = world4["shuffled"]
    else:
        perms = _jax_perms(1, 512, EPOCHS)
        monkeypatch.setattr(sync, "shard_permutation",
                            lambda seed, epoch, shard, n: torch.as_tensor(perms[epoch, shard]))
        port = _port_fit(state, x, y, "epoch", 64)
    _assert_match(port, want, get_model("mlp", device="cpu", **MLP))


@pytest.mark.parametrize("world", [1, 4])
def test_evaluate_and_predict_match_jax(blobs_case, world4, world):
    """Evaluation is the exact weighted mean over all rows and every rank
    gets every row's prediction, on 510 rows: at world size 4 each rank
    takes 127 in chunks of 64 and rank 0 the 2 left over."""
    x, y, jm, state = blobs_case
    want = _jax_fit(jm, x, y, world, "batch", 512 // world)
    port = world4["batch"] if world == 4 else _port_fit(state, x, y, "batch", 512)
    for k, v in want["evaluate"].items():
        assert port["evaluate"][k] == pytest.approx(v, rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(port["predict"], want["predict"], rtol=1e-4, atol=1e-4)


def test_stack_epoch_and_shard_block_lay_out_as_jax():
    x = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    y = np.arange(40)
    xs, ys, nb = sync.stack_epoch(x, y, 4, 3)
    jxs, jys, jnb = jax_stack_epoch(x, y, 4, 3)
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(ys, jys)
    assert nb == jnb == 3
    for shard in range(4):
        bx, by, bnb = sync.shard_block(x, y, 4, 3, shard)
        assert bnb == nb
        np.testing.assert_array_equal(bx, xs[:, shard * 3:(shard + 1) * 3])
        np.testing.assert_array_equal(by, ys[:, shard * 3:(shard + 1) * 3])
    with pytest.raises(ValueError, match="too small"):
        sync.shard_block(x, y, 4, 11, 0)


def test_shard_permutation_is_seeded_per_epoch_and_shard():
    a = sync.shard_permutation(0, 1, 2, 50)
    assert torch.equal(a, sync.shard_permutation(0, 1, 2, 50))
    assert sorted(a.tolist()) == list(range(50))
    others = [sync.shard_permutation(*k, 50) for k in ((1, 1, 2), (0, 2, 2), (0, 1, 3))]
    assert all(not torch.equal(a, b) for b in others)


def test_mesh_without_a_group_is_one_process():
    mesh = build_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    t = torch.ones(3)
    mesh.all_reduce_([t])
    assert torch.equal(t, torch.ones(3))
    with pytest.raises(ValueError, match="world of 4"):
        build_mesh(num_data=4)
    assert Mesh().size == 1
    assert build_mesh(num_data=1) == Mesh()


def _mlp_compiled():
    return et.compile_model(get_model("mlp", device="cpu", **MLP), input_shape=(20,),
                            optimizer=ADAM, loss="categorical_crossentropy", metrics=["acc"])


def test_constructor_validates_like_jax(caplog, tmp_path):
    net = _mlp_compiled()
    for kwargs in ({"mode": "bogus"}, {"frequency": "step"},
                   {"hogwild_granularity": "row"}, {"max_failures": 0}):
        with pytest.raises(ValueError):
            et.SparkModel(net, **{"mode": "synchronous", **kwargs})
    tuned = et.SparkModel(net, mode="synchronous", autotune=True)  # ported: constructs
    assert tuned.autotune and tuned.last_autotune is None
    for mode in ("asynchronous", "hogwild"):  # ported: they construct
        assert et.SparkModel(net, mode=mode).mode == mode
    # A model_to_dict payload constructs (serialization, ported).
    from_payload = et.SparkModel(et.model_to_dict(net), mode="synchronous", device="cpu")
    assert from_payload.master_network.count_params() == net.count_params()
    with pytest.raises(TypeError, match="CompiledModel"):
        et.SparkModel(object(), mode="synchronous")
    with caplog.at_level(logging.WARNING):
        model = et.SparkModel(net, mode="synchronous", num_workers=4)
    assert model.num_workers == 1 and "capping" in caplog.text
    # Ported: a streamed fit trains, and a chunk size below 1 is refused.
    x, y = make_blobs(n=64)
    history = model.fit((x, y), epochs=2, batch_size=8, stream_batches=3)
    assert len(history["loss"]) == 2 and history["loss"][-1] < history["loss"][0]
    with pytest.raises(ValueError, match="stream_batches"):
        model.fit((x, y), stream_batches=0)
    model.save(tmp_path / "model.pkl")  # ported: save and load round-trip
    loaded = et.load_spark_model(tmp_path / "model.pkl", device="cpu")
    assert (loaded.mode, loaded.num_workers) == ("synchronous", 1)


def test_fit_validation_split_and_callbacks():
    """``validation_split`` holds out the last rows (``val_*`` keys each
    epoch), callbacks see (epoch, state, metrics) after each epoch and
    ``on_fit_end`` after the fit; evaluate/predict use the trained
    weights."""
    x, y = make_blobs(n=256)
    seen = []

    class Recorder:
        def __call__(self, epoch, state, metrics):
            seen.append((epoch, state.step, sorted(metrics)))

        def on_fit_end(self):
            seen.append("end")

    model = et.SparkModel(_mlp_compiled(), mode="synchronous", frequency="batch")
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=16,
                        validation_split=0.25, callbacks=[Recorder()])
    keys = ["acc", "loss", "val_acc", "val_loss"]
    assert sorted(history) == keys and len(history["val_loss"]) == 2
    assert seen == [(0, 12, keys), (1, 24, keys), "end"]
    held_out = model.evaluate(x[-64:], y[-64:])
    assert held_out["loss"] == pytest.approx(history["val_loss"][-1], rel=1e-6)
    assert model.predict(x).shape == (256, 4)
    assert model.training_histories == [history]
