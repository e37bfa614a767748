"""The port's hyperparameter search (``elephas_tpu_torch/hyperparam.py``,
``tune/search.py``) and masked MLP (``mlp_masked``) held against the JAX
package's on the CPU, at a small size.

Sample streams and trial lists must be exactly equal (the combinators
and samplers are NumPy, copied); the masked MLP's logits, gradients and
three Adam steps match within 1e-5 by norm from the same flax init; a
real-objective search (``mlp_masked`` through ``SyncTrainer``, the JAX
trainer's row orders injected) matches per trial within 1e-4. Two gloo
ranks of two workers each run the trials one process of four runs, and
every rank returns the same winner.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu import hyperparam as jax_hp
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.data.rdd import ShardedDataset as JaxShardedDataset
from elephas_tpu.engine import step as jax_step
from elephas_tpu.engine.sync import SyncTrainer as JaxSyncTrainer
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elephas_tpu_torch import hyperparam as port_hp
from elephas_tpu_torch.api import CompiledModel, compile_model
from elephas_tpu_torch.convert import (from_flax_params, to_flax_batch_stats,
                                       to_flax_params)
from elephas_tpu_torch.data.rdd import ShardedDataset
from elephas_tpu_torch.engine import step as port_step
from elephas_tpu_torch.engine import sync
from elephas_tpu_torch.engine.sync import SyncTrainer
from elephas_tpu_torch.models import MaskedMLP, get_model
from elephas_tpu_torch.parallel.mesh import build_mesh
from elephas_tpu_torch.serialize import dict_to_model, model_to_dict

from conftest import make_blobs

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "test_torch_dist_worker.py"


def _spaces(pkg):
    hp = pkg.hp
    return {
        "config5": {"lr": hp.loguniform(np.log(1e-4), np.log(1e-2)),
                    "width": hp.choice([64, 128, 256])},
        "nested": {"lr": hp.loguniform(np.log(1e-4), np.log(1e-1)),
                   "width": hp.choice([16, 32]), "layers": [hp.randint(3), "fixed"],
                   "drop": hp.quniform(0.0, 0.5, 0.1), "x": hp.uniform(-1.0, 2.0),
                   "opt": hp.choice(["adam", "sgd"])},
    }


def _loss(sample):
    """A deterministic loss of a sample (both packages' samples are plain
    Python values)."""
    return float((np.log(sample["lr"]) - np.log(3e-3)) ** 2
                 + 1e-3 * sample["width"] + 0.1 * sample.get("x", 0.0) ** 2)


# -- streams ------------------------------------------------------------------------


@pytest.mark.parametrize("space", ["config5", "nested"])
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_space_draws_identical_streams(space, seed):
    port_space, jax_space = _spaces(port_hp)[space], _spaces(jax_hp)[space]
    port_rng, jax_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    port = [port_hp.sample_space(port_space, port_rng) for _ in range(20)]
    ref = [jax_hp.sample_space(jax_space, jax_rng) for _ in range(20)]
    assert port == ref


@pytest.mark.parametrize("algo", ["random", "tpe"])
@pytest.mark.parametrize("space", ["config5", "nested"])
@pytest.mark.parametrize("seed", [0, 5])
def test_samplers_draw_identical_streams_given_the_losses(algo, space, seed):
    """Each sampler, fed the same losses, suggests the same values: TPE's
    adaptive draws depend on them, so the losses come from the samples."""
    out = []
    for pkg in (port_hp, jax_hp):
        sampler = pkg._SAMPLERS[algo](_spaces(pkg)[space], np.random.default_rng([seed, 1]))
        rows = []
        for _ in range(24):
            values, sample = sampler.suggest()
            rows.append((values, sample))
            sampler.observe(values, _loss(sample))
        out.append(rows)
    assert out[0] == out[1]


@pytest.mark.parametrize("width, buckets, want", [
    (64, (128, 256), 128), (128, (128, 256), 128), (129, (128, 256), 256),
    (256, (256, 128), 256), (1, (8,), 8), (512, (128, 256), None)])
def test_width_bucket_matches_jax(width, buckets, want):
    if want is None:
        for fn in (port_hp.width_bucket, jax_hp.width_bucket):
            with pytest.raises(ValueError, match="largest bucket"):
                fn(width, buckets)
    else:
        assert port_hp.width_bucket(width, buckets) == jax_hp.width_bucket(width, buckets) \
            == want


# -- minimize with a NumPy objective -------------------------------------------------


def _numpy_objective(sample, data):
    return {"loss": _loss(sample), "model": None}


def _rows(search):
    return sorted((t["worker"], t["trial"], t["sample"], t["loss"]) for t in search.trials)


@pytest.mark.parametrize("max_evals", [1, 3, 7, 16])
@pytest.mark.parametrize("algo", ["random", "tpe"])
def test_minimize_trials_equal_jax_at_four_workers(max_evals, algo):
    port = port_hp.HyperParamModel(None, num_workers=4, device="cpu")
    ref = jax_hp.HyperParamModel(None, num_workers=4)
    kw = dict(max_evals=max_evals, space=_spaces(port_hp)["nested"], seed=2, algo=algo)
    best = port.minimize(_numpy_objective, lambda: None, **kw)
    jax_best = ref.minimize(_numpy_objective, lambda: None,
                            **{**kw, "space": _spaces(jax_hp)["nested"]})
    assert len(port.trials) == max_evals  # the exact budget, the remainder spread
    assert _rows(port) == _rows(ref)
    assert {k: best[k] for k in ("loss", "sample", "worker", "trial")} == \
        {k: jax_best[k] for k in ("loss", "sample", "worker", "trial")}
    assert len(port.best_models) == min(4, max_evals)
    for t in port.trials:
        assert t["status"] == "ok" and t["t_end"] >= t["t_start"]
        assert t["secs"] == t["t_end"] - t["t_start"]


def test_errors_propagate_and_order_of_calls():
    search = port_hp.HyperParamModel(None, num_workers=2, device="cpu")
    with pytest.raises(TypeError, match="'loss'"):
        search.minimize(lambda s, d: 42, lambda: None, max_evals=2,
                        space={"x": port_hp.hp.uniform(0, 1)})

    def boom(sample, data):
        raise RuntimeError("objective failed")

    with pytest.raises(RuntimeError, match="objective failed"):
        search.minimize(boom, lambda: None, max_evals=3, space={"x": port_hp.hp.uniform(0, 1)})
    with pytest.raises(RuntimeError, match="minimize"):
        port_hp.HyperParamModel(None, num_workers=1, device="cpu").best_model()
    with pytest.raises(ValueError, match="algo"):
        search.minimize(lambda s, d: {"loss": 0.0}, lambda: None, max_evals=1,
                        space={"x": port_hp.hp.uniform(0, 1)}, algo="grid")


def test_search_takes_the_card_unless_told(monkeypatch):
    """No device: one worker per card, and no card raises; ``device="cpu"``
    gives ``num_workers`` CPU threads; a worker publishes its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_hp.HyperParamModel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_hp.current_trial_device()
    search = port_hp.HyperParamModel(None, num_workers=3, device="cpu")
    assert search.num_workers == 3 and search.devices == [torch.device("cpu")] * 3
    seen = []
    search.minimize(lambda s, d: seen.append(port_hp.current_trial_device()) or {"loss": 0.0},
                    lambda: None, max_evals=3, space={"x": port_hp.hp.uniform(0, 1)})
    assert seen == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = port_hp.HyperParamModel(None, num_workers=8)
    assert two.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert port_hp.HyperParamModel(None, num_workers=4, device="cuda:1").devices == \
        [torch.device("cuda", 1)]  # one card is never oversubscribed


def test_package_exports():
    import elephas_tpu_torch as et

    assert et.HyperParamModel is port_hp.HyperParamModel and et.hp is port_hp.hp
    assert et.current_trial_device is port_hp.current_trial_device


# -- the masked MLP against the JAX package --------------------------------------------

IN, BUCKET, ACTIVE, CLASSES = 6, 32, 8, 3


def _jax_masked(active=ACTIVE, seed=0, lr=0.05, injected=True):
    return JaxCompiledModel(
        jax_get_model("mlp_masked", features=(BUCKET,), active=(active,), num_classes=CLASSES),
        optimizer={"name": "adam", "learning_rate": lr, "injected": injected},
        loss="categorical_crossentropy", metrics=["acc"], input_shape=(IN,), seed=seed)


def _port_from(jm, injected=True, lr=0.05):
    module = get_model("mlp_masked", features=(BUCKET,), active=(ACTIVE,),
                       num_classes=CLASSES, device="cpu")
    state = from_flax_params(jax.device_get(jm.params), module, jax.device_get(jm.batch_stats))
    return CompiledModel(module, state,
                         optimizer={"name": "adam", "learning_rate": lr, "injected": injected},
                         loss="categorical_crossentropy", metrics=["acc"])


def _data(seed=0, rows=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, IN)).astype(np.float32)
    return x, np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, size=rows)]


def _assert_by_norm(got, want, rtol):
    assert got.keys() == want.keys()
    for name in want:
        ref = np.asarray(want[name], np.float64)
        err = np.linalg.norm(np.asarray(got[name], np.float64) - ref)
        assert err <= rtol * max(np.linalg.norm(ref), 1e-30), (name, err)


def test_masked_mlp_from_jax_params_logits_and_gradients():
    jm = _jax_masked()
    pm = _port_from(jm)
    x, y = _data()
    want = np.asarray(jm.apply_eval(jm.params, jm.batch_stats, jnp.asarray(x)))
    got = pm.apply_eval(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    module = jax_get_model("mlp_masked", features=(BUCKET,), active=(ACTIVE,),
                           num_classes=CLASSES)

    def loss(params):
        logits = module.apply({"params": params, "batch_stats": jm.batch_stats}, x)
        return -(jax.nn.log_softmax(logits) * y).sum(-1).mean()

    grads = jax.device_get(jax.grad(loss)(jm.params))
    loss_t, _ = port_step.make_loss_fn(pm)(torch.as_tensor(x), torch.as_tensor(y))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss(jm.params)), rtol=1e-6)
    got = {n: p.grad.numpy() for n, p in pm.module.named_parameters()}
    ref = {k: v.numpy() for k, v in from_flax_params(grads, pm.module, jm.batch_stats).items()
           if k in got}
    _assert_by_norm(got, ref, 1e-5)
    # The padded units take exactly zero gradient.
    assert not got["hidden.0.weight"][ACTIVE:].any() and not got["out.weight"][:, ACTIVE:].any()


@pytest.mark.parametrize("injected", [True, False])
def test_masked_mlp_three_adam_steps_match_jax_injected(injected):
    """The JAX side runs injected Adam (lr in the optimizer state); the port
    holds the lr in its param groups either way, so both configs match."""
    jm = _jax_masked(injected=True)
    pm = _port_from(jm, injected=injected)
    step, state = jax.jit(jax_step.make_train_step(jm)), jax_step.init_train_state(jm)
    pstep, pstate = port_step.make_train_step(pm), port_step.init_train_state(pm)
    before = {k: v.clone() for k, v in pm.module.state_dict().items()}
    for seed in range(3):
        x, y = _data(seed + 1)
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
        pstate, pmetrics = pstep(pstate, torch.as_tensor(x), torch.as_tensor(y))
        np.testing.assert_allclose(float(pmetrics["loss"]), float(metrics["loss"]), rtol=1e-5)
    want = from_flax_params(jax.device_get(state.params), pm.module,
                            jax.device_get(state.batch_stats))
    got = pm.module.state_dict()
    _assert_by_norm({k: v.numpy() for k, v in got.items()},
                    {k: v.numpy() for k, v in want.items()}, 1e-5)
    for name, pad in (("hidden.0.weight", (slice(ACTIVE, None),)),
                      ("hidden.0.bias", (slice(ACTIVE, None),)),
                      ("out.weight", (slice(None), slice(ACTIVE, None)))):
        assert torch.equal(got[name][pad], before[name][pad]), name  # padded: bitwise still
    assert torch.equal(got["mask_0"], before["mask_0"])


def test_masked_mlp_equals_plain_mlp_at_active_width():
    masked = compile_model(get_model("mlp_masked", features=(BUCKET,), active=(ACTIVE,),
                                     num_classes=CLASSES, device="cpu"),
                           optimizer="adam", loss="categorical_crossentropy", metrics=[],
                           input_shape=(IN,), seed=4)
    w = masked.get_weights()
    plain = compile_model(get_model("mlp", features=(ACTIVE,), num_classes=CLASSES,
                                    device="cpu"),
                          params={"hidden.0.weight": w["hidden.0.weight"][:ACTIVE],
                                  "hidden.0.bias": w["hidden.0.bias"][:ACTIVE],
                                  "out.weight": w["out.weight"][:, :ACTIVE],
                                  "out.bias": w["out.bias"]},
                          optimizer="adam", loss="categorical_crossentropy", metrics=[])
    x, y = _data(9)
    torch.testing.assert_close(masked.apply_eval(torch.as_tensor(x)),
                               plain.apply_eval(torch.as_tensor(x)), rtol=1e-6, atol=1e-6)
    # Garbage in the padded parameters changes nothing.
    with torch.no_grad():
        masked.module.hidden[0].weight[ACTIVE:] = 7.7
        masked.module.out.weight[:, ACTIVE:] = -3.0
    torch.testing.assert_close(masked.apply_eval(torch.as_tensor(x)),
                               plain.apply_eval(torch.as_tensor(x)), rtol=1e-6, atol=1e-6)


def test_masked_mlp_init_variance_matches_active_width():
    """The output layer of a (bucket 256, active 64) model draws at the
    ACTIVE fan-in (std 1/8), as the JAX package's does, through the seeded
    init and the module's own."""
    seeded = compile_model(get_model("mlp_masked", features=(256,), active=(64,),
                                     num_classes=8, device="cpu"),
                           optimizer="sgd", loss="categorical_crossentropy", metrics=[],
                           input_shape=(20,), seed=0)
    jm = JaxCompiledModel(jax_get_model("mlp_masked", features=(256,), active=(64,),
                                        num_classes=8),
                          optimizer="sgd", loss="categorical_crossentropy", metrics=[],
                          input_shape=(20,), seed=0)
    want = (1.0 / 64) ** 0.5
    jax_std = np.asarray(jm.params["Dense_1"]["kernel"])[:64].std()
    built = get_model("mlp_masked", features=(256,), active=(64,), num_classes=8,
                      device="cpu")
    for std in (seeded.module.out.weight[:, :64].std().item(),
                built.out.weight[:, :64].std().item(), jax_std):
        assert abs(std - want) / want < 0.15
        assert std > 1.5 * (1.0 / 256) ** 0.5  # not the bucket's fan-in
    assert seeded.module.out.live_fan_in == 64
    assert not built.out.bias.any()


@pytest.mark.parametrize("mode, frequency", [("asynchronous", "epoch"),
                                             ("asynchronous", "batch"), ("hogwild", "batch")])
def test_async_deltas_leave_the_mask_and_padded_units_exact(mode, frequency):
    """The asynchronous trainers difference every buffer too: the mask's
    delta and the padded units' are exactly 0, so N workers' summed deltas
    leave them to the bit while the live units train."""
    import elephas_tpu_torch as et

    net = compile_model(get_model("mlp_masked", features=(BUCKET,), active=(ACTIVE,),
                                  num_classes=4, device="cpu"),
                        optimizer={"name": "adam", "learning_rate": 0.01, "injected": True},
                        loss="categorical_crossentropy", metrics=["acc"], input_shape=(8,))
    before = net.get_weights()
    x, y = make_blobs(n=256, num_classes=4, dim=8, seed=2)
    et.SparkModel(net, mode=mode, frequency=frequency, mesh=["cpu"] * 2).fit(
        et.to_simple_rdd(None, x, y), epochs=2, batch_size=32)
    after = net.get_weights()
    assert torch.equal(after["mask_0"], before["mask_0"])
    assert torch.equal(after["hidden.0.weight"][ACTIVE:], before["hidden.0.weight"][ACTIVE:])
    assert torch.equal(after["out.weight"][:, ACTIVE:], before["out.weight"][:, ACTIVE:])
    assert not torch.equal(after["out.weight"][:, :ACTIVE], before["out.weight"][:, :ACTIVE])


def test_masked_mlp_validates_its_layout():
    with pytest.raises(ValueError, match="layer-for-layer"):
        get_model("mlp_masked", features=(32, 32), active=(8,), device="cpu")
    for bad in (0, 33):
        with pytest.raises(ValueError, match=r"outside \(0, 32\]"):
            get_model("mlp_masked", features=(32,), active=(bad,), device="cpu")
    full = get_model("mlp_masked", features=(16, 8), device="cpu")
    assert isinstance(full, MaskedMLP) and full.active == (16, 8)
    assert [n for n, _ in full.named_buffers()] == ["mask_0", "mask_1"]
    assert all(b.all() for b in full.buffers())


def test_masked_mlp_layout_round_trips_and_payloads_cross_packages():
    jm = _jax_masked()
    pm = _port_from(jm)
    params = to_flax_params(pm.module.state_dict(), pm.module)
    stats = to_flax_batch_stats(pm.module.state_dict(), pm.module)
    for got, want in ((params, jax.device_get(jm.params)),
                      (stats, jax.device_get(jm.batch_stats))):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    # A port payload loads in the JAX package and back.
    from elephas_tpu.serialize import dict_to_model as jax_dict_to_model
    from elephas_tpu.serialize import model_to_dict as jax_model_to_dict

    pm.model_config = {"name": "mlp_masked", "kwargs": {
        "features": (BUCKET,), "active": (ACTIVE,), "num_classes": CLASSES, "device": "cpu"}}
    pm.input_shape = (IN,)
    payload = model_to_dict(pm)
    assert payload["arch"]["config"]["kwargs"] == {"features": (BUCKET,), "active": (ACTIVE,),
                                                   "num_classes": CLASSES}
    x, _ = _data(5)
    back = jax_dict_to_model(payload)
    np.testing.assert_allclose(
        np.asarray(back.apply_eval(back.params, back.batch_stats, jnp.asarray(x))),
        pm.apply_eval(torch.as_tensor(x)).numpy(), rtol=0, atol=1e-5)
    again = dict_to_model(jax_model_to_dict(back), device="cpu")
    assert isinstance(again.module, MaskedMLP)
    for k, v in pm.module.state_dict().items():
        assert torch.equal(again.module.state_dict()[k], v), k


# -- a real objective: mlp_masked through the sync trainer ------------------------------


def _jax_perms(rows, epochs):
    """The JAX sync trainer's row orders at one shard (as
    ``tests/test_torch_ml_model.py``)."""
    base, out = jax.random.PRNGKey(0), []
    for epoch in range(epochs):
        key = jax.random.split(jax.random.fold_in(jax.random.fold_in(base, epoch), 0))[0]
        out.append(np.asarray(jax.random.permutation(key, rows)))
        base = jax.random.fold_in(base, epoch + 1)
    return out


def _real_data():
    x, y = make_blobs(n=320, num_classes=4, dim=8, seed=11)
    return x[:256], y[:256], x[256:], y[256:]


REAL_BUCKETS = (32,)


def _real_space(pkg):
    return {"lr": pkg.hp.loguniform(np.log(1e-3), np.log(1e-1)),
            "width": pkg.hp.choice([8, 16, 32])}


def _jax_real_objective(sample, data):
    x, y, xv, yv = data
    width = int(sample["width"])
    net = JaxCompiledModel(
        jax_get_model("mlp_masked", features=(jax_hp.width_bucket(width, REAL_BUCKETS),),
                      active=(width,), num_classes=4),
        optimizer={"name": "adam", "learning_rate": sample["lr"], "injected": True},
        loss="categorical_crossentropy", metrics=["acc"], input_shape=(x.shape[1],))
    mesh = jax_build_mesh(num_data=1, devices=[jax_hp.current_trial_device()])
    trainer = JaxSyncTrainer(net, mesh, frequency="batch")
    state, _ = trainer.fit(JaxShardedDataset(x, y, 1), epochs=1, batch_size=64)
    val = trainer.evaluate_state(state, xv, yv)
    return {"loss": float(val["loss"]), "val_acc": float(val["acc"])}


def _port_real_objective(sample, data):
    """The same trial in the port, from the flax init of the same seed."""
    x, y, xv, yv = data
    width = int(sample["width"])
    kwargs = dict(features=(port_hp.width_bucket(width, REAL_BUCKETS),), active=(width,),
                  num_classes=4)
    init = JaxCompiledModel(jax_get_model("mlp_masked", **kwargs), input_shape=(x.shape[1],))
    module = get_model("mlp_masked", device=port_hp.current_trial_device(), **kwargs)
    net = CompiledModel(module, from_flax_params(jax.device_get(init.params), module,
                                                 jax.device_get(init.batch_stats)),
                        optimizer={"name": "adam", "learning_rate": sample["lr"],
                                   "injected": True},
                        loss="categorical_crossentropy", metrics=["acc"])
    trainer = SyncTrainer(net, build_mesh(num_data=1), frequency="batch")
    state, _ = trainer.fit(ShardedDataset(x, y, 1), epochs=1, batch_size=64)
    val = trainer.evaluate_state(state, xv, yv)
    return {"loss": float(val["loss"]), "val_acc": float(val["acc"])}


def test_real_objective_search_matches_jax(monkeypatch):
    perms = _jax_perms(256, 1)
    monkeypatch.setattr(sync, "shard_permutation",
                        lambda seed, epoch, shard, n: torch.as_tensor(np.array(perms[epoch][:n])))
    data = _real_data()
    port = port_hp.HyperParamModel(None, num_workers=2, device="cpu")
    port.minimize(_port_real_objective, lambda: data, max_evals=4,
                  space=_real_space(port_hp), seed=6, algo="random")
    ref = jax_hp.HyperParamModel(None, num_workers=2)
    ref.minimize(_jax_real_objective, lambda: data, max_evals=4,
                 space=_real_space(jax_hp), seed=6, algo="random")
    key = lambda t: (t["worker"], t["trial"])  # noqa: E731
    port_trials, jax_trials = sorted(port.trials, key=key), sorted(ref.trials, key=key)
    assert [(key(t), t["sample"]) for t in port_trials] == \
        [(key(t), t["sample"]) for t in jax_trials]
    for a, b in zip(port_trials, jax_trials):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * max(1.0, abs(b["loss"])), (a, b)
        assert abs(a["val_acc"] - b["val_acc"]) <= 1e-6 + 1 / 64


# -- two gloo ranks against one process ------------------------------------------------


def _spawn(tmp_path, world, jobs, timeout=240):
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


def test_no_device_takes_the_ranks_own_card_in_a_group(tmp_path):
    """Two ranks on a host of two cards, each rank driving its own
    (``current_device``): each takes one worker on its card, so the group
    has 2 slots, as the JAX package's two hosts of one chip each (one
    worker per local device); 5 trials split 3 and 2."""
    job = {"kind": "search_devices", "cards": 2, "max_evals": 5,
           "out": str(tmp_path / "devices.pt")}
    _spawn(tmp_path, 2, [job])
    ranks = [torch.load(f"{job['out']}.rank{r}", weights_only=False) for r in range(2)]
    assert [r["devices"] for r in ranks] == [[torch.device("cuda", 0)],
                                             [torch.device("cuda", 1)]]
    assert [r["slots"] for r in ranks] == [[0, 0, 0], [1, 1]]


def test_two_ranks_of_two_workers_equal_one_process_of_four(tmp_path):
    sys.path.insert(0, str(WORKER.parent))
    from test_torch_dist_worker import search_data, search_objective, search_space

    job = {"kind": "search", "workers": 2, "max_evals": 7, "seed": 1, "algo": "tpe",
           "out": str(tmp_path / "search.pt")}
    _spawn(tmp_path, 2, [job])
    ranks = [torch.load(f"{job['out']}.rank{r}", weights_only=False) for r in range(2)]
    single = port_hp.HyperParamModel(None, num_workers=4, device="cpu")
    best = single.minimize(search_objective, search_data, max_evals=7, space=search_space(),
                           seed=1, algo="tpe")
    want = sorted((t["worker"], t["trial"], t["sample"], t["loss"]) for t in single.trials)
    got = sorted(ranks[0]["trials"] + ranks[1]["trials"])
    assert [t[:3] for t in got] == [t[:3] for t in want]
    for (*_, loss), (*_, want_loss) in zip(got, want):  # trained losses, 4 threads vs 1
        assert abs(loss - want_loss) <= 1e-6 * max(1.0, abs(want_loss)), (loss, want_loss)
    assert {w for w, *_ in ranks[0]["trials"]} <= {0, 1}  # rank 1 holds slots 2 and 3
    assert {w for w, *_ in ranks[1]["trials"]} <= {2, 3}
    keys = ("sample", "worker", "trial")
    for r in ranks:
        assert {k: r["best"][k] for k in keys} == {k: best[k] for k in keys}
        assert abs(r["best"]["loss"] - best["loss"]) <= 1e-6 * max(1.0, abs(best["loss"]))
    assert ranks[0]["best"]["loss"] == ranks[1]["best"]["loss"]
    holder = ranks[0]["best"]["built_by_rank"]
    assert ranks[1]["best"]["built_by_rank"] == holder
    assert [r["best_model_is_live"] for r in ranks] == [holder == 0, holder == 1]
    single_weights = best["model"].get_weights()
    for name, value in ranks[holder]["best_weights"].items():
        assert torch.equal(ranks[1 - holder]["best_weights"][name], value), name
        assert torch.allclose(value, single_weights[name], rtol=1e-6, atol=1e-6), name
