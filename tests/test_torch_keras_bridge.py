"""The port's Keras-3 bridge (``elephas_tpu_torch/serialize/keras_bridge.py``,
torch backend) against the JAX package's (JAX backend).

A Keras backend is fixed for each process, and this process may already
hold keras on another one, so keras never runs here:
``tests/torch_keras_worker.py`` runs each package's bridge in a process
of its own, both at once, once for the module. Both build the same
architectures with the same NumPy-seeded weights and compile
configurations. Held: the mapped optimizer, loss, metrics and schedules
equal exactly; logits within 1e-5; the weights after one synchronous
epoch (the port's rows in the JAX package's order) within 1e-4 by norm;
every refusal the reference raises raised by the port too; and the
counterparts of ``tests/test_keras_bridge.py``'s fits through
``SparkModel``, on the port.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_keras_worker.py"
PACKAGES = ("jax", "port")
BACKEND = {"jax": "jax", "port": "torch"}
LOGIT_TOL, FIT_TOL = 1e-5, 1e-4


def _jax_perms(rows):
    """The JAX package's row order of one shard's first epoch
    (``engine/sync.py``: ``fold_in(fold_in(PRNGKey(0), 0), 0)``, split,
    the first half drawing ``permutation(rows)``)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), 0)
    return np.asarray([[np.asarray(jax.random.permutation(jax.random.split(key)[0], rows))]])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("keras")
    tmp = tmp_path_factory.mktemp("keras")
    np.save(tmp / "perms.npy", _jax_perms(128))
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    procs = {}
    for pkg in PACKAGES:
        log = open(tmp / f"{pkg}.log", "w")
        procs[pkg] = (subprocess.Popen(
            [sys.executable, str(WORKER), BACKEND[pkg], str(tmp / f"{pkg}.json"),
             str(tmp / "perms.npy")], env=env, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT),
            log)
    out = {}
    for pkg, (proc, log) in procs.items():
        rc = proc.wait(timeout=300)
        log.close()
        assert rc == 0, (tmp / f"{pkg}.log").read_text()[-4000:]
        out[pkg] = json.loads((tmp / f"{pkg}.json").read_text())
    return out


def test_each_run_holds_its_backend(runs):
    assert {pkg: runs[pkg]["backend"] for pkg in PACKAGES} == BACKEND


# -- the mapped compile configurations ------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_from_keras_reads_compile_config(runs, pkg):
    cfg = runs[pkg]["configs"]["mlp"]
    assert cfg["loss"] == "categorical_crossentropy"
    assert cfg["optimizer"]["name"] == "adam"
    assert cfg["optimizer"]["learning_rate"] == pytest.approx(0.01)
    assert cfg["params"] == 12 * 24 + 24 + 24 * 3 + 3


def test_mapped_configs_equal_the_references(runs):
    """Every architecture's optimizer config, loss, metrics and
    parameter count, exactly as the JAX bridge maps them."""
    assert runs["port"]["configs"] == runs["jax"]["configs"]
    assert len(runs["port"]["configs"]) == 8


@pytest.mark.parametrize("pkg", PACKAGES)
def test_from_keras_uncompiled_requires_explicit_args(runs, pkg):
    assert runs[pkg]["errors"]["uncompiled"] == [
        "ValueError", "model is not compiled; pass optimizer=..."]
    assert runs[pkg]["explicit"] == {"name": "sgd", "learning_rate": 0.01}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_softmax_output_maps_to_prob_loss(runs, pkg):
    assert runs[pkg]["configs"]["softmax"]["loss"] == "categorical_crossentropy_probs"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sigmoid_binary_maps_to_prob_loss_and_metric(runs, pkg):
    cfg = runs[pkg]["configs"]["sigmoid"]
    assert cfg["loss"] == "binary_crossentropy_probs"
    assert "binary_accuracy_probs" in cfg["metrics"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_from_logits_true_keeps_logit_loss(runs, pkg):
    assert runs[pkg]["configs"]["from_logits"]["loss"] == "categorical_crossentropy"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_standalone_softmax_layer_maps_to_prob_loss(runs, pkg):
    assert runs[pkg]["configs"]["softmax_layer"]["loss"] == "categorical_crossentropy_probs"


# -- refusals -----------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case, match", [
    ("unbuilt", "build"),
    ("mismatched", "cannot map"),
    ("spark_uncompiled", "not compiled"),
    ("unmapped_optimizer", "unmapped Keras optimizer Nadam"),
    ("unmapped_loss", "unmapped Keras loss 'huber'"),
])
def test_refusals_raise_as_the_reference(runs, pkg, case, match):
    """The reference's error cases: the same exception, the same message
    in both packages."""
    kind, message = runs[pkg]["errors"][case]
    assert kind == "ValueError" and match in message
    assert runs["port"]["errors"][case] == runs["jax"]["errors"][case]


@pytest.mark.parametrize("pkg, wants, has", [("jax", "JAX", "torch"), ("port", "torch", "jax")])
def test_each_bridge_refuses_the_other_backend(runs, pkg, wants, has):
    """A model of another backend is refused with the reference's kind of
    message (each bridge tried in the other backend's process)."""
    other = "port" if pkg == "jax" else "jax"
    kind, message = runs[other]["errors"]["other_backend"]
    assert kind == "ValueError"
    assert f"Keras ingestion needs the {wants} backend" in message
    assert f"(current backend: '{has}')" in message


# -- numbers ------------------------------------------------------------------------------


def test_logits_agree_with_the_reference(runs):
    for name, ref in runs["jax"]["logits"].items():
        got, ref = np.asarray(runs["port"]["logits"][name]), np.asarray(ref)
        assert got.shape == ref.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL, err_msg=name)


def test_one_sync_epoch_agrees_with_the_reference(runs):
    """One synchronous epoch of a Dense-BatchNorm-Dense model under SGD:
    every trainable (``v{i}``) and every moving statistic (``nt{i}``,
    the JAX bridge's ``batch_stats``) within 1e-4 by norm."""
    ref, got = runs["jax"]["fit"], runs["port"]["fit"]
    assert sorted(got["weights"]) == sorted(ref["weights"]) == [
        "nt0", "nt1", "v0", "v1", "v2", "v3", "v4", "v5"]
    for key, want in ref["weights"].items():
        want, have = np.asarray(want), np.asarray(got["weights"][key])
        assert np.linalg.norm(have - want) <= FIT_TOL * np.linalg.norm(want), key
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=FIT_TOL)


@pytest.mark.parametrize("name", ["exponential", "piecewise", "warmup_cosine", "cosine"])
def test_keras_lr_schedules_map(runs, name):
    """Keras schedules carry over as serializable schedule configs equal
    to the JAX bridge's, whose values follow Keras itself at each probe
    step (at a piecewise boundary Keras keeps the old value)."""
    ref, got = runs["jax"]["schedules"][name], runs["port"]["schedules"][name]
    assert got["config"] == ref["config"]
    np.testing.assert_allclose(got["mapped"], ref["mapped"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["mapped"], got["keras"], rtol=1e-5, atol=1e-9)


def test_warmup_cosine_matches_keras_pointwise(runs):
    got = runs["port"]["schedules"]["warmup_cosine"]
    assert got["config"]["learning_rate"]["schedule"] == "warmup_cosine"
    assert got["config"]["learning_rate"]["decay_steps"] == 250
    np.testing.assert_allclose(got["mapped"], got["keras"], atol=5e-3)


def test_keras_param_rules_match_the_reference(runs):
    assert runs["port"]["param_rules"] == runs["jax"]["param_rules"]
    assert runs["port"]["param_rules"] == [["^v0$", [None, "model"]], ["^v1$", ["model"]],
                                           ["^v2$", [None, "model"]], ["^v3$", ["model"]]]


# -- the port's fits through SparkModel (tests/test_keras_bridge.py's) ----------------


def test_keras_model_trains_through_spark_model(runs):
    got = runs["port"]["port"]["sync"]
    assert got["acc"] > 0.8 and got["evaluate"] > 0.8 and got["predict_shape"] == [5, 3]


def test_keras_model_async_mode(runs):
    assert runs["port"]["port"]["hogwild"]["evaluate"] > 0.8


def test_softmax_output_maps_to_prob_loss_and_trains(runs):
    got = runs["port"]["port"]["softmax"]
    assert got["loss"] == "categorical_crossentropy_probs" and got["acc"] > 0.8


def test_sigmoid_binary_trains(runs):
    got = runs["port"]["port"]["sigmoid"]
    assert got["loss"] == "binary_crossentropy_probs"
    assert got["metrics"] == ["binary_accuracy_probs"] and got["acc"] > 0.8


def test_spark_model_accepts_compiled_keras_directly(runs):
    got = runs["port"]["port"]["direct"]
    assert got["adapter"] == "KerasModuleAdapter"
    assert got["acc"] > 0.8 and got["predict_shape"] == [32, 3]


def test_keras_backed_save_load_roundtrip(runs):
    assert runs["port"]["port"]["save_load"]["max_abs"] <= 1e-5


# -- schedule configs without keras -------------------------------------------------------


def test_dict_lr_without_schedule_key_raises_value_error():
    from elephas_tpu_torch.api.compile import resolve_schedule

    with pytest.raises(ValueError, match="schedule"):
        resolve_schedule({"init_value": 0.1})


def test_schedule_config_trains_and_serializes(tmp_path):
    """A dict-lr optimizer config flows through compile, fit, and the
    save/load round trip (schedule configs are plain data)."""
    import elephas_tpu_torch as et
    from elephas_tpu_torch.models import get_model

    from conftest import make_blobs

    x, y = make_blobs(n=192, num_classes=3, dim=12, seed=8)
    net = et.compile_model(
        get_model("mlp", device="cpu", features=(16,), num_classes=3),
        optimizer={"name": "sgd", "learning_rate": {
            "schedule": "exponential_decay", "init_value": 0.1, "transition_steps": 50,
            "decay_rate": 0.9}},
        loss="categorical_crossentropy", metrics=["acc"], input_shape=(12,))
    model = et.SparkModel(net, mode="synchronous", frequency="epoch")
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=3, batch_size=16)
    assert history["acc"][-1] > 0.8
    path = str(tmp_path / "sched.pkl")
    model.save(path)
    loaded = et.load_spark_model(path, device="cpu")
    np.testing.assert_allclose(loaded.predict(x[:16]), model.predict(x[:16]), rtol=1e-5)
