"""The port's ML pipeline (``ml/``: ``ElephasEstimator``,
``ElephasTransformer``, their save/load) on the CPU: the JAX package's
own pipeline tests (``tests/test_ml_model.py``), ported, and the
estimator held against the JAX package's estimator on the small LSTM
(vocab 50, embed 8, hidden 8, sequences of 12).

Both estimators start from one JAX ``model_to_dict`` payload as
``keras_model_config`` (the reference's own path), so both hold the
flax init. The synchronous fit at one worker draws the JAX package's
row orders (``_jax_perms``, as ``tests/test_torch_fit.py``); the
asynchronous fit at one unpipelined worker the JAX worker's
(``_jax_perm``, as ``tests/test_torch_async.py``). Limits: each history
entry 1e-5 relative, each trained tensor 1e-5 of its norm, the
transformed outputs 1e-5 and their argmax equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_blobs

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.data.dataframe import to_data_frame as jax_to_data_frame
from elephas_tpu.ml import ElephasEstimator as JaxEstimator
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.serialize import model_to_dict as jax_model_to_dict
from elephas_tpu_torch.data.dataframe import DataFrame, to_data_frame
from elephas_tpu_torch.engine import async_engine, sync
from elephas_tpu_torch.ml import (
    ElephasEstimator,
    ElephasTransformer,
    load_ml_estimator,
    load_ml_transformer,
)
from elephas_tpu_torch.ml.params import HasOptimizerConfig

NUM_CLASSES, DIM = 3, 12


@pytest.fixture(scope="module")
def df():
    x, y = make_blobs(n=360, num_classes=NUM_CLASSES, dim=DIM, seed=5)
    return to_data_frame(None, x, y, categorical=True)


def make_estimator(**overrides):
    est = ElephasEstimator(
        keras_model_config={
            "name": "mlp",
            "kwargs": {"features": (24,), "num_classes": NUM_CLASSES},
            "input_shape": (DIM,),
        },
        mode="synchronous",
        frequency="batch",
        nb_classes=NUM_CLASSES,
        num_workers=1,
        epochs=3,
        batch_size=16,
        optimizer_config={"name": "adam", "learning_rate": 0.01},
        loss="categorical_crossentropy",
        metrics=("acc",),
        categorical=True,
        device="cpu",
    )
    est.set_params(**overrides)
    return est


def test_fit_transform_pipeline(df):
    transformer = make_estimator().fit(df)
    assert isinstance(transformer, ElephasTransformer)
    out = transformer.transform(df)
    assert "prediction" in out.columns and out["prediction"].dtype == np.float32
    acc = float(np.mean(out["prediction"] == df["label"]))
    assert acc > 0.8
    assert transformer.history["acc"][-1] > 0.8


def test_chainable_setters(df):
    est = make_estimator()
    est.set_epochs(2).set_batch_size(8).set_output_col("guess").set_verbose(0)
    assert est.get_epochs() == 2
    out = est.fit(df).transform(df)
    assert "guess" in out.columns


def test_estimator_save_load_roundtrip(df, tmp_path):
    est = make_estimator()
    path = os.path.join(tmp_path, "estimator.pkl")
    est.save(path)
    loaded = load_ml_estimator(path, device="cpu")
    assert loaded.param_map() == est.param_map()
    assert loaded.fit(df).transform(df)["prediction"].shape == (len(df),)


def test_transformer_save_load_roundtrip(df, tmp_path):
    transformer = make_estimator().fit(df)
    before = transformer.transform(df)["prediction"]
    path = os.path.join(tmp_path, "transformer.pkl")
    transformer.save(path)
    after = load_ml_transformer(path, device="cpu").transform(df)["prediction"]
    np.testing.assert_array_equal(before, after)


def test_get_model_returns_trained_network(df):
    net = make_estimator().fit(df).get_model()
    assert net.count_params() > 0
    assert next(net.module.parameters()).device == torch.device("cpu")


def test_async_estimator(df):
    transformer = make_estimator(mode="asynchronous", frequency="epoch").fit(df)
    acc = float(np.mean(transformer.transform(df)["prediction"] == df["label"]))
    assert acc > 0.8


def test_param_validation():
    with pytest.raises(ValueError):
        ElephasEstimator(bogus_param=1)
    est = ElephasEstimator(device="cpu")
    with pytest.raises(ValueError):  # no model config
        est.fit(to_data_frame(None, np.zeros((8, 2), np.float32), np.zeros(8), False))
    with pytest.raises(ValueError, match="input_shape"):
        est.set_keras_model_config({"name": "mlp"}).fit(
            to_data_frame(None, np.zeros((8, 2), np.float32), np.zeros(8), False))
    assert "mode" in est.explain_params()


def test_defaults_are_the_jax_packages():
    """Every param and default of the JAX estimator (``mode``
    asynchronous, ``optimizer_config`` sgd), and mutable defaults never
    shared between stages."""
    ours, theirs = ElephasEstimator(), JaxEstimator()
    assert ours.param_map() == theirs.param_map()
    assert ours.mode == "asynchronous" and ours.optimizer_config == {"name": "sgd"}
    a, b = ElephasEstimator(), ElephasEstimator()
    a.optimizer_config["learning_rate"] = 123.0
    assert "learning_rate" not in b.optimizer_config
    assert "learning_rate" not in HasOptimizerConfig._params()["optimizer_config"].default


def test_regression_transform_single_row(df):
    """categorical=False with a 1-row frame keeps the row dimension."""
    transformer = make_estimator().fit(df)
    transformer.set_categorical(False)
    out = transformer.transform(df.limit(1))
    assert out[transformer.output_col].shape == (1, NUM_CLASSES)
    single = make_estimator(keras_model_config={"name": "mlp", "kwargs": {
        "features": (8,), "num_classes": 1}, "input_shape": (DIM,)}, loss="mse",
        metrics=(), categorical=False, epochs=1)
    regress = single.fit(df.with_column("label", np.float32(df["label"])[:, None]))
    assert regress.transform(df.limit(1))["prediction"].shape == (1,)


def test_estimator_autotune_param_raises(df):
    """The stage keeps the reference's autotune param and passes it to
    ``SparkModel``, whose A/B is ported (one candidate on the CPU): the
    fit trains and the transformer transforms every row."""
    est = make_estimator().set_autotune(True)
    assert est.autotune is True and "autotune" in est.param_map()
    transformer = est.fit(df)
    out = transformer.transform(df)
    assert out[transformer.output_col].shape[0] == len(df)


def test_wrong_kind_load_raises(tmp_path):
    path = os.path.join(tmp_path, "est.pkl")
    make_estimator().save(path)
    with pytest.raises(ValueError, match="ElephasTransformer"):
        load_ml_transformer(path)


# -- against the JAX package's estimator -----------------------------------------

LSTM = {"vocab_size": 50, "embed_dim": 8, "hidden_dim": 8}
ROWS, SEQ, BATCH, EPOCHS = 64, 12, 16, 3


def _jax_perms(rows, epochs):
    """The JAX sync trainer's row orders at one shard (``engine/sync.py``):
    epoch e's key ``fold_in(fold_in(base, e), 0)``, split, the first half
    drawing the permutation; the base key moves by ``fold_in(base, e + 1)``."""
    base, out = jax.random.PRNGKey(0), []
    for epoch in range(epochs):
        key = jax.random.split(jax.random.fold_in(jax.random.fold_in(base, epoch), 0))[0]
        out.append(np.asarray(jax.random.permutation(key, rows)))
        base = jax.random.fold_in(base, epoch + 1)
    return out


def _jax_perm(index, epoch, n):
    """The JAX async worker's row order."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(1234), index), 7), epoch)
    return np.array(jax.random.permutation(key, n))


@pytest.fixture(scope="module")
def imdb_like():
    """Pre-padded float32 token rows (as a DataFrame column carries them),
    float32 binary labels, and a JAX payload of the flax LSTM init."""
    rng = np.random.default_rng(9)
    x = np.zeros((ROWS, SEQ), np.float32)
    for i, n in enumerate(rng.integers(3, SEQ + 1, ROWS)):
        x[i, SEQ - n:] = rng.integers(1, 50, n)
    y = rng.integers(0, 2, ROWS).astype(np.float32)
    module = jax_get_model("lstm", **LSTM)
    params = jax.device_get(module.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))
                            ["params"])
    payload = jax_model_to_dict(JaxCompiledModel(module, params, optimizer="sgd",
                                                 loss="sparse_categorical_crossentropy"))
    return x, y, payload


def _stage(cls, payload, mode, **kw):
    return cls(keras_model_config=payload, mode=mode, frequency="epoch", num_workers=1,
               epochs=EPOCHS, batch_size=BATCH, nb_classes=2, categorical=False,
               optimizer_config={"name": "adam", "learning_rate": 1e-2},
               loss="sparse_categorical_crossentropy", metrics=["acc"], **kw)


@pytest.mark.parametrize("mode", ["synchronous", "asynchronous"])
def test_estimator_fit_from_jax_payload_matches_jax(imdb_like, monkeypatch, mode):
    x, y, payload = imdb_like
    want = _stage(JaxEstimator, payload, mode).fit(jax_to_data_frame(None, x, y))
    if mode == "synchronous":
        perms = _jax_perms(ROWS, EPOCHS)
        monkeypatch.setattr(sync, "shard_permutation",
                            lambda seed, epoch, shard, n: torch.tensor(perms[epoch]))
    else:
        monkeypatch.setattr(async_engine, "worker_permutation",
                            lambda index, epoch, attempt, n: torch.as_tensor(
                                _jax_perm(index, epoch, n)))
    got = _stage(ElephasEstimator, payload, mode, device="cpu").fit(
        to_data_frame(None, x, y))

    assert got.history.keys() == want.history.keys()
    for key, ref in want.history.items():
        np.testing.assert_allclose(got.history[key], ref, rtol=1e-5, atol=1e-7, err_msg=key)
    ours, theirs = got.model_payload["weights"], want.model_payload["weights"]
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ours),
                                 jax.tree_util.tree_leaves_with_path(theirs)):
        b = np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), jax.tree_util.keystr(path)
    test = DataFrame({"features": x[:24], "label": y[:24]})
    out_ours = got.transform(test)["prediction"]
    out_theirs = np.asarray(want.transform(jax_to_data_frame(None, x[:24], y[:24]))
                            ["prediction"])
    assert out_ours.shape == (24, 2)  # categorical=False: the raw outputs
    np.testing.assert_allclose(out_ours, out_theirs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out_ours.argmax(-1), out_theirs.argmax(-1))
