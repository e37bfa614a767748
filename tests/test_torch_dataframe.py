"""Parity of the port's DataFrame and MLlib adapters
(``data/dataframe.py``, ``data/mllib.py``) and of ``SparkMLlibModel``
with the JAX package's, on the CPU: the same columns, arrays and
partitions for the same inputs, exactly; the MLlib fit at world size 1
within the sync ``fit`` tests' limits (loss 1e-5, weights 1e-4 by norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from conftest import make_blobs

import elephas_tpu_torch as et
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.api.spark_model import SparkMLlibModel as JaxSparkMLlibModel
from elephas_tpu.data import dataframe as jax_dataframe
from elephas_tpu.data import mllib as jax_mllib
from elephas_tpu.data.rdd import to_labeled_point as jax_to_labeled_point
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu_torch.convert import from_flax_params, to_flax_params
from elephas_tpu_torch.data import dataframe, mllib
from elephas_tpu_torch.data.rdd import to_labeled_point
from elephas_tpu_torch.models import get_model


def _columns(df):
    return {name: df[name] for name in df.columns}


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_dataframe_surface_matches_jax():
    cols = {"a": np.arange(5), "b": np.ones((5, 3), np.float32)}
    ours, theirs = dataframe.DataFrame(cols), jax_dataframe.DataFrame(cols)
    assert ours.count() == len(ours) == theirs.count()
    assert ours.columns == theirs.columns
    for op in (lambda d: d.select("a"), lambda d: d.with_column("c", np.zeros(5)),
               lambda d: d.withColumn("c", np.zeros(5)).drop("c"), lambda d: d.limit(2)):
        _assert_same(_columns(op(ours)), _columns(op(theirs)))
    assert ours.head(2).keys() == theirs.head(2).keys()
    assert repr(ours) == repr(theirs)
    with pytest.raises(ValueError, match="length mismatch"):
        dataframe.DataFrame({"a": np.arange(5), "b": np.arange(4)})
    with pytest.raises(ValueError, match="at least one column"):
        dataframe.DataFrame({})
    with pytest.raises(KeyError):
        ours.select("missing")


def test_pandas_round_trip():
    pytest.importorskip("pandas")
    df = dataframe.DataFrame({"features": np.random.default_rng(0).normal(size=(6, 4)),
                              "label": np.arange(6.0)})
    back = dataframe.DataFrame.from_pandas(df.to_pandas())
    _assert_same(_columns(back), _columns(df))


@pytest.mark.parametrize("categorical", [False, True])
def test_to_and_from_data_frame_match_jax(categorical):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 5)).astype(np.float32)
    y_int = rng.integers(0, 3, size=12)
    y = np.eye(3, dtype=np.float32)[y_int] if categorical else y_int.astype(np.float32)
    ours = dataframe.to_data_frame(None, x, y, categorical=categorical)
    theirs = jax_dataframe.to_data_frame(None, x, y, categorical=categorical)
    _assert_same(_columns(ours), _columns(theirs))
    for nb_classes in (3, None):
        got = dataframe.from_data_frame(ours, categorical=True, nb_classes=nb_classes)
        want = jax_dataframe.from_data_frame(theirs, categorical=True, nb_classes=nb_classes)
        _assert_same(dict(zip("xy", got)), dict(zip("xy", want)))
    got = dataframe.from_data_frame(ours, categorical=False)
    _assert_same(dict(zip("xy", got)), dict(zip("xy", jax_dataframe.from_data_frame(theirs))))


@pytest.mark.parametrize("parts", [1, 4])
def test_df_to_simple_rdd_matches_jax(parts):
    rng = np.random.default_rng(2)
    df_cols = {"feats": rng.normal(size=(18, 5)).astype(np.float32),
               "y": rng.integers(0, 2, size=18).astype(np.float32)}
    kw = dict(categorical=True, nb_classes=2, features_col="feats", label_col="y",
              num_partitions=parts)
    ours = dataframe.df_to_simple_rdd(dataframe.DataFrame(df_cols), **kw)
    theirs = jax_dataframe.df_to_simple_rdd(jax_dataframe.DataFrame(df_cols), **kw)
    assert ours.getNumPartitions() == theirs.getNumPartitions() == parts
    assert ours.partition_sizes() == theirs.partition_sizes()
    np.testing.assert_array_equal(ours.features, theirs.features)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.labels.shape == (18, 2) and ours.labels.dtype == np.float32


def test_out_of_range_labels_raise_as_jax():
    df = dataframe.DataFrame({"features": np.zeros((3, 2), np.float32),
                              "label": np.array([0.0, 1.0, 5.0])})
    with pytest.raises(ValueError, match=r"labels outside \[0, 3\): min=0, max=5"):
        dataframe.from_data_frame(df, categorical=True, nb_classes=3)
    df = df.with_column("label", np.array([-1.0, 0.0, 1.0]))
    with pytest.raises(ValueError, match="min=-1"):
        dataframe.from_data_frame(df, categorical=True, nb_classes=3)


def test_mllib_matches_jax():
    v = np.array([1.0, 2.0, 3.0])
    m = np.arange(6.0).reshape(2, 3)
    vec, jvec = mllib.to_vector(v), jax_mllib.to_vector(v)
    np.testing.assert_array_equal(mllib.from_vector(vec), jax_mllib.from_vector(jvec))
    assert repr(vec) == repr(jvec) and len(vec) == 3
    assert vec == mllib.DenseVector(v) and not vec == mllib.DenseVector(v + 1)
    mat, jmat = mllib.to_matrix(m), jax_mllib.to_matrix(m)
    assert (mat.numRows, mat.numCols) == (jmat.numRows, jmat.numCols) == (2, 3)
    np.testing.assert_array_equal(mat.values, jmat.values)  # column-major
    np.testing.assert_array_equal(mllib.from_matrix(mat), m)
    with pytest.raises(ValueError):
        mllib.to_vector(np.ones((2, 2)))
    with pytest.raises(ValueError):
        mllib.to_matrix(np.ones(3))
    with pytest.raises(ValueError, match="does not match"):
        mllib.DenseMatrix(2, 2, np.ones(3))


def test_spark_mllib_model_fit_matches_jax():
    """LabeledPoints through ``SparkMLlibModel.fit`` at world size 1, one
    batch of all 128 rows per epoch (so the two packages' shuffles cannot
    differ), 3 epochs."""
    x, y = make_blobs(n=128, num_classes=3, dim=8, seed=4)
    kwargs, adam = {"features": (16,), "num_classes": 3}, {"name": "adam", "learning_rate": 0.01}
    flax = jax_get_model("mlp", **kwargs)
    params = jax.device_get(flax.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)))["params"])
    jm = JaxCompiledModel(flax, params, optimizer=adam, loss="categorical_crossentropy",
                          metrics=["acc"])
    want_model = JaxSparkMLlibModel(jm, mode="synchronous", frequency="batch", num_workers=1)
    want = want_model.fit(jax_to_labeled_point(None, x, y, categorical=True), epochs=3,
                          batch_size=128, categorical=True, nb_classes=3)

    module = get_model("mlp", device="cpu", **kwargs)
    compiled = et.CompiledModel(module, from_flax_params(params, module), optimizer=adam,
                                loss="categorical_crossentropy", metrics=["acc"])
    model = et.SparkMLlibModel(compiled, mode="synchronous", frequency="batch")
    got = model.fit(to_labeled_point(None, x, y, categorical=True), epochs=3, batch_size=128,
                    categorical=True, nb_classes=3)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    trained = to_flax_params(model.get_weights(), module)
    ref = jax.device_get(want_model.master_network.params)
    for a, b in zip(jax.tree_util.tree_leaves(trained), jax.tree_util.tree_leaves(ref)):
        assert np.linalg.norm(a - np.asarray(b)) <= 1e-4 * np.linalg.norm(b)
