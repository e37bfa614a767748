"""Parity of the port's data layer (``elephas_tpu_torch.data``, ``native``,
``utils.functional_utils``) with the JAX package's, on the CPU: the same
arrays for the same inputs and seeds, exactly.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from elephas_tpu.data import datasets as jax_datasets
from elephas_tpu.data import rdd as jax_rdd
from elephas_tpu.utils import functional_utils as jax_fu
from elephas_tpu_torch import native
from elephas_tpu_torch.data import datasets, rdd
from elephas_tpu_torch.utils import functional_utils as fu


def _xy(n=23, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 4)).astype(np.float32), rng.integers(0, 3, n)


@pytest.mark.parametrize("parts", [1, 3, 4, 23])
def test_sharded_dataset_matches_jax(parts):
    x, y = _xy()
    ours, theirs = rdd.ShardedDataset(x, y, parts), jax_rdd.ShardedDataset(x, y, parts)
    assert ours.partition_sizes() == theirs.partition_sizes()
    assert (len(ours), ours.count(), ours.getNumPartitions()) == (23, 23, parts)
    for (fx, fy), (jx, jy) in zip(ours.partitions(), theirs.partitions()):
        np.testing.assert_array_equal(fx, jx)
        np.testing.assert_array_equal(fy, jy)
    for got, want in zip(ours.even_shards(parts), theirs.even_shards(parts)):
        np.testing.assert_array_equal(got, want)
    shuffled, jshuffled = ours.shuffle(seed=5), theirs.shuffle(seed=5)
    np.testing.assert_array_equal(shuffled.features, jshuffled.features)
    np.testing.assert_array_equal(shuffled.labels, jshuffled.labels)
    assert shuffled.num_partitions == parts
    assert ours.repartition(2).partition_sizes() == theirs.repartition(2).partition_sizes()
    taken = ours.take(2)
    assert len(taken) == 2 and np.array_equal(taken[1][0], x[1])


def test_sharded_dataset_rejects_what_jax_rejects():
    x, y = _xy(5)
    for args in ((x, y[:4], 1), (x, y, 0), (x, y, 6)):
        with pytest.raises(ValueError):
            rdd.ShardedDataset(*args)
        with pytest.raises(ValueError):
            jax_rdd.ShardedDataset(*args)


@pytest.mark.parametrize("categorical", [False, True])
def test_labeled_points_match_jax(categorical):
    x, labels = _xy(7)
    y = np.eye(3, dtype=np.float32)[labels] if categorical else labels.astype(np.float32)
    ours = rdd.to_labeled_point(None, x, y, categorical)
    theirs = jax_rdd.to_labeled_point(None, x, y, categorical)
    assert [p.label for p in ours] == [p.label for p in theirs]
    got = rdd.from_labeled_point(ours, categorical, 3 if categorical else None)
    want = jax_rdd.from_labeled_point(theirs, categorical, 3 if categorical else None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    ds = rdd.lp_to_simple_rdd(ours, categorical, 3 if categorical else None, num_partitions=2)
    assert ds.num_partitions == 2
    np.testing.assert_array_equal(ds.labels, want[1])
    np.testing.assert_array_equal(rdd.encode_label(2, 4), jax_rdd.encode_label(2, 4))
    assert rdd.to_simple_rdd(None, x, y).num_partitions == 1
    if categorical:
        with pytest.raises(ValueError, match="outside"):
            rdd.from_labeled_point(ours, True, 2)


def test_synthetic_sets_are_byte_identical():
    cases = [("synthetic_cifar10", (64, 16), {}), ("synthetic_cifar10", (32, 8), {"seed": 3}),
             ("synthetic_mnist", (64, 16), {})]
    for name, args, kw in cases:
        ours = getattr(datasets, name)(*args, **kw)
        theirs = getattr(jax_datasets, name)(*args, **kw)
        for (a, b), (c, d) in zip(ours, theirs):
            assert a.dtype == c.dtype and b.dtype == d.dtype
            assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()
    x, y = datasets.synthetic_cifar10(64, 16)[0]
    assert x.shape == (64, 32, 32, 3) and x.dtype == np.uint8 and y.dtype == np.int64
    np.testing.assert_array_equal(datasets.one_hot(y, 10), jax_datasets.one_hot(y, 10))


def test_loaders_read_the_local_cache_as_jax(tmp_path, monkeypatch):
    """npz archives, and the CIFAR-10 pickle directory, read identically;
    without files MNIST falls back to the synthetic set, flagged."""
    monkeypatch.setenv("ELEPHAS_DATA_DIR", str(tmp_path))
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "mnist.npz", x_train=rng.integers(0, 255, (6, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 6), x_test=rng.integers(0, 255, (2, 28, 28),
                                                                 dtype=np.uint8),
             y_test=rng.integers(0, 10, 2))
    batches = tmp_path / "cifar-10-batches-py"
    batches.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(batches / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 255, (2, 3072), dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 2))}, f)
    for load in ("load_mnist", "load_cifar10"):
        (a, b), (c, d), real = getattr(datasets, load)()
        (e, f_), (g, h), jreal = getattr(jax_datasets, load)()
        assert real is jreal is True
        for got, want in ((a, e), (b, f_), (c, g), (d, h)):
            np.testing.assert_array_equal(got, want)
    assert a.shape == (10, 32, 32, 3)
    monkeypatch.setenv("ELEPHAS_DATA_DIR", str(tmp_path / "missing"))
    train, test, real = datasets.load_mnist()
    assert real is False
    assert train[0].tobytes() == jax_datasets.synthetic_mnist()[0][0].tobytes()


@pytest.mark.parametrize("native_path", [True, False])
def test_host_ops_match_numpy(monkeypatch, native_path):
    """``gather_rows`` (threaded and not, with and without labels, any
    dtype) and ``encode_onehot`` (out-of-range labels give zero rows),
    through the native library and through the numpy fallback."""
    if native_path:
        assert native.available()
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    rng = np.random.default_rng(1)
    for x, y in ((rng.standard_normal((50, 3, 2)).astype(np.float32), rng.integers(0, 9, 50)),
                 (rng.integers(0, 255, (9000, 7), dtype=np.uint8), None)):
        perm = rng.permutation(len(x))[: len(x) - 3]
        for threads in (1, 4):
            gx, gy = native.gather_rows(x, y, perm, n_threads=threads)
            np.testing.assert_array_equal(gx, x[perm])
            assert (gy is None) == (y is None)
            if y is not None:
                np.testing.assert_array_equal(gy, y[perm])
    labels = np.array([0, 3, 1, -1, 4, 2])
    want = np.zeros((6, 4), np.float32)
    for i, c in enumerate(labels):
        if 0 <= c < 4:
            want[i, c] = 1.0
    np.testing.assert_array_equal(native.encode_onehot(labels, 4), want)


def test_host_ops_build_into_the_port(monkeypatch, tmp_path):
    """The library builds from the port's own ``host_ops.cpp`` into a
    directory of the port, not the JAX package's; a corrupt library
    degrades to numpy instead of failing."""
    assert native._SRC.endswith("elephas_tpu_torch/native/host_ops.cpp")
    assert "/elephas_tpu_torch/_build/" in native._LIB_PATH
    fake = tmp_path / "host_ops.so"
    fake.write_bytes(b"not a shared object")
    src = tmp_path / "host_ops.cpp"
    src.write_text("// older than the library")
    os.utime(src, (0, 0))
    monkeypatch.setattr(native, "_LIB_PATH", str(fake))
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(native.gather_rows(x, None, np.array([2, 1, 0]))[0], x[::-1])
    assert native._build_failed


def test_functional_utils_match_jax():
    rng = np.random.default_rng(2)
    a = {"w": rng.standard_normal((3, 2)).astype(np.float32), "b": np.ones(2, np.float32)}
    b = {"w": rng.standard_normal((3, 2)).astype(np.float32), "b": np.full(2, 3, np.float32)}
    ta, tb = ({k: torch.from_numpy(v) for k, v in t.items()} for t in (a, b))
    for ours, theirs in ((fu.add_params(ta, tb), jax_fu.add_params(a, b)),
                         (fu.subtract_params(ta, tb), jax_fu.subtract_params(a, b)),
                         (fu.divide_by(ta, 4), jax_fu.divide_by(a, 4)),
                         (fu.scale_params(ta, 0.5), jax_fu.scale_params(a, 0.5)),
                         (fu.get_neutral_vector(ta), jax_fu.get_neutral_vector(a)),
                         (fu.average_params([ta, tb, ta]), jax_fu.average_params([a, b, a]))):
        assert ours.keys() == theirs.keys()
        for k in ours:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6)
    assert fu.tree_size(ta) == jax_fu.tree_size(a) == 8
    assert float(fu.global_norm(ta)) == pytest.approx(float(jax_fu.global_norm(a)), rel=1e-6)
    with pytest.raises(ValueError):
        fu.average_params([])
    with pytest.raises(ValueError, match="keys"):
        fu.add_params(ta, {"w": ta["w"]})
