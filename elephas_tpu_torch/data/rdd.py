"""ShardedDataset — the port's "RDD" (counterpart of ``elephas_tpu/data/rdd.py``).

Reference: ``elephas/utils/rdd_utils.py::{to_simple_rdd, to_labeled_point,
from_labeled_point, lp_to_simple_rdd, encode_label}`` (SURVEY.md §2.1).

In the reference, training data is a Spark RDD of ``(features, label)``
numpy pairs and each RDD *partition* becomes one worker's shard; Spark
owns placement. Here the same contract is a ``ShardedDataset``: features
and labels held as contiguous numpy arrays plus an explicit partition map,
so that

- partition ``i`` is the rows of data-group rank ``i`` (``engine/sync.py``
  uploads each rank's own rows to its device), and
- partition-faithful iteration (``partition(i)``) reproduces the
  reference's per-worker local-training semantics for parity tests.

The numpy logic is the JAX package's, line for line; only the native
gather comes from the port's own copy (``elephas_tpu_torch.native``).

No Spark driver exists, so ``to_simple_rdd(sc, ...)`` keeps its reference
signature with ``sc`` accepted-and-ignored (pass ``None``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


@dataclass
class LabeledPoint:
    """Minimal stand-in for ``pyspark.mllib.regression.LabeledPoint``."""

    label: float
    features: np.ndarray


def encode_label(label, nb_classes: int) -> np.ndarray:
    """One-hot encode a scalar label (reference ``encode_label``)."""
    out = np.zeros(nb_classes, dtype=np.float32)
    out[int(label)] = 1.0
    return out


class ShardedDataset:
    """A partitioned ``(features, labels)`` dataset — the "RDD".

    Parameters
    ----------
    features, labels:
        numpy arrays with matching leading dimension. ``labels`` may be
        ``None`` for inference-only datasets.
    num_partitions:
        number of logical worker shards (reference: RDD partitions).
    """

    def __init__(
        self,
        features: np.ndarray,
        labels: Optional[np.ndarray] = None,
        num_partitions: int = 1,
    ):
        features = np.asarray(features)
        if labels is not None:
            labels = np.asarray(labels)
            if len(labels) != len(features):
                raise ValueError(
                    f"features/labels length mismatch: {len(features)} vs {len(labels)}"
                )
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        if len(features) < num_partitions:
            raise ValueError(
                f"cannot split {len(features)} rows into {num_partitions} partitions"
            )
        self.features = features
        self.labels = labels
        self.num_partitions = int(num_partitions)
        # Contiguous equal-ish split, like Spark's default range partitioning
        # of a parallelized collection.
        self._bounds = np.linspace(0, len(features), self.num_partitions + 1).astype(int)

    # -- reference RDD surface -------------------------------------------------

    def __len__(self) -> int:
        return len(self.features)

    def count(self) -> int:
        return len(self)

    def getNumPartitions(self) -> int:  # noqa: N802 (Spark camelCase parity)
        return self.num_partitions

    def repartition(self, num_partitions: int) -> "ShardedDataset":
        """Return a new dataset with a different shard count (cheap: no copy)."""
        return ShardedDataset(self.features, self.labels, num_partitions)

    def partition(self, index: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The ``(features, labels)`` slice owned by worker ``index``."""
        lo, hi = self._bounds[index], self._bounds[index + 1]
        labels = None if self.labels is None else self.labels[lo:hi]
        return self.features[lo:hi], labels

    def partitions(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        for i in range(self.num_partitions):
            yield self.partition(i)

    def partition_sizes(self) -> Sequence[int]:
        return list(np.diff(self._bounds))

    def shuffle(self, seed: int = 0) -> "ShardedDataset":
        """Globally permute rows (new dataset, same partitioning)."""
        from elephas_tpu_torch.native import gather_rows

        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(self.features))
        features, labels = gather_rows(self.features, self.labels, perm)
        return ShardedDataset(features, labels, self.num_partitions)

    def take(self, n: int):
        if self.labels is None:
            return self.features[:n]
        return list(zip(self.features[:n], self.labels[:n]))

    # -- data-parallel surface ----------------------------------------------------

    def even_shards(self, n_shards: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Truncate to a multiple of ``n_shards`` and return stackable arrays.

        Data-parallel batches need equal shard sizes (every rank steps in
        lockstep), whereas Spark tolerates ragged partitions. Truncation
        (< n_shards rows) matches the
        reference's effective behavior of dropping remainder batches.
        """
        usable = (len(self.features) // n_shards) * n_shards
        labels = None if self.labels is None else self.labels[:usable]
        return self.features[:usable], labels


def to_simple_rdd(
    sc,
    features: np.ndarray,
    labels: np.ndarray,
    num_partitions: Optional[int] = None,
) -> ShardedDataset:
    """Build a ShardedDataset from arrays (reference ``to_simple_rdd``).

    ``sc`` (SparkContext in the reference) is accepted for signature parity
    and ignored — there is no Spark driver.
    """
    del sc
    if num_partitions is None:
        num_partitions = 1
    return ShardedDataset(features, labels, num_partitions)


def to_labeled_point(
    sc,
    features: np.ndarray,
    labels: np.ndarray,
    categorical: bool = False,
) -> list:
    """Arrays -> list of LabeledPoint (reference ``to_labeled_point``).

    With ``categorical=True`` the labels are one-hot rows and the point
    label is the argmax class index, mirroring the reference.
    """
    del sc
    points = []
    for x, y in zip(features, labels):
        label = float(np.argmax(y)) if categorical else float(np.squeeze(y))
        points.append(LabeledPoint(label, np.asarray(x)))
    return points


def from_labeled_point(
    lp_list,
    categorical: bool = False,
    nb_classes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """List of LabeledPoint -> (features, labels) arrays."""
    features = np.stack([np.asarray(lp.features) for lp in lp_list])
    if categorical:
        from elephas_tpu_torch.native import encode_onehot

        if nb_classes is None:
            nb_classes = int(max(lp.label for lp in lp_list)) + 1
        int_labels = np.array([lp.label for lp in lp_list], dtype=np.int64)
        if int_labels.size and (int_labels.min() < 0 or int_labels.max() >= nb_classes):
            raise ValueError(
                f"labels outside [0, {nb_classes}): "
                f"min={int_labels.min()}, max={int_labels.max()}"
            )
        labels = encode_onehot(int_labels, nb_classes)
    else:
        labels = np.array([lp.label for lp in lp_list], dtype=np.float32)
    return features, labels


def lp_to_simple_rdd(
    lp_list,
    categorical: bool = False,
    nb_classes: Optional[int] = None,
    num_partitions: int = 1,
) -> ShardedDataset:
    """LabeledPoints -> ShardedDataset (reference ``lp_to_simple_rdd``)."""
    features, labels = from_labeled_point(lp_list, categorical, nb_classes)
    return ShardedDataset(features, labels, num_partitions)
