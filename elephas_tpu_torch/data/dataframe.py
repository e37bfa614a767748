"""Minimal columnar DataFrame for the ML-pipeline façade (counterpart of
``elephas_tpu/data/dataframe.py``; the same columns and arrays).

The reference's ``ElephasEstimator`` operates on ``pyspark.sql.DataFrame``.
pyspark does not exist here, so this module provides the small columnar
surface the pipeline uses: named columns of numpy arrays,
``select``/``withColumn``, and conversion to/from pandas. It is a data
structure, not a query engine; the data-parallel split happens in
``ShardedDataset`` and the trainers. The one-hot encoding is the port's
own native host op (``elephas_tpu_torch.native``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class DataFrame:
    """Immutable named columns of equal-length numpy arrays."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        if not columns:
            raise ValueError("DataFrame needs at least one column")
        lengths = {name: len(np.asarray(col)) for name, col in columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"column length mismatch: {lengths}")
        self._columns = {name: np.asarray(col) for name, col in columns.items()}

    # -- pyspark-flavored surface ---------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return len(next(iter(self._columns.values())))

    def count(self) -> int:
        return len(self)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    def select(self, *names: str) -> "DataFrame":
        missing = [n for n in names if n not in self._columns]
        if missing:
            raise KeyError(f"unknown column(s): {missing}")
        return DataFrame({n: self._columns[n] for n in names})

    def with_column(self, name: str, values: np.ndarray) -> "DataFrame":
        new = dict(self._columns)
        new[name] = np.asarray(values)
        return DataFrame(new)

    # Spark camelCase alias used by reference-era user code.
    withColumn = with_column  # noqa: N815

    def drop(self, *names: str) -> "DataFrame":
        return DataFrame({n: c for n, c in self._columns.items() if n not in names})

    def limit(self, n: int) -> "DataFrame":
        return DataFrame({name: col[:n] for name, col in self._columns.items()})

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(
            {
                name: (list(col) if col.ndim > 1 else col)
                for name, col in self._columns.items()
            }
        )

    toPandas = to_pandas  # noqa: N815

    @staticmethod
    def from_pandas(pdf) -> "DataFrame":
        cols = {}
        for name in pdf.columns:
            values = pdf[name].to_numpy()
            if values.dtype == object:
                values = np.stack([np.asarray(v) for v in values])
            cols[name] = values
        return DataFrame(cols)

    def head(self, n: int = 5):
        return {name: col[:n] for name, col in self._columns.items()}

    def __repr__(self) -> str:
        shapes = {n: tuple(c.shape) for n, c in self._columns.items()}
        return f"DataFrame({shapes})"


def to_data_frame(sc, features: np.ndarray, labels: np.ndarray, categorical: bool = False) -> DataFrame:
    """Arrays -> DataFrame (reference ``elephas/ml/adapter.py::to_data_frame``).

    ``categorical=True`` means labels arrive one-hot and are stored as the
    scalar class index in the ``label`` column, like the reference.
    """
    del sc
    labels = np.asarray(labels)
    if categorical:
        label_col = np.argmax(labels, axis=-1).astype(np.float32)
    else:
        label_col = np.squeeze(labels).astype(np.float32)
    return DataFrame({"features": np.asarray(features), "label": label_col})


def from_data_frame(
    df: DataFrame,
    categorical: bool = False,
    nb_classes: Optional[int] = None,
    features_col: str = "features",
    label_col: str = "label",
):
    """DataFrame -> (features, labels) arrays (reference ``from_data_frame``)."""
    features = df[features_col]
    labels = df[label_col]
    if categorical:
        from elephas_tpu_torch.native import encode_onehot

        if nb_classes is None:
            nb_classes = int(labels.max()) + 1
        int_labels = labels.astype(np.int64)
        if int_labels.size and (int_labels.min() < 0 or int_labels.max() >= nb_classes):
            raise ValueError(
                f"labels outside [0, {nb_classes}): "
                f"min={int_labels.min()}, max={int_labels.max()}"
            )
        labels = encode_onehot(int_labels, nb_classes)
    return features, labels


def df_to_simple_rdd(
    df: DataFrame,
    categorical: bool = False,
    nb_classes: Optional[int] = None,
    features_col: str = "features",
    label_col: str = "label",
    num_partitions: int = 1,
):
    """DataFrame -> ShardedDataset (reference ``df_to_simple_rdd``)."""
    from elephas_tpu_torch.data.rdd import ShardedDataset

    features, labels = from_data_frame(df, categorical, nb_classes, features_col, label_col)
    return ShardedDataset(features, labels, num_partitions)
