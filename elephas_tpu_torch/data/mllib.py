"""MLlib linalg adapters (counterpart of ``elephas_tpu/data/mllib.py``;
reference: ``elephas/mllib/adapter.py``).

The reference converts between numpy and ``pyspark.mllib.linalg``
``Vector``/``Matrix`` types (``to_vector``/``from_vector``/``to_matrix``/
``from_matrix``). pyspark is absent, so this module defines the minimal
dense types with the same accessors plus the four conversion functions,
keeping the ``SparkMLlibModel`` / LabeledPoint path API-complete.
"""

from __future__ import annotations

import numpy as np


class DenseVector:
    """Dense vector with pyspark.mllib's accessor surface."""

    def __init__(self, values):
        self._values = np.asarray(values, dtype=np.float64).reshape(-1)

    def toArray(self) -> np.ndarray:  # noqa: N802
        return self._values

    @property
    def values(self) -> np.ndarray:
        return self._values

    def __len__(self) -> int:
        return len(self._values)

    def __eq__(self, other) -> bool:
        return isinstance(other, DenseVector) and np.array_equal(self._values, other._values)

    def __repr__(self) -> str:
        return f"DenseVector({self._values.tolist()})"


class DenseMatrix:
    """Dense matrix, column-major like pyspark.mllib (numRows, numCols, values)."""

    def __init__(self, num_rows: int, num_cols: int, values):
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        if values.size != num_rows * num_cols:
            raise ValueError("values size does not match matrix shape")
        self.numRows = int(num_rows)  # noqa: N815 (pyspark parity)
        self.numCols = int(num_cols)  # noqa: N815
        self._values = values

    def toArray(self) -> np.ndarray:  # noqa: N802
        # pyspark stores column-major.
        return self._values.reshape(self.numCols, self.numRows).T

    @property
    def values(self) -> np.ndarray:
        return self._values

    def __repr__(self) -> str:
        return f"DenseMatrix({self.numRows}x{self.numCols})"


def to_vector(np_array: np.ndarray) -> DenseVector:
    """1-D numpy array -> DenseVector (reference ``to_vector``)."""
    arr = np.asarray(np_array)
    if arr.ndim != 1:
        raise ValueError(f"to_vector expects a 1-D array, got shape {arr.shape}")
    return DenseVector(arr)


def from_vector(vector: DenseVector) -> np.ndarray:
    """DenseVector -> numpy array (reference ``from_vector``)."""
    return vector.toArray()


def to_matrix(np_array: np.ndarray) -> DenseMatrix:
    """2-D numpy array -> DenseMatrix (reference ``to_matrix``)."""
    arr = np.asarray(np_array)
    if arr.ndim != 2:
        raise ValueError(f"to_matrix expects a 2-D array, got shape {arr.shape}")
    return DenseMatrix(arr.shape[0], arr.shape[1], arr.T.reshape(-1))


def from_matrix(matrix: DenseMatrix) -> np.ndarray:
    """DenseMatrix -> numpy array (reference ``from_matrix``)."""
    return matrix.toArray()
