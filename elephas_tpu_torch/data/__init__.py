"""Data layer (counterpart of ``elephas_tpu/data/``): sharded datasets, the
columnar DataFrame of the ML pipeline, the MLlib adapters and the
benchmark datasets."""

from elephas_tpu_torch.data.rdd import (  # noqa: F401
    LabeledPoint,
    ShardedDataset,
    encode_label,
    from_labeled_point,
    lp_to_simple_rdd,
    to_labeled_point,
    to_simple_rdd,
)
from elephas_tpu_torch.data.dataframe import DataFrame  # noqa: F401
from elephas_tpu_torch.data import datasets  # noqa: F401
