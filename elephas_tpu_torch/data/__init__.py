"""Data layer (counterpart of ``elephas_tpu/data/``): sharded datasets and
the benchmark datasets. The DataFrame and MLlib adapters arrive with the
ML façade (ROADMAP.md, queue 1)."""

from elephas_tpu_torch.data.rdd import (  # noqa: F401
    LabeledPoint,
    ShardedDataset,
    encode_label,
    from_labeled_point,
    lp_to_simple_rdd,
    to_labeled_point,
    to_simple_rdd,
)
from elephas_tpu_torch.data import datasets  # noqa: F401
