"""ML-pipeline façade (counterpart of ``elephas_tpu/ml/``; reference
``elephas/ml_model.py`` and ``elephas/ml/``)."""

from elephas_tpu_torch.ml.ml_model import (  # noqa: F401
    ElephasEstimator,
    ElephasTransformer,
    load_ml_estimator,
    load_ml_transformer,
)
