"""Distributed hyperparameter search — compatibility façade
(counterpart of ``elephas_tpu/hyperparam.py``).

The implementation lives in ``elephas_tpu_torch/tune/`` (``search.py``
carries the ``hp`` combinators, the samplers and ``HyperParamModel``;
scheduler/runner/vault add the elastic ASHA frontend). This module is
the reference-parity import path
(``elephas/hyperparam.py::HyperParamModel``, SURVEY.md §2.1/§3.4).
"""

from __future__ import annotations

from elephas_tpu_torch.tune.search import (  # noqa: F401
    HyperParamModel,
    _SAMPLERS,
    _Choice,
    _Dist,
    _LogUniform,
    _QUniform,
    _RandInt,
    _RandomSampler,
    _TPESampler,
    _Uniform,
    _iter_nodes,
    _substitute,
    _trial_ctx,
    current_trial_device,
    hp,
    sample_space,
    width_bucket,
)

__all__ = [
    "hp", "HyperParamModel", "sample_space", "current_trial_device",
    "width_bucket",
]
