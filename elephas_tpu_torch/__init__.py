"""elephas_tpu_torch — the PyTorch/CUDA port of ``elephas_tpu``.

The package mirrors the JAX package module for module (``models/``,
``ops/``, ``api/``, ``engine/``, ``data/``, ``parallel/``, ``native/``,
``metrics/``, ``serving/``, ``obs/``, ``parameter/``, ``resilience/``,
``ml/``, ``serialize/``, ``checkpoint/``, ``tune/``, ``utils/``) so each file has
one obvious reference, and
imports nothing of JAX or of ``elephas_tpu``. Plain tensor code is
PyTorch; the Pallas kernels of the JAX package are hand-written CUDA
kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/attention_cuda.py``).

Entry points (``models.get_model``, ``api.CompiledModel``,
``models.transformer.generate``, ``engine.step.make_train_step``,
``SparkModel`` in every mode, ``AsyncTrainer``, the parameter servers,
``serving.InferenceEngine``, ``ElephasEstimator``/``ElephasTransformer``,
``dict_to_model``, ``load_spark_model`` and ``HyperParamModel``) run on
``cuda`` unless the caller passes ``device="cpu"`` (to ``get_model``, a
parameter server, the estimator, the transformer, the loaders or the
search; the async workers: ``mesh=["cpu"] * n``); without a GPU and
without that argument they raise.

Importing the package builds and loads nothing: a kernel library (or the
host-ops library, ``native/``) is built and loaded where one of its
functions is first called.
"""

__version__ = "0.1.0"

from elephas_tpu_torch.api.compile import CompiledModel, compile_model  # noqa: E402,F401
from elephas_tpu_torch.api.spark_model import (  # noqa: E402,F401
    SparkMLlibModel,
    SparkModel,
    TpuModel,
    load_spark_model,
)
from elephas_tpu_torch.data.dataframe import DataFrame  # noqa: E402,F401
from elephas_tpu_torch.data.rdd import ShardedDataset, to_simple_rdd  # noqa: E402,F401
from elephas_tpu_torch.engine.async_engine import AsyncTrainer  # noqa: E402,F401
from elephas_tpu_torch.hyperparam import (  # noqa: E402,F401
    HyperParamModel,
    current_trial_device,
    hp,
)
from elephas_tpu_torch.ml.ml_model import ElephasEstimator, ElephasTransformer  # noqa: E402,F401
from elephas_tpu_torch.models.cnn import SimpleCNN  # noqa: E402,F401
from elephas_tpu_torch.serialize.serialization import (  # noqa: E402,F401
    dict_to_model,
    model_to_dict,
)
from elephas_tpu_torch import parameter  # noqa: E402,F401
