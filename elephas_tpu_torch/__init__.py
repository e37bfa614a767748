"""elephas_tpu_torch — the PyTorch/CUDA port of ``elephas_tpu``.

The package mirrors the JAX package module for module (``models/``,
``ops/``, ``api/``, ``engine/``, ``data/``, ``parallel/``, ``native/``,
``metrics/``, ``utils/``) so each file has one obvious reference, and
imports nothing of JAX or of ``elephas_tpu``. Plain tensor code is
PyTorch; the Pallas kernels of the JAX package are hand-written CUDA
kernels under ``csrc/``, built with ``nvcc`` at first use
(``ops/attention_cuda.py``).

Entry points (``models.get_model``, ``api.CompiledModel``,
``models.transformer.generate``, ``engine.step.make_train_step``,
``SparkModel``) run on ``cuda`` unless the caller passes
``device="cpu"`` to ``get_model``; without a GPU and without that
argument they raise.

Importing the package builds and loads nothing: a kernel library (or the
host-ops library, ``native/``) is built and loaded where one of its
functions is first called.
"""

__version__ = "0.1.0"

from elephas_tpu_torch.api.compile import CompiledModel, compile_model  # noqa: E402,F401
from elephas_tpu_torch.api.spark_model import (  # noqa: E402,F401
    SparkModel,
    TpuModel,
    load_spark_model,
)
from elephas_tpu_torch.data.rdd import ShardedDataset, to_simple_rdd  # noqa: E402,F401
