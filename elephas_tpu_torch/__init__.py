"""elephas_tpu_torch — the PyTorch/CUDA port of ``elephas_tpu``.

The package mirrors the JAX package module for module (``models/``,
``ops/``, ``api/``, ``engine/``, ``metrics/``) so each file has one
obvious reference, and imports nothing of JAX or of ``elephas_tpu``.
Plain tensor code is PyTorch; the Pallas kernels of the JAX package are
hand-written CUDA kernels under ``csrc/``, built with ``nvcc`` at first
use (``ops/attention_cuda.py``).

Entry points (``models.get_model``, ``api.CompiledModel``,
``models.transformer.generate``, ``engine.step.make_train_step``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without that argument they raise.

Importing the package builds and loads nothing: a kernel library is
built and loaded where one of its kernels is first launched.
"""

__version__ = "0.1.0"
