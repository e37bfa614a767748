"""Parallelism layer (counterpart of ``elephas_tpu/parallel/``): the
process mesh, its collectives, sequence-parallel attention and training,
and multi-process coordination.

The JAX package's tensors ride XLA collectives inside compiled programs;
the port's ride ``torch.distributed`` (NCCL between cards, gloo on the
CPU or between processes that share one card). The JAX package's
``data_sharding`` and ``replicated_sharding`` place ``jax.Array``s and
have no counterpart: each process holds its own tensors. Tensor
parallelism (``tensor_parallel.py``) is not ported yet (ROADMAP.md,
queue 1, item 6b).
"""

from elephas_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    bind_mesh,
    build_mesh,
    local_device_count,
)


def __getattr__(name):
    # Loaded on first use: seq_parallel needs engine.step, which needs
    # parallel.mesh, so importing it here would be a cycle.
    if name == "SeqParallelTrainer":
        from elephas_tpu_torch.parallel.seq_parallel import SeqParallelTrainer

        return SeqParallelTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
