"""Parallelism layer (counterpart of ``elephas_tpu/parallel/``): the
process mesh, its collectives, sequence-parallel attention and training,
tensor parallelism, and multi-process coordination.

The JAX package's tensors ride XLA collectives inside compiled programs;
the port's ride ``torch.distributed`` (NCCL between cards, gloo on the
CPU or between processes that share one card). The JAX package's
``data_sharding`` and ``replicated_sharding`` place ``jax.Array``s and
have no counterpart: each process holds its own tensors, and under
tensor parallelism (``tensor_parallel.py``) its own shards of the
parameters, with the collectives GSPMD would insert placed by hand.
"""

from elephas_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    bind_mesh,
    build_mesh,
    local_device_count,
)


_TENSOR_PARALLEL = ("LM_RULES", "P", "param_specs", "lm_param_specs", "decode_cache_specs",
                    "make_train_step_tp", "init_state_tp", "make_lm_train_step_tp",
                    "init_lm_state_tp", "shard_module")


def __getattr__(name):
    # Loaded on first use: seq_parallel and tensor_parallel need
    # engine.step, which needs parallel.mesh, so importing them here would
    # be a cycle.
    if name == "SeqParallelTrainer":
        from elephas_tpu_torch.parallel.seq_parallel import SeqParallelTrainer

        return SeqParallelTrainer
    if name in _TENSOR_PARALLEL:
        from elephas_tpu_torch.parallel import tensor_parallel

        return getattr(tensor_parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
