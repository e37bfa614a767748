"""Checkpoint / resume (counterpart of ``elephas_tpu/checkpoint/``).

The reference saves only the final model after ``fit``
(``SparkModel.save``); these periodic snapshots of the weights, the
optimizer state, the generator and the step let a restarted job resume.
"""

from elephas_tpu_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    NoCheckpointError,
    latest_step,
    restore_train_state,
    save_train_state,
)
