"""Train state (counterpart of ``elephas_tpu/engine/state.py``).

The JAX package keeps training functional: an explicit pytree of params,
batch statistics, optimizer state, step counter and PRNG key. In the
port the parameters are the module's own tensors, updated in place by
the optimizer, so the state holds what is left: the step, the optimizer
(whose ``state`` is optax's ``opt_state``), a ``torch.Generator`` in the
PRNG key's place, and the batch statistics (empty for the LM).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class TrainState:
    step: int
    optimizer: torch.optim.Optimizer
    rng: torch.Generator
    batch_stats: dict = field(default_factory=dict)

    @property
    def opt_state(self):
        """The optimizer's per-parameter state (optax's ``opt_state``)."""
        return self.optimizer.state

    @classmethod
    def create(cls, optimizer, batch_stats=None, rng: Optional[torch.Generator] = None,
               step: int = 0) -> "TrainState":
        if rng is None:
            rng = torch.Generator().manual_seed(0)
        return cls(step=step, optimizer=optimizer, rng=rng,
                   batch_stats=batch_stats if batch_stats is not None else {})
