"""Sequence-parallel (data × seq) language-model training (counterpart of
``elephas_tpu/parallel/seq_parallel.py``).

The batch is sharded over the mesh's ``'data'`` axis and the sequence
over its ``'seq'`` axis: each process holds the [d, s] block of the
(batch, seq) tokens, its model's attention (``attention='ring'`` or
``'ulysses'``, or ``'auto'``) spans the sharded sequence through the seq
group's collectives, and the gradients and metrics are averaged over
data × seq in one all-reduce each (``make_train_step`` with
``pmean_axis=(DATA_AXIS, SEQ_AXIS)``). The sequence never exists
unsharded on any device, so context length scales with the seq-axis
size.

Each step binds the mesh (``parallel.mesh.bind_mesh``) around the
engine's standard step, as the JAX package runs it inside ``shard_map``:
the model finds its sequence group and its global positions there. The
LM has no dropout, so the JAX package's per-shard fold of the PRNG key
has nothing to draw here.

Every process calls the same functions with the same arrays (SPMD): the
shuffles are seeded identically, so every rank follows the same
schedule, and each takes its own block.

When the mesh also has a ``'model'`` axis above 1 (sp × tp, the JAX
package's GSPMD ``'model'`` axis beside its manual ``'data'`` and
``'seq'``), the module is sharded by tensor-parallel rules
(``init_lm_state(..., rules=)`` or ``SeqParallelTrainer(rules=)``;
default ``tensor_parallel.LM_RULES``): each rank's attention runs the
ring or Ulysses exchange on its own heads, the model group carries the
tensor-parallel collectives, and the data × seq average is that of the
rank's own model index. The model ranks of one [d, s] block take the
same tokens.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.engine.step import (
    init_train_state,
    make_eval_step,
    make_train_step,
    weighted_mean_over_chunks,
)
from elephas_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    bind_mesh,
)

logger = logging.getLogger("elephas_tpu_torch")


def _shard(compiled, mesh, rules) -> None:
    """Shard the module over the mesh's model axis (where it is above 1)."""
    if mesh.model_size > 1:
        from elephas_tpu_torch.parallel.tensor_parallel import shard_module

        shard_module(compiled.module, mesh, rules)


def _bound(step_fn, compiled, mesh):
    def step(*args):
        if mesh.model_size > 1 and getattr(compiled.module, "_tensor_parallel", None) is None:
            raise ValueError(
                f"a mesh with a model axis of {mesh.model_size} steps a tensor-parallel "
                "module: shard it first (init_lm_state(..., rules=) or "
                "tensor_parallel.shard_module)")
        with bind_mesh(mesh):
            return step_fn(*args)

    return step


def make_lm_train_step(compiled, mesh):
    """Build ``step(state, tokens, targets) -> (state, metrics)`` over
    ``mesh``: tokens and targets are this rank's [d, s] block
    (``shard_lm_batch``), the metrics come back replicated (averaged over
    data × seq).

    tokens: (batch / num_data, seq / num_seq) int64 on the model's device;
    targets: what ``compiled``'s loss expects per position (next-token
    ids for the LM losses; callers shift before sharding so shard
    boundaries stay aligned)."""
    return _bound(make_train_step(compiled, pmean_axis=(DATA_AXIS, SEQ_AXIS)), compiled, mesh)


def make_lm_eval_step(compiled, mesh):
    """Deterministic ``eval(state, tokens, targets) -> metrics`` under the
    same data × seq sharding as the train step: metrics on the local
    block, averaged over data × seq (exact global means: the blocks have
    equal sizes)."""
    return _bound(make_eval_step(compiled, pmean_axis=(DATA_AXIS, SEQ_AXIS)), compiled, mesh)


def shard_lm_batch(mesh, tokens: np.ndarray, targets: np.ndarray,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's [d, s] block of (batch, seq) token arrays as int64
    tensors on ``device`` (the JAX package places the whole arrays with
    P('data', 'seq') sharding; here each process keeps its own block)."""
    tokens, targets = np.asarray(tokens), np.asarray(targets)
    rows, cols = tokens.shape[0] // mesh.size, tokens.shape[1] // mesh.seq_size
    block = (slice(mesh.rank * rows, (mesh.rank + 1) * rows),
             slice(mesh.seq_rank * cols, (mesh.seq_rank + 1) * cols))
    return tuple(torch.as_tensor(np.ascontiguousarray(a[block]), dtype=torch.int64,
                                 device=device) for a in (tokens, targets))


def init_lm_state(compiled, mesh, rng=None, rules=None) -> TrainState:
    """TrainState for ``make_lm_train_step``: the parameters replicated
    over the data and seq axes, which every rank's own copy is when the
    ranks build the model alike (the same seed, or the same
    ``state_dict``), as the JAX package's replicated placement of each
    host's values assumes; on a mesh whose model axis is above 1, the
    module is first sharded over it by ``rules`` (default
    ``tensor_parallel.LM_RULES``)."""
    _shard(compiled, mesh, rules)
    return init_train_state(compiled, rng=rng)


class SeqParallelTrainer:
    """Fit-shaped driver for sequence-parallel LM training: epochs,
    shuffling, per-epoch validation, history, callbacks and resume, as
    ``SparkModel.fit`` gives the other workloads, over the data × seq
    step builders above.

    Build a ``TransformerLM`` with ``attention='ring' | 'ulysses' |
    'auto'``, pick a mesh (``build_mesh(num_data=D, num_seq=S[,
    num_model=M])``; with M above 1 the module is sharded here by
    ``rules``), and
    call ``fit`` on a (rows, seq+1) token array. Every process calls
    ``fit`` with the SAME arrays (SPMD: shuffles are seeded identically,
    so every rank sees the same schedule).
    """

    def __init__(self, compiled, mesh, rules=None):
        _shard(compiled, mesh, rules)
        self.compiled = compiled
        self.mesh = mesh
        self.rules = rules
        self.n_data = mesh.size
        self.n_seq = mesh.seq_size
        self.device = next(compiled.module.parameters()).device
        self._train = make_lm_train_step(compiled, mesh)
        self._eval = make_lm_eval_step(compiled, mesh)

    def _check_seq(self, tokens: np.ndarray) -> None:
        seq = tokens.shape[1] - 1
        if seq % self.n_seq != 0:
            raise ValueError(
                f"sequence length {seq} (tokens.shape[1]-1) must divide "
                f"by the seq-axis size {self.n_seq}"
            )

    def _check_batch(self, tokens: np.ndarray, batch_size: int) -> None:
        if batch_size % self.n_data != 0:
            raise ValueError(
                f"batch_size {batch_size} must divide by the data-axis "
                f"size {self.n_data} (each data shard takes "
                "batch_size/num_data rows)"
            )
        self._check_seq(tokens)

    def _block(self, rows):
        return shard_lm_batch(self.mesh, rows[:, :-1], rows[:, 1:], self.device)

    def fit(
        self,
        tokens: np.ndarray,
        epochs: int = 1,
        batch_size: int = 8,
        validation_tokens=None,
        val_batch_size: int = None,
        callbacks=(),
        initial_state: TrainState = None,
        rng=None,
        seed: int = 0,
        verbose: int = 0,
    ):
        """Train on ``tokens``, a (rows, seq+1) int array; position t
        predicts position t+1 (the shift happens here so shard
        boundaries stay aligned). Returns ``(state, history)`` with
        per-epoch ``loss`` (and ``val_loss`` when ``validation_tokens``
        is given; ``val_batch_size`` defaults to as much of
        ``batch_size`` as the validation set allows). ``callbacks``:
        ``(epoch, state, metrics)`` callables. Resuming via
        ``initial_state`` continues the shuffle schedule from the
        restored step, so a 2+2-epoch resumed fit sees the batch order of
        a straight 4-epoch one.
        """
        tokens = np.asarray(tokens)
        self._check_batch(tokens, batch_size)
        nb = len(tokens) // batch_size
        if nb == 0:
            raise ValueError(
                f"{len(tokens)} rows < batch_size {batch_size}"
            )
        state = initial_state if initial_state is not None else init_lm_state(
            self.compiled, self.mesh, rng=rng, rules=self.rules
        )
        epoch0 = int(state.step) // nb  # resumed fits continue the schedule
        history = {"loss": []}
        for epoch in range(epochs):
            # Per-epoch stream keyed on the GLOBAL epoch index: identical
            # on every rank, and stable under resume.
            perm = np.random.default_rng(
                [seed, 17, epoch0 + epoch]
            ).permutation(len(tokens))[: nb * batch_size]
            device_metrics = []
            for b in range(nb):
                rows = tokens[perm[b * batch_size:(b + 1) * batch_size]]
                state, metrics = self._train(state, *self._block(rows))
                device_metrics.append(metrics)
            fetched = [{k: float(v) for k, v in m.items()} for m in device_metrics]
            epoch_metrics = {
                k: float(np.mean([m[k] for m in fetched])) for k in fetched[0]
            }
            history["loss"].append(epoch_metrics["loss"])
            if validation_tokens is not None:
                val = self.evaluate(
                    state, validation_tokens, val_batch_size or batch_size
                )
                for k, v in val.items():
                    history.setdefault(f"val_{k}", []).append(v)
            for cb in callbacks:
                cb(epoch, state, epoch_metrics)
            if verbose:
                print(f"[seq-parallel] epoch {epoch}: "
                      + ", ".join(f"{k}={v[-1]:.4f}" for k, v in history.items()))
        return state, history

    def evaluate(self, state, tokens, batch_size: int = 8):
        """Mean metrics over ``tokens`` ((rows, seq+1)), exact across a
        ragged final batch (it runs at its own shape, weighted by row
        count). ``batch_size`` is clamped to the set's size; only rows
        beyond the last data-axis multiple are dropped (with a warning),
        since a partial batch must still shard over 'data'."""
        tokens = np.asarray(tokens)
        self._check_seq(tokens)
        usable = (len(tokens) // self.n_data) * self.n_data
        if usable == 0:
            raise ValueError(
                f"{len(tokens)} rows cannot shard over the {self.n_data}-way "
                "data axis"
            )
        if usable < len(tokens):
            logger.warning(
                "evaluate: dropping %d of %d rows (not a multiple of the "
                "%d-way data axis)", len(tokens) - usable, len(tokens),
                self.n_data,
            )
        # Clamp to [n_data, usable] on data-axis multiples: rounding DOWN
        # past n_data would make a zero-row batch and never advance.
        batch_size = max(
            self.n_data,
            min(batch_size, usable) // self.n_data * self.n_data,
        )
        self._check_batch(tokens, batch_size)
        spans = []
        start = 0
        while start < usable:
            stop = min(start + batch_size, usable)
            spans.append((start, stop, len(spans)))
            start = stop
        device_metrics = [self._eval(state, *self._block(tokens[start:stop]))
                          for start, stop, _ in spans]
        return weighted_mean_over_chunks(
            spans, lambda start, stop, i: device_metrics[i], usable
        )
