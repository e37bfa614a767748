"""Trial checkpoint vault: rung state that survives its worker
(counterpart of ``elephas_tpu/tune/vault.py``).

A promoted trial must RESUME — retraining rungs 0..r-1 after every
promotion turns ASHA's geometric saving back into linear cost, and a
worker kill mid-search must not reset its trials. ``save(trial, rung,
loss, state)`` after a rung completes, ``load(trial)`` before running
one. A state is a tree (nested dicts, lists, tuples) of tensors, NumPy
arrays or scalars — a CPU ``state_dict`` from
``CompiledModel.get_weights`` or a NumPy tree; a load returns the kind
of each leaf it was saved with (tensor leaves as CPU tensors, other
leaves as NumPy arrays), shapes and dtypes kept.

Two backends:

- ``MemoryVault`` — in-process; a checkpoint is stored as one packed
  wire frame (``parameter/wire.py``), the bytes a parameter push ships.
- ``GroupVault`` — checkpoints live ON a parameter server: the store is
  ``{t<i>: {"state": ..., "rung": -1, "loss": 0}}`` (``build_store``).
  The server applies a push as ``weights -= delta`` (the buffer's
  convention), so a save is two pushes onto the trial's slot: the
  pulled slot itself (which leaves it exactly zero), then the negated
  new values (which leave it exactly the new values) — bitwise, where a
  single push of ``old - new`` would round. Other trials' slots get
  zero deltas, so saves of disjoint trials compose. (The JAX package's
  ``GroupVault`` pushes ``new - old``, the additive convention.)

Zombie writes: lease fencing means at most one LIVE worker owns a
trial, and the scheduler/ledger fence duplicate *accounting*; a zombie
that re-saves a rung writes the deterministically identical state
(seeded trials), so vault content is last-writer-wins over equal
values.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from elephas_tpu_torch.parameter import wire
from elephas_tpu_torch.utils import locksan

__all__ = ["GroupVault", "MemoryVault", "TrialCheckpoint"]


class TrialCheckpoint(NamedTuple):
    state: Any          # the trial_fn's numeric tree
    rung: int           # highest rung this state has completed
    loss: float         # loss recorded at that rung


def _tree_map(fn, *trees):
    a = trees[0]
    if isinstance(a, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _kind(leaf) -> bool:
    """True for a tensor leaf (restored as a CPU tensor), False for the
    rest (restored as a NumPy array)."""
    return isinstance(leaf, torch.Tensor)


def _restore(leaf: torch.Tensor, is_tensor: bool):
    """A writable copy of a decoded (CPU tensor) leaf, in its saved kind
    (bfloat16, which NumPy lacks, stays a tensor). Decoded leaves may view
    the frame: copy so the resumed trial can train in place without
    touching the checkpoint."""
    leaf = leaf.detach().cpu().clone()
    return leaf if is_tensor or leaf.dtype == torch.bfloat16 else leaf.numpy()


class MemoryVault:
    """In-process vault; checkpoints are stored as packed wire frames
    (encode on save, decode on load), so the codec path the GroupVault
    rides is exercised too."""

    def __init__(self):
        self._lock = locksan.make_lock("MemoryVault._lock")
        self._frames: Dict[int, bytes] = {}
        self._meta: Dict[int, Dict[str, Any]] = {}

    def save(self, trial_id: int, rung: int, loss: float, state) -> None:
        buf = wire.encode_tree(state, version=int(rung)).tobytes()
        kinds = _tree_map(_kind, state)
        with self._lock:
            self._frames[int(trial_id)] = buf
            self._meta[int(trial_id)] = {"rung": int(rung), "loss": float(loss),
                                         "kinds": kinds}

    def load(self, trial_id: int) -> Optional[TrialCheckpoint]:
        with self._lock:
            buf = self._frames.get(int(trial_id))
            meta = self._meta.get(int(trial_id))
        if buf is None or meta is None:
            return None
        decoded = wire.decode(buf)
        state = _tree_map(_restore, decoded.tree, meta["kinds"])
        return TrialCheckpoint(state, int(meta["rung"]), meta["loss"])


def _zeros_like(leaf):
    """A zero leaf of ``leaf``'s kind, shape and dtype (float64 for a
    non-numeric leaf, as the JAX package's store)."""
    if isinstance(leaf, torch.Tensor):
        return torch.zeros_like(leaf.detach(), device="cpu")
    arr = np.asarray(leaf)
    return np.zeros_like(arr if arr.dtype.kind in "fiu" else arr.astype(np.float64))


def _negated_like(value, like: torch.Tensor) -> torch.Tensor:
    """``-value`` as a tensor of ``like``'s dtype on ``like``'s device."""
    value = value.detach() if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    return -value.to(like.device, like.dtype)


class GroupVault:
    """Checkpoints on a parameter server.

    ``client`` is any ``BaseParameterClient`` (a ``local``, ``socket``
    or ``http`` server's client) over a store built by ``build_store``.
    Trial state trees must be fixed-shape numeric trees (the same
    contract parameters themselves obey). A load returns each leaf in
    the kind it was saved with in this process; a trial this vault did
    not save comes back as NumPy arrays, as in the JAX package.
    """

    #: Store key for trial ``i``.
    @staticmethod
    def key(trial_id: int) -> str:
        return f"t{int(trial_id)}"

    @classmethod
    def build_store(cls, trial_ids: List[int], template) -> Dict[str, Any]:
        """The PS store tree: one slot per trial, ``rung=-1`` marking
        "no checkpoint yet" (float64 leaves, as ``rung`` and ``loss``
        are)."""
        return {
            cls.key(t): {
                "state": _tree_map(_zeros_like, template),
                "rung": np.float64(-1.0),
                "loss": np.float64(0.0),
            }
            for t in trial_ids
        }

    def __init__(self, client):
        self._client = client
        self._lock = locksan.make_lock("GroupVault._lock")
        self._kinds: Dict[int, Any] = {}

    def _push_slot(self, current, key: str, slot_delta) -> None:
        """One push: ``slot_delta`` on ``key``'s slot, zeros elsewhere."""
        delta = {k: _tree_map(torch.zeros_like, v) for k, v in current.items()
                 if k != key}
        delta[key] = slot_delta
        self._client.update_parameters(delta)

    def save(self, trial_id: int, rung: int, loss: float, state) -> None:
        """Two pushes. The first clears the slot to "no checkpoint" (state
        and loss to 0, rung to -1: ``x - x = 0``, ``r - (r + 1) = -1``),
        the second writes the new values (``0 - (-y) = y``, ``-1 - (-1 -
        rung) = rung``), all exact, so a load from another vault between
        them returns None, never a mix of the two checkpoints."""
        key = self.key(trial_id)
        with self._lock:
            current = self._client.get_parameters()
            slot = current[key]
            self._push_slot(current, key, {**slot, "rung": slot["rung"] + 1})
            negated = _tree_map(_negated_like,
                                {"state": state, "rung": rung + 1, "loss": loss},
                                {k: slot[k] for k in ("state", "rung", "loss")})
            self._push_slot(current, key, negated)
            self._kinds[int(trial_id)] = _tree_map(_kind, state)

    def load(self, trial_id: int) -> Optional[TrialCheckpoint]:
        key = self.key(trial_id)
        with self._lock:
            current = self._client.get_parameters()
            kinds = self._kinds.get(int(trial_id))
        slot = current.get(key)
        if slot is None:
            return None
        rung = int(round(float(slot["rung"])))
        if rung < 0:
            return None
        if kinds is None:
            kinds = _tree_map(lambda leaf: False, slot["state"])
        state = _tree_map(_restore, slot["state"], kinds)
        return TrialCheckpoint(state, rung, float(slot["loss"]))
