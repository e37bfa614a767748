"""The process mesh (counterpart of ``elephas_tpu/parallel/mesh.py``).

The JAX package lays its devices out in a ``jax.sharding.Mesh`` of axes
``('data', 'seq', 'model')``: ``'data'`` carries data parallelism,
``'seq'`` sequence parallelism (ring and Ulysses attention). The port
runs one process per device, as ``torch.distributed`` does, so an axis
is a process group: ``build_mesh`` returns a ``Mesh`` holding the groups,
their sizes and this process's ranks, laid out as the JAX package lays
its devices (``reshape(num_data, num_seq, num_model)``: rank = d·S·M +
s·M + m). With no process group initialised the mesh is this one
process, of size 1, and no collective runs. The ``'model'`` axis (tensor
parallelism) is not ported yet (ROADMAP.md, queue 1, item 6b).

The caller initialises the group (``parallel.distributed.initialize``, or
``torch.distributed.init_process_group`` with its address, world size
and rank): NCCL where each process drives a GPU, gloo where it runs on
the CPU or where several processes share one card.

Inside a sequence-parallel step the mesh is bound (``bind_mesh``), as
``shard_map`` binds the JAX package's axis names: the model's attention
finds its sequence group there (``bound_mesh``).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1, item 6b)"


@dataclass(frozen=True)
class Mesh:
    """The process mesh. ``size``, ``rank`` and ``group`` are the data
    axis: ``size`` processes, this one at ``rank``, ``group`` None for a
    single process (no collectives). ``seq_size``, ``seq_rank`` and
    ``seq_group`` are the sequence axis (the processes of this data
    index), and ``joint_group`` the data × seq group, set where both
    axes are above 1."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    seq_size: int = 1
    seq_rank: int = 0
    seq_group: Optional[object] = None
    joint_group: Optional[object] = None

    def over(self, axes: Union[str, Sequence[str]]) -> "Mesh":
        """The group of ``axes`` (an axis name or a tuple of names) as a
        one-axis ``Mesh`` (its ``size``, ``rank`` and ``group``): what the
        JAX package's collectives over those axis names reduce over."""
        names = _axis_names(axes)
        if names == {DATA_AXIS} or (names == {DATA_AXIS, SEQ_AXIS} and self.seq_size == 1):
            return Mesh(self.size, self.rank, self.group)
        if names == {SEQ_AXIS} or self.size == 1:
            return Mesh(self.seq_size, self.seq_rank, self.seq_group)
        return Mesh(self.size * self.seq_size, self.rank * self.seq_size + self.seq_rank,
                    self.joint_group)

    def all_reduce_(self, tensors: Sequence[torch.Tensor], op: str = "mean") -> None:
        """Reduce ``tensors`` in place across the data group, with one
        collective per dtype: ``"mean"`` (the JAX package's ``pmean``: a
        sum, then a division by the size), ``"sum"`` or ``"max"``
        (``pmax``)."""
        if self.size == 1 or not tensors:
            return
        reduce_op = {"mean": dist.ReduceOp.SUM, "sum": dist.ReduceOp.SUM,
                     "max": dist.ReduceOp.MAX}[op]
        by_dtype: Dict[torch.dtype, list] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, op=reduce_op, group=self.group)
            if op == "mean":
                flat /= self.size
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def _axis_names(axes) -> set:
    """The set of axis names ``axes`` gives; raises on the model axis
    (not ported) and on names the mesh does not have."""
    names = {axes} if isinstance(axes, str) else set(axes)
    if MODEL_AXIS in names:
        raise NotImplementedError(f"the '{MODEL_AXIS}' axis (tensor parallelism) {_NOT_PORTED}")
    unknown = names - {DATA_AXIS, SEQ_AXIS}
    if unknown or not names:
        raise ValueError(f"unknown mesh axes {sorted(unknown) or axes!r}; the mesh has "
                         f"'{DATA_AXIS}' and '{SEQ_AXIS}'")
    return names


def local_device_count() -> int:
    """Cards this process sees (1 on the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def world() -> tuple:
    """``(world size, rank)`` of the default process group, ``(1, 0)``
    when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(num_data: Optional[int] = None, *, num_seq: int = 1,
               num_model: int = 1) -> Mesh:
    """The ``(data, seq)`` mesh over every process of the default group.

    ``num_data`` (the JAX package's data-axis size) defaults to the world
    size over ``num_seq``, and ``num_data × num_seq`` must equal the
    world size: each process drives one device, and a mesh smaller than
    the world would leave processes out of every collective. The one
    exception is ``num_data=1`` with ``num_seq=1``: this process alone,
    which runs no collective, as a trial of a search does (the JAX
    package's ``build_mesh(num_data=1, devices=[current_trial_device()])``)
    while other processes run trials of their own.

    Every process must call this with the same sizes and in the same
    order as its other group creations: each group is a
    ``torch.distributed.new_group``, which every process of the world
    creates. ``num_model`` above 1 (tensor parallelism) raises."""
    if num_model != 1:
        raise NotImplementedError(f"a '{MODEL_AXIS}' axis of {num_model} {_NOT_PORTED}")
    if num_seq < 1:
        raise ValueError(f"num_seq must be >= 1, got {num_seq}")
    if num_data == 1 and num_seq == 1:
        return Mesh()
    size, rank = world()
    if num_data is None:
        if size % num_seq:
            raise ValueError(f"{size} processes not divisible by seq = {num_seq}")
        num_data = size // num_seq
    if num_data * num_seq != size:
        what = (f"a data group of {num_data}" if num_seq == 1
                else f"a mesh of data {num_data} x seq {num_seq}")
        raise ValueError(f"{what} needs a world of {num_data * num_seq} processes, one per "
                         f"device; this world has {size}")
    if size == 1:
        return Mesh()
    whole = dist.group.WORLD
    d, s = divmod(rank, num_seq)
    seq_group = data_group = None
    if num_seq > 1:
        seq_group = whole if num_data == 1 else None
        for dd in range(num_data if num_data > 1 else 0):
            g = dist.new_group(list(range(dd * num_seq, (dd + 1) * num_seq)))
            seq_group = g if dd == d else seq_group
    if num_data > 1:
        data_group = whole if num_seq == 1 else None
        for ss in range(num_seq if num_seq > 1 else 0):
            g = dist.new_group(list(range(ss, size, num_seq)))
            data_group = g if ss == s else data_group
    joint = whole if num_data > 1 and num_seq > 1 else None
    return Mesh(size=num_data, rank=d, group=data_group, seq_size=num_seq, seq_rank=s,
                seq_group=seq_group, joint_group=joint)


_BOUND: contextvars.ContextVar = contextvars.ContextVar("elephas_bound_mesh", default=None)


@contextlib.contextmanager
def bind_mesh(mesh: Mesh):
    """Bind ``mesh`` for the code inside (the JAX package's ``shard_map``
    axis binding): ``bound_mesh()`` returns it there. Autograd may run a
    backward on another thread, where nothing is bound, so a collective's
    backward keeps the group it was given."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def bound_mesh() -> Optional[Mesh]:
    """The mesh ``bind_mesh`` bound, or None outside one."""
    return _BOUND.get()
