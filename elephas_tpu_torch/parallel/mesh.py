"""The process mesh (counterpart of ``elephas_tpu/parallel/mesh.py``).

The JAX package lays its devices out in a ``jax.sharding.Mesh`` of axes
``('data', 'seq', 'model')``: ``'data'`` carries data parallelism,
``'seq'`` sequence parallelism (ring and Ulysses attention) and
``'model'`` tensor parallelism (``tensor_parallel.py``). The port runs
one process per device, as ``torch.distributed`` does, so an axis is a
process group: ``build_mesh`` returns a ``Mesh`` holding the groups,
their sizes and this process's ranks, laid out as the JAX package lays
its devices (``reshape(num_data, num_seq, num_model)``: rank = d·S·M +
s·M + m). With no process group initialised the mesh is this one
process, of size 1, and no collective runs.

The caller initialises the group (``parallel.distributed.initialize``, or
``torch.distributed.init_process_group`` with its address, world size
and rank): NCCL where each process drives a GPU, gloo where it runs on
the CPU or where several processes share one card.

Inside a sequence-parallel step the mesh is bound (``bind_mesh``), as
``shard_map`` binds the JAX package's axis names: the model's attention
finds its sequence group there (``bound_mesh``). A tensor-parallel
module keeps its model group in its layers (``tensor_parallel.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)  # outermost first, as the ranks are laid out


@dataclass(frozen=True)
class Mesh:
    """The process mesh. ``size``, ``rank`` and ``group`` are the data
    axis: ``size`` processes, this one at ``rank``, ``group`` None for a
    single process (no collectives). ``seq_size``, ``seq_rank`` and
    ``seq_group`` are the sequence axis (the processes of this data and
    model index), ``model_size``, ``model_rank`` and ``model_group`` the
    model axis (the processes of this data and seq index), and
    ``joint_group`` the data × seq group of this model index, set where
    both axes are above 1.

    A mesh is copied by reference (``copy.deepcopy`` of a module that
    holds one keeps the same groups)."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    seq_size: int = 1
    seq_rank: int = 0
    seq_group: Optional[object] = None
    joint_group: Optional[object] = None
    model_size: int = 1
    model_rank: int = 0
    model_group: Optional[object] = None

    def __deepcopy__(self, memo):
        return self

    def axis(self, name: str) -> Tuple[int, int, Optional[object]]:
        """``(size, rank, group)`` of one axis."""
        return {DATA_AXIS: (self.size, self.rank, self.group),
                SEQ_AXIS: (self.seq_size, self.seq_rank, self.seq_group),
                MODEL_AXIS: (self.model_size, self.model_rank, self.model_group)}[name]

    def over(self, axes: Union[str, Sequence[str]]) -> "Mesh":
        """The group of ``axes`` (an axis name or a tuple of names) as a
        one-axis ``Mesh`` (its ``size``, ``rank`` and ``group``): what the
        JAX package's collectives over those axis names reduce over. Axes
        of size 1 drop out; the rank counts the remaining axes in mesh
        order (data, seq, model), as the JAX package's ``axis_index``
        over several names does. The mesh holds a group for each axis,
        for data × seq and for all three; another pair of axes above 1
        raises, as no step reduces over it."""
        names = [a for a in AXES if a in _axis_names(axes) and self.axis(a)[0] > 1]
        if not names:
            return Mesh()
        if len(names) == 1:
            return Mesh(*self.axis(names[0]))
        size, rank = 1, 0
        for name in names:
            n, r, _ = self.axis(name)
            size, rank = size * n, rank * n + r
        key = frozenset(names)
        if key == {DATA_AXIS, SEQ_AXIS}:
            return Mesh(size, rank, self.joint_group)
        if len(key) == len(AXES):
            return Mesh(size, rank, dist.group.WORLD)
        raise ValueError(f"the mesh holds no group over {' x '.join(names)}")

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
    """The set of axis names ``axes`` gives; raises on names the mesh
    does not have."""
    names = {axes} if isinstance(axes, str) else set(axes)
    unknown = names - set(AXES)
    if unknown or not names:
        raise ValueError(f"unknown mesh axes {sorted(unknown) or axes!r}; the mesh has "
                         f"'{DATA_AXIS}', '{SEQ_AXIS}' and '{MODEL_AXIS}'")
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


def _group_of(axes: Tuple[str, ...], shape: Dict[str, int], coords: Dict[str, int]):
    """This process's group over ``axes``: None where it holds one
    process, the world where it holds every process, else one
    ``new_group`` per index of the other axes, all created by every
    process in the same order."""
    size = 1
    for a in axes:
        size *= shape[a]
    if size == 1:
        return None
    if size == shape[DATA_AXIS] * shape[SEQ_AXIS] * shape[MODEL_AXIS]:
        return dist.group.WORLD
    others = [a for a in AXES if a not in axes]
    mine = None
    for fixed in itertools.product(*(range(shape[a]) for a in others)):
        at = dict(zip(others, fixed))
        ranks = []
        for inside in itertools.product(*(range(shape[a]) for a in axes)):
            at.update(zip(axes, inside))
            ranks.append((at[DATA_AXIS] * shape[SEQ_AXIS] + at[SEQ_AXIS])
                         * shape[MODEL_AXIS] + at[MODEL_AXIS])
        group = dist.new_group(ranks)
        if all(coords[a] == v for a, v in zip(others, fixed)):
            mine = group
    return mine


def build_mesh(num_data: Optional[int] = None, *, num_seq: int = 1,
               num_model: int = 1) -> Mesh:
    """The ``(data, seq, model)`` mesh over every process of the default
    group.

    ``num_data`` (the JAX package's data-axis size) defaults to the world
    size over ``num_seq × num_model``, and ``num_data × num_seq ×
    num_model`` must equal the world size: each process drives one
    device, and a mesh smaller than the world would leave processes out
    of every collective. The one exception is a mesh of 1: this process
    alone, which runs no collective, as a trial of a search does (the
    JAX package's ``build_mesh(num_data=1, devices=[current_trial_device()])``)
    while other processes run trials of their own.

    Every process must call this with the same sizes and in the same
    order as its other group creations: each group is a
    ``torch.distributed.new_group``, which every process of the world
    creates."""
    if num_seq < 1 or num_model < 1:
        raise ValueError(f"num_seq and num_model must be >= 1, got {num_seq}, {num_model}")
    if num_data == 1 and num_seq == 1 and num_model == 1:
        return Mesh()
    size, rank = world()
    inner = num_seq * num_model
    if num_data is None:
        if size % inner:
            raise ValueError(f"{size} processes not divisible by seq x model = {inner}")
        num_data = size // inner
    if num_data * inner != size:
        what = (f"a data group of {num_data}" if inner == 1
                else f"a mesh of data {num_data} x seq {num_seq} x model {num_model}")
        raise ValueError(f"{what} needs a world of {num_data * inner} processes, one per "
                         f"device; this world has {size}")
    if size == 1:
        return Mesh()
    shape = {DATA_AXIS: num_data, SEQ_AXIS: num_seq, MODEL_AXIS: num_model}
    d, rest = divmod(rank, inner)
    s, m = divmod(rest, num_model)
    coords = {DATA_AXIS: d, SEQ_AXIS: s, MODEL_AXIS: m}
    seq_group = _group_of((SEQ_AXIS,), shape, coords)
    data_group = _group_of((DATA_AXIS,), shape, coords)
    model_group = _group_of((MODEL_AXIS,), shape, coords)
    joint = _group_of((DATA_AXIS, SEQ_AXIS), shape, coords)
    return Mesh(size=num_data, rank=d, group=data_group, seq_size=num_seq, seq_rank=s,
                seq_group=seq_group, joint_group=joint, model_size=num_model,
                model_rank=m, model_group=model_group)


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
