"""The data group (counterpart of ``elephas_tpu/parallel/mesh.py``).

The JAX package lays its devices out in a ``jax.sharding.Mesh`` whose
``'data'`` axis carries data parallelism. The port runs one process per
device, as ``torch.distributed`` does, so the same axis is the process
group: ``build_mesh`` returns a ``Mesh`` holding the group, its size and
this process's rank. With no process group initialised the mesh is this
one process, of size 1, and no collective runs.

The caller initialises the group (``torch.distributed.init_process_group``
with its address, world size and rank): NCCL where each process drives a
GPU, gloo where it runs on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The data-parallel group: ``size`` processes, this one at ``rank``.
    ``group`` is None for a single process (no collectives)."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None

    def all_reduce_(self, tensors: Sequence[torch.Tensor], op: str = "mean") -> None:
        """Reduce ``tensors`` in place across the group, with one collective
        per dtype: ``"mean"`` (the JAX package's ``pmean``: a sum, then a
        division by the size), ``"sum"`` or ``"max"`` (``pmax``)."""
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


def world() -> tuple:
    """``(world size, rank)`` of the default process group, ``(1, 0)``
    when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def build_mesh(num_data: Optional[int] = None) -> Mesh:
    """The data group over every process of the default group.

    ``num_data`` (the JAX package's data-axis size) defaults to the world
    size and must equal it: each process drives one device, and a group
    smaller than the world would leave processes out of every
    collective."""
    size, rank = world()
    if num_data is not None and num_data != size:
        raise ValueError(
            f"a data group of {num_data} needs a world of {num_data} processes, "
            f"one per device; this world has {size}"
        )
    return Mesh(size=size, rank=rank, group=dist.group.WORLD if size > 1 else None)
