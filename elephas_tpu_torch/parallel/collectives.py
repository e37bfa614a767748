"""Collectives of one mesh axis, differentiable (the port's counterparts of
``lax.ppermute`` and ``lax.all_to_all`` inside ``shard_map``, and of the
all-reduces and all-gathers GSPMD inserts for tensor parallelism).

- ``ppermute(tensors, mesh)`` sends each tensor to the next rank of the
  axis and returns what the previous rank sent (``rank + 1`` and ``rank
  - 1`` modulo the size): one ring hop. The tensors travel as one
  message (``dist.batch_isend_irecv``, peers by ``dist.get_global_rank``).
- ``all_to_all(x, mesh, split_axis, concat_axis)`` splits ``x`` along
  ``split_axis`` into one chunk per rank, sends chunk ``j`` to rank ``j``
  and concatenates what arrives along ``concat_axis`` in rank order
  (``lax.all_to_all(..., tiled=True)``; ``dist.all_to_all_single``).

The tensor-parallel collectives of the model axis, as Megatron-LM pairs
them (``tensor_parallel.py`` places them around its layers):

- ``copy_to_model(x, mesh)``: identity forward, all-reduce backward (a
  replicated activation entering a column-parallel layer);
- ``reduce_from_model(x, mesh)``: all-reduce forward, identity backward
  (a row-parallel layer's partial sums);
- ``gather_from_model(x, mesh, dim)``: all_gather along ``dim`` forward,
  this rank's slice backward; ``scatter_to_model`` the other way round.

``tp_bytes`` counts what they move: each call adds the bytes of its
result (the reduced tensor, or the gathered one).

Each is an ``autograd.Function`` whose backward is the inverse exchange,
as JAX transposes them. ``mesh`` is a one-axis ``parallel.mesh.Mesh``
(``Mesh.over(SEQ_AXIS)``); the backward keeps it, since autograd may run
the backward on a thread where no mesh is bound.

Host staging, gloo groups only: gloo's ``send`` and ``recv`` read a CUDA
tensor's device address as host memory and fail ("Bad address";
``scripts/torch_gloo_cuda_probe.py`` on an H100), while its
``all_to_all_single``, ``all_reduce``, ``broadcast`` and ``all_gather``
take CUDA tensors. So a ring hop of a gloo group on CUDA tensors copies
its message to the host, exchanges it there and copies what arrives back
to the card; ``staged_bytes`` counts both copies. That is the transport
of a gloo group, used where several processes share one card (NCCL
refuses two ranks on one GPU); no compute moves to the host, and an
NCCL group never stages. The counter holds the ring hops' staging only:
gloo's own CUDA collectives (the all_to_all here, a gradient all-reduce)
also copy through host memory inside gloo, and are not counted.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

#: Bytes that ring hops of gloo groups copied between the card and the host.
staged_bytes = 0
#: Bytes of the results of the tensor-parallel collectives.
tp_bytes = 0

# Messages are packed with each tensor at a multiple of this many bytes,
# so every unpacked view starts aligned, as the kernels read it.
_ALIGN = 16


def reset_staged() -> None:
    global staged_bytes
    staged_bytes = 0


def reset_tp_bytes() -> None:
    global tp_bytes
    tp_bytes = 0


def _pack(tensors) -> torch.Tensor:
    parts = []
    for t in tensors:
        raw = t.contiguous().reshape(-1).view(torch.uint8)
        parts.append(raw)
        if raw.numel() % _ALIGN:
            parts.append(raw.new_zeros(_ALIGN - raw.numel() % _ALIGN))
    return torch.cat(parts)


def _unpack(flat, like) -> Tuple[torch.Tensor, ...]:
    out, offset = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        out.append(flat[offset:offset + nbytes].view(t.dtype).view(t.shape))
        offset += nbytes + (-nbytes % _ALIGN)
    return tuple(out)


def _shift(tensors: Sequence[torch.Tensor], mesh, shift: int) -> Tuple[torch.Tensor, ...]:
    """Send ``tensors`` to rank ``rank + shift`` of ``mesh``'s group and
    return what rank ``rank - shift`` sent (same shapes and dtypes)."""
    if mesh.size == 1:
        return tuple(tensors)
    global staged_bytes
    message = _pack(tensors)
    # gloo's send/recv take no CUDA tensors: a gloo hop goes through the host.
    staged = message.is_cuda and dist.get_backend(mesh.group) == "gloo"
    device = message.device
    if staged:
        message = message.cpu()
        staged_bytes += 2 * message.numel()
    arrived = torch.empty_like(message)
    to = dist.get_global_rank(mesh.group, (mesh.rank + shift) % mesh.size)
    frm = dist.get_global_rank(mesh.group, (mesh.rank - shift) % mesh.size)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, message, to, mesh.group),
                                    dist.P2POp(dist.irecv, arrived, frm, mesh.group)])
    for work in works:
        work.wait()
    if staged:
        arrived = arrived.to(device)
    return _unpack(arrived, tensors)


def ppermute_(tensors: Sequence[torch.Tensor], mesh) -> Tuple[torch.Tensor, ...]:
    """One ring hop outside autograd: ``tensors`` to the next rank, the
    previous rank's back."""
    return _shift(tensors, mesh, 1)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, shift, *tensors):
        ctx.mesh, ctx.shift = mesh, shift
        return _shift(tensors, mesh, shift)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_shift(grads, ctx.mesh, -ctx.shift))


def ppermute(tensors: Sequence[torch.Tensor], mesh) -> Tuple[torch.Tensor, ...]:
    """One ring hop under autograd: each tensor to the next rank of
    ``mesh``, the previous rank's back; the gradients travel the other
    way."""
    return _PPermute.apply(mesh, 1, *tensors)


def _all_to_all(x, mesh, split_axis: int, concat_axis: int) -> torch.Tensor:
    n = mesh.size
    if n == 1:
        return x
    shape = list(x.shape)
    if shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} does not split "
                         f"into {n} chunks")
    chunk = shape[:split_axis] + [n, shape[split_axis] // n] + shape[split_axis + 1:]
    send = x.reshape(chunk).movedim(split_axis, 0).contiguous()
    arrived = torch.empty_like(send)
    dist.all_to_all_single(arrived, send, group=mesh.group)
    local = list(send.shape[1:])
    # arrived[i] came from rank i: rank order becomes the outer part of the
    # concatenated axis.
    merged = local[:concat_axis] + [n * local[concat_axis]] + local[concat_axis + 1:]
    return arrived.movedim(0, concat_axis).reshape(merged)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, split_axis, concat_axis):
        ctx.mesh, ctx.axes = mesh, (split_axis, concat_axis)
        return _all_to_all(x, mesh, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(grad, ctx.mesh, concat_axis, split_axis), None, None, None


def all_to_all(x, mesh, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``mesh``'s group, under autograd (the backward is the inverse
    all_to_all)."""
    return _AllToAll.apply(x, mesh, split_axis, concat_axis)


# -- the model axis ---------------------------------------------------------------


def all_reduce_(x: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place over ``mesh``'s group (``"sum"`` or
    ``"max"``), outside autograd; counted in ``tp_bytes``."""
    global tp_bytes
    if mesh.size > 1:
        reduce_op = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        dist.all_reduce(x, op=reduce_op, group=mesh.group)
        tp_bytes += x.numel() * x.element_size()
    return x


def all_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order,
    outside autograd; counted in ``tp_bytes``."""
    global tp_bytes
    if mesh.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts, dim=dim)
    tp_bytes += out.numel() * out.element_size()
    return out


def local_chunk(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """This rank's one of ``mesh.size`` equal chunks of ``x`` along ``dim``."""
    n = x.shape[dim] // mesh.size
    return x.narrow(dim, mesh.rank * n, n)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.contiguous().clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return local_chunk(grad, ctx.mesh, ctx.dim).contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return local_chunk(x, mesh, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.mesh, ctx.dim), None, None


def copy_to_model(x, mesh):
    """Identity forward; the gradient is all-reduced over ``mesh``."""
    return x if mesh.size == 1 else _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    """All-reduce (sum) over ``mesh`` forward; identity backward."""
    return x if mesh.size == 1 else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh, dim: int = -1):
    """All ranks' ``x`` along ``dim`` forward; this rank's slice of the
    gradient backward."""
    return x if mesh.size == 1 else _GatherFromModel.apply(x, mesh, dim % x.dim())


def scatter_to_model(x, mesh, dim: int = -1):
    """This rank's chunk of a replicated ``x`` along ``dim`` forward; the
    gradient all-gathered backward."""
    return x if mesh.size == 1 else _ScatterToModel.apply(x, mesh, dim % x.dim())
