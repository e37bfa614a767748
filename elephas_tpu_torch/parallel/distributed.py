"""Multi-process coordination (counterpart of
``elephas_tpu/parallel/distributed.py``).

The JAX package brings up ``jax.distributed``'s control plane and runs
the same program on every host (SPMD). The port runs one process per
device under ``torch.distributed``: ``initialize`` joins the process
group, every process runs the same program, and process 0 is the
"driver" for logging, checkpoints and the parameter server's address.
In one process everything is a no-op, so the same script runs from one
device to many:

    elephas_tpu_torch.parallel.distributed.initialize()   # no-op alone
    mesh = build_mesh(num_seq=4)
    SeqParallelTrainer(model, mesh).fit(tokens)

The bytes collectives (``broadcast_*``, ``allgather_bytes``,
``sync_global``) are control-plane traffic: they ride PyTorch's object
collectives, which pickle on the CPU and move the frames with the
group's backend (on NCCL through the current card, which each process
sets with ``torch.cuda.set_device``). Tensors ride the collectives of
``parallel/mesh.py`` and ``parallel/collectives.py``.

Async training across processes runs one parameter server on process 0
and workers on every process dialling it (``engine/async_engine.py``):
the address and the HMAC key travel by ``broadcast_from_host0`` /
``broadcast_bytes_from_host0``, ``$ELEPHAS_PS_ADDRESS`` overrides the
address (``parameter_server_address``), and the job-wide history is an
``allgather_bytes``. ``process_index``/``process_count`` name this
process in the job, as the JAX package's ``jax.process_index`` /
``jax.process_count`` do (the ops endpoints' worker ids read them).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from elephas_tpu_torch.parallel.mesh import local_device_count
from elephas_tpu_torch.utils.sockets import determine_master

def _env_int(*names) -> Optional[int]:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    heartbeat_timeout: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the default process group if this looks like a multi-process
    job; a no-op in one process and when a group is already up.

    The topology defaults from the environment: the coordinator from
    ``MASTER_ADDR`` (and ``MASTER_PORT``) or the JAX package's
    ``JAX_COORDINATOR_ADDRESS`` (``host:port``, or a ``tcp://`` or
    ``file://`` URL); the count from ``WORLD_SIZE`` or
    ``JAX_NUM_PROCESSES``; this process's rank from ``RANK`` or
    ``JAX_PROCESS_ID``. ``backend`` defaults to NCCL where a GPU is
    visible, gloo elsewhere (several processes that share one card need
    gloo: NCCL refuses two ranks on one GPU).

    ``heartbeat_timeout`` (seconds; ``$ELEPHAS_HEARTBEAT_TIMEOUT``): in
    the JAX package, how long a silent peer may miss heartbeats before
    every process is stopped. Here it is the process group's timeout,
    which bounds how long any collective waits for a peer (a dead one
    included) before it raises; unset, PyTorch's default.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if "MASTER_ADDR" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        else:
            coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if coordinator_address is None and num_processes in (None, 1):
        return  # one process
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process job needs the coordinator address, the number of "
            f"processes and this process's rank; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}"
        )
    if heartbeat_timeout is None:
        heartbeat_timeout = _env_int("ELEPHAS_HEARTBEAT_TIMEOUT")
    kwargs = {}
    if heartbeat_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=heartbeat_timeout)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"),
                            init_method=url, world_size=num_processes, rank=process_id,
                            **kwargs)


def _processes() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the job (0 alone)."""
    return dist.get_rank() if _processes() > 1 else 0


def process_count() -> int:
    """Processes in the job (1 alone)."""
    return _processes()


def is_host0() -> bool:
    """Is this the "driver" process (logging, checkpoints, the PS)?"""
    return _processes() == 1 or dist.get_rank() == 0


def total_chips() -> int:
    """Devices across every process: one per process in a group, else
    this process's visible cards (1 on the CPU)."""
    return _processes() if _processes() > 1 else local_chips()


def local_chips() -> int:
    """Cards this process sees (1 on the CPU)."""
    return local_device_count()


def host_count() -> int:
    """Hosts (distinct host names) across the group, 1 in one process.
    It gathers the names: every process calls it."""
    return len(set(allgather_bytes(socket.gethostname().encode())))


_ADDR_BYTES = 64  # the JAX package's fixed frame for an address ("ip:port")


def broadcast_from_host0(value: str, max_bytes: int = _ADDR_BYTES) -> str:
    """Process 0's short string on every process (``max_bytes`` of UTF-8
    at most, as the JAX package's fixed frame). No-op in one process."""
    if _processes() == 1:
        return value
    if is_host0() and len(value.encode()) > max_bytes:
        raise ValueError(f"broadcast payload too long ({len(value.encode())} > {max_bytes})")
    return broadcast_bytes_from_host0(value.encode() if is_host0() else b"").decode()


def broadcast_bytes_from_host0(payload: bytes) -> bytes:
    """Process 0's byte string, of any length, on every process. No-op in
    one process."""
    if _processes() == 1:
        return payload
    box = [bytes(payload) if is_host0() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def parameter_server_address(port: int = 4000) -> str:
    """Where workers on any process reach the PS (process 0):
    ``ELEPHAS_PS_ADDRESS`` (with ``port`` appended where it has none),
    else process 0's routable address broadcast to every process."""
    explicit = os.environ.get("ELEPHAS_PS_ADDRESS")
    if explicit:
        return explicit if ":" in explicit else f"{explicit}:{port}"
    return broadcast_from_host0(determine_master(port))


def allgather_bytes(payload: bytes) -> list:
    """One byte string of any length from EVERY process; every process
    receives the same ``[bytes_from_0, bytes_from_1, ...]``. ``[payload]``
    in one process. Control plane only (trial results, addresses)."""
    if _processes() == 1:
        return [payload]
    gathered = [None] * _processes()
    dist.all_gather_object(gathered, bytes(payload))
    return gathered


def sync_global(tag: str = "elephas:sync") -> None:
    """Barrier across processes (no-op in one process). Every process must
    reach it with the same ``tag``; a process that reaches another tag
    raises, as the JAX package's named barrier does."""
    tags = allgather_bytes(str(tag).encode())
    if len(set(tags)) > 1:
        raise RuntimeError(f"sync_global: processes reached different barriers "
                           f"{sorted({t.decode() for t in tags})}")
