"""The serving path's host↔device transfers, and its ONE sanctioned
device→host synchronization point (counterpart of
``elephas_tpu/serving/host_sync.py``).

Every device→host read in ``elephas_tpu_torch.serving`` funnels through
this module, so the pipelining contract is auditable: the scheduler
dispatches decode step N+1 BEFORE it reads step N's tokens back, and the
only place a read can block is here. ``tests/test_torch_serving_host_sync.py``
scans the package and fails on any other blocking read (``.item(``,
``.tolist(``, ``.cpu(``, ``.numpy(``, ``torch.cuda.synchronize``).

On the GPU a read must wait for step N only, never for step N+1, which
is already queued behind it on the same stream: a plain ``.cpu()`` of
step N's tokens issued after N+1's launch would wait for both. So each
program's output is *staged* when it is launched (``stage``): a
non-blocking copy into a pinned host buffer, enqueued right behind the
program, and a CUDA event recorded after it. ``fetch`` waits on that
event alone. ``fetch_lanes`` reads the whole ``(max_slots,)`` token
vector that way — one bulk copy of a handful of bytes — and selects the
active lanes on the host: a device gather of the lanes would be a new
launch queued behind the in-flight step, and a read per lane would be
one sync per slot, active or not.

Uploads (``upload``) go the other way through pinned buffers with
``non_blocking=True``: an upload from pageable memory blocks the host
until the copy is done. The pinned buffers come from PyTorch's caching
host allocator, which does not hand a buffer out again before the copies
recorded on it have run.

On the CPU every transfer is a plain copy and nothing is asynchronous.
"""

from __future__ import annotations

import io
import tokenize
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: Blocking device→host reads, banned in the serving package outside
#: this module (``blocking_reads``).
BLOCKING_READS = (".item(", ".tolist(", ".cpu(", ".numpy(", "torch.cuda.synchronize")


class Staged:
    """A device tensor whose copy to the host is under way.

    ``device`` is the tensor on its device (what a pipelined step chains
    as its next input); ``host`` the host copy; ``event`` the CUDA event
    recorded behind the copy (None on the CPU, where ``host`` is the
    tensor itself)."""

    __slots__ = ("device", "host", "event")

    def __init__(self, device: torch.Tensor, host: torch.Tensor,
                 event: Optional["torch.cuda.Event"]):
        self.device = device
        self.host = host
        self.event = event


def stage(tensor: torch.Tensor) -> Staged:
    """Start the device→host copy of ``tensor`` without waiting for it.

    ``tensor`` is cloned (a later step may overwrite the original, as it
    overwrites a decode step's static output); on CUDA the clone stays
    on the device and a fresh pinned buffer receives the copy, behind the
    launch that made the tensor."""
    if tensor.device.type != "cuda":
        tensor = tensor.clone()
        return Staged(tensor, tensor, None)
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return Staged(tensor.clone(), host, event)


def upload(array, device: torch.device, out: Optional[torch.Tensor] = None):
    """Copy the host ``array`` (NumPy or a CPU tensor) to ``device``
    without blocking the host; into ``out`` when given (its address is
    kept, as a CUDA graph's static inputs need), else into a new
    tensor."""
    host = torch.as_tensor(array)
    if device.type == "cuda":
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        host = pinned
    if out is None:
        return host.to(device, non_blocking=True)
    return out.copy_(host, non_blocking=True)


def settle(device: torch.device) -> None:
    """Wait for every launch queued on ``device``: a halted engine's
    last step, before ``InferenceEngine.release`` frees the memory it
    reads and writes. The one wait here that reads no value; a no-op off
    the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fetch(staged: Staged) -> np.ndarray:
    """Wait for a staged copy and return it as a NumPy array.

    THE sanctioned sync point for ``elephas_tpu_torch.serving``: it waits
    for the launch that made the value, not for anything queued after it.
    Callers convert lanes and scalars from this HOST copy."""
    if staged.event is not None:
        staged.event.synchronize()
    return staged.host.numpy()


def fetch_ints(staged: Staged) -> list:
    """``fetch`` converted to (nested) python ints, for callers that read
    lanes and scalars off the copy."""
    return fetch(staged).tolist()


def fetch_tensor(staged: Staged) -> torch.Tensor:
    """``fetch`` returning the host copy as a CPU tensor (for dtypes NumPy
    has no name for, such as bfloat16)."""
    if staged.event is not None:
        staged.event.synchronize()
    return staged.host


def fetch_scalar(value) -> int:
    """Fetch a one-element device value as a python int (prefill's first
    token)."""
    return int(fetch(value).reshape(-1)[0])


def fetch_lanes(tokens, lanes: Sequence[int]) -> List[Tuple[int, int]]:
    """Fetch ``tokens`` (a staged (max_slots,) token vector) and convert
    ONLY the ``lanes`` requested, as ``[(lane, token), ...]``."""
    host = fetch(tokens)
    return [(lane, int(host[lane])) for lane in lanes]


def blocking_reads(package: Optional[Path] = None) -> List[str]:
    """Every blocking device→host read (``BLOCKING_READS``) in the code of
    the serving package's modules other than this one, as ``"file:line:
    call"``; comments and strings do not count. Empty when the package
    keeps its one sync point — the counterpart of the reference's
    ``scripts/lint_blocking.py``."""
    package = Path(package) if package is not None else Path(__file__).parent
    found = []
    for path in sorted(package.glob("*.py")):
        if path.name == Path(__file__).name:
            continue
        lines = {}
        for tok in tokenize.generate_tokens(io.StringIO(path.read_text()).readline):
            if tok.type not in (tokenize.COMMENT, tokenize.STRING):
                lines[tok.start[0]] = lines.get(tok.start[0], "") + tok.string
        found += [f"{path.name}:{row}: {call}" for row, text in sorted(lines.items())
                  for call in BLOCKING_READS if call in text]
    return found
