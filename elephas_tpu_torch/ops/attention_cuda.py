"""Wrapper of the hand-written CUDA flash-attention forward (``csrc/flash_fwd.cu``).

The kernel replaces ``elephas_tpu/ops/attention_pallas.py::_flash_fwd_kernel``
(K1). It is built with ``nvcc`` for ``sm_90a`` at first use into
``elephas_tpu_torch/_build/`` (rebuilt when the source's hash changes) and
loaded with ``ctypes``: a plain C interface builds in seconds, where an
extension that includes PyTorch's headers takes minutes.

What bounds it on an H100: causal work is 2·B·H·S²·D FLOPs (K1's own
``CostEstimate``) against 4·B·H·S·D·itemsize bytes plus the float32 lse,
so at the LM's shape (8, 8, 2048, 32) it is bound by operations. bf16
inputs run both products on the tensor cores (``mma.sync``, f32
accumulation); float32 inputs run float32 FMAs, one query row per thread,
so they keep full float32 precision and are far from any tensor-core
bound. Neither uses ``wgmma`` or TMA yet, and it shows: on an H100 at the
LM's shape the bf16 kernel takes about twice as long as PyTorch's fused
attention and reaches under a tenth of the tensor-core bound, and the f32
kernel under a third of the FMA bound (times in PERF.md). They stay as
they are until a later change moves the products to ``wgmma``.

``launches`` counts the kernel launches made through ``flash_fwd``; it
moves where the kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)

launches = 0

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)"
        )
    return found


def build() -> Path:
    """Compile ``flash_fwd.cu`` unless a library of this source's hash
    exists; returns the library's path. ``nvcc``'s output, with the
    ``-Xptxas -v`` register and shared-memory report, goes beside it in
    a ``.log`` file."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"flash_fwd-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"flash_fwd-{digest}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(SOURCE),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.flash_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
                ctypes.c_float, ctypes.c_void_p,
            ]
            lib.flash_fwd.restype = ctypes.c_int
            _lib = lib
    return _lib


def flash_fwd(q, k, v, causal: bool = True):
    """Launch the kernel on CUDA tensors q, k, v of one (batch, heads, seq,
    head_dim) shape; returns ``(o, lse)``, o in the input dtype and lse
    (batch, heads, seq) float32. Raises on what the kernel does not take
    and when the launch is refused."""
    global launches
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_fwd needs CUDA tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_fwd takes float32 or bfloat16, one dtype for q, k, v; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_fwd needs q, k, v of one (batch, heads, seq, head_dim) "
            f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    batch, heads, seq, head_dim = q.shape
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {head_dim}")
    if not 0 < batch * heads <= 65535 or seq < 1:
        raise ValueError(
            f"batch*heads must be in [1, 65535] and seq >= 1, got {tuple(q.shape)}"
        )
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("flash_fwd needs contiguous, 16-byte aligned q, k, v")
    lib = _load()
    o = torch.empty_like(q)
    lse = torch.empty((batch, heads, seq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), batch * heads, seq, head_dim,
            int(q.dtype == torch.bfloat16), int(bool(causal)),
            1.0 / math.sqrt(head_dim), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    launches += 1
    return o, lse
