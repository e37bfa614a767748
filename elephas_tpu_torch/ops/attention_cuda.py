"""Wrappers of the hand-written CUDA flash-attention kernels (``csrc/``).

- ``flash_fwd`` (``csrc/flash_fwd.cu``) replaces
  ``elephas_tpu/ops/attention_pallas.py::_flash_fwd_kernel`` (K1);
- ``flash_bwd_dq`` and ``flash_bwd_dkv`` (``csrc/flash_bwd.cu``) replace
  ``_flash_dq_kernel`` (K2) and ``_flash_dkv_kernel`` (K3).

Each source is built with ``nvcc`` for ``sm_90a`` at first use into its
own ``elephas_tpu_torch/_build/<name>-<sha>.so`` (rebuilt when the
source's or a header's hash changes: every ``csrc/*.cuh`` is in
``HEADERS``) and loaded with ``ctypes``: a plain C interface builds in
seconds, where an extension that includes PyTorch's headers takes
minutes. ``build_all`` runs one ``nvcc`` per source, all at once.

What bounds them on an H100: causal work is 2·B·H·S²·D FLOPs for K1,
3·B·H·S²·D for K2 and 4·B·H·S²·D for K3 (the Pallas kernels' own
``CostEstimate``s) against 4–5·B·H·S·D·itemsize bytes, so at the LM's
shape (8, 8, 2048, 32) all three are bound by operations; in bf16 the
exponentials (one per valid score) are a floor of their own. Every
kernel, in both dtypes and at every head_dim of ``HEAD_DIMS``, is built
for Hopper (``csrc/sm90.cuh``): TMA loads into an mbarrier ring and
``wgmma`` products, in most instances a producer warp and one to three
consumer warpgroups of 64 rows each. The float32 kernels take each
product as three tf32 products (a_lo b + a b_lo + a b, a_lo the part of
a below tf32's 10 mantissa bits; ``csrc/tf32.cuh``), which keeps float32
accuracy (times in PERF.md); at head_dim 256 they take 32 rows (or keys)
as a stacked 64-row operand of those rows and their lo parts, held in
registers, in two warpgroups with no producer that issue their loads
from every warp (K1: one warpgroup for S and the softmax, one for O; K2
and K3: one operand a warpgroup), and float32 K3 computes half of dK's
and dV's columns a block. The bf16 K2 and K3 at head_dim 256 also have
two warpgroups and no producer: K2 64 query rows and all of dQ's columns
a warpgroup, 128 rows a block; K3 all of dK's and dV's columns for 64
keys, warpgroup 0 on S^T, P^T and dV, warpgroup 1 on dP^T, dS^T and dK.
``kernel_tiles`` gives each kernel's tiling, which sets the order of its
sums.

Above head_dim 256 every kernel takes any multiple of 256 (``WIDE``,
``wide_chunks``): each splits its output by columns over the grid's z
dimension, a block owning one chunk of 256 columns (O, dQ, dK or dV; K3
a chunk of dV or of dK), and streams the products that reduce over
head_dim (S = Q K^T and dP = dO V^T, or their transposes) over all the
chunks, recomputing them in every block of a row tile. A block takes 64
fixed rows (bf16) or 32 as a stacked operand (float32) against streamed
tiles of as many rows, with a producer warp and one consumer warpgroup;
both sides stream, in slices of 256 (bf16) or 64 (float32) columns.

``launches`` counts the launches of each kernel (``flash_fwd``,
``flash_dq``, ``flash_dkv``); a count moves where its kernel is launched
and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"flash_fwd": CSRC / "flash_fwd.cu", "flash_bwd": CSRC / "flash_bwd.cu"}
HEADERS = (CSRC / "common.cuh", CSRC / "sm90.cuh", CSRC / "tf32.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
HEAD_DIMS = (32, 64, 128, 256)
# Above 256 the instances take every multiple of WIDE, one chunk of
# WIDE output columns a block.
WIDE = 256
DTYPES = (torch.float32, torch.bfloat16)
# Each kernel's grid is (batch·heads, tiles of seq[, chunks]): CUDA's x-
# and z-dimension limits.
MAX_GRID_X = 2**31 - 1
MAX_GRID_Z = 65535

launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

# (query rows, keys) of each kernel's tile; it sets the order of the sums.
# bf16: K1 192 query rows (three consumer warpgroups of 64) against 128
# keys (64 at head_dim 128), 128 against 64 at 256; K2 128 query rows
# against 128 keys at head_dim 32, 192 against 64 at 64, 128 against 64 at
# 128 and 256; K3 64 query rows against 192 keys (128 at
# head_dim 64 and 128, 64 at 256). float32: K1 192, 128, 64 and 32 query
# rows against 64, 64, 32 and 16 keys at head_dim 32, 64, 128 and 256; K2
# 128, 128, 64 and 32 against 64, 32, 16 and 16; K3 64, 32, 16 and 16
# against 128, 64, 64 and 32. Above 256 (``WIDE_TILES``): bf16 64 rows
# against 64, float32 32 against 32, in every kernel.
_TILES = {
    torch.bfloat16: {"flash_fwd": {32: (192, 128), 64: (192, 128), 128: (192, 64),
                                   256: (128, 64)},
                     "flash_dq": {32: (128, 128), 64: (192, 64), 128: (128, 64),
                                  256: (128, 64)},
                     "flash_dkv": {32: (64, 192), 64: (64, 128), 128: (64, 128),
                                   256: (64, 64)}},
    torch.float32: {"flash_fwd": {32: (192, 64), 64: (128, 64), 128: (64, 32),
                                  256: (32, 16)},
                    "flash_dq": {32: (128, 64), 64: (128, 32), 128: (64, 16),
                                 256: (32, 16)},
                    "flash_dkv": {32: (64, 128), 64: (32, 64), 128: (16, 64),
                                  256: (16, 32)}},
}

WIDE_TILES = {torch.bfloat16: (64, 64), torch.float32: (32, 32)}

# C functions of each library: name -> (library, pointer arguments).
_FUNCTIONS = {"flash_fwd": ("flash_fwd", 5), "flash_bwd_dq": ("flash_bwd", 7),
              "flash_bwd_dkv": ("flash_bwd", 8)}

_libs = {}
_lock = threading.Lock()


def wide_chunks(head_dim: int) -> int:
    """The chunks of ``WIDE`` columns an instance above 256 splits
    ``head_dim`` into, or 0 where head_dim is no multiple of ``WIDE``
    above it."""
    return head_dim // WIDE if head_dim > WIDE and head_dim % WIDE == 0 else 0


def kernel_tiles(name: str, dtype, head_dim: int) -> tuple:
    """``(block_q, block_k)`` at which the kernel ``name`` (a key of
    ``launches``) sums for ``dtype`` and ``head_dim``: the tiling at which
    its plain version sums in the same order."""
    if name in launches and dtype in WIDE_TILES and wide_chunks(head_dim):
        return WIDE_TILES[dtype]
    try:
        return _TILES[dtype][name][head_dim]
    except KeyError:
        raise ValueError(f"no {name} kernel for {dtype} at head_dim {head_dim}") from None


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


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


def nvcc_command(source: Path, out: Path, extra_flags=()) -> list:
    """The ``nvcc`` command that builds ``source`` for ``sm_90a`` into the
    shared library ``out``, with the ``-Xptxas -v`` register and
    shared-memory report and ``extra_flags``."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *extra_flags,
        "-o", str(out), str(source),
    ]


def build(name: str) -> Path:
    """Compile the source ``name`` (a key of ``SOURCES``) unless a library
    of its hash exists; returns the library's path. ``nvcc``'s output
    goes beside it in a ``.log`` file."""
    source = SOURCES[name]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in (source, *HEADERS))).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{name}-{digest}.{os.getpid()}.tmp"
    proc = subprocess.run(nvcc_command(source, tmp), capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source.name} with code {proc.returncode}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, lib)
    return lib


def build_all() -> dict:
    """Build every source at once (one ``nvcc`` each); name -> library."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def bind(lib: ctypes.CDLL, name: str):
    """The C function ``name`` (a key of ``_FUNCTIONS``) of the loaded
    library ``lib``, its signature set: the tensors' pointers, five ints
    (batch·heads, seq, head_dim, bf16, causal), the scale and the stream."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * _FUNCTIONS[name][1] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _function(name: str):
    """The C function ``name``, its library built and loaded on first use."""
    lib_name = _FUNCTIONS[name][0]
    with _lock:
        if lib_name not in _libs:
            lib = ctypes.CDLL(str(build(lib_name)))  # lock-ok: one-time nvcc build; the module lock exists to build each library once
            for fn_name, (owner, _) in _FUNCTIONS.items():
                if owner == lib_name:
                    bind(lib, fn_name)
            _libs[lib_name] = lib
    return getattr(_libs[lib_name], name)


def _check(name, q, *others):
    """Raise unless q and ``others`` are CUDA tensors of one supported
    (batch, heads, seq, head_dim) shape and dtype, contiguous and 16-byte
    aligned."""
    tensors = (q, *others)
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(
            f"{name} takes float32 or bfloat16, one dtype for all inputs; got "
            f"{[t.dtype for t in tensors]}"
        )
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            f"{name} needs inputs of one (batch, heads, seq, head_dim) shape, "
            f"got {[tuple(t.shape) for t in tensors]}"
        )
    batch, heads, seq, head_dim = q.shape
    if head_dim not in HEAD_DIMS and not wide_chunks(head_dim):
        raise ValueError(
            f"head_dim must be one of {HEAD_DIMS} or a multiple of {WIDE} above it, "
            f"got {head_dim}")
    # K3 above 256 takes two blocks a chunk (dV and dK) on the z dimension.
    if wide_chunks(head_dim) * (2 if name == "flash_bwd_dkv" else 1) > MAX_GRID_Z:
        raise ValueError(f"{name}: head_dim {head_dim} has more chunks of {WIDE} than the "
                         f"grid's z dimension holds ({MAX_GRID_Z})")
    if not 0 < batch * heads <= MAX_GRID_X or seq < 1:
        raise ValueError(
            f"batch*heads must be in [1, {MAX_GRID_X}] and seq >= 1, got {tuple(q.shape)}"
        )
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError(f"{name} needs contiguous, 16-byte aligned inputs")


def _check_rows(name, q, *rows):
    """Raise unless each of ``rows`` is a contiguous float32 (batch, heads,
    seq) tensor on q's device."""
    for t in rows:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(q.shape[:3]) or not t.is_contiguous()):
            raise ValueError(
                f"{name} needs lse and delta as contiguous float32 "
                f"{tuple(q.shape[:3])} tensors on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def _call(fn_name, counter, q, tensors, causal, scale):
    """Call the C function ``fn_name`` on q's current stream, raise on a
    refused launch, and count the launch under ``counter``. The scores'
    scale is ``1 / sqrt(head_dim)`` unless ``scale`` is given."""
    fn = _function(fn_name)
    batch, heads, seq, head_dim = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), batch * heads, seq, head_dim,
                 int(q.dtype == torch.bfloat16), int(bool(causal)), scale, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")
    launches[counter] += 1


def flash_fwd(q, k, v, causal: bool = True, scale: Optional[float] = None):
    """Launch K1 on CUDA tensors q, k, v of one (batch, heads, seq,
    head_dim) shape; returns ``(o, lse)``, o in the input dtype and lse
    (batch, heads, seq) float32. The scores are ``scale * q.k``, ``1 /
    sqrt(head_dim)`` by default. Raises on what the kernel does not take
    and when the launch is refused."""
    _check("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _call("flash_fwd", "flash_fwd", q, (q, k, v, o, lse), causal, scale)
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 scale: Optional[float] = None):
    """Launch K2: dq (q's shape and dtype) from q, k, v, the output's
    gradient ``do``, K1's ``lse`` and ``delta = rowsum(do * o)`` (both
    float32 (batch, heads, seq)) and the forward's ``scale``."""
    _check("flash_bwd_dq", q, k, v, do)
    _check_rows("flash_bwd_dq", q, lse, delta)
    dq = torch.empty_like(q)
    _call("flash_bwd_dq", "flash_dq", q, (q, k, v, do, lse, delta, dq), causal, scale)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  scale: Optional[float] = None):
    """Launch K3: ``(dk, dv)`` from the inputs of ``flash_bwd_dq``."""
    _check("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _call("flash_bwd_dkv", "flash_dkv", q, (q, k, v, do, lse, delta, dk, dv), causal,
          scale)
    return dk, dv
