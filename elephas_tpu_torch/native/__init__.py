"""Native (C++) host ops with lazy compilation and numpy fallback
(counterpart of ``elephas_tpu/native/__init__.py``, with its own copy of
``host_ops.cpp``).

``gather_rows(x, y, perm)`` is the host-side shuffle gather used by
``ShardedDataset.shuffle``: a threaded row-copy that fuses the features
and labels passes. ``encode_onehot`` one-hot encodes integer labels.
The library is built on first use with ``g++ -O3 -shared`` into
``elephas_tpu_torch/_build/`` (rebuilt when the source is newer) and
loaded with ``ctypes``. Every entry point falls back to numpy when the
toolchain or the build is unavailable, so the package never depends on
the native path. These are host ops: no device runs them.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_ops.cpp")
_LIB_PATH = os.path.join(os.path.dirname(_HERE), "_build", "host_ops.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
        # Compile to a process-unique temp path and atomically rename, so
        # concurrent processes (pytest-xdist, shared checkouts) never load
        # a half-written .so.
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        tmp_path = f"{_LIB_PATH}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
               _SRC, "-o", tmp_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp_path, _LIB_PATH)
        except (OSError, subprocess.SubprocessError) as exc:
            logger.warning("native host_ops build failed (%s); using numpy fallback", exc)
            _build_failed = True
            return None
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as exc:  # corrupt/wrong-arch .so: degrade, don't crash
        logger.warning("native host_ops load failed (%s); using numpy fallback", exc)
        _build_failed = True
        return None
    lib.gather_rows2.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.gather_rows2.restype = None
    lib.encode_onehot.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.encode_onehot.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _build()  # one-time compile, under the lock
    return _lib


def available() -> bool:
    return get_lib() is not None


def gather_rows(
    x: np.ndarray, y: Optional[np.ndarray], perm: np.ndarray, n_threads: int = 0
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Return ``(x[perm], y[perm])`` via the native threaded gather.

    Falls back to numpy fancy indexing if the native library is missing.
    """
    lib = get_lib()
    if lib is None:
        return x[perm], (None if y is None else y[perm])
    x = np.ascontiguousarray(x)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    n = len(perm)
    x_dst = np.empty((n, *x.shape[1:]), dtype=x.dtype)
    x_row = x.dtype.itemsize * int(np.prod(x.shape[1:], dtype=np.int64))
    if y is not None:
        y = np.ascontiguousarray(y)
        y_dst = np.empty((n, *y.shape[1:]), dtype=y.dtype)
        y_row = y.dtype.itemsize * int(np.prod(y.shape[1:], dtype=np.int64))
        y_src_p, y_dst_p = y.ctypes.data, y_dst.ctypes.data
    else:
        y_dst, y_row, y_src_p, y_dst_p = None, 0, None, None
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.gather_rows2(
        x.ctypes.data, x_dst.ctypes.data, x_row,
        y_src_p, y_dst_p, y_row,
        perm.ctypes.data, n, n_threads,
    )
    return x_dst, y_dst


def encode_onehot(labels: np.ndarray, nb_classes: int) -> np.ndarray:
    """Vectorized one-hot; native when available, numpy otherwise."""
    labels = np.ascontiguousarray(labels, dtype=np.int64).reshape(-1)
    lib = get_lib()
    if lib is None:
        out = np.zeros((len(labels), nb_classes), dtype=np.float32)
        valid = (labels >= 0) & (labels < nb_classes)
        out[np.nonzero(valid)[0], labels[valid]] = 1.0
        return out
    out = np.empty((len(labels), nb_classes), dtype=np.float32)
    lib.encode_onehot(labels.ctypes.data, out.ctypes.data, len(labels), nb_classes)
    return out
