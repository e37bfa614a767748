"""Step metrics, JSONL sink, throughput meter, profiler hook
(counterpart of ``elephas_tpu/metrics/logging.py``).

- ``host0_logger`` — a logger that is silent on every rank but 0,
- ``JsonlSink``    — append-only structured metrics (one JSON per line),
  written by rank 0,
- ``Throughput``   — samples/sec walls that wait for the device,
- ``trace``        — a ``torch.profiler`` window whose Chrome trace is
  written to a directory (viewable in Perfetto).

"Host 0" is rank 0 of the default ``torch.distributed`` group, or the
one process when there is none.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Optional

import torch

from elephas_tpu_torch.parallel.mesh import world


def _rank() -> int:
    return world()[1]


def host0_logger(name: str = "elephas_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    """Rank-0-only logger (every rank logging identically is noise).

    Idempotent: repeated calls add one ``NullHandler`` at most."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if _rank() != 0:
        if not any(isinstance(h, logging.NullHandler) for h in logger.handlers):
            logger.addHandler(logging.NullHandler())
        logger.propagate = False
    return logger


class JsonlSink:
    """Append-only JSONL metrics file, written by rank 0 only."""

    def __init__(self, path: str):
        self.path = path
        self._active = _rank() == 0
        self._file = open(path, "a") if self._active else None

    def log(self, step: int, **metrics) -> None:
        if not self._active:
            return
        record = {"step": int(step), "time": time.time()}
        for key, value in metrics.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError):
                record[key] = value
        # A metrics hook must not kill the training loop: anything json
        # cannot carry (tensors of many elements, objects) is stringified.
        try:
            line = json.dumps(record)
        except TypeError:
            safe = {
                k: v if isinstance(v, (int, float, str, bool, type(None))) else str(v)
                for k, v in record.items()
            }
            line = json.dumps(safe)
        self._file.write(line + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _wait(wall) -> None:
    """Wait until ``wall`` (a tensor, or any nest of them) is computed:
    the device's work up to it is done."""
    tensors = wall if isinstance(wall, (list, tuple)) else (
        list(wall.values()) if isinstance(wall, dict) else [wall])
    for t in tensors:
        if torch.is_tensor(t) and t.is_cuda:
            torch.cuda.synchronize(t.device)


class Throughput:
    """samples/sec meter with device-sync walls.

    Usage::

        meter = Throughput()
        meter.start()                        # waits on `wall` if given
        ... run steps, meter.add(n_samples)
        rate = meter.rate(wall=last_output)  # waits until it is computed
    """

    def __init__(self):
        self._t0: Optional[float] = None
        self._samples = 0

    def start(self, wall=None) -> None:
        if wall is not None:
            _wait(wall)
        self._samples = 0
        self._t0 = time.perf_counter()

    def add(self, n_samples: int) -> None:
        self._samples += int(n_samples)

    def elapsed(self, wall=None) -> float:
        if self._t0 is None:
            raise RuntimeError("call start() first")
        if wall is not None:
            _wait(wall)
        return time.perf_counter() - self._t0

    def rate(self, wall=None) -> float:
        return self._samples / max(self.elapsed(wall), 1e-9)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` window (host and, where there is one, CUDA
    activity); its Chrome trace is written to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
