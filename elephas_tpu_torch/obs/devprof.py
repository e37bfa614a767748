"""On-demand device profiling: trace capture + memory watermarks.

Counterpart of ``elephas_tpu/obs/devprof.py``, with ``torch.profiler`` in
place of ``jax.profiler``:

- ``DeviceProfiler`` — a start/stop bridge over trace capture, guarded
  by a non-blocking capture lock (one active capture per process; a
  second ``start`` answers *busy* instead of corrupting the first).
  Dumps land next to the WAL when mounted on a PS (same placement as the
  kill-path flight dump), or in a temp dir otherwise. The opsd
  ``/profile`` route drives it remotely: ``?action=start`` /
  ``?action=stop`` / bare GET for status.
- ``device_memory_snapshot`` / ``record_device_memory`` — per-card
  allocated bytes (``torch.cuda.memory_stats(d)["allocated_bytes.all.
  current"]``) surfaced as ``device_mem_bytes{device=}`` gauges and
  sampled into the history ring. Without a card the snapshot is empty:
  an empty dict is an honest answer, never a guess.

The default capture is ``torch.profiler.profile(activities=[CPU, CUDA])``
(CUDA only where a card is visible). The profiler must be stopped on the
thread that started it, and the ops endpoint serves each request on a
thread of its own, so the capture runs on a dedicated thread that starts
it, waits for the stop, stops it and exports a Chrome trace
(``trace-<pid>-<n>.json``) into the capture directory. The card's kernels
are traced process-wide, whichever thread launched them, and host ops
on every thread (``profile_all_threads``). On a card each capture opens
with a burst of marker kernels (``MARKERS``, see there) so that the
trace holds every launch made after ``start`` returns. The starter and stopper are injectable, so tests exercise
the lock protocol and dump lifecycle without a profiler at all.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Dict, Optional

__all__ = [
    "DeviceProfiler",
    "device_memory_snapshot",
    "record_device_memory",
]


# A capture can miss the first kernels launched after its start, in two
# ways (scripts/torch_devprof_start.py, on an H100): in some sessions the
# profiler drops the first N kernel records, N growing by about one every
# 13 s of the process's age whatever the process did; and it places the
# card's timestamps up to milliseconds off the host's, dropping kernels
# that this puts before the session's start. So each capture opens with
# a burst of marker kernels, waited for, then a settle: both losses take
# markers, not the caller's launches. The trace opens with the markers.
# The capture counts the markers its trace lost and widens the next
# burst to four times that.
MARKERS = 256
MARKER_SETTLE_S = 0.05
MARKER_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def _count_markers(path: str) -> int:
    """The marker kernels a Chrome trace names."""
    import json

    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events
               if e.get("cat") == "kernel" and MARKER_KERNEL in e.get("name", ""))


class _TorchCapture:
    """One ``torch.profiler`` capture on a thread of its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started = threading.Event()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self._seq = 0
        self.last_trace: Optional[str] = None
        self.markers = MARKERS  # the next capture's burst
        self.markers_lost: Optional[int] = None  # of the last capture's burst

    def start(self, out_dir: str) -> None:
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("a torch.profiler capture is already running")
            self._seq += 1
            path = os.path.join(out_dir, f"trace-{os.getpid()}-{self._seq}.json")
            self._stop.clear()
            self._started.clear()
            self._done.clear()
            self._error = None
            self._thread = threading.Thread(target=self._run, args=(path,),
                                            name="devprof-capture", daemon=True)
            self._thread.start()
        self._started.wait()
        if self._error is not None:
            self._join()
            raise RuntimeError(f"torch.profiler did not start: {self._error!r}")

    def _run(self, path: str) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            # Host ops of every thread, not only the capture thread's.
            prof = profile(activities=activities,
                           experimental_config=_ExperimentalConfig(profile_all_threads=True))
            prof.start()
            markers = self.markers if torch.cuda.is_available() else 0
            for _ in range(markers):
                torch.cuda._sleep(1)
            if markers:
                torch.cuda.synchronize()
                time.sleep(MARKER_SETTLE_S)
        except BaseException as exc:  # surfaced by start()
            self._error = exc
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(path)
            self.last_trace = path
            if markers:
                self._count_lost(markers, path)
        except BaseException as exc:  # surfaced by stop()
            self._error = exc
        finally:
            self._done.set()

    def _count_lost(self, markers: int, path: str) -> None:
        """The markers of a burst of ``markers`` that the trace at ``path``
        lost, and the next burst four times that, never narrower."""
        self.markers_lost = max(0, markers - _count_markers(path))
        self.markers = max(self.markers, 4 * self.markers_lost)

    def stop(self) -> None:
        with self._lock:
            if self._thread is None:
                raise RuntimeError("no torch.profiler capture is running")
        self._stop.set()
        self._done.wait()
        self._join()
        if self._error is not None:
            raise RuntimeError(f"torch.profiler did not stop: {self._error!r}")

    def _join(self) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30)


_capture = _TorchCapture()


def _torch_start_trace(out_dir: str) -> None:
    _capture.start(out_dir)


def _torch_stop_trace() -> None:
    _capture.stop()


class DeviceProfiler:
    """Start/stop trace capture with a capture lock (see module doc).

    ``start`` answers ``{"status": "started", ...}`` or
    ``{"status": "busy", ...}`` — never raises for the already-capturing
    case, because the remote caller poking ``/profile?action=start``
    twice deserves a 409-shaped answer, not a stack trace. Runtime
    failures from the underlying profiler *are* surfaced (as
    ``{"status": "error", ...}``) so a misconfigured backend is visible.
    """

    def __init__(self, out_dir: Optional[str] = None,
                 starter: Callable[[str], None] = _torch_start_trace,
                 stopper: Callable[[], None] = _torch_stop_trace,
                 clock=time.monotonic):
        self.out_dir = out_dir
        self._starter = starter
        self._stopper = stopper
        self.clock = clock
        self._lock = threading.Lock()
        self._capturing = False
        self._capture_dir: Optional[str] = None
        self._started_at: Optional[float] = None
        self.captures = 0  # completed start→stop cycles

    def _resolve_dir(self, out_dir: Optional[str]) -> str:
        d = out_dir or self.out_dir
        if d is None:
            d = os.path.join(tempfile.gettempdir(), "elephas-profile")
        os.makedirs(d, exist_ok=True)
        return d

    def start(self, out_dir: Optional[str] = None) -> Dict[str, object]:
        with self._lock:
            if self._capturing:
                return {"status": "busy", "dir": self._capture_dir,
                        "since_s": self.clock() - self._started_at}
            d = self._resolve_dir(out_dir)
            try:
                self._starter(d)
            except Exception as exc:
                return {"status": "error", "error": repr(exc), "dir": d}
            self._capturing = True
            self._capture_dir = d
            self._started_at = self.clock()
            return {"status": "started", "dir": d}

    def stop(self) -> Dict[str, object]:
        with self._lock:
            if not self._capturing:
                return {"status": "idle"}
            d, t0 = self._capture_dir, self._started_at
            try:
                self._stopper()
            except Exception as exc:
                # The capture is unrecoverable either way; release the
                # lock so a retry can start fresh.
                self._capturing = False
                self._capture_dir = None
                self._started_at = None
                return {"status": "error", "error": repr(exc), "dir": d}
            self._capturing = False
            self._capture_dir = None
            self._started_at = None
            self.captures += 1
            return {"status": "stopped", "dir": d,
                    "duration_s": self.clock() - t0}

    def status(self) -> Dict[str, object]:
        with self._lock:
            doc: Dict[str, object] = {
                "capturing": self._capturing,
                "captures": self.captures,
                "dir": self._capture_dir or self.out_dir,
            }
            if self._capturing:
                doc["since_s"] = self.clock() - self._started_at
            return doc


def device_memory_snapshot() -> Dict[str, int]:
    """Per-card allocated bytes: ``{"cuda_0": 123456, ...}``, read from
    ``torch.cuda.memory_stats`` (the caching allocator's live tensors).
    Empty without a card — and never initialises CUDA in a process that
    has not touched it yet (a CPU-only process answers ``{}``)."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        count = torch.cuda.device_count()
    except Exception:
        return {}
    out: Dict[str, int] = {}
    for i in range(count):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            continue
        if "allocated_bytes.all.current" in stats:
            out[f"cuda_{i}"] = int(stats["allocated_bytes.all.current"])
    return out


def record_device_memory(registry=None) -> Dict[str, int]:
    """Probe device memory and set ``device_mem_bytes{device=}`` gauges.

    This is the ``extra_fn`` a ``HistorySampler`` runs before each tick,
    so the watermarks are fresh in the snapshot the tick records. Returns
    the probe result (handy for the ``/profile`` status body).
    """
    if registry is None:
        from elephas_tpu_torch import obs

        registry = obs.default_registry()
    snap = device_memory_snapshot()
    if snap:
        gauge = registry.gauge(
            "device_mem_bytes",
            help="live device buffer bytes, by device",
            labelnames=("device",))
        for name, nbytes in snap.items():
            gauge.labels(device=name).set(nbytes)
    return snap
