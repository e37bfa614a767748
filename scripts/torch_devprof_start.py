#!/usr/bin/env python3
"""How many kernel launches made right after a ``/profile`` capture's
start reach its trace, under several ways of starting the capture.

    env PYTHONPATH=. python3 scripts/torch_devprof_start.py [CAPTURES]
    env PYTHONPATH=. python3 scripts/torch_devprof_start.py --after-phases [CAPTURES]
    env PYTHONPATH=. python3 scripts/torch_devprof_start.py --clock [SECONDS]

Each arm is a way of starting the capture on its thread (``ArmCapture``,
a ``obs.devprof._TorchCapture`` whose start is spelled out here): after
``prof.start()``, a marker kernel waited for (``fence``) and a sleep
(``settle_s``); a throwaway capture started and stopped on the capture
thread before the real one (``prime``); host ops of every thread
(``all_threads``, the ``/profile`` default) or of the capture thread
only. ``bare`` is the capture as ``/profile`` ran it before its marker
burst (``obs.devprof.MARKERS``). Two conditions, in
this order in one process:

- ``fresh``: no other profiler session has run in the process;
- ``after_main``: before each capture, a ``torch.profiler`` session on
  the main thread around one kernel (as ``chip_smoke.device_breakdown``
  runs one in the phases before the ops phase).

Two workloads, CAPTURES captures each (default 20): ``fill``, a capture
started directly, then ``LAUNCHES`` fills of growing sizes (each launch
its own grid in the trace); and ``lm``, ``chip_smoke.py``'s ops check —
``SyncTrainer.mount_ops``, ``/profile?action=start`` over HTTP, one train
step of the full-width LM in float32 through K1-K3 (4 launches of each),
``?action=stop`` — held to the launch counters. Prints one JSON line per
condition, arm and workload: the launches each trace names, the captures
that hold every launch, which fills are missing (0 the first after
``start``), all kernel events per LM capture, and how far the first
traced fill starts after the host's clock at ``start``'s return
(negative where the card's timestamps, moved to the host's clock, land
before it). Then the card's name and power limit. Needs a card and
``nvcc``.

``--after-phases`` recreates the condition of ``chip_smoke.py``'s ops
check, late in one long process: it runs ``chip_smoke.py``'s phases in
its order up to the ops phase, and probes the capture before the first
and after each (``PROBE_ARMS``: ``bare`` and ``route``, ``obs.devprof``'s
own capture; CAPTURES fill and LM captures each, default 3), so the first
phase after which a launch goes missing is the one that causes the loss.
After the last phase ``FINAL_ARMS`` are probed. An idle child
process, started first, holds a card context of its own through the
phases and then probes every arm too: a loss there and not in a fresh
process comes with the process's age, not with what the phases did.
One JSON line per probe and arm, as it goes, with the phase's error if
it raised (the probes go on).

``--clock`` runs ``chip_smoke.kernel_phase``, then ``CLOCK_ARMS`` in turn
for SECONDS (default 150), and matches each traced kernel to its host
launch by correlation id (``trace_timing``): how far kernels sit from
their launches, and where the lost launches fall in the window.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from elephas_tpu_torch.obs import devprof

LAUNCHES = 12
ARMS = {  # name: (fence, settle_s, prime, all_threads)
    "bare": (False, 0.0, False, True),
    "settled": (True, 0.05, False, True),
    "primed": (False, 0.0, True, True),
    "one_thread": (False, 0.0, False, False),
}
# Tried by --clock: margins at both ends of the window, and a throwaway
# capture of half a second just before the real one.
CLOCK_ARMS = {  # name: (fence, settle_s, prime, all_threads, tail_s, prime_s)
    "bare": (False, 0.0, False, True),
    "margins_50ms": (True, 0.05, False, True, 0.05),
    "margins_200ms": (True, 0.2, False, True, 0.2),
    "long_prime": (False, 0.0, True, True, 0.0, 0.5),
}
# Tried by --after-phases, where the loss shows: a settle of a second,
# longer than any lead the fresh process showed, and --clock's arms.
LATE_ARMS = {**ARMS, "settled_1s": (True, 1.0, False, True),
             **{k: v for k, v in CLOCK_ARMS.items() if k != "bare"}}
# --after-phases probes ``bare`` and ``route`` (``obs.devprof``'s own
# capture, with its marker burst, one object kept across the process's
# captures as the route keeps it) at each point, and these before the ops
# phase.
PROBE_ARMS = ["bare", "route"]
FINAL_ARMS = ["bare", "route", "primed", "settled", "margins_200ms", "settled_1s"]


class ArmCapture(devprof._TorchCapture):
    """The capture thread of ``_TorchCapture``, started as an arm says:
    ``tail_s`` waits between the stop request and ``prof.stop()``, and a
    throwaway capture (``prime``) lasts ``prime_s``."""

    def __init__(self, fence, settle_s, prime, all_threads, tail_s=0.0, prime_s=0.0):
        super().__init__()
        self.arm = (fence, settle_s, prime, all_threads, tail_s, prime_s)

    def _run(self, path):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        fence, settle_s, prime, all_threads, tail_s, prime_s = self.arm
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

        def make():
            return profile(activities=activities, experimental_config=_ExperimentalConfig(
                profile_all_threads=all_threads))

        if prime:
            warm = make()
            warm.start()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(prime_s)
            warm.stop()
        prof = make()
        prof.start()
        if fence:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        time.sleep(settle_s)
        self._started.set()
        self._stop.wait()
        torch.cuda.synchronize()
        time.sleep(tail_s)
        prof.stop()
        prof.export_chrome_trace(path)
        self.last_trace = path
        self._done.set()


def main_thread_session():
    """A main-thread profiler session around one kernel, read as
    ``chip_smoke.device_breakdown`` reads its own."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 16, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        x.mul_(1.0)
        torch.cuda.synchronize()
    prof.key_averages()


def fills(buf):
    """LAUNCHES fill kernels of growing sizes, waited for."""
    for i in range(LAUNCHES):
        buf[:(i + 1) << 18].fill_(float(i))
    torch.cuda.synchronize()


def fill_capture(capture, buf, out_dir, before):
    before()
    capture.start(out_dir)
    started_us = time.time_ns() / 1e3
    fills(buf)
    capture.stop()
    doc = json.loads(Path(capture.last_trace).read_text())
    kernels = [e for e in doc["traceEvents"]
               if e.get("cat") == "kernel" and "Fill" in e.get("name", "")]
    base_ns = doc.get("baseTimeNanoseconds")
    first_ts = min((float(e["ts"]) for e in kernels), default=None)
    lead_us = None
    if first_ts is not None:
        lead_us = first_ts + (base_ns / 1e3 if base_ns else 0.0) - started_us
    return {"found": len(kernels),
            "grids": {tuple(e.get("args", {}).get("grid", ())) for e in kernels},
            "first_kernel_after_start_us": lead_us, "timing": trace_timing(doc, started_us),
            "markers_lost": capture.markers_lost}


class LmStep:
    """``chip_smoke.py``'s ops check: the full-width LM f32 train step
    behind ``SyncTrainer.mount_ops``, captured over ``/profile``."""

    def __init__(self):
        from elephas_tpu_torch.api import CompiledModel
        from elephas_tpu_torch.engine.step import init_train_state
        from elephas_tpu_torch.engine.sync import SyncTrainer
        from elephas_tpu_torch.models import get_model
        from elephas_tpu_torch.parallel.mesh import build_mesh

        rng = np.random.default_rng(cs.SEED)
        self.tokens = torch.as_tensor(rng.integers(0, 32000, (cs.BATCH, cs.SEQ + 1)),
                                      device="cuda")
        lm = CompiledModel(get_model("transformer_lm", attention="flash", dtype="float32"),
                           optimizer={"name": "adam", "learning_rate": 1e-3},
                           loss="sparse_categorical_crossentropy", metrics=["acc"],
                           seed=cs.SEED)
        self.trainer = SyncTrainer(lm, build_mesh())
        self.state = init_train_state(lm)
        self.ops = self.trainer.mount_ops()
        self.step()  # warm
        torch.cuda.synchronize()

    def step(self):
        t = self.tokens
        self.state, _ = self.trainer._train_step(self.state, t[:, :-1], t[:, 1:])

    def capture(self, out_dir, before):
        from elephas_tpu_torch.ops import attention_cuda

        for old in Path(out_dir).glob("trace-*.json"):
            old.unlink()
        before()
        attention_cuda.reset_launches()
        cs.scrape(f"{self.ops.url}/profile?action=start&dir={out_dir}")
        started_us = time.time_ns() / 1e3
        self.step()
        torch.cuda.synchronize()
        cs.scrape(f"{self.ops.url}/profile?action=stop")
        doc = json.loads(next(Path(out_dir).glob("trace-*.json")).read_text())
        kernels = [e for e in doc["traceEvents"] if e.get("cat") == "kernel"]
        names = [e["name"] for e in kernels]
        out = {k: [sum(n in x for x in names), attention_cuda.launches[k]]
               for k, n in cs.OPS_TRACE_KERNELS.items()}
        out["kernel_events"] = len(names)
        base_ns = doc.get("baseTimeNanoseconds")
        out["first_kernel_after_start_us"] = None if not kernels else (
            min(float(e["ts"]) for e in kernels) + (base_ns / 1e3 if base_ns else 0.0)
            - started_us)
        out["timing"] = trace_timing(doc, started_us)
        out["markers_lost"] = devprof._capture.markers_lost
        return out


def summary_lines(head, fill_runs, lm_runs, order):
    """The two JSON lines of one arm: its fill captures (``order``: the
    fills' grids over all captures, in launch order) and its LM ones."""
    found = [r["found"] for r in fill_runs]
    fill = {**head, "workload": "fill", "launches": LAUNCHES, "found": found,
            "complete": sum(f == LAUNCHES for f in found),
            "missing_launches": [[i for i, g in enumerate(order) if g not in r["grids"]]
                                 for r in fill_runs if r["found"] < LAUNCHES],
            "first_kernel_after_start_us": [r["first_kernel_after_start_us"]
                                            for r in fill_runs],
            "timing": [r["timing"] for r in fill_runs],
            "markers_lost": [r["markers_lost"] for r in fill_runs]}
    lm = {**head, "workload": "lm",
          "found_of_launched": {k: [r[k] for r in lm_runs] for k in cs.OPS_TRACE_KERNELS},
          "kernel_events": [r["kernel_events"] for r in lm_runs],
          "complete": sum(all(r[k][0] == r[k][1] for k in cs.OPS_TRACE_KERNELS)
                          for r in lm_runs),
          "lost_total": {k: sum(r[k][1] - r[k][0] for r in lm_runs)
                         for k in cs.OPS_TRACE_KERNELS},
          "first_kernel_after_start_us": [r["first_kernel_after_start_us"] for r in lm_runs],
          "timing": [r["timing"] for r in lm_runs],
          "markers_lost": [r["markers_lost"] for r in lm_runs]}
    return [json.dumps(fill), json.dumps(lm)]


class Prober:
    """Probes of the capture at points of one process: each arm's fill
    captures and LM captures over ``/profile``, with no session before."""

    def __init__(self, out_dir, captures, who):
        self.out_dir, self.captures, self.who = out_dir, captures, who
        self.born = time.perf_counter()
        self.buf = torch.empty(LAUNCHES * (1 << 18), device="cuda")
        fills(self.buf)
        self.lm = LmStep()
        self.grids = set()
        self.route = devprof._TorchCapture()  # the route's capture, kept across probes

    def capture(self, name):
        return self.route if name == "route" else ArmCapture(*LATE_ARMS[name])

    def probe(self, point, arms, error=None):
        route_capture = devprof._capture
        for name in arms:
            fill_runs = [fill_capture(self.capture(name), self.buf, self.out_dir,
                                      lambda: None)
                         for _ in range(self.captures)]
            self.grids.update(*(r["grids"] for r in fill_runs))
            devprof._capture = self.capture(name)
            lm_runs = [self.lm.capture(self.out_dir, lambda: None)
                       for _ in range(self.captures)]
            devprof._capture = route_capture
            head = {"process": self.who, "point": point, "arm": name,
                    "age_s": time.perf_counter() - self.born, "captures": self.captures,
                    "phase_error": error}
            for line in summary_lines(head, fill_runs, lm_runs, sorted(self.grids)):
                print(line, flush=True)

    def close(self):
        self.lm.trainer.unmount_ops()


def chip_smoke_phases(attention_cuda):
    """``chip_smoke.main``'s phases before the ops phase, in its order:
    ``[(name, run)]``, each run returning the phase's report."""
    reports = {}

    def phase(name, fn, extra=lambda reports: ()):
        def run():
            out = fn(attention_cuda, *extra(reports))
            reports[name] = out[1]
            return out

        return name, run

    return [
        phase("kernel", cs.kernel_phase),
        phase("inference", cs.inference_phase),
        phase("train", cs.train_phase),
        phase("seq_parallel", cs.seq_parallel_phase),
        phase("tensor_parallel", cs.tensor_parallel_phase),
        phase("resnet", cs.resnet_phase),
        phase("repair", cs.repair_phase),
        phase("serving", cs.serving_phase),
        phase("spec_handoff", cs.spec_handoff_phase),
        phase("async", cs.async_phase),
        phase("async_multiproc", cs.async_multiproc_phase,
              lambda r: (r["async"]["cnn_async"],)),
    ]


def after_phases(captures):
    """The phases of ``chip_smoke.py`` with a probe before the first and
    after each; then every arm, here and in the idle child."""
    from elephas_tpu_torch.ops import attention_cuda

    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        flag = os.path.join(tmp, "phases-done")
        child = subprocess.Popen([sys.executable, __file__, "--idle-child", flag,
                                  str(captures)], env={**os.environ, "PYTHONPATH": "."})
        while child.poll() is None and not os.path.exists(flag + ".ready"):
            time.sleep(1.0)  # the child's first probe runs alone on the card
        os.makedirs(os.path.join(tmp, "main"))
        prober = Prober(os.path.join(tmp, "main"), captures, "phases")
        prober.probe("start", PROBE_ARMS)
        for name, run in chip_smoke_phases(attention_cuda):
            t0 = time.perf_counter()
            error = None
            try:
                run()
            except Exception:
                error = traceback.format_exc(limit=3)[-600:]
            print(json.dumps({"phase": name, "s": time.perf_counter() - t0,
                              "error": error}), flush=True)
            prober.probe(name, PROBE_ARMS, error)
        prober.probe("before_ops", FINAL_ARMS)
        prober.close()
        Path(flag).touch()
        rc = child.wait(timeout=900)
    return rc


def idle_child(flag, captures):
    """A process as old as the phases' that ran none of them: a probe at
    its start, then every arm once the phases are done."""
    from elephas_tpu_torch.ops import attention_cuda

    attention_cuda.build_all()
    with tempfile.TemporaryDirectory() as out_dir:
        prober = Prober(out_dir, captures, "idle")
        prober.probe("start", PROBE_ARMS)
        Path(flag + ".ready").touch()
        while not os.path.exists(flag):
            time.sleep(1.0)
        prober.probe("before_ops", FINAL_ARMS)
        prober.close()
    return 0


def trace_timing(doc, started_us):
    """Where a trace's kernels land against their launches: each kernel
    is matched to its host launch event by correlation id; ``skew_us`` is
    kernel start minus launch (a few microseconds when the card's
    timestamps and the host's are on one clock), ``lost`` the launches
    with no kernel, each placed by its host time against the capture's
    window (``Trace`` span) and against ``start``'s return."""
    events = doc["traceEvents"]
    base_us = (doc.get("baseTimeNanoseconds") or 0) / 1e3
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "") and "correlation" in e.get("args", {})]
    window = [(float(e["ts"]), float(e.get("dur", 0))) for e in events
              if e.get("cat") == "Trace"]
    ws, we = (window[0][0], window[0][0] + window[0][1]) if window else (None, None)
    skew = sorted(float(kernels[e["args"]["correlation"]]["ts"]) - float(e["ts"])
                  for e in launches if e["args"]["correlation"] in kernels)
    lost = [float(e["ts"]) for e in launches if e["args"]["correlation"] not in kernels]

    def rel(ts, ref):
        return None if ts is None or ref is None else round(ts - ref, 1)

    return {"launches": len(launches), "kernels": len(kernels), "lost": len(lost),
            "skew_us": [rel(skew[0], 0), rel(skew[len(skew) // 2], 0), rel(skew[-1], 0)]
            if skew else None,
            "lost_after_window_start_us": [rel(min(lost), ws), rel(max(lost), ws)]
            if lost else None,
            "lost_before_window_end_us": [rel(we, max(lost))] if lost else None,
            "window_start_after_start_return_us": rel(ws, started_us - base_us),
            "first_kernel_after_window_start_us": rel(
                min((float(e["ts"]) for e in kernels.values()), default=None), ws)}


def adjtimex():
    """The kernel's clock discipline, read (``modes`` 0): state, offset,
    frequency in ppm and status bits."""
    import ctypes

    buf = ctypes.create_string_buffer(512)
    libc = ctypes.CDLL(None, use_errno=True)
    state = libc.adjtimex(buf)
    raw = buf.raw
    offset, freq = (int.from_bytes(raw[o:o + 8], "little", signed=True) for o in (8, 16))
    status = int.from_bytes(raw[40:44], "little", signed=True)
    return {"state": state, "offset": offset, "freq_ppm": freq / 65536, "status": status}


def clock_probe(seconds):
    """Every arm of CLOCK_ARMS in turn, a fill capture and an LM capture
    each, for ``seconds`` after ``chip_smoke.kernel_phase``: one JSON line
    per capture with ``trace_timing``, and the clocks (realtime minus
    raw monotonic, adjtimex) with each round."""
    from elephas_tpu_torch.ops import attention_cuda

    t0 = time.perf_counter()
    clock0 = time.clock_gettime_ns(time.CLOCK_REALTIME) - time.clock_gettime_ns(
        time.CLOCK_MONOTONIC_RAW)
    with tempfile.TemporaryDirectory() as out_dir:
        prober = Prober(out_dir, 1, "clock")
        cs.kernel_phase(attention_cuda)
        route_capture = devprof._capture
        rounds = 0
        while time.perf_counter() - t0 < seconds:
            rounds += 1
            drift = time.clock_gettime_ns(time.CLOCK_REALTIME) - time.clock_gettime_ns(
                time.CLOCK_MONOTONIC_RAW) - clock0
            print(json.dumps({"round": rounds, "age_s": time.perf_counter() - t0,
                              "realtime_minus_raw_drift_us": drift / 1e3,
                              "adjtimex": adjtimex()}), flush=True)
            for name, arm in CLOCK_ARMS.items():
                capture = ArmCapture(*arm)
                capture.start(out_dir)
                started_us = time.time_ns() / 1e3
                fills(prober.buf)
                capture.stop()
                doc = json.loads(Path(capture.last_trace).read_text())
                print(json.dumps({"round": rounds, "arm": name, "workload": "fill",
                                  **trace_timing(doc, started_us)}), flush=True)
                for old in Path(out_dir).glob("trace-*.json"):
                    old.unlink()
                devprof._capture = ArmCapture(*arm)
                cs.scrape(f"{prober.lm.ops.url}/profile?action=start&dir={out_dir}")
                started_us = time.time_ns() / 1e3
                prober.lm.step()
                torch.cuda.synchronize()
                cs.scrape(f"{prober.lm.ops.url}/profile?action=stop")
                devprof._capture = route_capture
                doc = json.loads(next(Path(out_dir).glob("trace-*.json")).read_text())
                print(json.dumps({"round": rounds, "arm": name, "workload": "lm",
                                  **trace_timing(doc, started_us)}), flush=True)
                for old in Path(out_dir).glob("trace-*.json"):
                    old.unlink()
        prober.close()
    return 0


def main():
    if not torch.cuda.is_available():
        print("torch_devprof_start: no card", file=sys.stderr)
        return 1
    from elephas_tpu_torch.ops import attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:2] == ["--idle-child"]:
        return idle_child(sys.argv[2], int(sys.argv[3]))
    attention_cuda.build_all()
    if sys.argv[1:2] == ["--clock"]:
        rc = clock_probe(float(sys.argv[2]) if sys.argv[2:] else 150.0)
        print(f"card: {cs.smi('name,power.limit')}; torch {torch.__version__} "
              f"cuda {torch.version.cuda}")
        return rc
    if sys.argv[1:2] == ["--after-phases"]:
        rc = after_phases(int(sys.argv[2]) if sys.argv[2:] else 3)
        print(f"card: {cs.smi('name,power.limit')}; torch {torch.__version__} "
              f"cuda {torch.version.cuda}")
        return rc
    captures = int(sys.argv[1]) if sys.argv[1:] else 20
    buf = torch.empty(LAUNCHES * (1 << 18), device="cuda")
    fills(buf)  # the fill kernel loaded before any capture
    lm = LmStep()
    rows, grids = [], set()
    route_capture = devprof._capture
    with tempfile.TemporaryDirectory() as out_dir:
        for condition, before in (("fresh", lambda: None), ("after_main", main_thread_session)):
            for name, arm in ARMS.items():
                fill_runs = [fill_capture(ArmCapture(*arm), buf, out_dir, before)
                             for _ in range(captures)]
                grids.update(*(r["grids"] for r in fill_runs))
                devprof._capture = ArmCapture(*arm)  # what the /profile route starts
                lm_runs = [lm.capture(out_dir, before) for _ in range(captures)]
                rows.append((condition, name, arm, fill_runs, lm_runs))
    devprof._capture = route_capture
    lm.trainer.unmount_ops()
    # Each fill has a grid of its own, growing with its size: over all
    # captures the grids seen, in order, are the launches 0, 1, ...
    order = sorted(grids)
    for condition, name, (fence, settle_s, prime, all_threads), fill_runs, lm_runs in rows:
        head = {"condition": condition, "arm": name, "fence": fence, "settle_s": settle_s,
                "prime": prime, "all_threads": all_threads, "captures": captures}
        for line in summary_lines(head, fill_runs, lm_runs, order):
            print(line, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__} cuda {torch.version.cuda}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
