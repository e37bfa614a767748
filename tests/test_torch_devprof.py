"""The device profiler (``elephas_tpu_torch/obs/devprof.py``) against the
JAX package's (``elephas_tpu/obs/devprof.py``): the capture lock's
protocol with an injected starter and stopper gives the same documents
in both; a real ``torch.profiler`` capture on the CPU writes a Chrome
trace into the capture directory; and without a card the memory
snapshot is empty, as the JAX contract's "an empty dict is an honest
answer" asks.
"""

import json
from pathlib import Path

import pytest
import torch

from elephas_tpu.obs import devprof as jax_devprof
from elephas_tpu_torch import obs
from elephas_tpu_torch.obs import devprof


def _protocol(module, out_dir):
    """start, busy, stop, idle, with fake starter/stopper and clock."""
    calls, now = [], [10.0]

    def clock():
        now[0] += 1.0
        return now[0]

    prof = module.DeviceProfiler(out_dir=out_dir, starter=lambda d: calls.append(("start", d)),
                                 stopper=lambda: calls.append(("stop", None)), clock=clock)
    docs = [prof.status(), prof.start(), prof.start(), prof.status(), prof.stop(),
            prof.stop(), prof.status()]
    return docs, calls, prof.captures


def test_the_capture_lock_answers_as_the_jax_profiler(tmp_path):
    out = str(tmp_path / "prof")
    jax_docs, jax_calls, jax_captures = _protocol(jax_devprof, out)
    docs, calls, captures = _protocol(devprof, out)
    assert docs == jax_docs and calls == jax_calls and captures == jax_captures == 1
    assert [d.get("status") for d in docs[1:3]] == ["started", "busy"]
    assert docs[4]["status"] == "stopped" and docs[5] == {"status": "idle"}


@pytest.mark.parametrize("module", [jax_devprof, devprof], ids=["jax", "torch"])
def test_a_failing_backend_is_an_error_document_and_frees_the_lock(module):
    def broken(_d):
        raise RuntimeError("no backend")

    prof = module.DeviceProfiler(starter=broken, stopper=lambda: None)
    doc = prof.start()
    assert doc["status"] == "error" and "no backend" in doc["error"]
    assert prof.status()["capturing"] is False

    def broken_stop():
        raise RuntimeError("export failed")

    prof = module.DeviceProfiler(starter=lambda d: None, stopper=broken_stop)
    assert prof.start()["status"] == "started"
    doc = prof.stop()
    assert doc["status"] == "error" and "export failed" in doc["error"]
    assert prof.status()["capturing"] is False and prof.captures == 0


def test_a_torch_profiler_capture_on_the_cpu_writes_a_chrome_trace(tmp_path):
    """The default starter and stopper: the capture runs on a thread of
    its own, sees work launched on this thread, and exports the trace."""
    prof = devprof.DeviceProfiler(out_dir=str(tmp_path))
    assert prof.start()["status"] == "started"
    assert prof.start()["status"] == "busy"
    a = torch.randn(64, 64)
    for _ in range(3):
        a = torch.mm(a, a).tanh()
    doc = prof.stop()
    assert doc["status"] == "stopped" and prof.captures == 1
    traces = sorted(Path(tmp_path).glob("trace-*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    # A second capture starts fresh and writes a second file.
    assert prof.start()["status"] == "started"
    torch.mm(a, a)
    assert prof.stop()["status"] == "stopped"
    assert len(list(Path(tmp_path).glob("trace-*.json"))) == 2


def test_the_cpu_memory_snapshot_is_empty_and_sets_no_gauge():
    assert devprof.device_memory_snapshot() == {}
    registry = obs.MetricsRegistry()
    assert devprof.record_device_memory(registry) == {}
    assert not any(k.startswith("device_mem_bytes") for k in registry.snapshot())
