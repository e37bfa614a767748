"""The port's observability copies (``elephas_tpu_torch.obs``) against the
JAX package's (``elephas_tpu.obs``): the same event sequence fed into
both packages' objects must give the same exposition bytes, histogram
quantiles, flight-recorder notes, load/goodput/cost snapshots, alert
firings and Chrome trace JSON."""

import json
import time
import types

import numpy as np
import pytest

import elephas_tpu.obs as jax_obs
import elephas_tpu_torch.obs as port_obs
from elephas_tpu_torch.utils import locksan


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def fixed_wall_clock(monkeypatch):
    # Flight notes and the trace's clockSync block sample wall time.
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


def _both(drive):
    ref, ours = drive(jax_obs), drive(port_obs)
    assert ours == ref
    return ours


def _results(seed=0, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        status = "completed" if rng.random() < 0.85 else "timeout"
        out.append(types.SimpleNamespace(
            req_id=i, status=status, tokens=[1] * int(rng.integers(1, 9)),
            ttft_s=float(rng.lognormal(-1.0, 1.2)) if status == "completed" else None,
            itl_s_avg=float(rng.lognormal(-3.0, 1.0)) if rng.random() < 0.9 else None,
            tenant=["a", "b", None][i % 3]))
    return out


def test_registry_exposition_bytes_and_snapshot():
    def drive(obs):
        rng = np.random.default_rng(1)
        reg = obs.MetricsRegistry()
        c = reg.counter("serve_requests_total", help="requests", labelnames=("route",))
        for _ in range(7):
            c.labels(route=["a", "b\"q"][int(rng.integers(0, 2))]).inc(int(rng.integers(1, 4)))
        reg.gauge("pool_free", help="free slots").set(3.5)
        h = reg.histogram("serving_itl_seconds", help="itl")
        for v in rng.lognormal(-3.0, 1.5, 500):
            h.observe(float(v))
        hl = reg.histogram("step_seconds", labelnames=("phase",))
        for v in rng.exponential(0.01, 200):
            hl.labels(phase="decode").observe(float(v))
        return reg.expose_text(), reg.snapshot()

    text, snap = _both(drive)
    assert "serving_itl_seconds_bucket" in text and snap


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "bimodal"])
def test_histogram_quantiles(dist):
    def drive(obs):
        rng = np.random.default_rng(2)
        values = {"lognormal": rng.lognormal(-2.0, 1.0, 2000),
                  "uniform": rng.uniform(0.0, 3.0, 2000),
                  "bimodal": np.concatenate([rng.normal(0.01, 0.001, 1000),
                                             rng.normal(2.0, 0.1, 1000)])}[dist]
        h = obs.Histogram("x")
        for v in values:
            h.observe(float(abs(v)))
        return (h.percentiles((0.1, 0.5, 0.9, 0.95, 0.99, 0.999)), h.mean,
                h.count, h.sum)

    _both(drive)


def test_flight_recorder_notes_and_overwrite():
    def drive(obs):
        clock = FakeClock()
        rec = obs.FlightRecorder(capacity=5, clock=clock)
        for i, kind in enumerate(["backpressure_reject", "deadline_eviction",
                                  "retrace_storm", "prefix_evict",
                                  "deadline_eviction", "backpressure_reject",
                                  "deadline_eviction"]):
            clock.advance(0.5)
            rec.note(kind, "info" if kind == "prefix_evict" else "warn",
                     req_id=i, where="queue")
        with pytest.raises(ValueError):
            rec.note("deadline_eviction", "loud")
        return (rec.snapshot(),
                [e.to_dict() for e in rec.events(kind="deadline_eviction")],
                len(rec.events(min_severity="warn")))

    snap, _, _ = _both(drive)
    assert snap["dropped"] == 2 and snap["capacity"] == 5


def test_load_tracker_snapshots():
    def drive(obs):
        clock = FakeClock()
        tracker = obs.LoadTracker(clock=clock)
        rng = np.random.default_rng(3)
        snaps = []
        admitted = rejected = tokens = 0
        for _ in range(30):
            clock.advance(float(rng.uniform(0.01, 0.5)))
            admitted += int(rng.integers(0, 3))
            rejected += int(rng.integers(0, 2))
            tokens += int(rng.integers(0, 40))
            tracker.observe(queue_depth=int(rng.integers(0, 16)), queue_limit=16,
                            active=int(rng.integers(0, 8)), max_slots=8,
                            kv_free_frac=float(rng.random()),
                            admitted_total=admitted, rejected_total=rejected,
                            tokens_total=tokens, kv_blocks_free=int(rng.integers(0, 64)),
                            kv_blocks_total=64, prefix_hit_rate=float(rng.random()))
            snaps.append(tracker.snapshot())
        return snaps

    _both(drive)


def test_goodput_ledger_snapshots():
    def drive(obs):
        clock = FakeClock()
        ledger = obs.GoodputLedger(clock=clock, registry=obs.MetricsRegistry())
        out = []
        for r in _results():
            clock.advance(3.0)
            out.append(ledger.record(r))
        out.append(ledger.snapshot())
        out.append(ledger.burn())
        return out

    _both(drive)


def test_cost_ledger_snapshots():
    def drive(obs):
        clock = FakeClock()
        ledger = obs.CostLedger(clock=clock, registry=obs.MetricsRegistry())
        for r in _results(seed=4):
            clock.advance(1.5)
            ledger.record_submit(r.tenant)
            ledger.record_queue(r.tenant, 0.25)
            ledger.record_prefill(r.tenant, 12, cached=4)
            ledger.record_decode(r.tenant, len(r.tokens))
            ledger.record_block_seconds(r.tenant, 2.0 + r.req_id % 5)
            ledger.record_status(r.tenant, r.status)
            ledger.record_goodput(r)
        ledger.record_reject("b")
        fired = ledger.evaluate_alerts()
        return (ledger.snapshot(), ledger.kv_share(), ledger.goodput_ratio(),
                ledger.tenants(), [f["rule"] for f in fired], obs.DEFAULT_TENANT)

    _both(drive)


def test_alert_engine_fires_identically():
    def drive(obs):
        clock = FakeClock()
        reg = obs.MetricsRegistry()
        flight = obs.FlightRecorder(clock=clock)
        engine = obs.AlertEngine(registry=reg, flight=flight, clock=clock)
        itl = reg.histogram("serving_itl_seconds")
        retries = reg.counter("ps_push_retry_total")
        seq = []
        for step in range(12):
            clock.advance(10.0)
            itl.observe(0.5 if step in (3, 4, 5) else 0.01)
            retries.inc(50 if step > 6 else 0)
            seq.append([f["rule"] for f in engine.evaluate()])
        return seq, engine.snapshot(), flight.snapshot(), list(obs.RULE_NAMES)

    seq, _, _, _ = _both(drive)
    assert any(seq)


def test_chrome_trace_json(tmp_path):
    def drive(obs):
        clock = FakeClock()
        tracer = obs.Tracer(clock=clock, annotate_device=False)
        for i in range(4):
            t0 = clock()
            clock.advance(0.25)
            tracer.record("queue", t0, clock(), track=f"req:{i}", req_id=i)
            tracer.instant("submit", track=f"req:{i}", req_id=i)
            with tracer.span("decode_step", lanes=i):
                clock.advance(0.01)
        path = tmp_path / f"{obs.__name__}.json"
        tracer.export_chrome(str(path), process="serving")
        return path.read_bytes(), tracer.to_chrome_events(), len(tracer)

    raw, events, n = _both(drive)
    assert json.loads(raw)["traceEvents"] == events and n == 12


def test_tracer_bridges_spans_into_the_torch_profiler():
    import torch

    tracer = port_obs.Tracer(annotate_device=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("serving/decode"):
            torch.ones(4).sum()
    assert "serving/decode" in {e.key for e in prof.key_averages()}
    assert tracer.events()[0].name == "serving/decode"


def test_note_retrace_counts_and_files_storms():
    flight = port_obs.FlightRecorder(capacity=16)
    previous = port_obs.default_flight_recorder()
    port_obs.set_default_flight_recorder(flight)
    try:
        family = port_obs.default_registry().counter(
            "retrace_total", help="hot-program (re)traces across the process",
            labelnames=("program",))
        before = family.labels(program="test_prog").value
        for i in range(4):
            port_obs.note_retrace("test_prog", count=i + 1)
        assert family.labels(program="test_prog").value == before + 4
        storms = flight.events(kind="retrace_storm")
        assert len(storms) == 1 and storms[0].detail["program"] == "test_prog"
    finally:
        port_obs.set_default_flight_recorder(previous)


def test_default_tracer_switches():
    assert port_obs.default_tracer() is port_obs.NULL_TRACER
    live = port_obs.enable_tracing(annotate_device=False)
    try:
        assert port_obs.default_tracer() is live and live.enabled
    finally:
        port_obs.disable_tracing()
    assert port_obs.default_tracer() is port_obs.NULL_TRACER


def test_lock_sanitizer_off_by_default_and_catches_inversions():
    import threading

    assert type(locksan.make_lock("X._lock")) is type(threading.Lock())
    locksan.enable()
    try:
        a, b = locksan.make_lock("A._lock"), locksan.make_lock("B._lock")
        with a:
            with b:
                pass
        with b:
            with pytest.raises(locksan.LockOrderInversion):
                a.acquire()
        with a:
            with pytest.raises(locksan.LockOrderInversion, match="self-deadlock"):
                a.acquire()
    finally:
        locksan.disable()
