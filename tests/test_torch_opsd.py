"""The live ops endpoint (``elephas_tpu_torch/obs/opsd.py``) against the
JAX package's (``elephas_tpu/obs/opsd.py``).

Two started servers, one of each package, each over its own package's
surfaces in the same state (registry, tracer, flight recorder, history
sampler, alert engine, load tracker, goodput and cost ledgers, device
profiler, telemetry store): every route answers with the same status
and the same document keys, ``/metrics`` is the same text apart from
the process identity line's boot and pid, the 404 body lists the same
routes, and both bind loopback unless ``ELEPHAS_OPS_BIND`` says
otherwise. Real HTTP requests over loopback throughout.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

from elephas_tpu import obs as jax_obs
from elephas_tpu.obs import devprof as jax_devprof
from elephas_tpu.obs import opsd as jax_opsd
from elephas_tpu_torch import obs as torch_obs
from elephas_tpu_torch.obs import devprof as torch_devprof
from elephas_tpu_torch.obs import opsd as torch_opsd


def _get(url, timeout=5.0):
    """(status, content type, body bytes) for a GET, 4xx/5xx included."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.headers.get("Content-Type"), err.read()


def _keys(doc):
    """The document's key structure: dicts by their keys (recursively),
    lists by their first element's structure, leaves by nothing."""
    if isinstance(doc, dict):
        return {k: _keys(v) for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return [_keys(doc[0])] if doc else []
    return None


def _server(obs, opsd, devprof, tmp_path, name):
    """A started server over ``obs``'s surfaces, in a fixed state."""
    clock = iter(float(t) for t in range(1000)).__next__
    registry = obs.MetricsRegistry()
    registry.counter("ps_push_total", help="pushes", labelnames=("transport",)).labels(
        transport="socket").inc(3)
    registry.gauge("serving_queue_depth", help="queued").set(4)
    hist = registry.histogram("serving_itl_seconds", help="itl")
    for v in (0.01, 0.02, 0.05):
        hist.observe(v)
    tracer = obs.Tracer(annotate_device=False)
    with tracer.span("ps/handle_pull", boot="boot01"):
        pass
    flight = obs.FlightRecorder(capacity=8)
    flight.note("wal_restore", "info", version=2)
    sampler = obs.HistorySampler(registry=registry, clock=lambda: 0.0)
    sampler.tick(now=0.0)
    registry.counter("ps_push_total", help="pushes", labelnames=("transport",)).labels(
        transport="socket").inc(2)
    sampler.tick(now=2.0)
    alerts = obs.AlertEngine(registry=registry, flight=flight)
    load = obs.LoadTracker(clock=lambda: 5.0)
    load.observe(queue_depth=2, queue_limit=8, active=3, max_slots=4, kv_free_frac=0.5)
    slo = obs.GoodputLedger(clock=lambda: 5.0, registry=registry)
    costs = obs.CostLedger(clock=lambda: 5.0)
    store = obs.TelemetryStore(str(tmp_path / name / "telemetry"), role="ps", boot="bootX",
                               clock=clock)
    store.record("flight", {"kind": "wal_restore"})
    profiler = devprof.DeviceProfiler(out_dir=str(tmp_path / name / "prof"),
                                      starter=lambda d: None, stopper=lambda: None)
    server = opsd.OpsServer(
        port=0, registry=registry, tracer=tracer, flight=flight, role="ps", boot="bootX",
        worker_id="w0",
        vars_fn=lambda: {"role": "test", "version": 7},
        health_fn=lambda: {"workers_alive": 2},
        workers_fn=lambda: {"workers": {"w0": {"pushes": 3}}, "max_staleness": 1},
        alerts_fn=alerts.scrape, history=sampler, profiler=profiler,
        load_fn=load.snapshot, slo_fn=slo.snapshot, tenants_fn=costs.snapshot,
        incidents_fn=store.doc)
    server.start()
    return server, store


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("opsd")
    pair = {"jax": _server(jax_obs, jax_opsd, jax_devprof, tmp, "jax"),
            "torch": _server(torch_obs, torch_opsd, torch_devprof, tmp, "torch")}
    yield {name: server for name, (server, _) in pair.items()}
    for server, store in pair.values():
        server.stop()
        store.close()


def test_the_route_table_is_the_jax_one():
    assert torch_opsd.ROUTES == jax_opsd.ROUTES
    assert torch_obs.ROUTES == jax_obs.opsd.ROUTES


@pytest.mark.parametrize("route", [r for r in jax_opsd.ROUTES if r != "/metrics"] +
                         ["/history?window=5", "/profile?action=start",
                          "/profile?action=reboot"])
def test_every_route_answers_with_the_jax_document_keys(servers, route):
    answers, docs = {}, {}
    for name, server in servers.items():
        status, ctype, body = _get(f"{server.url}{route}")
        docs[name] = json.loads(body)
        answers[name] = (status, ctype)
    if route == "/profile":
        # The card's memory by device: JAX reports its CPU devices too;
        # without a card the port's answer is empty (devprof's contract).
        assert docs["torch"].pop("device_memory") == {}
        assert isinstance(docs["jax"].pop("device_memory"), dict)
    assert answers["torch"] == answers["jax"]
    assert _keys(docs["torch"]) == _keys(docs["jax"])
    assert answers["torch"][0] in (200, 400)


def test_the_shells_of_unprovided_routes_are_the_jax_ones(servers):
    """Routes whose provider is not ported yet answer exactly as the JAX
    server does when none is given."""
    for route in ("/fleet", "/canary", "/replicas", "/tiers", "/rollout", "/trials",
                  "/shards"):
        docs = {name: json.loads(_get(f"{s.url}{route}")[2]) for name, s in servers.items()}
        assert docs["torch"] == docs["jax"], route


def _masked_metrics(text):
    return re.sub(r'(elephas_process_info\{[^}]*)pid="\d+"', r'\1pid="-"', text)


def test_metrics_text_is_the_jax_text_apart_from_the_pid(servers):
    texts = {}
    for name, server in servers.items():
        status, ctype, body = _get(f"{server.url}/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        texts[name] = body.decode()
    assert _masked_metrics(texts["torch"]) == _masked_metrics(texts["jax"])
    info = [line for line in texts["torch"].splitlines()
            if line.startswith("elephas_process_info")]
    assert len(info) == 1 and 'role="ps"' in info[0] and 'boot="bootX"' in info[0]
    assert 'ps_push_total{transport="socket"} 5' in texts["torch"]


def test_the_404_body_lists_the_known_routes(servers):
    docs = {}
    for name, server in servers.items():
        status, _, body = _get(f"{server.url}/nope")
        assert status == 404
        docs[name] = json.loads(body)
    assert docs["torch"] == docs["jax"]
    assert docs["torch"]["path"] == "/nope"


def test_identity_routes_carry_the_same_values(servers):
    for route in ("/vars", "/meta", "/workers", "/flight"):
        docs = {}
        for name, server in servers.items():
            doc = json.loads(_get(f"{server.url}{route}")[2])
            for key in ("pid", "ops_port", "uptime_s", "wall_s", "mono_s", "t", "started_at"):
                doc.pop(key, None)
            docs[name] = doc
        assert docs["torch"].keys() == docs["jax"].keys(), route
    history = {name: json.loads(_get(f"{s.url}/history")[2]) for name, s in servers.items()}
    assert history["torch"] == history["jax"]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_the_endpoint_binds_loopback_unless_told(monkeypatch, package):
    opsd = {"jax": jax_opsd, "torch": torch_opsd}[package]
    monkeypatch.delenv("ELEPHAS_OPS_BIND", raising=False)
    assert opsd.OpsServer(port=0).host == "127.0.0.1"
    monkeypatch.setenv("ELEPHAS_OPS_BIND", "0.0.0.0")
    assert opsd.OpsServer(port=0).host == "0.0.0.0"
    assert opsd.OpsServer(port=0, host="127.0.0.2").host == "127.0.0.2"


def test_trace_route_is_chrome_json_with_the_clock_sync_block(servers):
    docs = {name: json.loads(_get(f"{s.url}/trace")[2]) for name, s in servers.items()}
    for doc in docs.values():
        assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == ["ps/handle_pull"]
        assert {"origin_mono_s", "mono_s_at_export", "wall_s_at_export"} <= set(doc["clockSync"])
    assert set(docs["torch"]) == set(docs["jax"])


def test_history_samplers_agree_on_the_same_registry_operations():
    """``HistorySampler`` of both packages: the same ticks over the same
    registry operations give the same snapshot, and a store attached to
    each journals the same metric records."""
    snaps = {}
    for name, obs in (("jax", jax_obs), ("torch", torch_obs)):
        registry = obs.MetricsRegistry()
        counter = registry.counter("ps_push_total", help="pushes")
        registry.gauge("unrelated_gauge", help="not sampled").set(1)
        sampler = obs.HistorySampler(registry=registry, clock=lambda: 0.0, period_s=0.5)
        for t in range(6):
            counter.inc(t)
            sampler.maybe_tick(now=t * 0.3)
        snaps[name] = (sampler.snapshot(window_s=1.0, now=1.5), sampler.snapshot())
    assert snaps["torch"] == snaps["jax"]
    assert list(snaps["torch"][1]["series"]) == ["ps_push_total"]
    assert torch_obs.DEFAULT_SAMPLE_PREFIXES == jax_obs.history.DEFAULT_SAMPLE_PREFIXES
