"""The port's fleet view (``elephas_tpu_torch/obs/fleet.py``) against the
JAX package's (``elephas_tpu/obs/fleet.py``), on the CPU.

The counterparts of ``tests/test_fleet.py``: the same exposition texts,
parsed label sets, bucket ladders and scripted rosters go through both
packages' functions and aggregators, and their outputs must be equal
exactly (host logic: no tolerance). The live tests scrape the port's
``OpsServer`` over real sockets with both aggregators, and the
concurrent-poll hammer is bounded to a few seconds.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from elephas_tpu.obs import fleet as jax_fleet
from elephas_tpu.obs import MetricsRegistry as JaxRegistry
from elephas_tpu_torch.obs import FlightRecorder, MetricsRegistry, OpsServer, Tracer
from elephas_tpu_torch.obs import fleet
from elephas_tpu_torch.utils import locksan


@pytest.fixture(scope="module", autouse=True)
def _lock_sanitizer(request):
    """The suite runs with the port's lock sanitizer on, seeded from
    ANALYSIS_TORCH.json (``locksan.SANITIZED_SUITES``): module fixtures
    included, so the scenarios they run are order-checked too."""
    with locksan.sanitized_suite(request.module.__name__):
        yield


FLEETS = {"jax": jax_fleet, "port": fleet}


def _exposition(registry_cls, counter_value, gauge_value, hist_vals, buckets=(0.1, 1.0),
                hist_name="ps_apply_seconds"):
    reg = registry_cls()
    reg.counter("ps_push_total", help="pushes",
                labelnames=("worker",)).labels(worker="w1").inc(counter_value)
    reg.gauge("ps_queue_depth", help="depth").set(gauge_value)
    h = reg.histogram(hist_name, buckets=list(buckets))
    for v in hist_vals:
        h.observe(v)
    return reg.expose_text()


TEXTS = {
    "registry": _exposition(MetricsRegistry, 3, 7, [0.05, 0.5, 0.5, 5.0]),
    "escapes": ('# TYPE weird_total counter\n'
                'weird_total{msg="a\\"b\\\\c\\nd",x="y"} 2\n'),
    "untyped_and_help_after": ('plain_metric 4\n# HELP plain_metric some help\n'
                               '# TYPE h histogram\nh_bucket{le="1",a="x"} 2\n'
                               'h_bucket{le="+Inf",a="x"} 3\nh_sum{a="x"} 2.5\n'
                               'h_count{a="x"} 3\n'),
}


# -- exposition parsing, label keys, percentiles ----------------------------------


@pytest.mark.parametrize("name", list(TEXTS))
def test_parse_equals_the_jax_parse(name):
    assert fleet.parse_prometheus_text(TEXTS[name]) == \
        jax_fleet.parse_prometheus_text(TEXTS[name])


def test_the_port_registry_exposition_parses_as_the_jax_registry_does():
    """The port's ``expose_text`` and the JAX package's, on the same
    metrics, parse to the same families."""
    texts = [_exposition(cls, 3, 7, [0.05, 0.5, 5.0]) for cls in (MetricsRegistry, JaxRegistry)]
    fams = fleet.parse_prometheus_text(texts[0])
    assert fams == jax_fleet.parse_prometheus_text(texts[1])
    assert fams["ps_push_total"]["samples"] == [({"worker": "w1"}, 3.0)]
    assert fams["ps_apply_seconds"]["histograms"][""]["counts"] == [1, 1, 1]


@pytest.mark.parametrize("labels", [{}, {"b": "2", "a": "1"}, {"z": 'q"uote', "a": ""}])
def test_canonical_label_key_equals_jax(labels):
    assert fleet.canonical_label_key(labels) == jax_fleet.canonical_label_key(labels)


def test_bucket_percentile_equals_jax_on_seeded_ladders():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        bounds = tuple(sorted(float(b) for b in rng.uniform(0.0, 10.0, n)))
        counts = [int(c) for c in rng.integers(0, 5, n + 1)]
        q = float(rng.uniform(0.0, 1.0))
        assert fleet.bucket_percentile(bounds, counts, q) == \
            jax_fleet.bucket_percentile(bounds, counts, q)
    for module in FLEETS.values():
        with pytest.raises(ValueError):
            module.bucket_percentile((1.0,), [1, 0], 1.5)
    assert fleet.bucket_percentile((1.0, 2.0), [0, 0, 5], 0.99) == 2.0


# -- merge semantics ------------------------------------------------------------


MERGES = {
    "counters_and_gauges": {"ps": (3, 7, []), "w1": (5, 2, [])},
    "histograms": {"ps": (1, 0, [0.05, 0.5]), "w1": (1, 0, [0.5, 5.0])},
    "mismatched_ladders": {"ps": (1, 0, [0.05], (0.1, 1.0)), "w1": (1, 0, [0.05], (0.2, 2.0))},
}


@pytest.mark.parametrize("name", list(MERGES))
def test_merge_equals_jax(name):
    per_proc = {proc: fleet.parse_prometheus_text(_exposition(MetricsRegistry, *args))
                for proc, args in MERGES[name].items()}
    merged = fleet.merge_metrics(per_proc)
    assert merged == jax_fleet.merge_metrics(per_proc)
    if name == "mismatched_ladders":
        assert merged["unmerged_histograms"] == ["ps_apply_seconds[proc=w1]"]
    if name == "counters_and_gauges":
        assert merged["counters"] == {'ps_push_total{worker="w1"}': 8.0}


# -- the roster on a scripted clock and fetch -------------------------------------


def _fake_bodies(metrics_text="", workers=None, alerts=None, meta=None):
    return {
        "/meta": json.dumps(meta or {"role": "proc", "boot": "b0"}).encode(),
        "/metrics": metrics_text.encode(),
        "/workers": json.dumps(workers or {"workers": {}, "total_updates": 0,
                                           "unstamped_updates": 0}).encode(),
        "/alerts": json.dumps(alerts or {"rules": [], "active": [], "fired": [],
                                         "fired_kinds": []}).encode(),
    }


def _fetch_over(bodies_by_url, up=None):
    def fetch(url, timeout):
        if up is not None and not up["on"]:
            raise OSError("connection refused")
        for base, bodies in bodies_by_url.items():
            if url.startswith(base + "/"):
                return bodies[url[len(base):]]
        raise OSError(f"connection refused: {url}")

    return fetch


def _rollup_bodies():
    return {
        "http://a": {**_fake_bodies(
            metrics_text="# TYPE ps_push_total counter\nps_push_total 9\n",
            workers={"workers": {"w1": {"updates": 3, "lag_max": 1}},
                     "total_updates": 3, "unstamped_updates": 0},
            alerts={"rules": [], "active": [{"rule": "r", "metric": "m"}],
                    "fired": [{"kind": "slo_breach"}], "fired_kinds": []}),
            "/load": json.dumps({"score": 0.25, "raw": 0.3, "observations": 5}).encode(),
            "/slo": json.dumps({"evaluated": 10, "goodput_ratio": 0.98}).encode(),
            "/replicas": json.dumps({"replicas": {"r0": {"state": "serving", "boot": 1}},
                                     "router": {"requests": 7}, "autoscale": None}).encode(),
            "/tiers": json.dumps({"tiers": {"prefill": {"replicas": ["r0"]}}}).encode(),
            "/rollout": json.dumps({"active": True, "phase": "idle"}).encode()},
        "http://b": {**_fake_bodies(
            workers={"workers": {"w1": {"updates": 5, "lag_max": 2}},
                     "total_updates": 5, "unstamped_updates": 1}),
            "/replicas": json.dumps({"replicas": {}, "router": None,
                                     "autoscale": None}).encode()},
    }


def _scripted_roster(module):
    """One roster through a scripted life on a fake clock: alive,
    stale, dead, alive, beside a never-reachable slot and a roll-up
    peer. Returns every snapshot and the transitions."""
    up = {"on": True}
    bodies = _rollup_bodies()
    live = _fetch_over(bodies)
    flaky = _fetch_over({"http://ps": bodies["http://a"]}, up)

    def fetch(url, timeout):
        return flaky(url, timeout) if url.startswith("http://ps/") else live(url, timeout)

    agg = module.FleetAggregator(dead_after=5.0, clock=lambda: 0.0, fetch=fetch)
    for name, url in (("a", "http://a"), ("b", "http://b"), ("ps", "http://ps"),
                      ("ghost", "http://nowhere")):
        agg.add(url, name=name)
    snaps = []
    for now, on in ((0.0, True), (1.0, False), (6.0, False), (7.0, True)):
        up["on"] = on
        snaps.append((agg.poll(now=now), agg.snapshot(now=now)))
    return snaps, {e.name: e.transitions for e in agg.registry.entries()}


def test_a_scripted_roster_equals_the_jax_roster():
    """Lifecycles (alive → stale → dead → alive; never reachable → stale
    → dead), last-known counters through the outage, the worker and
    alert roll-ups and the optional per-process routes: every tally and
    snapshot equal to the JAX aggregator's."""
    port, ref = _scripted_roster(fleet), _scripted_roster(jax_fleet)
    assert json.loads(json.dumps(port)) == json.loads(json.dumps(ref))
    snaps, transitions = port
    assert [s for _, s in transitions["ps"]] == ["alive", "stale", "dead", "alive"]
    assert [s for _, s in transitions["ghost"]] == ["stale", "dead"]
    outage = snaps[2][1]
    assert outage["metrics"]["counters"]["ps_push_total"] == 18.0
    assert set(outage["replicas"]) == {"a", "ps"} and set(outage["rollout"]) == {"a", "ps"}
    assert {"a/w1", "b/w1"} <= set(outage["workers"]["workers"])


def test_registry_autonames_and_repoints_slots():
    for module in FLEETS.values():
        reg = module.ProcessRegistry()
        e0 = reg.add("http://h:1/")
        assert e0.name == "proc0" and e0.url == "http://h:1"
        e1 = reg.add("http://h:2", name="ps")
        assert reg.add("http://h:3", name="ps") is e1 and e1.url == "http://h:3"
        assert [e.name for e in reg.entries()] == ["proc0", "ps"] and len(reg) == 2


# -- live federation over the port's OpsServer ---------------------------------------


def _ops_server(role, registry, worker_id=None, boot=None, port=0, **kw):
    return OpsServer(port=port, registry=registry,
                     tracer=Tracer(annotate_device=False, enabled=False),
                     flight=FlightRecorder(capacity=4), role=role, boot=boot,
                     worker_id=worker_id, **kw).start()


def test_live_processes_merge_exactly_with_both_aggregators():
    """A PS and two workers of the port scraped over real sockets: both
    packages' aggregators merge them to the same counters and histograms,
    the counters exact, the pooled percentiles within one 1 ms bucket."""
    buckets = [i / 1000.0 for i in range(1, 101)]
    vals = {"ps": [i / 1000.0 for i in range(1, 41)],
            "w1": [i / 1000.0 for i in range(20, 80)],
            "w2": [i / 1000.0 for i in range(50, 100)]}
    servers = {}
    for name in vals:
        reg = MetricsRegistry()
        reg.counter("train_units_total", help="units").inc({"ps": 0, "w1": 4, "w2": 6}[name])
        h = reg.histogram("ps_apply_seconds", buckets=buckets)
        for v in vals[name]:
            h.observe(v)
        servers[name] = _ops_server("ps" if name == "ps" else "worker", reg,
                                    worker_id=None if name == "ps" else name)
    try:
        merged = {}
        for key, module in FLEETS.items():
            agg = module.FleetAggregator(dead_after=30.0)
            for name, srv in servers.items():
                agg.add(srv.url, name=name)
            assert agg.poll()["ok"] == 3
            merged[key] = agg.snapshot()["metrics"]
        assert merged["port"]["counters"] == merged["jax"]["counters"]
        assert merged["port"]["histograms"] == merged["jax"]["histograms"]
        assert merged["port"]["counters"]["train_units_total"] == 10.0
        pooled = sorted(sum(vals.values(), []))
        h = merged["port"]["histograms"]["ps_apply_seconds"]
        assert h["count"] == len(pooled) and sorted(h["procs"]) == ["ps", "w1", "w2"]
        for q, key in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
            exact = pooled[min(len(pooled) - 1, int(q * len(pooled)))]
            assert h[key] == pytest.approx(exact, abs=1.5e-3), key
    finally:
        for srv in servers.values():
            srv.stop()


def test_live_kill_is_marked_stale_then_dead_then_alive():
    reg = MetricsRegistry()
    reg.counter("train_units_total", help="units").inc(2)
    srv = _ops_server("ps", reg, boot="boot-a")
    now = {"t": 0.0}
    agg = fleet.FleetAggregator(dead_after=5.0, clock=lambda: now["t"])
    entry = agg.add(srv.url, name="ps")
    agg.poll()
    srv.stop()
    for t in (1.0, 7.0):
        now["t"] = t
        agg.poll()
    assert agg.snapshot()["metrics"]["counters"]["train_units_total"] == 2.0
    srv2 = _ops_server("ps", reg, boot="boot-b", port=srv.port)
    try:
        now["t"] = 8.0
        agg.poll()
        assert entry.meta["boot"] == "boot-b"
        assert [s for _, s in entry.transitions] == ["alive", "stale", "dead", "alive"]
    finally:
        srv2.stop()


def test_concurrent_polls_under_writer_never_tear():
    """Bounded to a few seconds: three scrapers poll and snapshot the
    port's live servers while writer threads mutate every registry; every
    poll succeeds, every snapshot serializes, counters only move on."""
    regs = [MetricsRegistry() for _ in range(3)]
    for reg in regs:
        reg.counter("train_units_total", help="units")
        reg.histogram("ps_apply_seconds", buckets=[0.01, 0.1, 1.0])
    servers = [_ops_server("worker", reg, worker_id=f"w{i}") for i, reg in enumerate(regs)]
    agg = fleet.FleetAggregator(dead_after=30.0)
    for i, srv in enumerate(servers):
        agg.add(srv.url, name=f"w{i}")
    stop, errors = threading.Event(), []
    deadline = time.monotonic() + 8.0

    def writer(reg):
        while not stop.is_set():
            reg.counter("train_units_total", help="units").inc()
            reg.histogram("ps_apply_seconds", buckets=[0.01, 0.1, 1.0]).observe(0.05)
            time.sleep(0.0005)

    def scraper():
        last = 0.0
        for _ in range(5):
            if time.monotonic() > deadline:
                return
            try:
                assert agg.poll()["failed"] == 0
                snap = agg.snapshot()
                json.dumps(snap)
                total = snap["metrics"]["counters"].get("train_units_total", 0.0)
                assert total >= last, (total, last)
                last = total
            except Exception as err:  # noqa: BLE001 - collected for the assert
                errors.append(repr(err))

    writers = [threading.Thread(target=writer, args=(reg,), daemon=True) for reg in regs]
    scrapers = [threading.Thread(target=scraper, daemon=True) for _ in range(3)]
    try:
        for t in writers + scrapers:
            t.start()
        for t in scrapers:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in scrapers)
    finally:
        stop.set()
        for t in writers:
            t.join(timeout=5)
        for srv in servers:
            srv.stop()
    assert errors == []


def test_fleet_route_serves_the_aggregators_snapshot():
    """``/fleet`` of the process hosting the aggregator serves its merged
    view; an unwired one answers the JAX package's empty roster."""
    reg = MetricsRegistry()
    reg.counter("train_units_total", help="units").inc(1)
    member = _ops_server("worker", reg, worker_id="w0")
    agg = fleet.FleetAggregator(dead_after=30.0)
    agg.add(member.url, name="w0")
    agg.poll()
    host = _ops_server("serving", MetricsRegistry(), fleet_fn=agg.snapshot)
    bare = _ops_server("serving", MetricsRegistry())
    try:
        with urllib.request.urlopen(f"{host.url}/fleet", timeout=5) as resp:
            doc = json.loads(resp.read())
        assert sorted(doc) == sorted(agg.snapshot())
        assert doc["status_counts"] == {"alive": 1}
        assert doc["metrics"]["counters"]["train_units_total"] == 1.0
        with urllib.request.urlopen(f"{bare.url}/fleet", timeout=5) as resp:
            assert json.loads(resp.read()) == {"polls": 0, "status_counts": {},
                                                "processes": {}}
    finally:
        for srv in (host, bare, member):
            srv.stop()
