"""opsd: threaded HTTP introspection endpoint for live processes.

Counterpart of ``elephas_tpu/obs/opsd.py``: the same route table, the same
documents and the same 404 body; ``/profile`` drives ``torch.profiler``.

Every long-lived process in the system — PS servers, the serving
``InferenceEngine`` frontend, trainers — can mount one of these and
answer, while under load, the questions that today require attaching a
debugger:

- ``GET /metrics`` — Prometheus text exposition of the process registry
  (scrapeable by a stock Prometheus server), stamped with an
  ``elephas_process_info{role=,boot=,pid=}`` identity line so merged
  dumps stay attributable without out-of-band context;
- ``GET /healthz`` — liveness + an optional health summary (PS servers
  wire their ``MembershipView``/failure-detector state in);
- ``GET /trace``   — the span ring as Chrome-trace JSON *with the
  clockSync block*, which is exactly the per-process dump
  ``scripts/trace_report.py --merge`` aligns across machines;
- ``GET /vars``    — process identity and config (boot id, buffer
  version, bind address) for "which incarnation am I talking to";
- ``GET /flight``  — the anomaly flight-recorder ring;
- ``GET /workers`` — the PS's per-worker staleness/contribution ledger
  (``obs.health.StalenessLedger.snapshot``);
- ``GET /alerts``  — the SLO alert engine's rules, active breaches, and
  ordered fired history (each scrape runs one evaluation pass);
- ``GET /meta``    — self-description for fleet federation: role, boot
  id, worker_id, and the served route list (``obs.fleet`` polls this);
- ``GET /history?window=N`` — windowed stats from the process's
  ``HistorySampler`` rings (rates, min/max/last over the trailing N s);
- ``GET /profile`` — device profiling: bare GET for capture status +
  per-device memory watermarks, ``?action=start[&dir=]`` /
  ``?action=stop`` to drive ``torch.profiler`` trace capture remotely;
- ``GET /fleet``   — the merged fleet view, when this process hosts a
  ``FleetAggregator`` (usually the one doing the polling);
- ``GET /replicas`` — the serving router's roster: per-replica
  lifecycle state and dispatch signals, router affinity/requeue
  counters, and the last autoscale decision
  (``serving.fleet.Router.replicas_doc``);
- ``GET /incidents`` — the durable telemetry store's live view: disk
  stats (bytes, segments, last-record age) plus the most recent
  journaled records (``obs.store.TelemetryStore.doc``).

Routes are registered in an explicit table (``_add_route``), and the
full vocabulary lives in the module-level ``ROUTES`` constant —
``scripts/lint_blocking.py`` AST-reads it and rejects unregistered
route strings at ``add_route`` call sites (``# route-ok`` escapes), so
the served surface and the documented surface cannot drift. Unknown
paths answer 404 *with the known-route list in the body*: a scraper
with a typo learns the fix from the error itself.

Security: opsd binds **loopback by default** (``127.0.0.1``). It serves
unauthenticated process internals — trace args can contain request ids
and config values, ``/profile`` can start device captures — so exposing
it beyond the host is an explicit decision: pass ``host=`` or set
``ELEPHAS_OPS_BIND``. This mirrors the PS servers' own
``ELEPHAS_PS_BIND`` convention.

The server is a ``ThreadingHTTPServer`` on a daemon thread: requests
never touch the training/serving hot paths beyond the GIL, handlers
only *read* shared structures (registry exposition and ring snapshots
are already lock-guarded copies), and ``stop()`` is idempotent.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

__all__ = ["OpsServer", "ROUTES"]

#: Registered route vocabulary. Grow this table when adding a route —
#: ``lint_blocking`` rejects ``add_route`` call sites whose path string
#: is not listed here, so every served route is documented by construction.
ROUTES = (
    "/metrics",
    "/healthz",
    "/trace",
    "/vars",
    "/flight",
    "/workers",
    "/alerts",
    "/meta",
    "/history",
    "/profile",
    "/fleet",
    "/shards",
    "/load",
    "/slo",
    "/canary",
    "/replicas",
    "/incidents",
    "/trials",
    "/tenants",
    "/tiers",
    "/rollout",
)


def _default_bind_host() -> str:
    # Loopback unless the operator explicitly opts into exposure.
    return os.environ.get("ELEPHAS_OPS_BIND", "127.0.0.1")


class OpsServer:
    """Mountable introspection endpoint (see module docstring).

    Parameters
    ----------
    port: TCP port; 0 picks a free one (read ``.port`` after
        ``start()``).
    host: bind address; defaults to loopback / ``ELEPHAS_OPS_BIND``.
    registry / tracer / flight: the surfaces to serve; default to the
        process-global ones resolved lazily at request time (so a
        later ``enable_tracing()`` is picked up without a remount).
    role / boot / worker_id: process identity for ``/meta`` and the
        ``elephas_process_info`` stamp on ``/metrics``.
    vars_fn: extra ``/vars`` content, e.g. the PS server's boot id and
        buffer version — called per request so values are live.
    health_fn: extra ``/healthz`` content (membership summary). If it
        raises, ``/healthz`` answers 500 — a health route that lies is
        worse than one that fails.
    workers_fn: the ``/workers`` payload (a staleness-ledger snapshot);
        the route answers an empty table when unset, so scrapers can
        probe any process uniformly.
    alerts_fn: the ``/alerts`` payload (an alert-engine scrape); answers
        an empty rule pack when unset.
    history: a ``HistorySampler`` backing ``/history``; empty shell when
        unset.
    profiler: a ``DeviceProfiler`` backing ``/profile``; a default one
        (``torch.profiler``-backed, tempdir dumps) is created lazily on
        first use.
    fleet_fn: the ``/fleet`` payload (a ``FleetAggregator.snapshot``);
        empty roster when unset.
    shards_fn: the ``/shards`` payload (a ``ShardGroup.snapshot`` —
        plan digest, directory generation, standby lag, promotions);
        empty doc when unset.
    load_fn: the ``/load`` payload (a ``LoadTracker.snapshot`` — EWMA
        saturation score plus raw signal anatomy); null score when
        unset.
    slo_fn: the ``/slo`` payload (a ``GoodputLedger.snapshot`` —
        objectives, windowed goodput ratios, burn rates); empty
        objective pack when unset.
    canary_fn: the ``/canary`` payload (a ``CanaryDriver.snapshot`` /
        ``PSCanary.snapshot`` — blackbox probe SLIs); zero probes when
        unset.
    replicas_fn: the ``/replicas`` payload (a serving fleet
        ``Router.replicas_doc`` — replica roster + dispatch signals +
        last autoscale decision); empty roster when unset.
    incidents_fn: the ``/incidents`` payload (a ``TelemetryStore.doc``
        — durable-store disk stats + most recent journaled records,
        the live end of the post-mortem plane); empty store when
        unset.
    trials_fn: the ``/trials`` payload (a ``TuneRunner.trials_snapshot``
        — per-trial rung/status/loss cards, rung counts, the search
        digest); empty search when unset.
    tenants_fn: the ``/tenants`` payload (a ``CostLedger.snapshot`` —
        per-tenant token/queue/block-second costs, goodput, and the
        tenancy alert state; routers serve the tenant-wise union over
        their replicas); empty ledger when unset.
    tiers_fn: the ``/tiers`` payload (a ``Router.tiers_doc`` —
        per-tier membership/load/KV pressure, KV-handoff latency and
        failure counts, and the QoS policy card for disaggregated
        prefill/decode serving); empty topology when unset.
    rollout_fn: the ``/rollout`` payload (a ``RolloutController.doc``
        — live-delivery state machine phase, per-replica served
        versions with the canary flagged, the pinned/candidate
        versions, and the rollout event history + digest); idle plane
        when unset.
    """

    def __init__(self, port: int = 0, host: Optional[str] = None,
                 registry=None, tracer=None, flight=None,
                 role: str = "proc", boot: Optional[str] = None,
                 worker_id: Optional[str] = None,
                 vars_fn: Optional[Callable[[], Dict]] = None,
                 health_fn: Optional[Callable[[], Dict]] = None,
                 workers_fn: Optional[Callable[[], Dict]] = None,
                 alerts_fn: Optional[Callable[[], Dict]] = None,
                 history=None, profiler=None,
                 fleet_fn: Optional[Callable[[], Dict]] = None,
                 shards_fn: Optional[Callable[[], Dict]] = None,
                 load_fn: Optional[Callable[[], Dict]] = None,
                 slo_fn: Optional[Callable[[], Dict]] = None,
                 canary_fn: Optional[Callable[[], Dict]] = None,
                 replicas_fn: Optional[Callable[[], Dict]] = None,
                 incidents_fn: Optional[Callable[[], Dict]] = None,
                 trials_fn: Optional[Callable[[], Dict]] = None,
                 tenants_fn: Optional[Callable[[], Dict]] = None,
                 tiers_fn: Optional[Callable[[], Dict]] = None,
                 rollout_fn: Optional[Callable[[], Dict]] = None):
        self._requested_port = port
        self.host = host if host is not None else _default_bind_host()
        self._registry = registry
        self._tracer = tracer
        self._flight = flight
        self.role = role
        self.boot = boot
        self.worker_id = worker_id
        self._vars_fn = vars_fn
        self._health_fn = health_fn
        self._workers_fn = workers_fn
        self._alerts_fn = alerts_fn
        self._history = history
        self._profiler = profiler
        self._fleet_fn = fleet_fn
        self._shards_fn = shards_fn
        self._load_fn = load_fn
        self._slo_fn = slo_fn
        self._canary_fn = canary_fn
        self._replicas_fn = replicas_fn
        self._incidents_fn = incidents_fn
        self._trials_fn = trials_fn
        self._tenants_fn = tenants_fn
        self._tiers_fn = tiers_fn
        self._rollout_fn = rollout_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_wall = None
        self.port: Optional[int] = None
        # Explicit route table: path → handler(query) -> (code, payload[,
        # content_type]). Every registration is lint-checked against the
        # module ROUTES vocabulary.
        self._routes: Dict[str, Callable] = {}
        self._add_route("/metrics", self._h_metrics)
        self._add_route("/healthz", self._h_healthz)
        self._add_route("/trace", self._h_trace)
        self._add_route("/vars", self._h_vars)
        self._add_route("/flight", self._h_flight)
        self._add_route("/workers", self._h_workers)
        self._add_route("/alerts", self._h_alerts)
        self._add_route("/meta", self._h_meta)
        self._add_route("/history", self._h_history)
        self._add_route("/profile", self._h_profile)
        self._add_route("/fleet", self._h_fleet)
        self._add_route("/shards", self._h_shards)
        self._add_route("/load", self._h_load)
        self._add_route("/slo", self._h_slo)
        self._add_route("/canary", self._h_canary)
        self._add_route("/replicas", self._h_replicas)
        self._add_route("/incidents", self._h_incidents)
        self._add_route("/trials", self._h_trials)
        self._add_route("/tenants", self._h_tenants)
        self._add_route("/tiers", self._h_tiers)
        self._add_route("/rollout", self._h_rollout)

    def _add_route(self, path: str, handler: Callable) -> None:
        self._routes[path] = handler

    def routes(self) -> Tuple[str, ...]:
        """The served route list (sorted) — ``/meta`` and 404 bodies."""
        return tuple(sorted(self._routes))

    # Lazy resolution: a tracer enabled after mount is still served.
    def _get_registry(self):
        if self._registry is not None:
            return self._registry
        from elephas_tpu_torch import obs
        return obs.default_registry()

    def _get_tracer(self):
        if self._tracer is not None:
            return self._tracer
        from elephas_tpu_torch import obs
        return obs.default_tracer()

    def _get_flight(self):
        if self._flight is not None:
            return self._flight
        from elephas_tpu_torch import obs
        return obs.default_flight_recorder()

    def _get_profiler(self):
        if self._profiler is None:
            from elephas_tpu_torch.obs.devprof import DeviceProfiler
            self._profiler = DeviceProfiler()
        return self._profiler

    # -- route handlers: (query) -> (code, payload[, content_type]) ---------

    def _proc_info_line(self) -> str:
        """The process-identity stamp appended to every ``/metrics``
        body: merged fleet dumps stay attributable per sample source."""
        boot = self.boot or ""
        return (
            "# TYPE elephas_process_info gauge\n"
            f'elephas_process_info{{role="{self.role}",boot="{boot}",'
            f'pid="{os.getpid()}"}} 1\n'
        )

    def _h_metrics(self, query):
        text = self._get_registry().expose_text() + self._proc_info_line()
        return 200, text.encode(), "text/plain; version=0.0.4"

    def _h_healthz(self, query):
        doc = {"status": "ok",
               "uptime_s": time.time() - self._started_wall}
        if self._health_fn is not None:
            doc.update(self._health_fn())
        return 200, doc

    def _h_trace(self, query):
        return 200, self._get_tracer().export_chrome()

    def _h_vars(self, query):
        doc = {"pid": os.getpid(),
               "ops_host": self.host,
               "ops_port": self.port}
        if self._vars_fn is not None:
            doc.update(self._vars_fn())
        return 200, doc

    def _h_flight(self, query):
        return 200, self._get_flight().snapshot()

    def _h_workers(self, query):
        if self._workers_fn is not None:
            return 200, self._workers_fn()
        return 200, {"workers": {}, "total_updates": 0,
                     "unstamped_updates": 0}

    def _h_alerts(self, query):
        if self._alerts_fn is not None:
            return 200, self._alerts_fn()
        return 200, {"rules": [], "active": [], "fired": [],
                     "fired_kinds": []}

    def _h_meta(self, query):
        return 200, {
            "role": self.role,
            "boot": self.boot,
            "worker_id": self.worker_id,
            "pid": os.getpid(),
            "ops_host": self.host,
            "ops_port": self.port,
            "routes": list(self.routes()),
        }

    def _h_history(self, query):
        window = query.get("window")
        window_s = float(window) if window else None
        if self._history is None:
            return 200, {"period_s": None, "capacity": 0,
                         "window_s": window_s, "ticks": 0, "series": {}}
        return 200, self._history.snapshot(window_s=window_s)

    def _h_profile(self, query):
        from elephas_tpu_torch.obs import devprof

        action = query.get("action")
        prof = self._get_profiler()
        if action is None:
            return 200, {"profiler": prof.status(),
                         "device_memory": devprof.device_memory_snapshot()}
        if action == "start":
            doc = prof.start(out_dir=query.get("dir"))
            code = {"started": 200, "busy": 409}.get(doc["status"], 500)
            return code, doc
        if action == "stop":
            doc = prof.stop()
            return (200 if doc["status"] in ("stopped", "idle")
                    else 500), doc
        return 400, {"error": f"unknown action {action!r}",
                     "actions": ["start", "stop"]}

    def _h_fleet(self, query):
        if self._fleet_fn is not None:
            return 200, self._fleet_fn()
        return 200, {"polls": 0, "status_counts": {}, "processes": {}}

    def _h_shards(self, query):
        if self._shards_fn is not None:
            return 200, self._shards_fn()
        return 200, {"plan": None, "directory": None, "standbys": [],
                     "promotions": []}

    def _h_load(self, query):
        if self._load_fn is not None:
            return 200, self._load_fn()
        return 200, {"score": None, "raw": None, "observations": 0,
                     "signals": None}

    def _h_slo(self, query):
        if self._slo_fn is not None:
            return 200, self._slo_fn()
        return 200, {"objectives": [], "evaluated": 0, "goodput": {},
                     "burn": {}, "goodput_ratio": None}

    def _h_canary(self, query):
        if self._canary_fn is not None:
            return 200, self._canary_fn()
        return 200, {"surface": None, "probes": 0, "failures": 0,
                     "failure_ratio": None, "last": None}

    def _h_replicas(self, query):
        if self._replicas_fn is not None:
            return 200, self._replicas_fn()
        return 200, {"replicas": {}, "router": None, "autoscale": None}

    def _h_incidents(self, query):
        if self._incidents_fn is not None:
            return 200, self._incidents_fn()
        return 200, {"meta": None, "recent": []}

    def _h_trials(self, query):
        if self._trials_fn is not None:
            return 200, self._trials_fn()
        return 200, {"counts": {}, "trials": {}, "best": None,
                     "search_digest": None, "epochs_spent": 0}

    def _h_tenants(self, query):
        if self._tenants_fn is not None:
            return 200, self._tenants_fn()
        return 200, {"tenants": {}, "totals": {}, "kv_share": {},
                     "alerts": {"active": [], "fired": [],
                                "fired_kinds": []}}

    def _h_tiers(self, query):
        if self._tiers_fn is not None:
            return 200, self._tiers_fn()
        return 200, {"disagg_active": False, "tiers": {},
                     "imbalance": 0.0,
                     "handoffs": {"count": 0, "fails": 0,
                                  "p50_ms": None, "p99_ms": None},
                     "preemptions": 0, "qos": None}

    def _h_rollout(self, query):
        if self._rollout_fn is not None:
            return 200, self._rollout_fn()
        return 200, {"active": False, "phase": "idle",
                     "approved_version": None, "candidate_version": None,
                     "canary": None, "versions": {}, "skew": 0,
                     "events": [], "digest": None}

    def start(self) -> "OpsServer":
        if self._httpd is not None:
            return self
        ops = self
        self._started_wall = time.time()

        class Handler(BaseHTTPRequestHandler):
            # opsd must never spam the process stdout per scrape.
            def log_message(self, *a):  # noqa: D102
                pass

            def _send(self, code: int, body: bytes,
                      content_type: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, doc) -> None:
                self._send(code, json.dumps(doc).encode())

            def do_GET(self):  # noqa: N802
                try:
                    split = urllib.parse.urlsplit(self.path)
                    handler = ops._routes.get(split.path)
                    if handler is None:
                        self._send_json(404, {
                            "error": "not found",
                            "path": split.path,
                            "routes": list(ops.routes()),
                        })
                        return
                    query = {k: v[-1] for k, v in
                             urllib.parse.parse_qs(split.query).items()}
                    result = handler(query)
                    if len(result) == 3:
                        code, payload, ctype = result
                        self._send(code, payload, ctype)
                    else:
                        code, payload = result
                        self._send_json(code, payload)
                except Exception as exc:  # surface, don't hang the scrape
                    try:
                        self._send_json(500, {"error": repr(exc)})
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"opsd:{self.port}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
