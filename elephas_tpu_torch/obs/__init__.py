"""Observability for the port (counterpart of ``elephas_tpu/obs``).

Everything here is HOST-side only and allocation-light — no device
syncs, no per-sample storage — so instrumentation can stay on inside
the pipelined serving scheduler's overlap window. The modules are the
reference's own, with their imports pointed at the port; the tracer's
device bridge enters ``torch.profiler.record_function``.

Process-global defaults back cross-cutting instrumentation:

- ``default_tracer()`` — starts as the shared disabled ``NULL_TRACER``
  (every span is a no-op); ``enable_tracing()`` swaps in a live ring.
- ``default_registry()`` — always live; scrape with
  ``default_registry().expose_text()``.
- ``default_flight_recorder()`` — bounded anomaly ring (retrace storms,
  rejections, deadline evictions), swappable for tests via
  ``set_default_flight_recorder()``.
- ``note_retrace(program, **args)`` — the reference keeps it in
  ``elephas_tpu/utils/compiler.py``, a module that imports JAX; here it
  counts the builds of the serving programs (a CUDA-graph capture on the
  card) on the same counter, marker and anomaly.

Ported: the tracer, the registry, the flight recorder, the
history ring and its sampler, the alert engine, the load tracker, the
goodput ledger, the cost ledger, the training-health accounting
(``health.py``: the parameter server's staleness ledger, the trainers'
unit dynamics), and the ops plane: the ops endpoint (``opsd.py``), the
device profiler over ``torch.profiler`` (``devprof.py``), the durable
telemetry store (``store.py``) and the incident builder that reads it
back (``incident.py``), the fleet aggregator behind ``/fleet``
(``fleet.py``) and the blackbox canaries behind ``/canary``
(``canary.py``).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

from elephas_tpu_torch.obs.registry import (  # noqa: F401
    Counter,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_latency_buckets,
)
from elephas_tpu_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    SpanEvent,
    TraceContext,
    Tracer,
    activate,
    current_context,
    new_context,
)
from elephas_tpu_torch.obs.flight import (  # noqa: F401
    KINDS,
    NULL_FLIGHT_RECORDER,
    FlightEvent,
    FlightRecorder,
)
from elephas_tpu_torch.obs.health import (  # noqa: F401
    StalenessLedger,
    record_staleness,
    record_unit_dynamics,
    tree_norm,
)
from elephas_tpu_torch.obs.alerts import (  # noqa: F401
    RULE_NAMES,
    AlertEngine,
    AlertRule,
    default_rules,
)
from elephas_tpu_torch.obs.history import (  # noqa: F401
    DEFAULT_SAMPLE_PREFIXES,
    HistoryRing,
    HistorySampler,
)
from elephas_tpu_torch.obs.devprof import (  # noqa: F401
    DeviceProfiler,
    device_memory_snapshot,
    record_device_memory,
)
from elephas_tpu_torch.obs.load import (  # noqa: F401
    LoadScore,
    LoadSnapshot,
    LoadTracker,
    instant_load,
)
from elephas_tpu_torch.obs.slo import (  # noqa: F401
    GoodputLedger,
    SLOObjective,
    default_objectives,
)
from elephas_tpu_torch.obs.tenancy import (  # noqa: F401
    DEFAULT_TENANT,
    CostLedger,
    merge_tenant_docs,
    tenant_rules,
)
from elephas_tpu_torch.obs.store import (  # noqa: F401
    RECORD_KINDS,
    TelemetryStore,
    iter_records,
    read_store,
    store_dirs,
)
from elephas_tpu_torch.obs.incident import (  # noqa: F401
    IncidentBuilder,
    render_markdown,
)
from elephas_tpu_torch.obs.opsd import ROUTES, OpsServer  # noqa: F401
from elephas_tpu_torch.obs.fleet import (  # noqa: F401
    FleetAggregator,
    ProcessRegistry,
    parse_prometheus_text,
)
from elephas_tpu_torch.obs.canary import (  # noqa: F401
    CanaryDriver,
    PSCanary,
)

_tracer: Tracer = NULL_TRACER
_registry = MetricsRegistry()
_flight = FlightRecorder()


def default_tracer() -> Tracer:
    """The process-global tracer (disabled until ``enable_tracing``)."""
    return _tracer


def set_default_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the global default (None → disabled)."""
    global _tracer
    _tracer = tracer if tracer is not None else NULL_TRACER
    return _tracer


def enable_tracing(capacity: int = 65536, clock=time.monotonic,
                   annotate_device: bool = True) -> Tracer:
    """Swap a live ring in as the global tracer and return it."""
    return set_default_tracer(
        Tracer(capacity=capacity, clock=clock,
               annotate_device=annotate_device)
    )


def disable_tracing() -> None:
    """Back to the shared no-op tracer (recorded events are dropped)."""
    set_default_tracer(None)


def default_registry() -> MetricsRegistry:
    """The process-global metrics registry (always live)."""
    return _registry


def default_flight_recorder() -> FlightRecorder:
    """The process-global anomaly ring (live by default)."""
    return _flight


def set_default_flight_recorder(
        recorder: Optional[FlightRecorder]) -> FlightRecorder:
    """Install ``recorder`` as the global default (None → disabled)."""
    global _flight
    _flight = recorder if recorder is not None else NULL_FLIGHT_RECORDER
    return _flight


# Retrace-storm detection, as in the reference: a hot program rebuilt
# this many times inside the window is being fed fresh shapes per call.
_RETRACE_STORM_COUNT = 4
_RETRACE_STORM_WINDOW_S = 60.0
_retrace_times: Dict[str, collections.deque] = {}


def note_retrace(program: str, **args) -> None:
    """Record a (re)build of a hot program: a ``retrace_total{program=}``
    counter bump and an instant ``compile/<program>`` event on the
    default tracer. The fourth build of one program inside 60 s is a
    *retrace storm* and also lands in the flight recorder."""
    default_registry().counter(
        "retrace_total",
        help="hot-program (re)traces across the process",
        labelnames=("program",),
    ).labels(program=program).inc()
    default_tracer().instant(f"compile/{program}", **args)
    now = time.monotonic()
    times = _retrace_times.setdefault(
        program, collections.deque(maxlen=_RETRACE_STORM_COUNT))
    times.append(now)
    if (len(times) == _RETRACE_STORM_COUNT
            and now - times[0] <= _RETRACE_STORM_WINDOW_S):
        default_flight_recorder().note(
            "retrace_storm", "warn", program=program,
            retraces=_RETRACE_STORM_COUNT,
            window_s=round(now - times[0], 3),
        )
