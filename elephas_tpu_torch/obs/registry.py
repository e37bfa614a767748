"""Metrics registry: named counters, gauges, fixed-bucket histograms.

Counterpart of ``elephas_tpu/obs/registry.py``, whose logic is framework-free;
the port keeps its own copy so that it imports nothing of the JAX package.

The registry is the scrape surface the ROADMAP's serving north star
needs: in-memory aggregation only (recording a sample is an integer
bump — no allocation, no device sync, safe inside the pipelined
scheduler's overlap window), read out either as a Prometheus-style text
exposition (``expose_text``) or as one structured line through the
existing ``metrics.logging.JsonlSink`` (``log_to`` — the same artifact
format every committed benchmark in this repo uses).

``Histogram`` gives p50/p90/p99 without storing every sample: fixed
bucket bounds (default: a geometric latency ladder from 10µs to ~80s),
percentiles linearly interpolated inside the owning bucket and clamped
to the observed min/max, so the estimate is never wider than one bucket
off the exact quantile (tests pin this against exact quantiles on known
distributions).

Labels: ``registry.counter("ps_push_retry_total",
labelnames=("worker",))`` returns a ``Family``; ``.labels(worker="w1")``
get-or-creates the child instrument. One metric name, N label-keyed
children — instead of N metric names with the dimension baked in
(``retrace_total::prog``), which Prometheus can neither aggregate nor
relabel. ``Family.value`` sums the children, so "total across the
dimension" reads stay one attribute access. Exposition renders
``name{worker="w1"} 3`` with proper label-value escaping.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Family",
    "MetricsRegistry",
    "default_latency_buckets",
]


def default_latency_buckets() -> Tuple[float, ...]:
    """Geometric ladder 10µs → ~80s (×2 per bucket, 24 bounds): spans a
    sub-ms decode step and a minute-long compile in one histogram."""
    return tuple(1e-5 * 2 ** i for i in range(24))


_trace_mod = None


def _current_trace_id() -> Optional[str]:
    """Active trace id, or None. Lazily binds ``obs.trace`` so the
    registry (imported first by ``obs/__init__``) never participates in
    an import cycle; only exemplar-enabled histograms pay the call."""
    global _trace_mod
    if _trace_mod is None:
        from elephas_tpu_torch.obs import trace as _t
        _trace_mod = _t
    ctx = _trace_mod.current_context()
    return ctx.trace_id if ctx is not None else None


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping: backslash, quote, newline."""
    return (v.replace("\\", r"\\").replace('"', r"\"")
             .replace("\n", r"\n"))


def _render_labels(labels: Dict[str, str], **extra: str) -> str:
    """``{k="v",...}`` suffix for a sample line; "" when empty.

    ``extra`` appends synthetic labels (the histogram ``le`` bound)
    after the family's own, matching Prometheus ordering convention.
    """
    items = list(labels.items()) + list(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in items)
    return "{" + body + "}"


class Counter:
    """Monotonic counter (``inc`` only)."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.labels = None  # set by the owning Family, if any
        self._value = 0

    def inc(self, n: int = 1) -> None:
        self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "help", "labels", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.labels = None  # set by the owning Family, if any
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``buckets`` are ascending upper bounds; an implicit +inf bucket
    catches overflow. Observing is two comparisons + two integer bumps
    (bisect over ~24 bounds); nothing per-sample is stored beyond
    count/sum/min/max, so a million decode steps cost the same memory
    as ten.

    ``exemplars=True`` additionally latches the *active trace id* per
    bucket on every observe (last-writer-wins, one string slot per
    bucket — still O(buckets) memory): a p99 spike in the exposition
    joins directly to the span tree of a request that actually landed
    in that bucket, via ``exemplar_ids()`` and
    ``scripts/trace_report.py``. Off by default; recording sites that
    run under per-request trace context (``ServingMetrics``'s ITL
    mirror) opt in.
    """

    __slots__ = ("name", "help", "labels", "bounds", "counts", "count",
                 "sum", "min", "max", "exemplars")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None,
                 exemplars: bool = False):
        self.name = name
        self.help = help
        self.labels = None  # set by the owning Family, if any
        bounds = tuple(sorted(buckets)) if buckets is not None \
            else default_latency_buckets()
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # trailing +inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.exemplars: Optional[List[Optional[str]]] = \
            [None] * (len(bounds) + 1) if exemplars else None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        # Hand-rolled bisect_right over a ~24-entry tuple: no imports in
        # the hot path, O(log n) either way.
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        if self.exemplars is not None:
            trace_id = _current_trace_id()
            if trace_id is not None:
                self.exemplars[lo] = trace_id

    def exemplar_ids(self) -> Dict[str, str]:
        """``le-bound → trace id`` for every bucket that latched one
        (the join key into a trace dump); empty when disabled."""
        if self.exemplars is None:
            return {}
        out: Dict[str, str] = {}
        for i, tid in enumerate(self.exemplars):
            if tid is not None:
                le = (f"{self.bounds[i]:g}" if i < len(self.bounds)
                      else "+Inf")
                out[le] = tid
        return out

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """Estimated ``q``-quantile (q in [0, 1]); None when empty.

        Linear interpolation inside the bucket holding the target rank,
        clamped to [observed min, observed max] — so degenerate
        single-bucket data still reports sane numbers.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0.0
        lower = self.min
        for i, c in enumerate(self.counts):
            upper = self.bounds[i] if i < len(self.bounds) else self.max
            if c and cum + c >= rank:
                frac = (rank - cum) / c
                est = lower + (min(upper, self.max) - lower) * frac
                return min(max(est, self.min), self.max)
            cum += c
            if i < len(self.bounds):
                lower = max(self.bounds[i], self.min)
        return self.max

    def percentiles(self, qs=(0.50, 0.95, 0.99)) -> Dict[str, Optional[float]]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` convenience dict."""
        return {f"p{int(q * 100)}": self.percentile(q) for q in qs}


class Family:
    """A labeled metric: one name, one label schema, N children keyed by
    label values. ``family.labels(worker="w1")`` get-or-creates the
    child instrument (a plain Counter/Gauge/Histogram whose ``labels``
    attr holds the key→value dict the exposition renders).

    ``value`` sums the children (counters/gauges), so call sites that
    read "the total across the dimension" don't need to enumerate.
    """

    __slots__ = ("name", "help", "cls", "labelnames", "_kw",
                 "_children", "_lock")

    def __init__(self, cls, name: str, help: str,
                 labelnames: Tuple[str, ...], **kw):
        if not labelnames:
            raise ValueError("Family needs at least one label name")
        self.name = name
        self.help = help
        self.cls = cls
        self.labelnames = tuple(labelnames)
        self._kw = kw
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}"
            )
        key = tuple(str(kv[k]) for k in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self.cls(self.name, help=self.help, **self._kw)
                    child.labels = dict(zip(self.labelnames, key))
                    self._children[key] = child
        return child

    def children(self) -> List[object]:
        """Children sorted by label values (stable exposition order)."""
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    @property
    def value(self):
        """Sum across children (counter/gauge families)."""
        return sum(c.value for c in self.children())


class MetricsRegistry:
    """Name → instrument map with get-or-create accessors.

    Accessors are idempotent (same name returns the same instrument) and
    kind-checked — registering ``"x"`` as both a counter and a gauge, or
    as both plain and labeled (or with two different label schemas), is
    a programming error worth failing loudly on.
    """

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Tuple[str, ...] = (), **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                if labelnames:
                    inst = Family(cls, name, help, tuple(labelnames), **kw)
                else:
                    inst = cls(name, help=help, **kw)
                self._instruments[name] = inst
            elif isinstance(inst, Family):
                if inst.cls is not cls:
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{inst.cls.__name__} family, not {cls.__name__}"
                    )
                if tuple(labelnames) != inst.labelnames:
                    raise TypeError(
                        f"metric {name!r} already registered with labels "
                        f"{inst.labelnames}, not {tuple(labelnames)}"
                    )
            elif labelnames:
                raise TypeError(
                    f"metric {name!r} already registered unlabeled; "
                    f"cannot re-register with labels {tuple(labelnames)}"
                )
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: Tuple[str, ...] = ()):
        return self._get_or_create(Counter, name, help,
                                   labelnames=labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Tuple[str, ...] = ()):
        return self._get_or_create(Gauge, name, help, labelnames=labelnames)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None,
                  labelnames: Tuple[str, ...] = (),
                  exemplars: bool = False):
        return self._get_or_create(Histogram, name, help,
                                   labelnames=labelnames, buckets=buckets,
                                   exemplars=exemplars)

    def instruments(self) -> List[object]:
        with self._lock:
            return [self._instruments[k] for k in sorted(self._instruments)]

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()

    # -- readout -----------------------------------------------------------

    def expose_text(self) -> str:
        """Prometheus-style text exposition (scrape/dump surface).

        Labeled families emit one HELP/TYPE header and one sample line
        per child (``name{worker="w1"} 3``); labeled histograms merge
        the family labels with ``le`` on every bucket line.
        """
        lines: List[str] = []
        for inst in self.instruments():
            if isinstance(inst, Family):
                kind = inst.cls.__name__.lower()
                children = inst.children()
            else:
                kind = type(inst).__name__.lower()
                children = [inst]
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {kind}")
            for child in children:
                labels = child.labels or {}
                if isinstance(child, Histogram):
                    cum = 0
                    for bound, c in zip(child.bounds, child.counts):
                        cum += c
                        lines.append(
                            f"{child.name}_bucket"
                            f"{_render_labels(labels, le=f'{bound:g}')}"
                            f" {cum}"
                        )
                    lines.append(
                        f"{child.name}_bucket"
                        f"{_render_labels(labels, le='+Inf')} {child.count}"
                    )
                    suffix = _render_labels(labels)
                    lines.append(f"{child.name}_sum{suffix} {child.sum:g}")
                    lines.append(f"{child.name}_count{suffix} {child.count}")
                else:
                    lines.append(
                        f"{child.name}{_render_labels(labels)} "
                        f"{child.value:g}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, float]:
        """Flat name → number dict; histograms expand to
        ``_count``/``_sum``/``_p50``/``_p95``/``_p99``; labeled children
        key as ``name{worker="w1"}``."""
        out: Dict[str, float] = {}

        def emit(child):
            suffix = _render_labels(child.labels or {})
            if isinstance(child, Histogram):
                out[f"{child.name}_count{suffix}"] = child.count
                out[f"{child.name}_sum{suffix}"] = child.sum
                for pk, v in child.percentiles().items():
                    if v is not None:
                        out[f"{child.name}_{pk}{suffix}"] = v
            else:
                out[f"{child.name}{suffix}"] = child.value

        for inst in self.instruments():
            if isinstance(inst, Family):
                for child in inst.children():
                    emit(child)
            else:
                emit(inst)
        return out

    def exemplars(self) -> Dict[str, Dict[str, str]]:
        """Every latched histogram exemplar: snapshot-style key
        (``name`` or ``name{labels}``) → ``{le: trace_id}``. Served
        out-of-band from the text exposition (the 0.0.4 format has no
        exemplar syntax and ``obs.fleet.parse_prometheus_text`` must
        keep round-tripping ``expose_text`` unchanged)."""
        out: Dict[str, Dict[str, str]] = {}

        def emit(child):
            if isinstance(child, Histogram):
                ids = child.exemplar_ids()
                if ids:
                    out[f"{child.name}"
                        f"{_render_labels(child.labels or {})}"] = ids

        for inst in self.instruments():
            if isinstance(inst, Family):
                for child in inst.children():
                    emit(child)
            else:
                emit(inst)
        return out

    def log_to(self, sink, step: int = 0, **extra) -> None:
        """One structured line into a ``metrics.logging.JsonlSink``
        (duck-typed: anything with ``log(step, **metrics)``)."""
        sink.log(step, event="metrics", **{**self.snapshot(), **extra})
