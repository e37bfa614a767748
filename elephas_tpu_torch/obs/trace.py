"""Span tracer: bounded in-memory ring buffer → Chrome ``trace_event``.

Counterpart of ``elephas_tpu/obs/trace.py``. The port keeps its own copy
so that it imports nothing of the JAX package; its one change is the
device bridge, which enters ``torch.profiler.record_function`` where the
reference enters ``jax.profiler.TraceAnnotation``. The Chrome export is
the reference's, byte for byte.

The serving/training hot paths need per-phase wall-clock visibility
without ever touching the device: recording a span is a
clock read plus one append into a ``deque(maxlen=...)`` ring, so it can
stay on inside the pipelined scheduler's overlap window. The ring drops
the OLDEST events when full — a long-running server keeps the recent
past instead of dying or growing without bound.

Two recording styles, one event format:

- ``with tracer.span("prefill", req_id=3):`` — reads the tracer's clock
  on enter/exit (training loops, parameter-server push/pull);
- ``tracer.record("queue", begin_s, end_s, track="req:3")`` — a span
  whose endpoints the CALLER already timestamped with the same clock
  (the serving scheduler, whose injectable ``clock`` the fake-clock
  tests replace — pass that clock to the ``Tracer`` so both styles land
  in one time domain).

Export is Chrome ``trace_event`` JSON (``{"traceEvents": [...]}``),
viewable in Perfetto / ``chrome://tracing``. Each distinct ``track``
becomes a named thread row, so per-request spans (``track="req:7"``)
render as one lane per request with phases nested by containment —
``scripts/trace_report.py`` reads the same file back into per-phase
percentiles and a request tree.

Device correlation: when ``annotate_device=True`` (default) every
``span()`` also enters ``torch.profiler.record_function``, so inside a
``torch.profiler`` window the SAME span names appear on the host rows of
the trace, lined up with the CUDA kernels they launched. Outside a
profiler window the annotation records nothing — cost is one small
object.

Disabled tracers are free: ``span()`` returns a shared null context
(no allocation), ``record``/``instant`` return before touching the
clock. ``NULL_TRACER`` is the module's shared disabled instance —
instrumented code can hold it unconditionally.

Distributed trace context: every live span carries a
``(trace_id, span_id, parent_id)`` triple threaded through a
``contextvars.ContextVar`` — nested spans on one thread become a causal
tree automatically, ``activate(ctx)`` adopts a context that crossed a
thread (the async comms pipeline) or a socket (the parameter-server
wire codec ships the pair in its header), and ``new_context()`` roots a
fresh trace (the async trainer roots one per (epoch, partition) unit).
Ids are strings: an 8-hex per-process prefix + a counter for span ids
(one contextvar op + one format per span — cheap enough for the <2%
serving-overhead guardrail) and 16 random hex chars for trace ids
(minted once per unit/request, not per span).

Truncation honesty: a bounded ring that silently overwrites unexported
spans makes ``trace_report.py`` lie by omission, so every overwrite is
counted — ``Tracer.dropped`` locally and ``tracer_dropped_spans_total``
on the process registry (lazily bound to dodge the obs import cycle).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = [
    "SpanEvent",
    "TraceContext",
    "Tracer",
    "NULL_TRACER",
    "activate",
    "current_context",
    "new_context",
    "new_span_id",
    "new_trace_id",
    "export_events",
]

_NULL_CTX = contextlib.nullcontext()  # shared: disabled span() allocates nothing


class TraceContext(NamedTuple):
    """The active span's identity: what a child (local or remote) points
    at as its parent. Exactly the pair the wire codec ships."""

    trace_id: str
    span_id: str


#: The innermost active span on this thread/task (None = no trace).
_CTX: contextvars.ContextVar[Optional[TraceContext]] = contextvars.ContextVar(
    "elephas_trace_ctx", default=None
)

# Span ids: per-process random prefix + counter — unique across the
# processes of one job without per-span urandom (which would cost a
# syscall inside the serving hot path).
_SPAN_PREFIX = os.urandom(4).hex()
_SPAN_COUNTER = itertools.count(1)


def new_span_id() -> str:
    return f"{_SPAN_PREFIX}{next(_SPAN_COUNTER):x}"


def new_trace_id() -> str:
    """A fresh 16-hex trace id (minted per unit/request, not per span)."""
    return os.urandom(8).hex()


def new_context() -> TraceContext:
    """A fresh root context — activate it around a unit of work so every
    span recorded inside (this thread, adopted threads, remote handlers)
    lands in one causal tree."""
    return TraceContext(new_trace_id(), new_span_id())


def current_context() -> Optional[TraceContext]:
    """The innermost active span's ``(trace_id, span_id)``, or None."""
    return _CTX.get()


class activate:
    """Context manager installing ``ctx`` as the active trace context
    (and restoring the previous one on exit). ``ctx=None`` detaches —
    spans recorded inside start fresh traces.

    Used to adopt a context that crossed a boundary contextvars can't:
    a queue hop to the comms thread, or a wire frame into a PS handler.
    Reentrant-safe via contextvar tokens; allocation is one small object
    per adoption (never per span)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        self._token = _CTX.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _CTX.reset(self._token)
        return False


class SpanEvent:
    """One recorded span (or instant, when ``end_s == begin_s``)."""

    __slots__ = ("name", "begin_s", "end_s", "track", "args",
                 "trace_id", "span_id", "parent_id")

    def __init__(self, name: str, begin_s: float, end_s: float,
                 track: Optional[str], args: Optional[Dict[str, Any]],
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.name = name
        self.begin_s = begin_s
        self.end_s = end_s
        self.track = track
        self.args = args
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @property
    def duration_s(self) -> float:
        return self.end_s - self.begin_s

    def __repr__(self):
        return (f"SpanEvent({self.name!r}, {self.begin_s:.6f}→"
                f"{self.end_s:.6f}, track={self.track!r})")


class _Span:
    """Live ``span()`` context — clock on enter, ring append on exit.

    When a trace context is active (or always, for the span tree on one
    thread), the span mints its own id, records the enclosing span as
    parent, and installs itself as the active context so children —
    including remote PS handle spans fed the wire-propagated pair —
    point back at it."""

    __slots__ = ("_tracer", "_name", "_args", "_begin", "_annotation",
                 "_trace_id", "_span_id", "_parent_id", "_token")

    def __init__(self, tracer: "Tracer", name: str, args):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._begin = 0.0
        self._annotation = None
        self._trace_id = None
        self._span_id = None
        self._parent_id = None
        self._token = None

    def __enter__(self):
        tracer = self._tracer
        if tracer._annotate:
            annotation = tracer._device_annotation(self._name)
            if annotation is not None:
                self._annotation = annotation
                annotation.__enter__()
        parent = _CTX.get()
        if parent is not None:
            self._trace_id = parent.trace_id
            self._parent_id = parent.span_id
            self._span_id = new_span_id()
            self._token = _CTX.set(TraceContext(parent.trace_id,
                                                self._span_id))
        self._begin = tracer.clock()
        return self

    @property
    def context(self) -> Optional[TraceContext]:
        """This span's ``(trace_id, span_id)`` — what the client ships
        on the wire so the server-side handle span becomes its child.
        None when no trace is active."""
        if self._span_id is None:
            return None
        return TraceContext(self._trace_id, self._span_id)

    def note(self, **attrs) -> "_Span":
        """Attach args discovered mid-span (payload bytes, codec, cache
        hit) — merged into the event's ``args`` at exit. Callers using
        ``with tracer.span(...) as sp:`` must guard for a disabled
        tracer, whose null context yields ``None``."""
        if self._args is None:
            self._args = dict(attrs)
        else:
            self._args.update(attrs)
        return self

    def __exit__(self, *exc):
        tracer = self._tracer
        end = tracer.clock()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        if self._token is not None:
            _CTX.reset(self._token)
        # Track = recording thread: async trainer workers are threads,
        # so each worker's pull/train/push phases get their own row.
        tracer._append(
            SpanEvent(self._name, self._begin, end,
                      threading.current_thread().name, self._args,
                      self._trace_id, self._span_id, self._parent_id)
        )
        return False


class Tracer:
    """Bounded host-side span recorder.

    Parameters
    ----------
    capacity: ring size in events; the oldest are dropped when full.
    clock: monotonic seconds source. MUST match the clock of any caller
        that records retroactive spans (``record``) — the serving engine
        passes its own injectable clock through.
    enabled: a disabled tracer records nothing and ``span()`` returns a
        shared null context (zero allocation).
    annotate_device: bridge each ``span()`` into
        ``torch.profiler.record_function`` so host spans line up with
        CUDA kernels inside an open profiler window.
    """

    def __init__(self, capacity: int = 65536, clock=time.monotonic,
                 enabled: bool = True, annotate_device: bool = True):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.enabled = enabled
        self._annotate = annotate_device
        self._events: deque = deque(maxlen=capacity)
        self._annotation_cls = None  # resolved lazily (torch import)
        self.dropped = 0  # ring overwrites of unexported spans
        self._dropped_counter = None  # lazily bound registry counter
        self._stores: tuple = ()  # durable tees (obs/store.py), COW

    def _append(self, event: SpanEvent) -> None:
        events = self._events
        if len(events) == events.maxlen:
            # The append below overwrites the oldest unexported span —
            # count it so trace_report can't silently lie by omission.
            self.dropped += 1
            counter = self._dropped_counter
            if counter is None:
                try:
                    from elephas_tpu_torch import obs  # lazy: import cycle
                    counter = obs.default_registry().counter(
                        "tracer_dropped_spans_total",
                        "Spans overwritten by the bounded ring before export.",
                    )
                except Exception:
                    counter = False  # registry unavailable: count locally
                self._dropped_counter = counter
            if counter:
                counter.inc()
        events.append(event)
        # Durable tee: every COMPLETED span summary (this is the single
        # sink — __exit__, record(), instant() all land here) journals
        # so a post-mortem keeps the recent span history the ring loses
        # with the process. Summaries only: name/duration/ids, no args
        # beyond what the incident timeline needs.
        for store in self._stores:
            try:
                store.record_span(
                    {"name": event.name, "begin_s": event.begin_s,
                     "dur_s": event.end_s - event.begin_s,
                     "track": event.track, "trace_id": event.trace_id},
                    mono_s=event.end_s,
                )
            except Exception:
                pass

    # -- durable tee -------------------------------------------------------

    def attach_store(self, store) -> None:
        """Journal every subsequent completed span summary into
        ``store`` (a ``TelemetryStore``). Idempotent."""
        if store not in self._stores:
            self._stores = self._stores + (store,)

    def detach_store(self, store) -> None:
        self._stores = tuple(s for s in self._stores if s is not store)

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager recording ``name`` from enter to exit."""
        if not self.enabled:
            return _NULL_CTX
        return _Span(self, name, args or None)

    def record(self, name: str, begin_s: float, end_s: float,
               track: Optional[str] = None, **args) -> None:
        """Record a span whose endpoints the caller already timestamped
        (with THIS tracer's clock domain). Tagged with the active trace
        context (as a leaf: the retroactive span never becomes a parent,
        so the serving hot path pays one contextvar read, no id mint)."""
        if not self.enabled:
            return
        if track is None:
            track = threading.current_thread().name
        ctx = _CTX.get()
        if ctx is None:
            event = SpanEvent(name, begin_s, end_s, track, args or None)
        else:
            event = SpanEvent(name, begin_s, end_s, track, args or None,
                              ctx.trace_id, new_span_id(), ctx.span_id)
        self._append(event)

    def instant(self, name: str, at: Optional[float] = None,
                track: Optional[str] = None, **args) -> None:
        """Zero-duration marker (defaults to now)."""
        if not self.enabled:
            return
        t = self.clock() if at is None else at
        if track is None:
            track = threading.current_thread().name
        ctx = _CTX.get()
        if ctx is None:
            event = SpanEvent(name, t, t, track, args or None)
        else:
            event = SpanEvent(name, t, t, track, args or None,
                              ctx.trace_id, new_span_id(), ctx.span_id)
        self._append(event)

    def _device_annotation(self, name: str):
        """A ``torch.profiler.record_function`` for ``name``, or None
        when the profiler API is unavailable — the tracer must work in
        stripped environments."""
        if self._annotation_cls is None:
            try:
                from torch.profiler import record_function
                self._annotation_cls = record_function
            except Exception:  # no profiler: disable the bridge
                self._annotate = False
                return None
        try:
            return self._annotation_cls(name)
        except Exception:
            self._annotate = False
            return None

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[SpanEvent]:
        """Snapshot of the ring (oldest first)."""
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    # -- export ------------------------------------------------------------

    def to_chrome_events(self) -> List[dict]:
        """The ring as Chrome ``trace_event`` dicts (microsecond ts,
        normalized so the earliest event sits at t=0).

        Each distinct ``track`` becomes one named tid row (thread-name
        metadata events included), untracked spans share a row per
        recording thread name; Perfetto nests spans on a row by time
        containment. Spans recorded under a trace context carry
        ``trace_id``/``span_id``/``parent_id`` in ``args`` — the keys
        ``trace_report.py --merge`` joins on across processes.
        """
        return _to_chrome_events(self.events())

    def export_chrome(self, path: Optional[str] = None,
                      process: Optional[str] = None):
        """Dump the ring as a Perfetto-viewable trace. Returns the
        ``{"traceEvents": [...]}`` dict; also writes it to ``path``
        when given.

        The doc carries a ``clockSync`` block — the normalization origin
        in this tracer's clock domain plus a (mono, wall) sample taken
        at export — so ``trace_report.py --merge`` can map every event
        back to wall time and align dumps from different processes
        (each with its own arbitrary monotonic-clock base).
        """
        return export_events(self.events(), self.clock, path=path,
                             process=process, dropped=self.dropped)


def _to_chrome_events(events: List[SpanEvent]) -> List[dict]:
    if not events:
        return []
    t0 = min(e.begin_s for e in events)
    tids: Dict[str, int] = {}
    out: List[dict] = []

    def tid_for(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
            out.append({
                "name": "thread_name", "ph": "M", "pid": 0,
                "tid": tids[track], "args": {"name": track},
            })
        return tids[track]

    main = threading.main_thread().name
    for e in events:
        rec = {
            "name": e.name,
            "ph": "X",
            "pid": 0,
            "tid": tid_for(e.track if e.track is not None else main),
            "ts": (e.begin_s - t0) * 1e6,
            "dur": max(e.end_s - e.begin_s, 0.0) * 1e6,
        }
        if e.args:
            rec["args"] = dict(e.args)
        if e.trace_id is not None:
            args = rec.setdefault("args", {})
            args["trace_id"] = e.trace_id
            args["span_id"] = e.span_id
            if e.parent_id is not None:
                args["parent_id"] = e.parent_id
        out.append(rec)
    return out


def export_events(events: List[SpanEvent], clock,
                  path: Optional[str] = None,
                  process: Optional[str] = None,
                  dropped: int = 0):
    """Build (and optionally write) a Chrome-trace doc for an event
    subset — ``chaos_bench --trace`` splits one in-process ring into
    per-role dumps (workers vs PS handlers) through this.

    ``clock`` must be the clock the events were recorded with; it is
    sampled once alongside wall time to form the ``clockSync`` block.
    """
    doc = {
        "traceEvents": _to_chrome_events(events),
        "displayTimeUnit": "ms",
        "clockSync": {
            # t=0 of the normalized events, in the recording clock:
            "origin_mono_s": (min(e.begin_s for e in events)
                              if events else 0.0),
            # simultaneous sample pair mapping that clock to wall time:
            "mono_s_at_export": clock(),
            "wall_s_at_export": time.time(),
        },
        "droppedSpans": dropped,
    }
    if process is not None:
        doc["process"] = process
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


#: Shared disabled instance — hold it unconditionally in instrumented code.
NULL_TRACER = Tracer(capacity=0, enabled=False, annotate_device=False)
