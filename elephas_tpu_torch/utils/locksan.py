"""Runtime lock sanitizer: the dynamic half of the concurrency lint
(counterpart of ``elephas_tpu/utils/locksan.py``).

``elephas_tpu_torch/analysis/locks.py`` derives the port's
lock-acquisition graph statically; this module cross-validates it on
REAL executions. When enabled (``ELEPHAS_LOCK_SANITIZER=1``, or
:func:`enable` from a test fixture), the :func:`make_lock`/
:func:`make_rlock`/:func:`make_condition` factories hand out
:class:`InstrumentedLock` wrappers that record, per thread, the order
locks are taken in, and a named ``RWLock`` joins through
:func:`rw_acquire`/:func:`rw_release`. Every blocking acquisition is
checked against the union of (a) the statically derived order seeded
from ``ANALYSIS_TORCH.json`` and (b) every order observed so far in this
process: acquiring ``B`` while holding ``A`` when ``B`` can already
reach ``A`` in that graph is an inversion — two threads interleaving
those paths can deadlock — and raises :class:`LockOrderInversion` at the
acquisition site instead of hanging the run. A same-thread re-acquire of
a non-reentrant lock raises too (that hang needs no second thread).

Deliberate exemptions mirror the static analyzer: a NONBLOCKING
``acquire(blocking=False)`` is the sanctioned order-breaking pattern
(try-lock either succeeds or backs off — it cannot deadlock) and adds
no edge; ``Condition.wait`` fully releases its lock, so the held stack
is popped around the wait.

Disabled (the default), the factories return plain
``threading.Lock``/``RLock``/``Condition`` objects — the production
path carries zero wrapper overhead, which the unit tests pin by type.

Lock NAMES are the contract: ``make_lock("ParameterBuffer._version_guard")``
must use the identity the static analyzer derives for that field — the
``lock-order`` rule fails on drift, so the two graphs always join.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

#: The committed static report whose lock graph seeds the order
#: (``python -m elephas_tpu_torch.analysis --write ANALYSIS_TORCH.json``).
ANALYSIS_PATH = Path(__file__).resolve().parents[2] / "ANALYSIS_TORCH.json"

#: The port's concurrency suites that run with the sanitizer on, seeded
#: from ``ANALYSIS_PATH`` (the counterparts of the reference's
#: ``tests/conftest.py::_SANITIZED_SUITES``). To add a suite, name its
#: module here and give the file a module-scoped autouse fixture that
#: enters :func:`sanitized_suite` with ``request.module.__name__``.
SANITIZED_SUITES = (
    "test_torch_hogwild_races",
    "test_torch_opsd",
    "test_torch_fleet_serving",
    "test_torch_fleet_obs",
    "test_torch_parameter_server",
)


class LockOrderInversion(RuntimeError):
    """Raised at an acquisition that inverts the established order."""


class _Registry:
    """Process-wide order graph + per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()
        self._observed: Dict[str, Set[str]] = {}
        self._static: Dict[str, Set[str]] = {}
        self._tls = threading.local()
        self.blocking_events: List[Tuple[Tuple[str, ...], str, str]] = []
        self.checks = 0          # acquisitions order-checked (telemetry)
        #: every inversion raised, also where a thread swallowed it
        self.inversions: List[str] = []

    # -- per-thread stack ----------------------------------------------------

    def held(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    # -- graph ---------------------------------------------------------------

    def load_static_order(self, edges: Iterable[Tuple[str, str]]) -> None:
        with self._mu:
            for src, dst in edges:
                self._static.setdefault(src, set()).add(dst)

    def load_analysis(self, path) -> int:
        """Seed from a committed ``ANALYSIS_TORCH.json``; returns edge count
        (0 when the file is absent — sanitizing still works from
        observed orders alone)."""
        import json
        try:
            with open(path) as f:
                report = json.load(f)
        except (OSError, ValueError):
            return 0
        edges = [(e["src"], e["dst"])
                 for e in report.get("lock_graph", {}).get("edges", [])]
        self.load_static_order(edges)
        return len(edges)

    def _reaches(self, src: str, dst: str) -> Optional[List[str]]:
        """Path ``src -> … -> dst`` in observed ∪ static, else None.
        Caller holds ``_mu``."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in (self._observed.get(node, set())
                        | self._static.get(node, set())):
                if nxt == dst:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- events --------------------------------------------------------------

    def note_acquire(self, name: str, reentrant: bool = False) -> None:
        """Order-check + record a BLOCKING acquisition about to happen.
        Raises instead of letting the caller deadlock."""
        held = self.held()
        if name in held:
            if reentrant:
                held.append(name)
                return
            self._invert(
                f"self-deadlock: {threading.current_thread().name} "
                f"re-acquires non-reentrant lock {name} it already holds")
        with self._mu:
            self.checks += 1
            for h in reversed(held):
                path = self._reaches(name, h)
                if path is not None:
                    self._invert(
                        f"lock-order inversion: "
                        f"{threading.current_thread().name} acquires "
                        f"{name} while holding {h}, but the established "
                        f"order is {' -> '.join(path)}")
            for h in held:
                self._observed.setdefault(h, set()).add(name)
        held.append(name)

    def _invert(self, message: str) -> None:
        self.inversions.append(message)
        raise LockOrderInversion(message)

    def note_tryacquire(self, name: str) -> None:
        """A successful nonblocking acquire: hold-tracked (so blocking
        events under it are attributed) but never order-checked — the
        try-lock pattern is deadlock-free by construction."""
        self.held().append(name)

    def note_release(self, name: str) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def note_blocking(self, desc: str,
                      exclude: Optional[str] = None) -> None:
        held = tuple(h for h in self.held() if h != exclude)
        if held:
            self.blocking_events.append(
                (held, desc, threading.current_thread().name))

    def snapshot_edges(self) -> Dict[str, Set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._observed.items()}

    def static_edges(self) -> Dict[str, Set[str]]:
        """The seeded static order (``load_static_order``/``load_analysis``)."""
        with self._mu:
            return {k: set(v) for k, v in self._static.items()}


_REGISTRY = _Registry()
_ENABLED = os.environ.get("ELEPHAS_LOCK_SANITIZER", "") == "1"


def enabled() -> bool:
    return _ENABLED


def registry() -> _Registry:
    return _REGISTRY


def enable(analysis_path=None) -> None:
    """Turn the sanitizer on (test fixtures; prod uses the env var).
    Starts from a FRESH registry so one test's observed orders don't
    leak into the next; ``analysis_path`` seeds the static order."""
    global _ENABLED, _REGISTRY
    _REGISTRY = _Registry()
    if analysis_path is not None:
        _REGISTRY.load_analysis(analysis_path)
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


@contextmanager
def sanitized_suite(module: str):
    """The sanitizer on, from a fresh registry seeded with
    ``ANALYSIS_PATH`` when the file is there, for the body (a suite's
    tests and its module fixtures); off again after. ``module`` must be
    one of ``SANITIZED_SUITES``, so the list stays the one place that
    names them."""
    name = module.rsplit(".", 1)[-1]
    if name not in SANITIZED_SUITES:
        raise ValueError(f"{name} is not in locksan.SANITIZED_SUITES")
    enable(analysis_path=ANALYSIS_PATH if ANALYSIS_PATH.exists() else None)
    try:
        yield registry()
    finally:
        disable()


class InstrumentedLock:
    """``threading.Lock``/``RLock`` wrapper that feeds the registry."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not blocking:
            got = self._inner.acquire(False)
            if got:
                _REGISTRY.note_tryacquire(self.name)
            return got
        _REGISTRY.note_acquire(self.name, self.reentrant)  # may raise
        try:
            got = self._inner.acquire(True, timeout)
        except BaseException:
            _REGISTRY.note_release(self.name)
            raise
        if not got:
            _REGISTRY.note_release(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _REGISTRY.note_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self.name}>"


class InstrumentedCondition(threading.Condition):
    """Condition over an :class:`InstrumentedLock`; ``wait`` records a
    held-while-blocking event when OTHER locks are held across it (the
    cond's own lock is released by the wait protocol — the default
    ``_release_save`` calls our ``release``, popping the stack)."""

    def __init__(self, name: str):
        self.name = name
        super().__init__(InstrumentedLock(name))

    def wait(self, timeout: Optional[float] = None) -> bool:
        _REGISTRY.note_blocking(f"cond.wait({self.name})",
                                exclude=self.name)
        return super().wait(timeout)


def make_lock(name: str):
    """A mutex: plain ``threading.Lock`` disabled (zero overhead),
    instrumented under the sanitizer. ``name`` must be the statically
    derived identity (``Class.attr`` / ``module.attr``)."""
    if _ENABLED:
        return InstrumentedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    if _ENABLED:
        return InstrumentedLock(name, reentrant=True)
    return threading.RLock()


def make_condition(name: str):
    if _ENABLED:
        return InstrumentedCondition(name)
    return threading.Condition()


def note_blocking(desc: str) -> None:
    """Optional hook for call sites that KNOW they block (journal
    fsync, socket round-trip): records a held-while-blocking event when
    sanitizing, free no-op otherwise."""
    if _ENABLED:
        _REGISTRY.note_blocking(desc)


def rw_acquire(name: Optional[str], write: bool) -> None:
    """RWLock integration: order-check the SEMANTIC lock identity
    before the RWLock blocks on its internal condition. Read sides are
    shared, so a same-thread nested read is reentrant; a same-thread
    write-while-held is a real self-deadlock (the writer waits for its
    own read/write to drain) and raises."""
    if name is not None and _ENABLED:
        _REGISTRY.note_acquire(name, reentrant=not write)


def rw_release(name: Optional[str]) -> None:
    if name is not None and _ENABLED:
        _REGISTRY.note_release(name)
