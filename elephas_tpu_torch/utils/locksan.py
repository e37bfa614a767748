"""Runtime lock sanitizer (counterpart of ``elephas_tpu/utils/locksan.py``).

The port carries the part its serving path calls: ``make_lock``, which
the request queue, the flight recorder, the alert engine and the cost
ledger take their mutexes from. Disabled (the default), ``make_lock``
returns a plain ``threading.Lock`` — no wrapper, no overhead. Enabled
(``ELEPHAS_LOCK_SANITIZER=1`` in the environment, or :func:`enable` from
a test), it hands out :class:`InstrumentedLock` wrappers that record,
per thread, the order locks are taken in: acquiring ``B`` while holding
``A`` when ``B`` already reaches ``A`` in the observed order graph is an
inversion — two threads interleaving those paths can deadlock — and
raises :class:`LockOrderInversion` at the acquisition site instead of
hanging. A same-thread re-acquire of a non-reentrant lock raises too.
A NONBLOCKING ``acquire(blocking=False)`` adds no edge: a try-lock
either succeeds or backs off, and cannot deadlock.

The reference also seeds the order from its static analysis
(``ANALYSIS.json``, derived from the JAX package's tree) and offers
reentrant locks, conditions and read-write hooks; those arrive with the
port of the analysis (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set


class LockOrderInversion(RuntimeError):
    """Raised at an acquisition that inverts the established order."""


class _Registry:
    """Process-wide order graph + per-thread held stacks."""

    def __init__(self):
        self._mu = threading.Lock()
        self._observed: Dict[str, Set[str]] = {}
        self._tls = threading.local()

    # -- per-thread stack ----------------------------------------------------

    def held(self) -> List[str]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    # -- graph ---------------------------------------------------------------

    def _reaches(self, src: str, dst: str) -> Optional[List[str]]:
        """Path ``src -> … -> dst`` in the observed graph, else None.
        Caller holds ``_mu``."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            for nxt in self._observed.get(node, set()):
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
            raise LockOrderInversion(
                f"self-deadlock: {threading.current_thread().name} "
                f"re-acquires non-reentrant lock {name} it already holds")
        with self._mu:
            for h in reversed(held):
                path = self._reaches(name, h)
                if path is not None:
                    raise LockOrderInversion(
                        f"lock-order inversion: "
                        f"{threading.current_thread().name} acquires "
                        f"{name} while holding {h}, but the established "
                        f"order is {' -> '.join(path)}")
            for h in held:
                self._observed.setdefault(h, set()).add(name)
        held.append(name)

    def note_tryacquire(self, name: str) -> None:
        """A successful nonblocking acquire: hold-tracked but never
        order-checked — the try-lock pattern is deadlock-free by
        construction."""
        self.held().append(name)

    def note_release(self, name: str) -> None:
        held = self.held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return


_REGISTRY = _Registry()
_ENABLED = os.environ.get("ELEPHAS_LOCK_SANITIZER", "") == "1"


def enable() -> None:
    """Turn the sanitizer on (test fixtures; prod uses the env var).
    Starts from a FRESH registry so one test's observed orders don't
    leak into the next."""
    global _ENABLED, _REGISTRY
    _REGISTRY = _Registry()
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


class InstrumentedLock:
    """``threading.Lock`` wrapper that feeds the registry."""

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


def make_lock(name: str):
    """A mutex: plain ``threading.Lock`` disabled (zero overhead),
    instrumented under the sanitizer. ``name`` must be the statically
    derived identity (``Class.attr`` / ``module.attr``)."""
    if _ENABLED:
        return InstrumentedLock(name)
    return threading.Lock()
