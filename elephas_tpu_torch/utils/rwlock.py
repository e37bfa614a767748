"""Readers-writer lock (counterpart of ``elephas_tpu/utils/rwlock.py``).

Reference: ``elephas/utils/rwlock.py::RWLock`` (SURVEY.md §2.1, §5.2) —
guards the parameter-server weight state in ``asynchronous`` mode and is
deliberately bypassed in ``hogwild`` mode (lock-free, Hogwild!-style).

Writer-preferring: once a writer is waiting, new readers queue behind
it, so pull-heavy Downpour loops cannot starve the merge thread. The
reference's ``acquire_read`` / ``acquire_write`` / ``release`` are kept,
with context-manager helpers, which is what the engine uses.

The condition's mutex comes from ``utils.locksan.make_lock``: a plain
lock normally, an order-checked one under the sanitizer. The JAX
package also tracks the whole lock as one node of the order graph while
a side is held (``locksan.rw_acquire``); those read-write hooks arrive
with the rest of the sanitizer (ROADMAP.md queue 1, item 7).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from elephas_tpu_torch.utils import locksan


class RWLock:
    """Writer-preferring readers-writer lock with the reference's API."""

    def __init__(self, name: str = "RWLock._cond"):
        self._cond = threading.Condition(locksan.make_lock(name))
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release(self):
        """Release whichever side the calling thread holds."""
        with self._cond:
            if self._writer:
                self._writer = False
            elif self._readers:
                self._readers -= 1
            else:
                raise RuntimeError("release() without a held lock")
            self._cond.notify_all()

    @contextmanager
    def reading(self):
        self.acquire_read()
        try:
            yield self
        finally:
            self.release()

    @contextmanager
    def writing(self):
        self.acquire_write()
        try:
            yield self
        finally:
            self.release()


class NullLock:
    """Lock-shaped no-op used by ``hogwild`` mode (SURVEY.md §2.2).

    Updates proceed unfenced, last writer wins. The parameter buffer
    never writes a published tensor in place, so "race" means
    interleaved read-modify-writes of whole tensors (the Hogwild!
    algorithmic contract), never a torn value.
    """

    def acquire_read(self):
        pass

    def acquire_write(self):
        pass

    def release(self):
        pass

    @contextmanager
    def reading(self):
        yield self

    @contextmanager
    def writing(self):
        yield self
