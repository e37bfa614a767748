"""Readers-writer lock (counterpart of ``elephas_tpu/utils/rwlock.py``).

Reference: ``elephas/utils/rwlock.py::RWLock`` (SURVEY.md §2.1, §5.2) —
guards the parameter-server weight state in ``asynchronous`` mode and is
deliberately bypassed in ``hogwild`` mode (lock-free, Hogwild!-style).

Writer-preferring: once a writer is waiting, new readers queue behind
it, so pull-heavy Downpour loops cannot starve the merge thread. The
reference's ``acquire_read`` / ``acquire_write`` / ``release`` are kept,
with context-manager helpers, which is what the engine uses.

Under the runtime sanitizer (``utils.locksan``) a NAMED lock is one
node of the order graph while either side is held: ``acquire_read`` /
``acquire_write`` order-check the name before blocking
(``locksan.rw_acquire``) and ``release`` pops it
(``locksan.rw_release``). The condition's own mutex stays a plain
``threading.Lock``: it is released before the caller's critical section
runs, so it can never take part in an inversion.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from elephas_tpu_torch.utils import locksan


class RWLock:
    """Writer-preferring readers-writer lock with the reference's API.

    ``name`` opts the lock into the sanitizer under its static identity
    (the ``Class.attr`` the analyzer derives); an unnamed lock is
    untracked."""

    def __init__(self, name: Optional[str] = None):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._san_name = name

    def acquire_read(self):
        locksan.rw_acquire(self._san_name, write=False)
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def acquire_write(self):
        locksan.rw_acquire(self._san_name, write=True)
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
        locksan.rw_release(self._san_name)

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
