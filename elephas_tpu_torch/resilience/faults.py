"""Deterministic fault injection: seeded, step-indexed chaos that replays
(counterpart of ``elephas_tpu/resilience/faults.py``; the same plans make
the same decisions in both packages).

Chaos tests are worthless when the chaos is irreproducible — a flake
under random packet loss cannot be bisected. A ``FaultPlan`` therefore
makes every injected failure a **pure function of (seed, site)**:

- wire faults key on ``(direction, label, frame_seq)`` — the per-peer
  frame counter, NOT wall time — and the decision is drawn from a
  ``numpy`` generator seeded with ``[seed, site-hash]``, so run N and
  run N+1 of the same scenario drop/delay/duplicate the SAME frames;
- worker faults (``kill_worker_at`` / ``stall_worker_at``) key on
  ``(worker_id, unit_seq)`` — the worker's Nth leased frequency unit —
  and fire unconditionally at the planned site.

Every consulted decision is recorded in the plan's ``trace``; two runs
from the same seed produce identical ``trace_digest()`` values for the
same consulted sites, which is what the chaos tests pin.

Runtime binding: ``FaultInjector`` attaches a plan to live traffic. The
socket layer (``utils.sockets.send/receive``) consults the process-wide
injector installed by ``install()`` — a single ``None``-check when no
chaos is configured, so production traffic pays nothing. A "dropped"
frame raises ``ConnectionError`` at the injection site (the wire model:
the peer never saw it / the reply never arrived), which drives the SAME
client retry/fail-fast machinery a real network fault would. Worker
kills raise ``InjectedWorkerDeath`` at the unit boundary; the elastic
pool treats it exactly like a crashed worker thread (units re-queued).
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

SEND = "send"
RECV = "recv"
_ANY = "*"


class InjectedWorkerDeath(RuntimeError):
    """A FaultPlan killed this worker thread at a planned unit."""


def _site_hash(kind: str, key: Tuple) -> int:
    return zlib.crc32(repr((kind, key)).encode())


def _as_seq_set(value: Union[int, Iterable[int], None]):
    if value is None:
        return frozenset()
    if isinstance(value, int):
        return frozenset((value,))
    return frozenset(int(v) for v in value)


class FaultPlan:
    """Seeded, step-indexed chaos schedule.

    ``drop``/``delay``/``duplicate``: probability per wire frame, either
    a float (all labels) or ``{label: p}`` with ``"*"`` as the default.
    ``delay_seconds``: sleep applied to delayed frames.
    ``partition``: ``{label: (start_seq, end_seq)}`` — every frame for
    ``label`` with ``start_seq <= seq < end_seq`` is dropped (a
    deterministic network partition window).
    ``kill_worker_at``/``stall_worker_at``: ``{worker_id: unit_seq}``
    (or a collection of unit_seqs) — the worker dies/stalls when it
    reaches that many leased units. ``stall_seconds`` is how long a
    stalled worker sleeps (choose it beyond the detector's
    ``dead_after`` to exercise expiry + re-queue).
    """

    def __init__(
        self,
        seed: int,
        drop: Union[float, Dict[str, float], None] = None,
        delay: Union[float, Dict[str, float], None] = None,
        duplicate: Union[float, Dict[str, float], None] = None,
        delay_seconds: float = 0.05,
        partition: Optional[Dict[str, Tuple[int, int]]] = None,
        kill_worker_at: Optional[Dict] = None,
        stall_worker_at: Optional[Dict] = None,
        stall_seconds: float = 0.5,
    ):
        self.seed = int(seed)
        self.drop = self._norm_prob(drop)
        self.delay = self._norm_prob(delay)
        self.duplicate = self._norm_prob(duplicate)
        self.delay_seconds = float(delay_seconds)
        self.partition = dict(partition or {})
        self.kill_worker_at = {
            str(k): _as_seq_set(v) for k, v in (kill_worker_at or {}).items()
        }
        self.stall_worker_at = {
            str(k): _as_seq_set(v) for k, v in (stall_worker_at or {}).items()
        }
        self.stall_seconds = float(stall_seconds)
        self._trace: List[Tuple] = []
        self._trace_lock = threading.Lock()

    @staticmethod
    def _norm_prob(value) -> Dict[str, float]:
        if value is None:
            return {}
        if isinstance(value, (int, float)):
            return {_ANY: float(value)}
        return {str(k): float(v) for k, v in value.items()}

    def _prob(self, table: Dict[str, float], label: str) -> float:
        return table.get(label, table.get(_ANY, 0.0))

    def _record(self, kind: str, key: Tuple, outcome) -> None:
        with self._trace_lock:
            self._trace.append((kind, key, outcome))

    @property
    def trace(self) -> List[Tuple]:
        with self._trace_lock:
            return list(self._trace)

    def trace_digest(self) -> int:
        """Order-independent digest of every consulted decision — two
        replays from the same seed that consult the same sites agree
        (thread scheduling reorders the trace list, never its set)."""
        with self._trace_lock:
            return zlib.crc32(repr(sorted(map(repr, self._trace))).encode())

    def _chance(self, kind: str, label: str, seq: int, p: float) -> bool:
        if p <= 0.0:
            return False
        if p >= 1.0:
            self._record(kind, (label, seq), True)
            return True
        rng = np.random.default_rng([self.seed, _site_hash(kind, (label, seq))])
        hit = bool(rng.random() < p)
        self._record(kind, (label, seq), hit)
        return hit

    # -- wire decisions (consulted by FaultInjector) ---------------------

    def frame_action(self, direction: str, label: str, seq: int) -> Tuple[str, float]:
        """``(action, delay_s)`` for one frame at ``(direction, label,
        seq)``; action is 'pass' | 'drop' | 'dup'. Pure in (seed, site)."""
        window = self.partition.get(label) or self.partition.get(_ANY)
        if window is not None and window[0] <= seq < window[1]:
            self._record("partition", (direction, label, seq), True)
            return "drop", 0.0
        if self._chance(f"drop-{direction}", label, seq,
                        self._prob(self.drop, label)):
            return "drop", 0.0
        action = "pass"
        if direction == SEND and self._chance(
            f"dup-{direction}", label, seq, self._prob(self.duplicate, label)
        ):
            action = "dup"
        delay_s = (
            self.delay_seconds
            if self._chance(f"delay-{direction}", label, seq,
                            self._prob(self.delay, label))
            else 0.0
        )
        return action, delay_s

    # -- worker decisions ------------------------------------------------

    def should_kill(self, worker_id, unit_seq: int) -> bool:
        hit = unit_seq in self.kill_worker_at.get(str(worker_id), ())
        if hit:
            self._record("kill", (str(worker_id), unit_seq), True)
        return hit

    def stall_for(self, worker_id, unit_seq: int) -> float:
        if unit_seq in self.stall_worker_at.get(str(worker_id), ()):
            self._record("stall", (str(worker_id), unit_seq),
                         self.stall_seconds)
            return self.stall_seconds
        return 0.0


class FaultInjector:
    """Binds a ``FaultPlan`` to live traffic.

    Sockets are labelled via ``label_socket(sock, label)`` (the elastic
    pool labels each worker's client connection with the worker id);
    unlabelled sockets share the ``"?"`` label. Frame sequence numbers
    are per ``(label, direction)`` so a label's Nth send is the same
    site in every replay, regardless of what other workers do.
    """

    def __init__(self, plan: FaultPlan, sleep: Callable[[float], None] = time.sleep):
        self.plan = plan
        self._sleep = sleep
        self._lock = threading.Lock()
        self._labels: Dict[int, str] = {}
        self._seqs: Dict[Tuple[str, str], int] = {}

    def label_socket(self, sock, label: str) -> None:
        with self._lock:
            self._labels[id(sock)] = str(label)

    def unlabel_socket(self, sock) -> None:
        with self._lock:
            self._labels.pop(id(sock), None)

    def _next_seq(self, label: str, direction: str) -> int:
        with self._lock:
            key = (label, direction)
            seq = self._seqs.get(key, 0)
            self._seqs[key] = seq + 1
            return seq

    def _frame_event(self, sock, direction: str) -> str:
        with self._lock:
            label = self._labels.get(id(sock), "?")
        seq = self._next_seq(label, direction)
        action, delay_s = self.plan.frame_action(direction, label, seq)
        if delay_s > 0.0:
            self._sleep(delay_s)
        if action == "drop":
            raise ConnectionError(
                f"fault-injected {direction} drop (label={label}, seq={seq})"
            )
        return action

    # -- hooks called from utils.sockets --------------------------------

    def on_send(self, sock) -> str:
        """'pass' or 'dup'; raises ConnectionError on a planned drop."""
        return self._frame_event(sock, SEND)

    def on_recv(self, sock) -> str:
        return self._frame_event(sock, RECV)

    # -- hooks called from the elastic pool ------------------------------

    def maybe_fail_worker(self, worker_id, unit_seq: int) -> None:
        """Raise/stall per the plan at a worker's unit boundary."""
        stall = self.plan.stall_for(worker_id, unit_seq)
        if stall > 0.0:
            self._sleep(stall)
        if self.plan.should_kill(worker_id, unit_seq):
            raise InjectedWorkerDeath(
                f"fault plan killed worker {worker_id} at unit {unit_seq}"
            )


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install (or clear, with None) the process-wide injector consulted
    by ``utils.sockets.send/receive``. Returns the injector for
    with-style chaining. Tests MUST clear it in teardown."""
    from elephas_tpu_torch.utils import sockets

    sockets.set_fault_injector(injector)
    return injector
