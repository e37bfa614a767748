"""The port's resilience layer (``elephas_tpu_torch/resilience``) held
against the JAX package's: fault plans make the same decisions and
digests, the unit ledger leases and requeues in the same order for the
same script, the elastic pool requeues deaths, fences detector-dead
workers and admits late joiners on a fake clock, the socket layer's
fault hook drops and duplicates frames on a port socket server, and the
``MembershipView`` reads fencing state."""

import threading
import time

import numpy as np
import pytest
import torch

from elephas_tpu import resilience as jax_resilience
from elephas_tpu_torch.parameter.client import ParameterServerUnavailable
from elephas_tpu_torch.parameter.server import make_server
from elephas_tpu_torch.resilience import (
    ALIVE,
    DEAD,
    ElasticWorkerPool,
    FaultInjector,
    FaultPlan,
    InjectedWorkerDeath,
    MembershipView,
    UnitLedger,
    install,
)
from elephas_tpu_torch.utils import sockets


class FakeTime:
    """A fake clock whose sleep advances it (and yields the thread for a
    moment, so the pool's threads interleave)."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []
        self._lock = threading.Lock()

    def clock(self):
        return self.now

    def sleep(self, seconds):
        with self._lock:
            self.now += seconds
            self.sleeps.append(seconds)
        time.sleep(0.0002)


# -- FaultPlan / FaultInjector against the JAX package ----------------------

PLANS = [
    dict(seed=5, drop=0.5, delay=0.5, duplicate=0.5),
    dict(seed=11, drop={"w0": 0.3, "*": 0.1}, duplicate={"w1": 0.7}, delay=0.2),
    dict(seed=0, partition={"*": (2, 4)}),
    dict(seed=0, partition={"w1": (0, 2)}, drop=1.0),
    dict(seed=3, kill_worker_at={"w0": 2, "w1": (0, 3)},
         stall_worker_at={"w1": (1, 4)}, stall_seconds=7.5),
]


def _consult(plan):
    out = [plan.frame_action(d, label, seq) for d in ("send", "recv")
           for label in ("w0", "w1", "?") for seq in range(12)]
    out += [(plan.should_kill(w, u), plan.stall_for(w, u))
            for w in ("w0", "w1") for u in range(5)]
    return out


@pytest.mark.parametrize("kwargs", PLANS, ids=lambda k: f"seed{k['seed']}-" + "-".join(
    sorted(k)[:3]))
def test_fault_plan_decisions_and_digest_equal_jax(kwargs):
    port, ref = FaultPlan(**kwargs), jax_resilience.FaultPlan(**kwargs)
    assert _consult(port) == _consult(ref)
    assert sorted(map(repr, port.trace)) == sorted(map(repr, ref.trace))
    assert port.trace_digest() == ref.trace_digest()
    # Consulting the same sites in another order leaves the digest.
    again = FaultPlan(**kwargs)
    for args in reversed([(d, label, seq) for d in ("send", "recv")
                          for label in ("w0", "w1", "?") for seq in range(12)]):
        again.frame_action(*args)
    for w in ("w0", "w1"):
        for u in range(5):
            again.should_kill(w, u)
            again.stall_for(w, u)
    assert again.trace_digest() == port.trace_digest()


def _drive_injector(injector, death_type):
    """The same script of frames and unit boundaries; returns what each
    call did."""
    socks = [object(), object(), object()]
    injector.label_socket(socks[0], "w0")
    injector.label_socket(socks[1], "w1")
    out = []
    for i in range(20):
        sock = socks[i % 3]
        for hook in (injector.on_send, injector.on_recv):
            try:
                out.append(hook(sock))
            except ConnectionError as exc:
                out.append(str(exc))
    for worker in ("w0", "w1"):
        for unit in range(4):
            try:
                injector.maybe_fail_worker(worker, unit)
                out.append("ok")
            except death_type as exc:
                out.append(str(exc))
    return out


@pytest.mark.parametrize("kwargs", [
    dict(seed=0, partition={"w0": (0, 1)}, delay={"w0": 1.0}, duplicate={"w0": 1.0},
         delay_seconds=0.25),
    dict(seed=9, drop=0.3, duplicate=0.3, delay=0.3, kill_worker_at={"w1": 2},
         stall_worker_at={"w0": 1}, stall_seconds=3.0),
])
def test_fault_injector_actions_equal_jax(kwargs):
    port_sleeps, ref_sleeps = [], []
    port = _drive_injector(FaultInjector(FaultPlan(**kwargs), sleep=port_sleeps.append),
                           InjectedWorkerDeath)
    ref = _drive_injector(
        jax_resilience.FaultInjector(jax_resilience.FaultPlan(**kwargs),
                                     sleep=ref_sleeps.append),
        jax_resilience.InjectedWorkerDeath)
    assert port == ref
    assert port_sleeps == ref_sleeps  # delays and stalls on the injected sleep


# -- UnitLedger against the JAX package ---------------------------------------

SCRIPTS = {
    "epoch_major": (dict(epochs=2, partitions=[0, 1]),
                    [("lease", "w")] * 5),
    "requeue_front": (dict(epochs=2, partitions=[0, 1]),
                      [("lease", "dead"), ("lease", "dead"), ("lease", "w1"),
                       ("requeue", "dead"), ("lease", "survivor"), ("requeue", "dead"),
                       ("outstanding",)]),
    "exact_accounting": (dict(epochs=1, partitions=[0, 1]),
                         [("lease", "w0"), ("lease", "w1"), ("complete", "w0", 0),
                          ("complete", "w1", 1), ("complete", "w0", 0), ("done",)]),
    "zombie": (dict(epochs=1, partitions=[0]),
               [("lease", "zombie"), ("requeue", "zombie"), ("complete", "zombie", 0),
                ("lease", "survivor"), ("done",)]),
    "ranges": (dict(epochs=2, partitions=[0, 1], n_batches=5, batches_per_unit=2),
               [("lease", "w")] * 7 + [("requeue", "w"), ("lease", "v"), ("outstanding",)]),
    "ranges_uneven": (dict(epochs=1, partitions=["a", "b"], n_batches={"a": 3, "b": 1},
                           batches_per_unit=2),
                      [("lease", "w0"), ("lease", "w0"), ("complete", "w0", 0),
                       ("requeue", "w0"), ("lease", "w1"), ("complete", "w1", 1),
                       ("lease", "w1"), ("complete", "w1", 2), ("done",)]),
    "add_units": (dict(epochs=1, partitions=[0, 1, 2]),
                  [("lease", "w0"), ("complete", "w0", 0), ("lease", "w1"),
                   ("add", [(0, 0), (0, 1), (0, 2), (1, 0), (1, 0), (2, 5)]),
                   ("complete", "w1", 1), ("lease", "w0"), ("complete", "w0", 2),
                   ("done",), ("lease", "w0"), ("lease", "w0"), ("requeue", "w0"),
                   ("outstanding",)]),
}


def _run_script(ledger_cls, shape, ops):
    ledger = ledger_cls(shape["epochs"], shape["partitions"],
                        n_batches=shape.get("n_batches"),
                        batches_per_unit=shape.get("batches_per_unit"))
    leased, out = [], []
    for op in ops:
        if op[0] == "lease":
            unit = ledger.lease(op[1])
            leased.append(unit)
            out.append(unit)
        elif op[0] == "complete":
            out.append(ledger.complete(op[1], leased[op[2]]))
        elif op[0] == "requeue":
            out.append(ledger.requeue_worker(op[1]))
        elif op[0] == "add":
            out.append(ledger.add_units(op[1]))
        elif op[0] == "done":
            out.append(ledger.all_done())
        else:
            out.append(ledger.outstanding())
    return out + [ledger.completed_units, ledger.requeued_units, ledger.total_units,
                  ledger.epochs]


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_ledger_sequences_equal_jax(name):
    shape, ops = SCRIPTS[name]
    assert _run_script(UnitLedger, shape, ops) == \
        _run_script(jax_resilience.UnitLedger, shape, ops)


def test_ledger_epoch_done_fires_once_under_shuffled_completion():
    import random

    ledger = UnitLedger(2, [0, 1], n_batches=4, batches_per_unit=2)
    units = [ledger.lease("w") for _ in range(ledger.total_units)]
    random.Random(7).shuffle(units)
    fired = [ledger.complete("w", u)[1] for u in units]
    assert sorted(f for f in fired if f is not None) == [0, 1]
    assert ledger.all_done()


@pytest.mark.parametrize("kwargs", [dict(epochs=0, partitions=[0]),
                                    dict(epochs=1, partitions=[]),
                                    dict(epochs=1, partitions=[0], batches_per_unit=2)])
def test_ledger_rejects_bad_shapes(kwargs):
    with pytest.raises(ValueError):
        UnitLedger(**kwargs)


# -- ElasticWorkerPool on a fake clock ----------------------------------------


class _FakeClient:
    """Liveness surface only; ``table`` stands in for the PS membership."""

    def __init__(self, table=None, healthy=True):
        self._table = table if table is not None else {}
        self._healthy = healthy

    def heartbeat(self, worker_id):
        pass

    def membership(self):
        return dict(self._table)

    def health(self):
        return self._healthy

    def deregister(self, worker_id):
        pass

    def close(self):
        pass


def _pool(ledger, run_unit, fake, worker_ids=("w0", "w1"), factory=None, **kw):
    return ElasticWorkerPool(ledger, run_unit=run_unit,
                             client_factory=factory or (lambda wid: _FakeClient()),
                             worker_ids=list(worker_ids), monitor_poll=0.005,
                             idle_wait=0.001, clock=fake.clock, sleep=fake.sleep, **kw)


def test_pool_drains_ledger_and_reports_stats():
    fake = FakeTime()
    ledger = UnitLedger(3, [0, 1])
    done, fired = [], []
    pool = _pool(ledger, lambda wid, client, unit: done.append((wid, unit)) or {"n": 1},
                 fake, on_epoch_complete=fired.append)
    pool.start()
    stats = pool.wait()
    assert stats["completed_units"] == 6 and stats["requeued_units"] == 0
    assert fired == [0, 1, 2] and len(done) == 6
    assert pool.epoch_metrics()[2][1] == {"n": 1}


def test_pool_requeues_injected_death_to_survivor():
    fake = FakeTime()
    ledger = UnitLedger(2, [0, 1])
    ran = []

    def run_unit(wid, client, unit):
        # w1 holds its first unit until w0 has reached its second (and
        # died there), so the kill lands however the threads are scheduled.
        deadline = time.monotonic() + 10.0
        while wid == "w1" and not pool.stats["worker_deaths"] \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        fake.sleep(1.0)  # a unit takes one fake second
        ran.append(wid)
        return {}

    plan = FaultPlan(seed=1, kill_worker_at={"w0": 1})
    pool = _pool(ledger, run_unit, fake, injector=FaultInjector(plan, sleep=fake.sleep))
    pool.start()
    stats = pool.wait()
    assert stats["completed_units"] == 4  # exact despite the death
    assert [d["worker"] for d in stats["worker_deaths"]] == ["w0"]
    assert stats["worker_deaths"][0]["reason"] == "injected kill"
    assert ran.count("w0") == 1
    assert plan.trace == [("kill", ("w0", 1), True)]
    # The repair window is measured on the fake clock.
    assert stats["mttr_samples"] and all(s >= 1.0 for s in stats["mttr_samples"])


def test_pool_rides_out_ps_outage_on_the_fake_clock():
    fake = FakeTime()
    ledger = UnitLedger(2, [0])
    state = {"failed": False, "clients": 0}

    def factory(worker_id):
        state["clients"] += 1
        return _FakeClient()

    def run_unit(worker_id, client, unit):
        if not state["failed"]:
            state["failed"] = True
            raise ParameterServerUnavailable("boom")
        return {}

    pool = _pool(ledger, run_unit, fake, worker_ids=["w0"], factory=factory,
                 ps_recovery_grace=5.0)
    pool.start()
    stats = pool.wait()
    assert stats["completed_units"] == 2 and stats["requeued_units"] == 1
    assert len(stats["ps_outages"]) == 1 and stats["ps_outages"][0]["recovered"]
    assert state["clients"] >= 2  # a FRESH client after the outage


class _UnreachableAtStart(_FakeClient):
    """A client whose first heartbeat finds the server unreachable."""

    def heartbeat(self, worker_id):
        raise ParameterServerUnavailable("dropped during heartbeat")


@pytest.mark.parametrize("returns", [True, False], ids=["returns", "never"])
def test_pool_rides_out_ps_outage_before_the_first_lease(returns):
    """Every worker's first heartbeat is dropped (a partition open at
    start-up): the pool waits out the grace for the server instead of
    losing its workers with every unit still pending."""
    fake = FakeTime()
    clients = {}

    def factory(worker_id):
        clients[worker_id] = clients.get(worker_id, 0) + 1
        if worker_id != "monitor" and clients[worker_id] == 1:
            return _UnreachableAtStart()
        return _FakeClient(healthy=returns)

    pool = _pool(UnitLedger(2, [0, 1]), lambda wid, client, unit: {}, fake,
                 factory=factory, ps_recovery_grace=2.0)
    pool.start()
    if not returns:
        with pytest.raises(ParameterServerUnavailable, match="grace"):
            pool.wait()
        assert not any(o["recovered"] for o in pool.stats["ps_outages"])
        return
    stats = pool.wait()
    assert stats["completed_units"] == 4 and stats["requeued_units"] == 0
    assert stats["worker_deaths"] == []
    assert len(stats["ps_outages"]) == 2 and all(o["recovered"] for o in stats["ps_outages"])
    assert clients["w0"] >= 2 and clients["w1"] >= 2  # a fresh client each


def test_pool_fails_fast_when_ps_never_returns():
    fake = FakeTime()

    def run_unit(worker_id, client, unit):
        raise ParameterServerUnavailable("gone for good")

    pool = _pool(UnitLedger(1, [0]), run_unit, fake, worker_ids=["w0"],
                 factory=lambda wid: _FakeClient(healthy=False), ps_recovery_grace=2.0)
    pool.start()
    with pytest.raises(ParameterServerUnavailable, match="grace"):
        pool.wait()
    assert pool.stats["ps_outages"][0]["recovered"] is False
    assert fake.now >= 2.0  # the grace ran out on the fake clock


def test_pool_admits_late_joiner():
    fake = FakeTime()
    gate = threading.Event()
    ran = []

    arrived = set()

    def run_unit(worker_id, client, unit):
        arrived.add(worker_id)
        gate.wait(10.0)  # hold units until the joiner holds one too
        ran.append(worker_id)
        return {}

    pool = _pool(UnitLedger(4, [0, 1]), run_unit, fake, worker_ids=["w0"])
    pool.start()
    pool.join_worker("late")
    with pytest.raises(ValueError):
        pool.join_worker("late")  # a double join while alive is a bug
    deadline = time.monotonic() + 10.0
    while "late" not in arrived and time.monotonic() < deadline:
        time.sleep(0.001)
    gate.set()
    stats = pool.wait()
    assert stats["completed_units"] == 8 and stats["late_joins"] == ["late"]
    assert "late" in ran


def test_pool_fences_detector_dead_worker():
    fake = FakeTime()
    table = {"w0": {"state": DEAD}}
    started = threading.Event()

    def run_unit(worker_id, client, unit):
        started.wait(5.0)
        return {}

    pool = _pool(UnitLedger(50, [0]), run_unit, fake,
                 factory=lambda wid: _FakeClient(table))
    pool.start()
    deadline = time.monotonic() + 10.0
    while pool.membership.state("w0") != DEAD and time.monotonic() < deadline:
        time.sleep(0.001)  # the monitor publishes the table
    started.set()
    stats = pool.wait()
    assert stats["completed_units"] == 50  # w1 finished everything
    assert "w0" in stats["fenced"]


def test_pool_range_units_mean_into_one_metric_slot():
    fake = FakeTime()
    losses = iter([4.0, 2.0])
    pool = _pool(UnitLedger(1, [0], n_batches=4, batches_per_unit=2),
                 lambda wid, client, unit: {"loss": next(losses)}, fake, worker_ids=["w0"])
    pool.start()
    assert pool.wait()["completed_units"] == 2
    assert pool.epoch_metrics() == {0: {0: {"loss": 3.0}}}


def test_pool_accounting_exact_under_contention():
    """Eight workers (more than this host's cores) drain 120 units with
    fast thread switches, three of them killed by the plan: every unit
    counts exactly once, and the ledger ends empty."""
    import sys

    fake = FakeTime()
    seen = []
    plan = FaultPlan(seed=2, kill_worker_at={"w1": 1, "w4": 0, "w6": 1})
    arrived = set()
    ledger = UnitLedger(20, list(range(6)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run_unit(wid, client, unit):
            # Every worker holds a unit (or has died at its first lease)
            # before any unit completes, so each planned kill site is reached.
            arrived.add(wid)
            deadline = time.monotonic() + 10.0
            while len(arrived | {d["worker"] for d in pool.stats["worker_deaths"]}) < 8 \
                    and time.monotonic() < deadline:
                time.sleep(0.001)
            time.sleep(0.001)
            seen.append(unit)
            return {}

        pool = _pool(ledger, run_unit, fake,
                     worker_ids=[f"w{i}" for i in range(8)], injector=FaultInjector(plan))
        pool.start()
        stats = pool.wait()
    finally:
        sys.setswitchinterval(interval)
    assert stats["completed_units"] == ledger.total_units == 120
    assert sorted({d["worker"] for d in stats["worker_deaths"]}) == ["w1", "w4", "w6"]
    assert sorted(set(seen)) == sorted((e, p) for e in range(20) for p in range(6))
    assert ledger.outstanding() == {"pending": 0, "leased": 0, "done": 120}


# -- the socket layer's fault hook on a port socket server --------------------


@pytest.fixture
def socket_server():
    server = make_server("socket", {"w": torch.zeros(3)}, port=0, device="cpu")
    server.start()
    yield server
    install(None)
    server.stop()


def _labelled_client(server, injector, label):
    """A client whose connection carries ``label``. The injector keys
    labels by ``id(sock)``, so the caller keeps the socket alive: a freed
    socket's id could come back as a server-side socket's."""
    client = server.client()
    sock = client._connection()
    injector.label_socket(sock, label)
    return client, sock


def test_socket_hook_drops_a_pull_frame_then_reconnects(socket_server):
    plan = FaultPlan(seed=0, partition={"w0": (0, 1)})
    injector = install(FaultInjector(plan))
    assert sockets._fault_injector is injector
    client, sock = _labelled_client(socket_server, injector, "w0")
    pulled = client.get_parameters()  # w0's first send drops; the read reconnects once
    torch.testing.assert_close(pulled["w"], torch.zeros(3))
    assert ("partition", ("send", "w0", 0), True) in plan.trace
    client.close()
    sock.close()


def test_socket_hook_drop_fails_a_push_without_resending(socket_server):
    injector = install(FaultInjector(FaultPlan(seed=0, partition={"w0": (0, 1)})))
    client, sock = _labelled_client(socket_server, injector, "w0")
    with pytest.raises(ParameterServerUnavailable, match="not re-sent"):
        client.update_parameters({"w": torch.ones(3)})
    install(None)
    assert socket_server.buffer.version == 0  # nothing applied
    client.close()
    sock.close()


def test_socket_hook_duplicates_a_push_frame(socket_server):
    """Without an auth key a duplicated frame applies twice: the wire
    model of a retransmitted packet the peer cannot tell apart."""
    injector = install(FaultInjector(FaultPlan(seed=0, duplicate={"w0": 1.0})))
    client, sock = _labelled_client(socket_server, injector, "w0")
    client.update_parameters({"w": torch.ones(3)})
    install(None)
    deadline = time.monotonic() + 10.0
    while socket_server.buffer.version < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert socket_server.buffer.version == 2
    np.testing.assert_array_equal(socket_server.buffer.get()["w"].numpy(), -2.0)
    client.close()
    sock.close()


def test_hook_is_off_by_default():
    assert sockets._fault_injector is None
    assert install(None) is None


# -- MembershipView ------------------------------------------------------------


def test_membership_view_fencing_reads():
    view = MembershipView()
    assert view.state("w0") is None and not view.is_dead("w0")
    view.publish({"w0": {"state": DEAD}, "w1": {"state": ALIVE}})
    assert view.is_dead("w0") and not view.is_dead("w1")
    assert view.snapshot()["w1"]["state"] == ALIVE
    ref = jax_resilience.MembershipView()
    ref.publish({"w0": {"state": DEAD}})
    assert ref.is_dead("w0") == view.is_dead("w0") and jax_resilience.DEAD == DEAD
