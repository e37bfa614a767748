"""The port's runtime lock sanitizer (``elephas_tpu_torch/utils/locksan.py``)
against the JAX package's (``tests/test_locksan.py``'s checks, each a
case per package).

Pins the two contracts: (1) the DISABLED path is zero-overhead — the
factories hand back plain ``threading`` primitives, checked by type; (2)
the ENABLED path detects order inversions — transitive ones, ones seeded
from the static report, and the ``RWLock`` as one node of the graph —
and raises at the acquisition site instead of deadlocking. Threads are
real: the cross-thread tests establish an order on one thread and break
it from another. Also the repaired fault: the buffer's write lock taken
inside its version guard, after the established order, raises in the
port as it does in the JAX package.
"""

import json
import threading
from pathlib import Path

import pytest

from elephas_tpu.utils import locksan as jax_locksan
from elephas_tpu.utils.rwlock import RWLock as JaxRWLock
from elephas_tpu_torch.utils import locksan as port_locksan
from elephas_tpu_torch.utils.rwlock import RWLock as PortRWLock

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("jax", "port")
LOCKSAN = {"jax": jax_locksan, "port": port_locksan}
RWLOCK = {"jax": JaxRWLock, "port": PortRWLock}


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


@pytest.fixture
def ls(pkg):
    return LOCKSAN[pkg]


@pytest.fixture
def sanitizer(ls):
    ls.enable()
    yield ls.registry()
    ls.disable()


def run_in_thread(fn):
    """Run ``fn`` on a fresh thread; re-raise anything it raised."""
    box = {}

    def worker():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - relayed to caller
            box["exc"] = exc

    t = threading.Thread(target=worker, name="locksan-test")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "worker thread hung"
    if "exc" in box:
        raise box["exc"]


# -- disabled path: zero overhead --------------------------------------------------------


def test_disabled_factories_return_plain_primitives(ls):
    assert not ls.enabled()
    assert type(ls.make_lock("x")) is type(threading.Lock())
    assert type(ls.make_rlock("x")) is type(threading.RLock())
    assert type(ls.make_condition("x")) is threading.Condition
    ls.note_blocking("fsync")
    assert ls.registry().blocking_events == []


def test_enable_swaps_factories_and_resets_registry(ls, sanitizer):
    assert ls.enabled()
    assert isinstance(ls.make_lock("x"), ls.InstrumentedLock)
    assert isinstance(ls.make_rlock("x"), ls.InstrumentedLock)
    assert isinstance(ls.make_condition("x"), ls.InstrumentedCondition)
    sanitizer.load_static_order([("p", "q")])
    ls.enable()  # fresh registry: previous orders must not leak
    assert ls.registry() is not sanitizer
    assert ls.registry().snapshot_edges() == {}
    assert ls.registry()._static == {}


# -- inversion detection -------------------------------------------------------------------


def test_same_thread_inversion_raises(ls, sanitizer):
    a, b = ls.make_lock("a"), ls.make_lock("b")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(ls.LockOrderInversion, match="a -> b"):
            a.acquire()
    assert sanitizer.checks >= 3


def test_cross_thread_inversion_raises(ls, sanitizer):
    a, b = ls.make_lock("a"), ls.make_lock("b")

    def establish():
        with a:
            with b:
                pass

    def invert():
        with b:
            a.acquire()

    run_in_thread(establish)
    with pytest.raises(ls.LockOrderInversion, match="inversion"):
        run_in_thread(invert)


def test_transitive_inversion_raises(ls, sanitizer):
    a, b, c = ls.make_lock("a"), ls.make_lock("b"), ls.make_lock("c")
    with a, b:
        pass
    with b, c:
        pass
    with c:
        with pytest.raises(ls.LockOrderInversion, match="a -> b -> c"):
            a.acquire()


def test_consistent_order_never_raises(ls, sanitizer):
    a, b = ls.make_lock("a"), ls.make_lock("b")

    def ordered():
        with a:
            with b:
                pass

    for _ in range(3):
        run_in_thread(ordered)
    assert sanitizer.snapshot_edges() == {"a": {"b"}}


def test_static_order_seeding(ls, sanitizer):
    """An inversion against the STATIC order fires on first execution."""
    sanitizer.load_static_order([("p", "q")])
    p, q = ls.make_lock("p"), ls.make_lock("q")
    with q:
        with pytest.raises(ls.LockOrderInversion):
            p.acquire()


def test_load_analysis_json(ls, tmp_path):
    art = tmp_path / "ANALYSIS.json"
    art.write_text(json.dumps({
        "lock_graph": {"edges": [{"src": "p", "dst": "q", "path": "x.py", "lineno": 1}]}}))
    ls.enable(analysis_path=art)
    try:
        with ls.make_lock("q"):
            with pytest.raises(ls.LockOrderInversion):
                ls.make_lock("p").acquire()
    finally:
        ls.disable()


def test_load_analysis_missing_file_is_tolerated(sanitizer):
    assert sanitizer.load_analysis("/nonexistent/ANALYSIS.json") == 0


def test_self_deadlock_raises(ls, sanitizer):
    lk = ls.make_lock("solo")
    lk.acquire()
    with pytest.raises(ls.LockOrderInversion, match="self-deadlock"):
        lk.acquire()


def test_rlock_reentry_allowed(ls, sanitizer):
    lk = ls.make_rlock("re")
    with lk:
        with lk:
            assert sanitizer.held() == ["re", "re"]
    assert sanitizer.held() == []


def test_nonblocking_acquire_is_exempt(ls, sanitizer):
    a, b = ls.make_lock("a"), ls.make_lock("b")
    with a, b:
        pass
    with b:
        assert a.acquire(blocking=False)  # would raise if order-checked
        a.release()
    assert "b" not in sanitizer.snapshot_edges()


def test_timed_acquire_failure_leaves_clean_stack(ls, sanitizer):
    lk = ls.make_lock("held-elsewhere")
    grabbed, done = threading.Event(), threading.Event()

    def holder():
        with lk._inner:
            grabbed.set()
            done.wait(timeout=10)

    t = threading.Thread(target=holder)
    t.start()
    grabbed.wait(timeout=10)
    assert lk.acquire(timeout=0.05) is False
    assert sanitizer.held() == []
    done.set()
    t.join(timeout=10)


# -- condition / blocking events -----------------------------------------------------------


def test_condition_wait_notify_roundtrip(ls, sanitizer):
    cond = ls.make_condition("C.cond")
    ready = []

    def consumer():
        with cond:
            while not ready:
                cond.wait(timeout=10)

    t = threading.Thread(target=consumer)
    t.start()
    with cond:
        ready.append(1)
        cond.notify()
    t.join(timeout=10)
    assert not t.is_alive()
    assert sanitizer.blocking_events == []
    assert sanitizer.held() == []


def test_condition_wait_under_foreign_lock_is_recorded(ls, sanitizer):
    outer, cond = ls.make_lock("outer"), ls.make_condition("C.cond")
    with outer:
        with cond:
            cond.wait(timeout=0.01)
    held, desc, _thread = sanitizer.blocking_events[0]
    assert held == ("outer",)
    assert "C.cond" in desc


def test_note_blocking_records_held_stack(ls, sanitizer):
    with ls.make_lock("j"):
        ls.note_blocking("journal fsync")
    ls.note_blocking("idle fsync")  # nothing held: not an event
    assert sanitizer.blocking_events == [(("j",), "journal fsync", "MainThread")]


# -- RWLock integration --------------------------------------------------------------------


def test_rwlock_is_one_graph_node(pkg, ls, sanitizer):
    rw, aux = RWLOCK[pkg](name="Buf._lock"), ls.make_lock("aux")
    with rw.reading():
        with aux:
            pass
    with aux:
        with pytest.raises(ls.LockOrderInversion):
            rw.acquire_write()


def test_rwlock_nested_reads_are_reentrant(pkg, sanitizer):
    rw = RWLOCK[pkg](name="Buf._lock")
    with rw.reading():
        with rw.reading():
            pass
    assert sanitizer.held() == []


def test_rwlock_write_after_read_same_thread_raises(pkg, ls, sanitizer):
    rw = RWLOCK[pkg](name="Buf._lock")
    rw.acquire_read()
    with pytest.raises(ls.LockOrderInversion, match="self-deadlock"):
        rw.acquire_write()
    rw.release()


def test_unnamed_rwlock_is_untracked(pkg, sanitizer):
    rw = RWLOCK[pkg]()
    with rw.writing():
        assert sanitizer.held() == []


# -- the repaired fault: the buffer's RWLock is the node, not its mutex -------------------


def test_buffer_order_inversion_raises_as_in_the_jax_package(pkg, ls, sanitizer):
    """``with rw.writing(): with version_guard:`` establishes the buffer's
    order; ``with version_guard: with rw.writing():`` then raises, naming
    it, and the observed graph holds only the established edge (the
    condition's mutex is no node)."""
    rw = RWLOCK[pkg](name="ParameterBuffer._lock")
    guard = ls.make_lock("ParameterBuffer._version_guard")
    with rw.writing():
        with guard:
            pass
    with guard:
        with pytest.raises(ls.LockOrderInversion,
                           match="ParameterBuffer._lock -> ParameterBuffer._version_guard"):
            rw.acquire_write()
    assert sanitizer.snapshot_edges() == {
        "ParameterBuffer._lock": {"ParameterBuffer._version_guard"}}


def test_port_buffer_apply_observes_the_static_edge():
    """A real port ``ParameterBuffer`` built under the sanitizer: a locked
    apply takes the version guard inside the write lock, the edge the
    static report pins, and the report's order seeds the registry."""
    import torch

    from elephas_tpu_torch.parameter.buffer import ParameterBuffer

    port_locksan.enable(analysis_path=port_locksan.ANALYSIS_PATH)
    try:
        san = port_locksan.registry()
        assert ("ParameterBuffer._version_guard"
                in san.static_edges()["ParameterBuffer._lock"])
        buf = ParameterBuffer({"w": torch.zeros(3)}, device="cpu")
        buf.apply_delta({"w": torch.ones(3)})
        assert "ParameterBuffer._version_guard" in san.snapshot_edges()["ParameterBuffer._lock"]
        assert san.inversions == [] and san.checks > 0
    finally:
        port_locksan.disable()


def test_port_records_a_swallowed_inversion():
    """An inversion raised on a thread that swallows it still shows in
    the port registry's ``inversions`` (what the card phase holds)."""
    port_locksan.enable()
    try:
        a, b = port_locksan.make_lock("a"), port_locksan.make_lock("b")
        with a, b:
            pass

        def invert():
            with b:
                try:
                    a.acquire()
                except port_locksan.LockOrderInversion:
                    pass

        run_in_thread(invert)
        assert len(port_locksan.registry().inversions) == 1
        assert "a -> b" in port_locksan.registry().inversions[0]
    finally:
        port_locksan.disable()


# -- the sanitized suites -------------------------------------------------------------------


def test_sanitized_suites_are_listed_once_and_mounted():
    """Each suite of ``SANITIZED_SUITES`` is a file of the port's tests
    whose module-scoped autouse fixture enters ``sanitized_suite``; a
    module not in the list is refused."""
    assert set(port_locksan.SANITIZED_SUITES) == {
        "test_torch_hogwild_races", "test_torch_opsd", "test_torch_fleet_serving",
        "test_torch_fleet_obs", "test_torch_parameter_server"}
    for name in port_locksan.SANITIZED_SUITES:
        text = (ROOT / "tests" / f"{name}.py").read_text()
        assert '@pytest.fixture(scope="module", autouse=True)' in text
        assert "locksan.sanitized_suite(request.module.__name__)" in text
    with pytest.raises(ValueError, match="SANITIZED_SUITES"):
        with port_locksan.sanitized_suite("tests.test_torch_train"):
            pass
    assert not port_locksan.enabled()
    with port_locksan.sanitized_suite("tests.test_torch_opsd") as san:
        assert port_locksan.enabled() and san is port_locksan.registry()
        assert san.static_edges()
    assert not port_locksan.enabled()
