"""Hogwild lost-update contracts of the port's ``ParameterBuffer``
(``tests/test_hogwild_races.py``'s, on the CPU).

``lock=False`` races whole-tensor read-modify-writes: an apply that read
W can be overwritten by a concurrent apply that also read W, and its
delta vanishes. The contracts: locked mode applies EVERY update; hogwild
applies a nonzero share and never tears a value (every survivor is an
exact integer sum of whole deltas, so every element of a leaf agrees);
'leaf' granularity keeps the applied share above one half; and the
buffer never writes a published tensor in place, so a snapshot taken
before the storm is untouched after it. The buffer's own applied-share
count (``applied_share``) agrees with the survivors exactly.
"""

import threading

import numpy as np
import pytest
import torch

from elephas_tpu_torch.parameter.buffer import ParameterBuffer
from elephas_tpu_torch.utils import locksan


@pytest.fixture(scope="module", autouse=True)
def _lock_sanitizer(request):
    """The suite runs with the port's lock sanitizer on, seeded from
    ANALYSIS_TORCH.json (``locksan.SANITIZED_SUITES``): module fixtures
    included, so the scenarios they run are order-checked too."""
    with locksan.sanitized_suite(request.module.__name__):
        yield


N_THREADS = 8
N_UPDATES = 150  # per thread; integer-valued f32 stays exact far past this


def _hammer(buffer: ParameterBuffer, n_leaves: int = 1) -> None:
    delta = {f"w{i}": -np.ones(8, dtype=np.float32) for i in range(n_leaves)}  # W -= delta → +1
    barrier = threading.Barrier(N_THREADS)

    def worker():
        barrier.wait()  # maximize overlap
        for _ in range(N_UPDATES):
            buffer.apply_delta(delta)

    threads = [threading.Thread(target=worker) for _ in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


@pytest.mark.parametrize("granularity", ["tree", "leaf"])
def test_locked_buffer_applies_every_update(granularity):
    buffer = ParameterBuffer({"w0": np.zeros(8, dtype=np.float32)}, lock=True,
                             device="cpu", granularity=granularity)
    _hammer(buffer)
    total = N_THREADS * N_UPDATES
    applied = float(buffer.get()["w0"][0])
    assert applied == total, f"locked mode lost {total - applied} updates"
    assert buffer.version == total and buffer.applied_share() == 1.0


def test_hogwild_lost_update_rate_measured():
    buffer = ParameterBuffer({"w0": np.zeros(8, dtype=np.float32)}, lock=False, device="cpu")
    before = buffer.get()["w0"]
    _hammer(buffer)
    total = N_THREADS * N_UPDATES
    w = buffer.get()["w0"]
    assert torch.all(w == w[0]), w  # no torn value: one whole-delta sum
    applied = float(w[0])
    assert applied == int(applied), "non-integer sum ⇒ torn update"
    assert buffer.version == total  # attempts
    assert 0.0 < applied / total <= 1.0
    assert buffer.applied_share() == applied / total
    assert torch.equal(before, torch.zeros(8))  # the published tensor was never written


def test_leaf_granularity_applied_fraction_floor():
    """Each leaf in its own slot: contention drops at most overlapping
    LEAVES. The applied share stays above one half, values stay exact,
    and the host copy the wire transports serve is rebuilt from the
    slots."""
    for _ in range(2):
        buf = ParameterBuffer({f"w{i}": np.zeros(8, dtype=np.float32) for i in range(4)},
                              lock=False, granularity="leaf", device="cpu")
        _hammer(buf, n_leaves=4)
        w = buf.get_host()
        assert set(w) == {f"w{i}" for i in range(4)}
        for i in range(4):
            leaf = w[f"w{i}"]
            assert torch.all(leaf == leaf[0]), leaf
        applied = sum(float(w[f"w{i}"][0]) for i in range(4)) / 4
        fraction = applied / (N_THREADS * N_UPDATES)
        assert 0.5 < fraction <= 1.0
        assert buf.applied_share() == pytest.approx(fraction, abs=1e-12)


def test_leaf_granularity_exact_under_lock():
    buf = ParameterBuffer({"a": np.zeros(4, np.float32), "b": np.ones(4, np.float32)},
                          lock=True, granularity="leaf", device="cpu")
    for _ in range(5):
        buf.apply_delta({"a": -np.ones(4, np.float32), "b": np.zeros(4, np.float32)})
    w = buf.get()
    assert torch.equal(w["a"], torch.full((4,), 5.0))
    assert torch.equal(w["b"], torch.ones(4))


@pytest.mark.parametrize("granularity", ["tree", "leaf"])
def test_snapshots_survive_concurrent_applies(granularity):
    """Readers pull while writers apply: every pulled snapshot is one
    consistent whole-delta sum per leaf, and stays what it was."""
    buf = ParameterBuffer({"w": np.zeros(64, np.float32)}, lock=False, device="cpu",
                          granularity=granularity)
    seen, stop = [], threading.Event()

    def reader():
        while not stop.is_set():
            snap = buf.get()["w"]
            seen.append((snap, snap.clone()))

    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers:
        t.start()
    _hammer_leaf = {"w": -np.ones(64, np.float32)}
    writers = [threading.Thread(target=lambda: [buf.apply_delta(_hammer_leaf)
                                                for _ in range(100)]) for _ in range(4)]
    for t in writers:
        t.start()
    for t in writers:
        t.join()
    stop.set()
    for t in readers:
        t.join()
    assert seen
    for snap, copy in seen:
        assert torch.equal(snap, copy)  # never written after publication
        assert torch.all(snap == snap[0])
