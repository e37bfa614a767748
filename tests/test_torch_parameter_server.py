"""The port's parameter server (``elephas_tpu_torch/parameter/``,
``obs/health.py``, ``resilience/liveness.py``, ``utils/rwlock.py``)
against the JAX package's, on the CPU.

The buffer, the admission policy, the staleness ledger, the failure
detector and the servers' wire behaviour are host logic over exact
arithmetic (float32 subtraction, and the damping multiply, are the same
IEEE operations in both frameworks), so every comparison here is exact.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from elephas_tpu.obs.health import StalenessLedger as JaxLedger
from elephas_tpu.obs.health import tree_norm as jax_tree_norm
from elephas_tpu.parameter.buffer import ParameterBuffer as JaxBuffer
from elephas_tpu.parameter.client import StaleDeltaRejected as JaxStaleDeltaRejected
from elephas_tpu.parameter.client import VersionUnavailable as JaxVersionUnavailable
from elephas_tpu.parameter.client import make_client as jax_make_client
from elephas_tpu.parameter.server import AdmissionPolicy as JaxPolicy
from elephas_tpu.parameter.server import _scale_tree as jax_scale_tree
from elephas_tpu.parameter.server import make_server as jax_server
from elephas_tpu.resilience.liveness import FailureDetector as JaxDetector
from elephas_tpu_torch import obs
from elephas_tpu_torch.obs.health import StalenessLedger, tree_norm
from elephas_tpu_torch.parameter import client as client_mod
from elephas_tpu_torch.parameter.buffer import ParameterBuffer
from elephas_tpu_torch.parameter.client import (
    HttpClient,
    ParameterServerUnavailable,
    SocketClient,
    StaleDeltaRejected,
    make_client,
)
from elephas_tpu_torch.parameter.server import AdmissionPolicy, _scale_tree, make_server
from elephas_tpu_torch.resilience.liveness import FailureDetector
from elephas_tpu_torch.utils.rwlock import RWLock


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"dense": {"kernel": rng.normal(size=(6, 3)).astype(np.float32),
                                 "bias": rng.normal(size=(3,)).astype(np.float32)},
                       "out": rng.normal(size=(3, 2)).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(size=(3,)).astype(np.float32),
                            "count": np.int32(seed)}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
    return out


def _assert_same(port_tree, jax_tree):
    got, want = _flat(port_tree), _flat(jax_tree)
    assert list(got) == list(want)  # the same (sorted) key order
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("granularity", ["tree", "leaf"])
@pytest.mark.parametrize("lock", [True, False])
def test_buffer_matches_jax_over_a_sequence(granularity, lock):
    """The same applies and gets on both buffers give the same values
    (bit for bit), versions and key order."""
    port = ParameterBuffer(_tree(0), lock=lock, granularity=granularity, device="cpu")
    jax = JaxBuffer(_tree(0), lock=lock, granularity=granularity)
    _assert_same(port.get(), jax.get_numpy())
    for step in range(1, 8):
        delta = _tree(step)
        port.apply_delta(delta)
        jax.apply_delta(delta)
        assert port.version == jax.version == step
        _assert_same(port.get(), jax.get_numpy())
        pv, ps = port.get_host_with_version()
        jv, js = jax.get_numpy_with_version()
        assert pv == jv
        _assert_same(ps, js)
    assert port.applied_share() == 1.0


def test_buffer_never_writes_a_published_tensor():
    buf = ParameterBuffer({"w": np.ones(4, np.float32)}, device="cpu")
    snap = buf.get()
    ptr, value = snap["w"].data_ptr(), snap["w"].clone()
    buf.apply_delta({"w": np.full(4, 0.5, np.float32)})
    assert torch.equal(snap["w"], value) and snap["w"].data_ptr() == ptr
    assert buf.get()["w"].data_ptr() != ptr
    assert torch.equal(buf.get()["w"], torch.full((4,), 0.5))
    with pytest.raises(ValueError, match="structure"):
        buf.apply_delta({"v": np.ones(4, np.float32)})


def test_buffer_takes_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParameterBuffer({"w": np.ones(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_server("local", {"w": np.ones(2, np.float32)})


POLICIES = [(None, None), (8, None), (None, 2), (6, 2), (0, 0)]


@pytest.mark.parametrize("max_staleness,soft", POLICIES)
def test_admission_policy_matches_jax(max_staleness, soft, monkeypatch):
    monkeypatch.delenv("ELEPHAS_MAX_STALENESS", raising=False)
    monkeypatch.delenv("ELEPHAS_STALENESS_SOFT", raising=False)
    port, jax = AdmissionPolicy(max_staleness, soft), JaxPolicy(max_staleness, soft)
    for lag in [None, *range(12)]:
        assert port.decide(lag) == jax.decide(lag), lag
    assert repr(port) == repr(jax)


def test_admission_env_fallbacks_match_jax(monkeypatch):
    monkeypatch.setenv("ELEPHAS_MAX_STALENESS", "5")
    monkeypatch.setenv("ELEPHAS_STALENESS_SOFT", "1")
    assert (AdmissionPolicy().max_staleness, AdmissionPolicy().soft) == (5, 1)
    assert [AdmissionPolicy().decide(k) for k in range(8)] == \
        [JaxPolicy().decide(k) for k in range(8)]
    monkeypatch.setenv("ELEPHAS_MAX_STALENESS", "five")
    with pytest.warns(RuntimeWarning, match="not an integer"):
        assert AdmissionPolicy().max_staleness is None


def test_scale_tree_matches_jax():
    tree = {"w": np.linspace(-2, 2, 7).astype(np.float32), "n": np.arange(3)}
    for weight in (1 / 3, 0.25, 1 / 7):
        got = _scale_tree({k: torch.from_numpy(v) for k, v in tree.items()}, weight)
        want = jax_scale_tree(tree, weight)
        assert got["w"].numpy().tobytes() == np.asarray(want["w"]).tobytes()
        assert torch.equal(got["n"], torch.arange(3))


def _admission_run(make, mode, **policy):
    """A stamped client (pulled once) falls behind while an unstamped
    one advances the version, then pushes 0.6s: the values, the typed
    answers and the ledger it leaves."""
    server = make(mode)
    server.start()
    try:
        address = f"127.0.0.1:{server.port}"
        stale = make_client(mode, address)
        stale.worker_id = "w1"
        stale.get_parameters()
        advance = make_client(mode, address)
        answers = []
        for _ in range(5):
            advance.update_parameters({"w": np.zeros(4, np.float32)})
            try:
                stale.update_parameters({"w": np.full(4, 0.6, np.float32)})
                answers.append("applied")
            except (StaleDeltaRejected, JaxStaleDeltaRejected) as exc:
                answers.append((exc.version, exc.lag, exc.max_staleness))
        values = np.asarray(advance.get_parameters()["w"])
        ledger = server.ledger.snapshot()
        for row in ledger["workers"].values():
            row.pop("last_seen_s")
        for c in (stale, advance):
            if hasattr(c, "close"):
                c.close()
        return answers, values.tobytes(), ledger, server.buffer.version
    finally:
        server.stop()


@pytest.mark.parametrize("mode", ["socket", "http"])
def test_wire_admission_matches_jax(mode):
    policy = {"max_staleness": 5, "staleness_soft": 1}
    tree = {"w": np.ones(4, np.float32)}
    port = _admission_run(
        lambda m: make_server(m, tree, port=0, device="cpu", **policy), mode)
    global make_client
    saved, make_client = make_client, jax_make_client
    try:
        jax = _admission_run(lambda m: jax_server(m, tree, port=0, **policy), mode)
    finally:
        make_client = saved
    assert port[0] == jax[0]  # applied/damped vs rejected, and the typed answers
    assert any(a != "applied" for a in port[0]) and "applied" in port[0]
    assert port[1] == jax[1]  # the damped values, bit for bit
    assert port[2] == jax[2]  # the ledger
    assert port[3] == jax[3]


@pytest.mark.parametrize("mode", ["socket", "http"])
def test_pull_cache_control_plane_and_pinned_pulls(mode):
    """An unchanged server answers not-modified (the client hands back its
    cached tree); barriers, heartbeats, membership and health answer as
    the JAX servers' do; a version-pinned pull (the JAX rollout client's)
    of the live version gets the live tree, and of an older version, with
    no write-ahead log to read it from, the "cannot serve it" answer."""
    server = make_server(mode, {"w": np.arange(3, dtype=np.float32)}, port=0, device="cpu")
    server.start()
    hits = obs.default_registry().counter("ps_cache_hit_total")
    try:
        client = server.client()
        first, before = client.get_parameters(), hits.value
        assert client.get_parameters() is first and hits.value == before + 1
        client.update_parameters({"w": np.ones(3, np.float32)})
        assert torch.equal(client.get_parameters()["w"], torch.tensor([-1.0, 0.0, 1.0]))
        assert hits.value == before + 1 and client.known_version() == 1
        jax_client = jax_make_client(mode, f"127.0.0.1:{server.port}")
        np.testing.assert_array_equal(jax_client.get_parameters_pinned(1)["w"], [-1.0, 0.0, 1.0])
        with pytest.raises(JaxVersionUnavailable):
            jax_client.get_parameters_pinned(0)
        assert client.barrier_arrive("t") == 1 and client.barrier_count("t") == 1
        client.heartbeat("w0")
        assert client.membership()["w0"]["state"] == "alive"
        client.deregister("w0")
        assert client.membership() == {}
        assert client.health()
        if hasattr(client, "close"):
            client.close()
    finally:
        server.stop()
    assert not HttpClient(f"127.0.0.1:{server.port}").health()
    assert not SocketClient(f"127.0.0.1:{server.port}").health()


def test_local_server_hands_out_the_buffers_tensors():
    server = make_server("local", {"params": {"w": np.ones(3, np.float32)}}, device="cpu")
    client = server.client()
    pulled = client.get_parameters()
    assert pulled["params"]["w"] is server.buffer.get()["params"]["w"]  # no copy
    client.update_parameters({"params": {"w": torch.ones(3)}})
    assert torch.equal(server.get_parameters()["params"]["w"], torch.zeros(3))
    assert torch.equal(pulled["params"]["w"], torch.ones(3))


def test_dead_server_fails_fast(monkeypatch):
    monkeypatch.setattr(client_mod, "_RETRY_DELAYS", (0.0, 0.0))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for cls in (HttpClient, SocketClient):
        with pytest.raises(ParameterServerUnavailable, match="unreachable"):
            cls(f"127.0.0.1:{port}").get_parameters()


@pytest.mark.parametrize("kwargs,item", [
    ({"wal_dir": "wal"}, "wal_dir requires a wire transport"),
    ({"shard_info": {"digest": "d", "shard": 0, "k": 2}},
     "shard_info requires a wire transport"),
    ({"ops_port": 0}, "item 7"),
    ({"store_dir": "unused"}, "item 7"),
])
@pytest.mark.parametrize("mode", ["local", "socket", "http"])
def test_left_out_server_options_raise(mode, kwargs, item, tmp_path):
    """``wal_dir`` and ``shard_info`` raise the JAX package's
    ``ValueError`` on the local server, and on the wire servers they
    build and serve: the WAL holds every acked push, and the handshake
    document comes back with the live boot id. The ops endpoint and an
    explicit telemetry store (item 7) behave as the JAX package's: the
    local server ignores ``ops_port`` and refuses a ``store_dir``; a wire
    server mounts the endpoint at ``start()`` and the journal where it is
    told, and takes both down at ``stop()``."""
    if "wal_dir" in kwargs:
        kwargs = {"wal_dir": str(tmp_path / "wal")}
    if "store_dir" in kwargs:
        kwargs = {"store_dir": str(tmp_path / "unused")}
    tree = {"w": np.ones(2, np.float32)}
    if item.startswith("item"):
        from elephas_tpu.parameter.server import make_server as jax_make_server

        if mode == "local" and "store_dir" in kwargs:
            for build in (make_server, jax_make_server):
                with pytest.raises(ValueError, match="store_dir requires a wire transport"):
                    build(mode, tree, port=0, **({"device": "cpu"} if build is make_server
                                                 else {}), **kwargs)
            return
        server = make_server(mode, tree, port=0, device="cpu", **kwargs)
        server.start()
        try:
            if mode == "local":
                assert getattr(server, "ops", None) is None
                return
            if "ops_port" in kwargs:
                import json
                import urllib.request

                with urllib.request.urlopen(f"{server.ops.url}/vars", timeout=5.0) as resp:
                    assert json.loads(resp.read())["transport"] == mode
            else:
                assert server.ops is None and server.store is not None
                client = server.client()
                client.update_parameters({"w": np.ones(2, np.float32)})
                client.close()
        finally:
            server.stop()
        assert getattr(server, "ops", None) is None
        if "store_dir" in kwargs:
            from elephas_tpu import obs as jax_obs

            records = jax_obs.read_store(kwargs["store_dir"])["records"]
            assert [r["data"].get("event") for r in records if r["k"] == "lifecycle"] == \
                ["boot", "close"]
        return
    if mode == "local":
        with pytest.raises(ValueError, match=item):
            make_server(mode, tree, port=0, device="cpu", **kwargs)
        with pytest.raises(ValueError, match=item):  # the JAX package's answer
            jax_server(mode, tree, port=0, **kwargs)
        return
    server = make_server(mode, tree, port=0, device="cpu", **kwargs)
    server.start()
    try:
        client = server.client()
        client.update_parameters({"w": np.ones(2, np.float32)})
        if "wal_dir" in kwargs:
            assert server.wal_writer.wal.versions() == [1]
        else:
            assert client.shard_info() == dict(kwargs["shard_info"], boot=server.boot)
        client.close()
    finally:
        server.stop()


def test_failure_detector_matches_jax():
    now = [0.0]
    port = FailureDetector(suspect_after=2.0, clock=lambda: now[0], register_metrics=False)
    jax = JaxDetector(suspect_after=2.0, clock=lambda: now[0], register_metrics=False)
    script = [(0.0, "beat", "a"), (0.5, "beat", "b"), (2.1, None, None), (4.2, "sweep", None),
              (4.3, "beat", "a"), (5.0, "deregister", "b"), (9.0, "sweep", None)]
    for t, op, arg in script:
        now[0] = t
        for d in (port, jax):
            if op == "beat":
                d.beat(arg)
            elif op == "deregister":
                d.deregister(arg)
        if op == "sweep":
            assert port.sweep() == jax.sweep()
        assert port.membership() == jax.membership()
        assert port.state("a") == jax.state("a")


def test_staleness_ledger_matches_jax():
    now = [0.0]
    port, jax = StalenessLedger(clock=lambda: now[0]), JaxLedger(clock=lambda: now[0])
    for i, (worker, lag) in enumerate([("w0", 0), ("w1", 3), (None, None), ("w0", 7),
                                       ("w1", 1)]):
        now[0] = float(i)
        for ledger in (port, jax):
            ledger.record(worker, lag, nbytes=100 * i, version=i, sync_interval=1.5)
    for ledger in (port, jax):
        ledger.record_rejected("w1")
        ledger.record_damped("w0")
    assert port.snapshot() == jax.snapshot()
    assert port.lag_percentile(0.5) == jax.lag_percentile(0.5)


def test_tree_norm_reads_tensors_as_numpy():
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(5, 4)).astype(np.float32), "b": [np.arange(3)],
            "c": np.array([True])}
    as_tensors = {"a": torch.from_numpy(tree["a"]), "b": [torch.arange(3)],
                  "c": torch.tensor([True])}
    assert tree_norm(as_tensors) == pytest.approx(jax_tree_norm(tree), rel=1e-12)
    assert tree_norm(tree) == jax_tree_norm(tree)


def test_rwlock_prefers_a_waiting_writer():
    lock, order = RWLock(), []
    lock.acquire_read()
    writer = threading.Thread(target=lambda: (lock.acquire_write(), order.append("w"),
                                              lock.release()))
    writer.start()
    while not lock._writers_waiting:
        time.sleep(0.001)
    reader = threading.Thread(target=lambda: (lock.acquire_read(), order.append("r"),
                                              lock.release()))
    reader.start()
    time.sleep(0.05)
    assert order == []  # the new reader queues behind the waiting writer
    lock.release()
    writer.join()
    reader.join()
    assert order == ["w", "r"]
    with pytest.raises(RuntimeError, match="without a held lock"):
        lock.release()


def test_stopped_server_refuses_new_clients(monkeypatch):
    monkeypatch.setattr(client_mod, "_RETRY_DELAYS", (0.0,))
    for mode in ("socket", "http"):
        server = make_server(mode, {"w": np.ones(2, np.float32)}, port=0, device="cpu",
                             auth_key=os.urandom(32))
        server.start()
        server.client().get_parameters()
        server.stop()
        with pytest.raises(ParameterServerUnavailable):
            make_client(mode, f"127.0.0.1:{server.port}",
                        auth_key=server.auth_key).update_parameters(
                {"w": np.ones(2, np.float32)})
        assert server.buffer.version == 0
