"""The port's write-ahead log (``elephas_tpu_torch/resilience/wal.py``),
``ParameterBuffer.set``, and the wire servers' durability, crash and
pinned-pull paths, against the JAX package's, on the CPU.

- A WAL file is one packed wire frame, so the port's ``.epk`` bytes equal
  the JAX package's for the same NumPy tree and version (bf16 leaves
  included), and each package restores the other's directory bitwise.
- The JAX package's WAL unit tests (``tests/test_resilience.py``:
  rotation, corrupt tail, idempotent append, the writer's cadence and
  its resume) run on the port's classes.
- Servers: every acked push is durable, ``stop`` syncs and ``kill`` does
  not, a warm restart resumes the durable version under a new boot id
  (a client whose cached version collides gets a full body), a WAL write
  failure is never acked, and version-pinned pulls cross packages both
  ways. Every comparison is exact.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from elephas_tpu.checkpoint import NoCheckpointError as JaxNoCheckpointError
from elephas_tpu.parameter.client import VersionUnavailable as JaxVersionUnavailable
from elephas_tpu.parameter.client import make_client as jax_make_client
from elephas_tpu.parameter.server import make_server as jax_make_server
from elephas_tpu.resilience.wal import SnapshotWAL as JaxWAL
from elephas_tpu_torch import obs
from elephas_tpu_torch.checkpoint import NoCheckpointError
from elephas_tpu_torch.parameter import client as client_mod
from elephas_tpu_torch.parameter.buffer import ParameterBuffer
from elephas_tpu_torch.parameter.client import (
    ParameterServerUnavailable,
    VersionUnavailable,
    make_client,
)
from elephas_tpu_torch.parameter.server import make_server
from elephas_tpu_torch.resilience import SnapshotWAL, WalWriter

MODES = ["socket", "http"]


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                      "bias": np.zeros(3, np.float32)}}


def _mixed(seed=0):
    """(JAX NumPy tree, the port's tree of the same bits): float32, int32,
    a scalar and a bf16 leaf (an ml_dtypes array against a bf16 tensor)."""
    rng = np.random.default_rng(seed)
    bf = rng.standard_normal((5, 2)).astype(ml_dtypes.bfloat16)
    common = {"k": rng.standard_normal((3, 4)).astype(np.float32),
              "count": np.int32(seed), "idx": np.arange(6, dtype=np.int32)}
    jax_tree = {"params": dict(common, bf=bf)}
    port_tree = {"params": dict(common, bf=torch.from_numpy(bf.view(np.int16).copy())
                                .view(torch.bfloat16))}
    return jax_tree, port_tree


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert _bytes(fa[k]) == _bytes(fb[k]), k


# -- the on-disk format, across packages ---------------------------------------


def test_epk_bytes_equal_jax(tmp_path):
    jax_tree, port_tree = _mixed(3)
    jax_path = JaxWAL(str(tmp_path / "jax")).append(jax_tree, version=41)
    port_path = SnapshotWAL(str(tmp_path / "port")).append(port_tree, version=41)
    assert port_path.name == jax_path.name == f"{41:016d}.epk"
    assert port_path.read_bytes() == jax_path.read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_restores_the_others_wal(writer, tmp_path):
    jax_tree, port_tree = _mixed(5)
    if writer == "jax":
        wal = JaxWAL(str(tmp_path), keep=2)
        for v in (3, 7):
            wal.append(jax_tree if v == 7 else _mixed(1)[0], version=v)
        version, tree = SnapshotWAL(str(tmp_path)).restore_latest()
    else:
        wal = SnapshotWAL(str(tmp_path), keep=2)
        for v in (3, 7):
            wal.append(port_tree if v == 7 else _mixed(1)[1], version=v)
        version, tree = JaxWAL(str(tmp_path)).restore_latest()
    assert version == 7
    _assert_bitwise(tree, jax_tree)


def test_both_packages_raise_their_cold_start_error(tmp_path):
    with pytest.raises(NoCheckpointError):
        SnapshotWAL(str(tmp_path / "a")).restore_latest()
    with pytest.raises(JaxNoCheckpointError):
        JaxWAL(str(tmp_path / "b")).restore_latest()


# -- the JAX package's WAL units, on the port ------------------------------------


def test_wal_roundtrip_and_latest(tmp_path):
    wal = SnapshotWAL(str(tmp_path))
    with pytest.raises(NoCheckpointError):
        wal.restore_latest()  # cold start is typed
    wal.append(_tree(1), version=1)
    wal.append(_tree(2), version=2)
    assert wal.latest_version() == 2
    version, tree = wal.restore_latest()
    assert version == 2
    np.testing.assert_array_equal(tree["dense"]["kernel"], _tree(2)["dense"]["kernel"])


def test_wal_rotation_bounds_disk(tmp_path):
    wal = SnapshotWAL(str(tmp_path), keep=2)
    for v in (1, 2, 3, 4):
        wal.append(_tree(v), version=v)
    assert wal.versions() == [3, 4]
    assert wal.read_version(2) is None and wal.read_version(4) is not None


def test_wal_restore_walks_past_corrupt_tail(tmp_path):
    wal = SnapshotWAL(str(tmp_path))
    wal.append(_tree(1), version=1)
    path2 = wal.append(_tree(2), version=2)
    path2.write_bytes(path2.read_bytes()[:40])  # torn copy of the newest
    version, tree = wal.restore_latest()
    assert version == 1
    np.testing.assert_array_equal(tree["dense"]["bias"], _tree(1)["dense"]["bias"])


def test_wal_skips_a_renamed_frame(tmp_path):
    wal = SnapshotWAL(str(tmp_path))
    wal.append(_tree(1), version=1)
    path = wal.append(_tree(2), version=2)
    path.rename(tmp_path / f"{9:016d}.epk")  # a frame whose name lies
    assert wal.restore_latest()[0] == 1


def test_wal_append_is_idempotent_per_version(tmp_path):
    wal = SnapshotWAL(str(tmp_path))
    wal.append(_tree(1), version=5)
    wal.append(_tree(2), version=5)  # second writer loses, silently
    _, tree = wal.restore_latest()
    np.testing.assert_array_equal(tree["dense"]["kernel"], _tree(1)["dense"]["kernel"])


class _FakeBuffer:
    """version + get_host_with_version — the WalWriter's whole view."""

    def __init__(self):
        self.version = 0
        self.tree = _tree()

    def get_host_with_version(self):
        return self.version, self.tree


def test_wal_writer_cadence(tmp_path):
    buf = _FakeBuffer()
    writer = WalWriter(buf, SnapshotWAL(str(tmp_path)), every=2)
    buf.version = 1
    assert not writer.after_update()  # 1 version ahead < every
    buf.version = 2
    assert writer.after_update()
    assert writer.last_written == 2
    buf.version = 3
    assert not writer.after_update()
    assert writer.sync() == 3  # shutdown hook forces the tail out
    assert writer.last_written == 3


def test_wal_writer_resumes_cadence_from_durable_version(tmp_path):
    wal = SnapshotWAL(str(tmp_path))
    wal.append(_tree(), version=6)
    buf = _FakeBuffer()
    buf.version = 6
    writer = WalWriter(buf, wal, every=3)
    assert writer.last_written == 6  # warm restart: no re-snapshot at 6
    buf.version = 8
    assert not writer.after_update()
    buf.version = 9
    assert writer.after_update()


def test_wal_validations(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        SnapshotWAL(str(tmp_path), keep=0)
    with pytest.raises(ValueError, match="every"):
        WalWriter(_FakeBuffer(), SnapshotWAL(str(tmp_path)), every=0)


# -- ParameterBuffer.set --------------------------------------------------------


@pytest.mark.parametrize("granularity", ["tree", "leaf"])
def test_buffer_set_resumes_the_version_and_restarts_the_counts(granularity):
    buf = ParameterBuffer(_tree(0), lock=False, device="cpu", granularity=granularity)
    for _ in range(3):
        buf.apply_delta(_tree(1))
    held = buf.get()
    buf.set(_tree(2), version=41)
    assert buf.version == 41 and buf.applied_share() == 1.0
    np.testing.assert_array_equal(buf.get()["dense"]["kernel"], _tree(2)["dense"]["kernel"])
    assert not torch.equal(held["dense"]["kernel"], buf.get()["dense"]["kernel"])  # not in place
    buf.set(_tree(3))  # no version: bumps, like an update
    assert buf.version == 42 and buf.applied_share() == 1.0
    buf.apply_delta(_tree(1))
    assert buf.version == 43 and buf.applied_share() == 1.0


def test_buffer_set_copies_host_bytes():
    tree = {"w": torch.zeros(3)}
    buf = ParameterBuffer({"w": np.ones(3, np.float32)}, device="cpu")
    buf.set(tree, version=2)
    tree["w"].add_(5.0)  # the caller's memory (a decoded frame) may change
    assert torch.equal(buf.get()["w"], torch.zeros(3))


# -- the servers' durability and crash path ----------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_acked_pushes_are_durable_and_kill_skips_the_sync(mode, tmp_path):
    wal_dir = str(tmp_path)
    server = make_server(mode, _tree(0), port=0, device="cpu", wal_dir=wal_dir, wal_every=2)
    server.start()
    client = server.client()
    for _ in range(3):
        client.update_parameters(_tree(1))
    assert SnapshotWAL(wal_dir).versions() == [2]  # version 3 is within wal_every
    flight = obs.default_flight_recorder()
    before = len(flight.events("ps_kill"))
    server.kill()
    client.close()
    assert SnapshotWAL(wal_dir).versions() == [2]  # a crash does not sync
    kills = flight.events("ps_kill")
    assert len(kills) == before + 1 and kills[-1].detail["version"] == 3
    if flight.enabled:
        assert server.flight_dump is not None and server.flight_dump.startswith(wal_dir)
    # A warm restart on the same port from the same directory.
    restarted = make_server(mode, _tree(9), port=server.port, device="cpu", wal_dir=wal_dir)
    restarted.start()
    try:
        assert restarted.buffer.version == 2 and restarted.boot != server.boot
        frame_version, frame = SnapshotWAL(wal_dir).restore_latest()
        assert frame_version == 2
        _assert_bitwise(restarted.get_parameters(), frame)
        assert flight.events("wal_restore")[-1].detail["version"] == 2
        fresh = restarted.client()
        fresh.update_parameters(_tree(1))
        fresh.close()
    finally:
        restarted.stop()
    assert SnapshotWAL(wal_dir).latest_version() == 3  # stop syncs the tail


@pytest.mark.parametrize("mode", MODES)
def test_auto_store_dir_mounts_no_telemetry_store_yet(mode, tmp_path):
    """The one deliberate gap (ROADMAP item 7, ``obs/store.py``): beside
    a WAL the JAX server's ``store_dir="auto"`` mounts a telemetry journal
    in ``<wal_dir>/telemetry``; the port's mounts none, and its WAL
    directory holds only the snapshots."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_server = jax_make_server(mode, _tree(0), port=0, wal_dir=str(jax_dir))
    port_server = make_server(mode, _tree(0), port=0, device="cpu", wal_dir=str(port_dir))
    for server in (jax_server, port_server):
        server.start()
        client = server.client()
        client.update_parameters(_tree(1))
        client.close()
        server.stop()
    assert (jax_dir / "telemetry").is_dir()
    assert sorted(p.name for p in port_dir.iterdir()) == [f"{1:016d}.epk"]


@pytest.mark.parametrize("mode", MODES)
def test_boot_id_collision_after_warm_restart_is_a_full_body(mode, tmp_path):
    """A client caches version 3, which the WAL (every 2) never held; the
    restarted server resumes at 2 and a new push takes it to 3 again,
    with other content: the client's (old boot, 3) must not earn a
    not-modified — it gets the new tree."""
    wal_dir = str(tmp_path)
    server = make_server(mode, _tree(0), port=0, device="cpu", wal_dir=wal_dir, wal_every=2)
    server.start()
    client = server.client()
    for _ in range(3):
        client.update_parameters(_tree(1))
    cached = client.get_parameters()
    assert client.known_version() == 3
    server.kill()
    restarted = make_server(mode, _tree(0), port=server.port, device="cpu",
                            wal_dir=wal_dir, wal_every=2)
    restarted.start()
    try:
        other = restarted.client()
        other.update_parameters(_tree(2))
        other.close()
        assert restarted.buffer.version == 3
        hits = obs.default_registry().counter("ps_cache_hit_total")
        before = hits.value
        got = client.get_parameters()
        assert hits.value == before  # a full body, not a cache hit
        assert client.known_version() == 3
        _assert_bitwise(got, restarted.get_parameters())
        assert not torch.equal(got["dense"]["kernel"], cached["dense"]["kernel"])
        assert client.get_parameters() is got  # same boot now: not-modified
        assert hits.value == before + 1
    finally:
        client.close()
        restarted.stop()


@pytest.mark.parametrize("mode", MODES)
def test_a_wal_write_failure_is_never_acked(mode, tmp_path, monkeypatch):
    monkeypatch.setattr(client_mod, "_RETRY_DELAYS", (0.0,))
    server = make_server(mode, _tree(0), port=0, device="cpu", wal_dir=str(tmp_path))
    server.start()
    client = server.client()

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(SnapshotWAL, "append", fail)
    try:
        with pytest.raises(ParameterServerUnavailable):
            client.update_parameters(_tree(1))
    finally:
        client.close()
        monkeypatch.undo()
        server.kill()  # its WAL writer is the failing one: no clean sync


# -- pinned pulls, across packages ----------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_pinned_pull_across_packages(mode, server_pkg, tmp_path):
    """Pushes 1..4 against a WAL keeping 3 frames: the live version and a
    durable older one come back bitwise through the other package's
    client; a pruned one is the client's VersionUnavailable."""
    deltas = [_tree(10 + i) for i in range(4)]
    if server_pkg == "port":
        server = make_server(mode, _tree(0), port=0, device="cpu", wal_dir=str(tmp_path))
        dial, unavailable = jax_make_client, JaxVersionUnavailable
    else:
        server = jax_make_server(mode, _tree(0), port=0, wal_dir=str(tmp_path))
        dial, unavailable = make_client, VersionUnavailable
    server.start()
    client = dial(mode, f"127.0.0.1:{server.port}")
    pusher = server.client()
    try:
        for d in deltas:
            pusher.update_parameters(d)
        wal = SnapshotWAL(str(tmp_path))
        assert wal.versions() == [2, 3, 4]
        _assert_bitwise(client.get_parameters_pinned(4), wal.restore_latest()[1])
        expect = _tree(0)
        for d in deltas[:3]:
            expect = {"dense": {k: expect["dense"][k] - d["dense"][k] for k in expect["dense"]}}
        _assert_bitwise(client.get_parameters_pinned(3), expect)
        with pytest.raises(unavailable):
            client.get_parameters_pinned(1)  # pruned past keep=3
    finally:
        pusher.close()
        client.close()
        server.stop()
