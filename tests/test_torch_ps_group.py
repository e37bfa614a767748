"""The port's sharded PS group (``elephas_tpu_torch/parameter/group.py``)
against the JAX package's, on the CPU.

- The JAX package's group tests (``tests/test_ps_group.py``: plan
  determinism and balance, the canonical digest, the path-keyed split,
  the directory, the WAL streamer, scatter/gather against one server,
  the per-shard not-modified cache, the handshake's digest and fencing,
  promotion on a fake clock and under the live monitor, the standby-lag
  gauge) run on the port's classes, every buffer on the CPU.
- ``ShardPlan``'s rows, placement, digest, split and merge equal the JAX
  package's on the CNN, ResNet-18 and MLP trees (from the JAX models'
  shapes, so the paths are the flax layout both packages' wire frames
  carry), whether the leaves are NumPy arrays or tensors.
- A port ``ShardedParameterClient`` against a JAX ``ShardGroup``, and a
  JAX client against a port group: pulls equal and pushes applied,
  bitwise.
"""

import hashlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parameter.group import GroupDirectory as JaxDirectory
from elephas_tpu.parameter.group import ShardedParameterClient as JaxShardedClient
from elephas_tpu.parameter.group import ShardGroup as JaxShardGroup
from elephas_tpu.parameter.group import ShardPlan as JaxShardPlan
from elephas_tpu_torch import obs
from elephas_tpu_torch.parameter import (
    FencedPrimaryError,
    GroupDirectory,
    ShardedParameterClient,
    ShardGroup,
    ShardGroupError,
    ShardMapMismatch,
    ShardPlan,
    WalStreamer,
)
from elephas_tpu_torch.parameter.buffer import ParameterBuffer
from elephas_tpu_torch.parameter.server import SocketServer, make_server
from elephas_tpu_torch.resilience import SnapshotWAL


class FakeClock:
    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense1": {"kernel": rng.normal(size=(8, 16)).astype(np.float32),
                   "bias": np.zeros(16, np.float32)},
        "dense2": {"kernel": rng.normal(size=(16, 4)).astype(np.float32),
                   "bias": np.zeros(4, np.float32)},
        "scale": np.ones((3,), np.float32),
    }


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _delta(seed):
    rng = np.random.default_rng(seed)
    return _map(lambda x: rng.normal(scale=0.01, size=x.shape).astype(x.dtype), _params())


def _leaves(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def _np(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _tree_digest(tree) -> str:
    """Value digest over the sorted-path flattening (order-canonical)."""
    h = hashlib.sha256()
    for path, leaf in _leaves(tree):
        h.update(path.encode())
        h.update(np.ascontiguousarray(_np(leaf)).tobytes())
    return h.hexdigest()


def _sorted_copy(tree):
    """The tree rebuilt with every dict's keys sorted (as the buffer
    holds it)."""
    if isinstance(tree, dict):
        return {k: _sorted_copy(tree[k]) for k in sorted(tree)}
    return tree


def _wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _group(params=None, k=2, **kw):
    return ShardGroup(_params() if params is None else params, k, mode="socket",
                      device="cpu", **kw)


# -- ShardPlan: determinism, balance, canonical digest, path-keyed split ----------


def test_plan_is_deterministic_and_balanced():
    a = ShardPlan.build(_params(), 2)
    b = ShardPlan.build(_params(), 2)
    assert a.digest == b.digest
    assert a.shard_of == b.shard_of
    assert a.paths == b.paths
    loads = [0] * a.k
    for i, shard in enumerate(a.shard_of):
        loads[shard] += a.rows[i][2]
    assert all(load > 0 for load in loads)
    assert max(loads) - min(loads) <= max(r[2] for r in a.rows)


def test_plan_digest_canonical_under_sorted_rebuild():
    params = _params()
    assert ShardPlan.build(params, 2).digest == ShardPlan.build(_sorted_copy(params), 2).digest


def test_split_is_path_keyed_not_positional():
    params = _params()
    plan = ShardPlan.build(params, 2)
    merged = plan.merge(plan.split(_sorted_copy(params)))
    assert [p for p, _ in _leaves(merged)] == [p for p, _ in _leaves(params)]
    for (_, a), (_, b) in zip(_leaves(params), _leaves(merged)):
        np.testing.assert_array_equal(a, b)


def test_split_rejects_a_different_tree():
    plan = ShardPlan.build(_params(), 2)
    other = _params()
    other["dense3"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ShardMapMismatch):
        plan.split(other)
    del other["dense3"], other["dense1"]
    with pytest.raises(ShardMapMismatch):
        plan.split(other)


def test_plan_build_validations():
    with pytest.raises(ValueError):
        ShardPlan.build(_params(), 0)
    with pytest.raises(ValueError):
        ShardPlan.build(_params(), 99)  # more shards than leaves


# -- ShardPlan against the JAX package's, on the registry's models -----------------


def _model_tree(name):
    """A seeded NumPy tree in the flax layout of the JAX model ``name``
    (shapes from ``jax.eval_shape``: nothing is compiled)."""
    kwargs, shape = {"cnn": ({}, (28, 28, 1)), "resnet18": ({}, (32, 32, 3)),
                     "mlp": ({"features": (32,), "num_classes": 3}, (8,))}[name]
    model = jax_get_model(name, **kwargs)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, *shape)), train=False)
                            if name == "resnet18" else
                            model.init(jax.random.PRNGKey(0), jnp.zeros((1, *shape))))
    rng = np.random.default_rng(0)
    return _map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), dict(shapes))


@pytest.mark.parametrize("name,k", [("cnn", 2), ("cnn", 3), ("resnet18", 2),
                                    ("resnet18", 4), ("mlp", 2)])
def test_plan_equals_jax_on_model_trees(name, k):
    tree = _model_tree(name)
    want = JaxShardPlan.build(tree, k)
    for leaves in ("numpy", "tensor"):
        given = tree if leaves == "numpy" else _map(torch.from_numpy, tree)
        got = ShardPlan.build(given, k)
        assert got.digest == want.digest
        assert got.paths == want.paths and got.rows == want.rows
        assert got.shard_of == want.shard_of
        assert got.bytes_per_shard() == want.bytes_per_shard()
        assert got.describe() == want.describe()
        subs, jax_subs = got.split(given), want.split(tree)
        for sub, jax_sub in zip(subs, jax_subs):
            assert list(sub) == list(jax_sub)
            for path in sub:
                np.testing.assert_array_equal(_np(sub[path]), np.asarray(jax_sub[path]))
        assert _tree_digest(got.merge(subs)) == _tree_digest(want.merge(jax_subs))


# -- GroupDirectory ---------------------------------------------------------------


def test_directory_publish_fence_generation():
    d = GroupDirectory("abc", 2)
    assert d.generation == 0
    with pytest.raises(ShardGroupError):
        d.address_of(0)
    d.publish(0, "127.0.0.1:1", "boot-a")
    d.publish(1, "127.0.0.1:2", "boot-b")
    assert d.generation == 2
    assert d.address_of(1) == "127.0.0.1:2"
    assert not d.is_fenced("boot-a")
    d.fence("boot-a")
    assert d.is_fenced("boot-a")
    snap = d.snapshot()
    assert snap["fenced"] == ["boot-a"]
    assert snap["digest"] == "abc"


# -- WalStreamer ------------------------------------------------------------------


def test_wal_streamer_tails_and_catches_up(tmp_path):
    wal = SnapshotWAL(str(tmp_path))
    spare = ParameterBuffer(_params(), lock=True, device="cpu")
    streamer = WalStreamer(wal, spare)
    assert streamer.poll_once() is None  # empty WAL: nothing to apply
    assert streamer.lag() == 0
    tree = _params(seed=7)
    wal.append(tree, 3)
    assert streamer.lag() == 1
    assert streamer.poll_once() == 3
    assert streamer.applied_version == 3 and spare.version == 3
    assert streamer.lag() == 0
    np.testing.assert_array_equal(_np(spare.get()["dense1"]["kernel"]),
                                  tree["dense1"]["kernel"])
    wal.append(_params(seed=8), 5)
    assert streamer.stop(catch_up=True) == 5


def test_wal_versions_after(tmp_path):
    wal = SnapshotWAL(str(tmp_path), keep=10)
    for v in (2, 5, 9):
        wal.append(_params(), v)
    assert wal.versions_after(None) == [2, 5, 9]
    assert wal.versions_after(2) == [5, 9]
    assert wal.versions_after(9) == []


# -- scatter/gather over live wire servers ------------------------------------------


def test_scatter_gather_matches_single_ps():
    params = _params()
    single = make_server("socket", params, lock=True, port=0, device="cpu")
    group = _group(params)
    single.start()
    group.start()
    try:
        sc, gc = single.client(), group.client()
        for seed in range(4):
            delta = _delta(seed)
            sc.update_parameters(delta)
            gc.update_parameters(delta)
        a, b = sc.get_parameters(), gc.get_parameters()
        assert _tree_digest(a) == _tree_digest(b)
        assert _tree_digest(group.get_parameters()) == _tree_digest(b)
        sc.close()
        gc.close()
    finally:
        single.stop()
        group.stop()


def test_group_client_per_shard_not_modified_cache():
    hit_counter = obs.default_registry().counter("ps_cache_hit_total")
    group = _group()
    group.start()
    try:
        client = group.client()
        first = client.get_parameters()
        before = hit_counter.value
        second = client.get_parameters()  # unchanged: K not-modified frames
        assert hit_counter.value == before + 2
        assert _tree_digest(first) == _tree_digest(second)
        client.update_parameters(_delta(0))
        client.get_parameters()  # full bodies again
        assert hit_counter.value == before + 2
        assert client.pull() == (1, client.get_parameters())
        client.close()
    finally:
        group.stop()


def test_group_roles_and_snapshot():
    group = _group()
    group.start()
    try:
        assert [group.primary(i).role for i in range(2)] == ["ps/shard0", "ps/shard1"]
        snap = group.snapshot()
        assert snap["plan"]["k"] == 2
        assert snap["directory"]["digest"] == group.plan.digest
        assert len(snap["directory"]["addresses"]) == 2
    finally:
        group.stop()


def test_group_validations_and_left_outs(tmp_path):
    with pytest.raises(ValueError, match="wire transport"):
        ShardGroup(_params(), 2, mode="local", device="cpu")
    with pytest.raises(ValueError, match="standby must be"):
        _group(standby=2)
    with pytest.raises(ValueError, match="wal_root"):
        _group(standby=1)
    group = _group(ops_port=0)  # every member mounts its endpoint at start (item 7)
    group.start()
    try:
        assert all(m.ops is not None for m in group._active)
    finally:
        group.stop()
    assert all(m.ops is None for m in group._active)


# -- handshake: digest pinning + fencing ----------------------------------------------


def test_client_rejects_stale_plan_digest():
    group = _group()
    stale = ShardPlan.build(_params(seed=1), 2)  # different values, same shapes
    other = ShardPlan.build({"only": np.zeros((4, 2), np.float32)}, 1)
    assert stale.digest == group.plan.digest  # digest is metadata, not values
    with pytest.raises(ShardMapMismatch):
        ShardedParameterClient("socket", group.directory, other)


def test_client_rejects_server_without_shard_map():
    plan = ShardPlan.build(_params(), 1)
    server = SocketServer(_params(), lock=True, port=0, device="cpu")
    server.start()
    try:
        directory = GroupDirectory(plan.digest, 1)
        directory.publish(0, f"127.0.0.1:{server.port}", server.boot)
        client = ShardedParameterClient("socket", directory, plan)
        with pytest.raises(ShardMapMismatch):
            client.get_parameters()
        client.close()
    finally:
        server.stop()


def test_client_rejects_fenced_boot():
    group = _group()
    group.start()
    try:
        group.directory.fence(group.primary(1).boot)
        client = group.client()
        with pytest.raises(FencedPrimaryError):
            client.get_parameters()
        client.close()
    finally:
        group.stop()


# -- promotion lifecycle ----------------------------------------------------------------


def test_promotion_lifecycle_on_fake_clock(tmp_path):
    clock = FakeClock()
    group = _group(standby=1, wal_root=str(tmp_path), suspect_after=5.0, clock=clock)
    group.start()
    client = group.client()
    try:
        for seed in range(3):
            client.update_parameters(_delta(seed))
        expected = client.get_parameters()
        assert _wait_for(lambda: group.streamer_of(0).lag() == 0)
        assert group.streamer_of(0).applied_version == 3
        snap = group.snapshot()
        assert all(row["warm"] for row in snap["standbys"])

        old_boot = group.primary(0).boot
        group.kill_primary(0)
        gen_before = group.directory.generation
        assert group.check() == []  # dead but not yet swept: still SUSPECT
        clock.advance(11.0)  # past dead_after (2x suspect_after)
        assert group.check() == [0]

        assert group.directory.is_fenced(old_boot)
        assert group.standby_of(0) is None  # the spare is spent
        assert group.directory.generation > gen_before
        record = group.promotions[-1]
        assert record["shard"] == 0 and record["old_boot"] == old_boot
        assert record["caught_up_version"] == 3
        assert record["promote_s"] >= 0.0
        after = client.get_parameters()
        assert _tree_digest(after) == _tree_digest(expected)
        group.kill_primary(0)  # a second failure has no spare left
        clock.advance(11.0)
        assert group.check() == []
    finally:
        client.close()
        group.stop()


def test_live_kill_primary_promotes_standby(tmp_path):
    group = _group(standby=1, wal_root=str(tmp_path), suspect_after=0.3)
    group.start()
    client = group.client()
    try:
        for seed in range(3):
            client.update_parameters(_delta(seed))
        expected = client.get_parameters()
        assert _wait_for(lambda: group.streamer_of(1).lag() == 0)
        group.start_monitor(interval=0.05)
        group.kill_primary(1)
        assert _wait_for(lambda: group.promotions, timeout=15.0), \
            "monitor never promoted the standby"
        assert group.promotions[0]["shard"] == 1
        after = client.get_parameters()
        assert _tree_digest(after) == _tree_digest(expected)
        assert client.pull(3)[0] == 3  # the promoted spare serves the pin
    finally:
        client.close()
        group.stop()


def test_snapshot_publishes_standby_lag_gauge(tmp_path):
    clock = FakeClock()
    group = _group(standby=1, wal_root=str(tmp_path), suspect_after=5.0, clock=clock)
    group.start()
    client = group.client()
    gauge = obs.default_registry().gauge("ps_standby_lag_snapshots", labelnames=("shard",))
    try:
        client.update_parameters(_delta(0))
        assert _wait_for(lambda: group.streamer_of(0).lag() == 0)
        assert _wait_for(lambda: group.streamer_of(1).lag() == 0)
        snap = group.snapshot()
        assert {row["shard"] for row in snap["standbys"]} == {0, 1}
        assert all(row["lag"] == 0 for row in snap["standbys"])
        for shard in ("0", "1"):
            assert gauge.labels(shard=shard).value == 0.0
    finally:
        client.close()
        group.stop()


# -- across packages --------------------------------------------------------------------


def _dial(group, directory_cls, k):
    """A directory of ``directory_cls`` naming ``group``'s live members."""
    snap = group.directory.snapshot()
    directory = directory_cls(snap["digest"], k)
    for shard in range(k):
        directory.publish(shard, snap["addresses"][shard], snap["boots"][shard])
    return directory


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_sharded_client_across_packages(server_pkg):
    """A port client against a JAX group and a JAX client against a port
    group: the handshake passes on the shared digest, pulls equal the
    group's own client's, and pushes land bitwise on both sides."""
    params = _params()
    if server_pkg == "jax":
        group = JaxShardGroup(params, 2, mode="socket")
        group.start()
        client = ShardedParameterClient("socket", _dial(group, GroupDirectory, 2),
                                        ShardPlan.build(params, 2))
    else:
        group = _group(params)
        group.start()
        client = JaxShardedClient("socket", _dial(group, JaxDirectory, 2),
                                  JaxShardPlan.build(params, 2))
    own = group.client()
    try:
        client.update_parameters(_delta(0))
        own.update_parameters(_delta(1))
        expect = _sub(_sub(params, _delta(0)), _delta(1))
        assert _tree_digest(client.get_parameters()) == _tree_digest(expect)
        assert _tree_digest(own.get_parameters()) == _tree_digest(expect)
        assert client.pull()[0] == 2 and client.pull(2)[0] == 2
    finally:
        client.close()
        own.close()
        group.stop()


def _sub(a, b):
    if isinstance(a, dict):
        return {k: _sub(a[k], b[k]) for k in a}
    return a - b
