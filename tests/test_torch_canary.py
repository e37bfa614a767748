"""The port's blackbox canaries (``elephas_tpu_torch/obs/canary.py``)
against the JAX package's (``elephas_tpu/obs/canary.py``), on the CPU.

The counterparts of the canary tests of ``tests/test_goodput.py`` and
``tests/test_ps_group.py``: the same traffic and probes through a JAX
engine with the JAX ``CanaryDriver`` and a port engine with the port's,
on the same weights (a 2-layer LM of width 64, carried across with
``convert.from_flax_params``) and a scripted clock, so that every count,
goodput figure and document key is compared exactly; and ``PSCanary``
probing each shard of a port ``ShardGroup`` beside the JAX one on the
JAX group, the state unperturbed.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu import obs as jax_obs
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parameter import ShardGroup as JaxShardGroup
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu_torch import obs
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parameter import ShardGroup
from elephas_tpu_torch.serving import InferenceEngine

VOCAB, SEQ = 97, 64
PACKAGES = ("jax", "port")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models():
    jc = JaxCompiledModel(
        jax_get_model("transformer_lm", vocab_size=VOCAB, d_model=64, num_heads=4,
                      num_layers=2, max_seq_len=SEQ),
        optimizer={"name": "adam", "learning_rate": 3e-3},
        loss="sparse_categorical_crossentropy", metrics=[],
        input_shape=(SEQ,), input_dtype=jnp.int32, seed=0)
    module = get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=64,
                       num_heads=4, num_layers=2, max_seq_len=SEQ)
    module.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, jc.params),
                                            module))
    return jc, module


def _engine(models, pkg, **kw):
    kw = {"max_slots": 3, "max_prompt_len": 8, "max_len": 24, "queue_depth": 8,
          "clock": FakeClock(), **kw}
    return JaxEngine(models[0], **kw) if pkg == "jax" else InferenceEngine(models[1], **kw)


def _obs(pkg):
    return jax_obs if pkg == "jax" else obs


@pytest.fixture()
def flights():
    """A fresh flight ring per package for the test."""
    saved = {pkg: _obs(pkg).default_flight_recorder() for pkg in PACKAGES}
    fresh = {pkg: _obs(pkg).FlightRecorder(capacity=64) for pkg in PACKAGES}
    for pkg in PACKAGES:
        _obs(pkg).set_default_flight_recorder(fresh[pkg])
    try:
        yield fresh
    finally:
        for pkg in PACKAGES:
            _obs(pkg).set_default_flight_recorder(saved[pkg])


def _serve(models, pkg, canaried):
    """Four real requests, a probe before every other one; the engine's
    ledger, the driver and the streams."""
    eng = _engine(models, pkg, queue_depth=16)
    driver = _obs(pkg).CanaryDriver(eng) if canaried else None
    streams = []
    for i in range(4):
        if driver is not None and i % 2 == 0:
            assert driver.probe()["ok"]
        rid = eng.submit([5, 3, 9, i + 1], max_new_tokens=4)
        streams.append(eng.result(rid, timeout_s=120).tokens)
    return eng, driver, streams


def test_real_goodput_is_the_same_with_canaries_on_and_off(models):
    """The canary exclusion: the same real traffic gives the port the same
    goodput ledger with probes riding along or not, and with probes the
    port's ledger, streams and probe counts equal the JAX package's."""
    out = {key: _serve(models, *key) for key in (("port", False), ("port", True),
                                                  ("jax", True))}
    docs = {key: eng.slo.snapshot() for key, (eng, _, _) in out.items()}
    off, on = docs[("port", False)], docs[("port", True)]
    assert off["evaluated"] == on["evaluated"] == 4
    assert off["goodput"] == on["goodput"] and on["goodput_ratio"] == 1.0
    assert out[("port", True)][0]._canary_ids == out[("jax", True)][0]._canary_ids == set()
    assert docs[("port", True)] == docs[("jax", True)]
    assert out[("port", True)][2] == out[("jax", True)][2]
    snaps = {pkg: out[(pkg, True)][1].snapshot() for pkg in PACKAGES}
    assert snaps["port"] == snaps["jax"]
    assert snaps["port"]["surface"] == "serving" and snaps["port"]["probes"] == 2


def test_a_failed_probe_is_counted_and_flight_noted(models, flights):
    """A probe refused by a full queue fails in both packages alike: the
    same records, counters, ``canary_fail`` notes and real goodput."""
    records = {}
    for pkg in PACKAGES:
        eng = _engine(models, pkg, max_slots=1, queue_depth=2)
        driver = _obs(pkg).CanaryDriver(eng)
        eng.submit([1, 2], max_new_tokens=2)
        eng.submit([3, 4], max_new_tokens=2)
        failed = driver.probe()
        assert eng._canary_ids == set()
        eng.run_until_drained()
        good = driver.probe()
        records[pkg] = (failed["ok"], failed["error"].split(":")[0], good["ok"],
                        driver.probes, driver.failures, driver.snapshot()["failure_ratio"],
                        flights[pkg].snapshot()["counts_by_kind"].get("canary_fail"),
                        eng.slo.snapshot()["evaluated"])
    assert records["port"] == records["jax"] == (False, "QueueFull", True, 2, 1, 0.5, 1, 2)


def test_canary_route_serves_the_drivers_snapshot(models):
    """``/canary`` of a mounted port engine is its driver's snapshot with
    the JAX driver's keys (and ``/slo`` leaves the probe out)."""
    import json
    import urllib.request

    jeng = _engine(models, "jax")
    jdriver = jax_obs.CanaryDriver(jeng)
    jdriver.probe()
    eng = _engine(models, "port")
    driver = obs.CanaryDriver(eng)
    ops = eng.mount_ops(port=0)
    try:
        assert driver.probe()["ok"]
        eng.result(eng.submit([5, 3], max_new_tokens=3), timeout_s=120)
        with urllib.request.urlopen(f"{ops.url}/canary", timeout=5) as resp:
            doc = json.loads(resp.read())
        with urllib.request.urlopen(f"{ops.url}/slo", timeout=5) as resp:
            assert json.loads(resp.read())["evaluated"] == 1
    finally:
        eng.unmount_ops()
    assert doc == driver.snapshot()
    assert sorted(doc) == sorted(jdriver.snapshot())
    assert sorted(doc["last"]) == sorted(jdriver.snapshot()["last"])


# -- PSCanary: one probe per shard ------------------------------------------------


def _params():
    rng = np.random.default_rng(0)
    return {"dense": {"kernel": rng.normal(size=(8, 16)).astype(np.float32),
                      "bias": np.zeros(16, np.float32)},
            "scale": np.ones((3,), np.float32)}


def _delta():
    rng = np.random.default_rng(3)
    return {"dense": {"kernel": rng.normal(scale=0.01, size=(8, 16)).astype(np.float32),
                      "bias": rng.normal(scale=0.01, size=16).astype(np.float32)},
            "scale": rng.normal(scale=0.01, size=3).astype(np.float32)}


def _digest(tree, prefix=""):
    h = hashlib.sha256()
    for key in sorted(tree):
        leaf = tree[key]
        if isinstance(leaf, dict):
            h.update(_digest(leaf, f"{prefix}{key}/").encode())
            continue
        arr = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        h.update(f"{prefix}{key}".encode() + np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def test_ps_canary_probes_each_shard_as_the_jax_canary_does(tmp_path):
    """A plan-exact zero-delta tree pushed and pulled through one
    sub-client per shard of a port group, beside the JAX canary on a JAX
    group of the same tree: the same documents (times aside), every shard
    and standby reported, the state digest unchanged."""
    groups = {
        "jax": JaxShardGroup(_params(), 2, mode="socket", standby=1,
                             wal_root=str(tmp_path / "jax"), suspect_after=5.0),
        "port": ShardGroup(_params(), 2, mode="socket", standby=1, device="cpu",
                           wal_root=str(tmp_path / "port"), suspect_after=5.0),
    }
    docs, digests = {}, {}
    for pkg, group in groups.items():
        group.start()
        client = group.client()
        try:
            client.update_parameters(_delta())
            before = _digest(client.get_parameters())
            canary = _obs(pkg).PSCanary(client, group=group)
            doc = canary.probe()
            digests[pkg] = (before, _digest(client.get_parameters()))
            docs[pkg] = (doc, canary.snapshot())
            with pytest.raises(ValueError):
                client.shard_client(2)
        finally:
            client.close()
            group.stop()
    for pkg in PACKAGES:
        assert digests[pkg][0] == digests[pkg][1]
    assert digests["port"] == digests["jax"]
    (doc, snap), (jdoc, jsnap) = docs["port"], docs["jax"]
    assert doc["ok"] and jdoc["ok"] and sorted(doc) == sorted(jdoc)
    assert [(s["shard"], s["ok"], s["error"]) for s in doc["shards"]] == \
        [(s["shard"], s["ok"], s["error"]) for s in jdoc["shards"]] == [(0, True, None),
                                                                        (1, True, None)]
    assert all(s["rtt_s"] >= 0 for s in doc["shards"]) and doc["rtt_s_max"] is not None
    assert {row["shard"] for row in doc["standby_lag"]} == {0, 1}
    assert {k: v for k, v in snap.items() if k != "last"} == \
        {k: v for k, v in jsnap.items() if k != "last"} == \
        {"surface": "ps", "probes": 1, "failures": 0, "failure_ratio": 0.0}
