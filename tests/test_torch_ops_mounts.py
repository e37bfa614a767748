"""The ops endpoints the port's long-lived objects mount, against the JAX
package's: the parameter server (local, socket, HTTP; ``ops_port``,
``store_dir``), the shard group (the members' port offsets, ``/shards``),
``AsyncTrainer`` (``mount_ops``, ``ps_ops_port``), ``SyncTrainer``,
``InferenceEngine`` and the tuner's ``/trials``. Each object of each
package is mounted in the same state and answers the same routes with
the same status and document keys.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import elephas_tpu_torch as et
from elephas_tpu import tune as jax_tune
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.engine.async_engine import AsyncTrainer as JaxAsyncTrainer
from elephas_tpu.engine.sync import SyncTrainer as JaxSyncTrainer
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.obs import FlightRecorder as JaxFlightRecorder
from elephas_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from elephas_tpu.parallel.mesh import build_mesh as jax_build_mesh
from elephas_tpu.parameter.group import ShardGroup as JaxShardGroup
from elephas_tpu.parameter.server import make_server as jax_make_server
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu_torch import obs, tune
from elephas_tpu_torch.engine.async_engine import AsyncTrainer
from elephas_tpu_torch.engine.sync import SyncTrainer
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parallel.mesh import build_mesh
from elephas_tpu_torch.parameter.group import ShardGroup
from elephas_tpu_torch.parameter.server import make_server
from elephas_tpu_torch.serving import InferenceEngine
from elephas_tpu_torch.tune.runner import TuneRunner

DIM, CLASSES = 8, 3
# Routes whose documents do not depend on process-global state (other
# tests' metrics and flight events): compared to every depth. The rest
# are compared by their top-level keys.
DEEP = ("/healthz", "/vars", "/meta", "/workers", "/shards", "/load", "/slo", "/canary",
        "/tenants", "/trials", "/incidents", "/profile")
ROUTES = ("/healthz", "/vars", "/meta", "/workers", "/alerts", "/history?window=5",
          "/incidents", "/profile", "/shards", "/flight", "/trace", "/load", "/slo",
          "/canary", "/tenants", "/trials")


def _get(url, timeout=5.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _keys(doc, depth):
    if depth == 0:
        return None
    if isinstance(doc, dict):
        return {k: _keys(v, depth - 1) for k, v in sorted(doc.items())}
    if isinstance(doc, list):
        return [_keys(doc[0], depth - 1)] if doc else []
    return None


def _same_routes(jax_url, url, routes=ROUTES):
    """Every route answers both endpoints with the same status and keys."""
    for route in routes:
        (jax_status, jax_doc), (status, doc) = _get(f"{jax_url}{route}"), _get(f"{url}{route}")
        if route == "/profile":
            # Without a card the port's device memory is empty; JAX lists
            # its CPU devices.
            assert doc.pop("device_memory") == {}
            jax_doc.pop("device_memory")
        depth = 8 if route.split("?")[0] in DEEP else 1
        assert (status, _keys(doc, depth)) == (jax_status, _keys(jax_doc, depth)), route
    assert _get(f"{url}/metrics".replace("/metrics", "/nope"))[0] == 404
    with urllib.request.urlopen(f"{url}/metrics", timeout=5.0) as resp:
        assert "elephas_process_info" in resp.read().decode()


def _tree():
    return {"dense": {"w": np.ones((4, 4), np.float32), "b": np.zeros(4, np.float32)}}


def _delta():
    return {"dense": {"w": np.full((4, 4), 0.25, np.float32), "b": np.ones(4, np.float32)}}


# -- the parameter server ------------------------------------------------------------


@pytest.mark.parametrize("mode", ["local", "socket", "http"])
def test_the_parameter_server_mounts_the_jax_routes(mode, tmp_path):
    """``ops_port=0`` mounts at ``start()`` with the WAL's telemetry
    journal (``store_dir="auto"``) behind ``/incidents``; ``stop()``
    unmounts. The local server has no endpoint in either package."""
    servers = {
        "jax": jax_make_server(mode, _tree(), port=0, ops_port=0,
                               wal_dir=None if mode == "local" else str(tmp_path / "jax")),
        "torch": make_server(mode, _tree(), port=0, device="cpu", ops_port=0,
                             wal_dir=None if mode == "local" else str(tmp_path / "torch")),
    }
    for server in servers.values():
        server.start()
    try:
        if mode == "local":
            assert all(getattr(s, "ops", None) is None for s in servers.values())
            return
        for server in servers.values():
            client = server.client()
            client.worker_id = "w9"
            client.get_parameters()
            client.update_parameters(_delta())
            client.update_parameters(_delta())
            client.close()
        _same_routes(servers["jax"].ops.url, servers["torch"].ops.url)
        _, doc = _get(f"{servers['torch'].ops.url}/vars")
        assert doc["boot"] == servers["torch"].boot and doc["version"] == 2
        assert doc["transport"] == mode
        _, doc = _get(f"{servers['torch'].ops.url}/workers")
        assert doc["workers"]["w9"]["updates"] == 2 and doc["workers"]["w9"]["lag_max"] >= 1
        _, doc = _get(f"{servers['torch'].ops.url}/incidents")
        assert doc["meta"]["role"] == "ps"
        assert str(tmp_path / "torch" / "telemetry") in doc["meta"]["dir"]
        url = servers["torch"].ops.url
    finally:
        for server in servers.values():
            server.stop()
    assert servers["torch"].ops is None and servers["torch"].store is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"{url}/healthz", timeout=0.5)
    # Both journals hold the same story: boot, ..., close.
    for name in ("jax", "torch"):
        kinds = [r["k"] for r in obs.read_store(str(tmp_path / name / "telemetry"))["records"]]
        assert kinds[0] == "lifecycle" and kinds[-1] == "lifecycle"


def test_a_killed_servers_journal_ends_with_the_kill(tmp_path):
    server = make_server("http", _tree(), port=0, device="cpu", wal_dir=str(tmp_path),
                         ops_port=0)
    server.start()
    client = server.client()
    client.update_parameters(_delta())
    client.close()
    server.kill()
    assert server.ops is None
    records = obs.read_store(str(tmp_path / "telemetry"))["records"]
    flights = [r["data"]["kind"] for r in records if r["k"] == "flight"]
    assert flights[-1] == "ps_kill"
    assert records[-1]["k"] == "lifecycle" and records[-1]["data"]["event"] == "kill"
    restarted = make_server("http", _tree(), port=0, device="cpu", wal_dir=str(tmp_path))
    restarted.start()
    restarted.stop()
    builder = obs.IncidentBuilder()
    builder.add_store(str(tmp_path / "telemetry"), name="ps")
    incident = builder.build()
    assert len(incident["boots_by_proc"]["ps"]) == 2
    assert incident["triggering_event"]["kind"] == "ps_kill"


# -- the shard group -------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_params():
    rng = np.random.default_rng(0)
    return {"dense1": {"kernel": rng.normal(size=(8, 16)).astype(np.float32),
                       "bias": np.zeros(16, np.float32)},
            "dense2": {"kernel": rng.normal(size=(16, 4)).astype(np.float32)}}


def test_the_group_members_take_the_jax_port_offsets(tmp_path):
    base = _free_port()
    offsets = {}
    for name, cls, kw in (("jax", JaxShardGroup, {}), ("torch", ShardGroup, {"device": "cpu"})):
        group = cls(_group_params(), 2, mode="socket", standby=1, ops_port=base,
                    wal_root=str(tmp_path / name), **kw)
        offsets[name] = ([m.ops_port for m in group._active],
                         [m.ops_port for m in group._standbys])
    assert offsets["torch"] == offsets["jax"] == ([base, base + 1], [base + 2, base + 3])


def test_the_group_serves_shards_on_every_member(tmp_path):
    groups = {"jax": JaxShardGroup(_group_params(), 2, mode="socket", standby=1, ops_port=0,
                                   wal_root=str(tmp_path / "jax")),
              "torch": ShardGroup(_group_params(), 2, mode="socket", standby=1, ops_port=0,
                                  wal_root=str(tmp_path / "torch"), device="cpu")}
    for group in groups.values():
        group.start()
    try:
        members = {name: [*g._active, *g._standbys] for name, g in groups.items()}
        assert all(m.ops is not None for m in members["torch"])
        for jax_member, member in zip(members["jax"], members["torch"]):
            _same_routes(jax_member.ops.url, member.ops.url,
                         routes=("/shards", "/vars", "/meta", "/healthz", "/incidents"))
        docs = [_get(f"{m.ops.url}/shards")[1] for m in members["torch"]]
        assert all(d == docs[0] for d in docs)
        assert docs[0]["plan"]["digest"] == groups["torch"].plan.digest
        assert docs[0]["plan"]["digest"] == _get(f"{members['jax'][0].ops.url}/shards")[1][
            "plan"]["digest"]
        roles = [_get(f"{m.ops.url}/meta")[1]["role"] for m in members["torch"]]
        assert roles == ["ps/shard0", "ps/shard1", "ps/standby", "ps/standby"]
    finally:
        for group in groups.values():
            group.stop()


# -- the trainers -----------------------------------------------------------------------


def _port_mlp():
    return et.compile_model(get_model("mlp", features=(8,), num_classes=CLASSES, device="cpu"),
                            optimizer={"name": "sgd", "learning_rate": 0.05},
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(DIM,), seed=0)


def _jax_mlp():
    from elephas_tpu import compile_model

    return compile_model(jax_get_model("mlp", features=(8,), num_classes=CLASSES),
                         optimizer={"name": "sgd", "learning_rate": 0.05},
                         loss="categorical_crossentropy", metrics=["acc"],
                         input_shape=(DIM,), seed=0)


def _pair_mounts(jax_obj, obj, routes=ROUTES):
    jax_ops, ops = jax_obj.mount_ops(), obj.mount_ops()
    try:
        assert obj.mount_ops() is ops  # idempotent
        _same_routes(jax_ops.url, ops.url, routes)
        meta = _get(f"{ops.url}/meta")[1]
        assert meta["worker_id"] == _get(f"{jax_ops.url}/meta")[1]["worker_id"]
        return _get(f"{ops.url}/vars")[1], meta
    finally:
        jax_obj.unmount_ops()
        obj.unmount_ops()
        obj.unmount_ops()
        assert obj.ops is None


def test_the_async_trainer_mounts_a_worker_endpoint(tmp_path):
    vars_doc, meta = _pair_mounts(
        JaxAsyncTrainer(_jax_mlp(), jax_build_mesh(num_data=2), frequency="epoch"),
        AsyncTrainer(_port_mlp(), ["cpu"] * 2, frequency="epoch"))
    assert meta["role"] == "worker" and meta["worker_id"] == "w0"
    assert vars_doc["frequency"] == "epoch" and vars_doc["parameter_server_mode"] == "local"
    # With a journal: the flight notes of the process land there.
    trainer = AsyncTrainer(_port_mlp(), ["cpu"], frequency="epoch")
    ops = trainer.mount_ops(store_dir=str(tmp_path / "w0"))
    obs.default_flight_recorder().note("worker_requeue", "warn", unit=3)
    assert _get(f"{ops.url}/incidents")[1]["meta"]["role"] == "worker"
    trainer.unmount_ops()
    kinds = [r["data"].get("kind") for r in obs.read_store(str(tmp_path / "w0"))["records"]]
    assert "worker_requeue" in kinds


def test_the_async_trainers_parameter_server_is_scraped_while_it_trains(tmp_path):
    """``ps_ops_port``: the fit's server mounts its endpoint; an epoch
    callback scrapes it live."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(128, DIM)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 128)]
    trainer = AsyncTrainer(_port_mlp(), ["cpu"] * 2, frequency="epoch",
                           parameter_server_mode="http", port=0, ps_ops_port=0,
                           ps_wal_dir=str(tmp_path))
    scraped = []

    def scrape(epoch, state, metrics):
        url = trainer.server.ops.url
        scraped.append({route: _get(f"{url}{route}") for route in ("/vars", "/workers")})

    trainer.fit(et.data.rdd.ShardedDataset(x, y, 2), epochs=2, batch_size=16,
                callbacks=[scrape])
    assert len(scraped) == 2
    assert all(s["/vars"][0] == 200 and s["/vars"][1]["transport"] == "http" for s in scraped)
    assert scraped[-1]["/vars"][1]["version"] >= 2
    assert set(scraped[-1]["/workers"][1]["workers"]) == {"w0", "w1"}
    assert trainer.server.ops is None  # stopped with the server
    assert (tmp_path / "telemetry").is_dir()


def test_the_sync_trainer_mounts_a_worker_endpoint():
    vars_doc, meta = _pair_mounts(JaxSyncTrainer(_jax_mlp(), jax_build_mesh()),
                                  SyncTrainer(_port_mlp(), build_mesh()))
    assert meta["role"] == "worker" and vars_doc["n_shards"] == 1


# -- the serving engine and the tuner -----------------------------------------------------


def test_the_serving_engine_mounts_the_jax_routes():
    jax_compiled = JaxCompiledModel(
        jax_get_model("transformer_lm", vocab_size=97, d_model=32, num_heads=4, num_layers=2,
                      max_seq_len=64),
        optimizer={"name": "adam", "learning_rate": 3e-3},
        loss="sparse_categorical_crossentropy", metrics=[], input_shape=(64,),
        input_dtype=jnp.int32, seed=0)
    module = get_model("transformer_lm", device="cpu", vocab_size=97, d_model=32, num_heads=4,
                       num_layers=2, max_seq_len=64)
    kw = dict(max_slots=3, max_prompt_len=8, max_len=24, queue_depth=8)
    engine = InferenceEngine(module, **kw)
    jax_engine = JaxEngine(jax_compiled, **kw)
    engine.submit([1, 2, 3], max_new_tokens=3, tenant="a")
    jax_engine.submit([1, 2, 3], max_new_tokens=3, tenant="a")
    vars_doc, meta = _pair_mounts(jax_engine, engine)
    assert meta["role"] == "serving" and vars_doc["max_slots"] == 3
    ops = engine.mount_ops()
    try:
        engine.run_until_drained()
        health = _get(f"{ops.url}/healthz")[1]
        assert health["queue_depth"] == 0 and health["pool_free"] == 3
        assert _get(f"{ops.url}/tenants")[1]["tenants"]["a"]["submitted"] == 1
        with urllib.request.urlopen(f"{ops.url}/metrics", timeout=5.0) as resp:
            assert "serving_" in resp.read().decode()
    finally:
        engine.unmount_ops()
    engine.unmount_ops()
    with pytest.raises(NotImplementedError, match="item 7"):
        engine.attach_canary(None)


def _staircase(config, state, epochs, seed, rung):
    steps = (float(state["steps"]) if state is not None else 0.0) + float(epochs)
    return {"loss": (config["tid"] + 1) / (1.0 + steps),
            "state": {"steps": torch.tensor(steps, dtype=torch.float64)}}


def _jax_staircase(config, state, epochs, seed, rung):
    steps = (float(state["steps"]) if state is not None else 0.0) + float(epochs)
    return {"loss": (config["tid"] + 1) / (1.0 + steps),
            "state": {"steps": np.asarray(steps, dtype=np.float64)}}


def test_the_trials_route_serves_the_runners_snapshot():
    runners = {}
    for name, pkg, fn, registry, flight in (
            ("jax", jax_tune, _jax_staircase, JaxMetricsRegistry, JaxFlightRecorder),
            ("torch", tune, _staircase, obs.MetricsRegistry, obs.FlightRecorder)):
        quiet = dict(registry=registry(), flight=flight(capacity=512))
        specs = [pkg.TrialSpec(i, {"tid": i}, seed=i) for i in range(6)]
        sched = pkg.AshaScheduler(specs, eta=3, rungs=3, r0=1, **quiet)
        runner_cls = TuneRunner if name == "torch" else __import__(
            "elephas_tpu.tune.runner", fromlist=["TuneRunner"]).TuneRunner
        runners[name] = runner_cls(fn, sched, vault=pkg.MemoryVault(), worker_ids=("w0",),
                                   **quiet)
        runners[name].run()
    from elephas_tpu.obs.opsd import OpsServer as JaxOpsServer

    servers = {"jax": JaxOpsServer(port=0, trials_fn=runners["jax"].trials_snapshot).start(),
               "torch": obs.OpsServer(port=0, trials_fn=runners["torch"].trials_snapshot)
               .start()}
    try:
        docs = {name: _get(f"{s.url}/trials") for name, s in servers.items()}
        assert docs["torch"] == docs["jax"]
        assert docs["torch"][1]["trials"]
    finally:
        for s in servers.values():
            s.stop()


def test_mounts_never_block_a_concurrent_fit_thread():
    """A mounted endpoint answers while another thread trains."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(256, DIM)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 256)]
    trainer = SyncTrainer(_port_mlp(), build_mesh())
    ops = trainer.mount_ops()
    answers = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            answers.append(_get(f"{ops.url}/healthz")[0])

    poller = threading.Thread(target=poll)
    poller.start()
    try:
        trainer.fit(et.data.rdd.ShardedDataset(x, y, 1), epochs=2, batch_size=32)
    finally:
        stop.set()
        poller.join()
        trainer.unmount_ops()
    assert answers and set(answers) == {200}
