"""The port's serving fleet (``elephas_tpu_torch/serving/fleet``: replica,
replica set, router, QoS) against the JAX package's, on the CPU.

The counterparts of ``tests/test_fleet_serving.py`` and of the router and
QoS tests of ``tests/test_disagg.py``. Each scenario runs once per package
on the same weights (a 2-layer LM of width 64, carried across with
``convert.from_flax_params``) in a module-scoped fixture, and the tests
read its records:

- greedy streams of the routed (one and two replicas), requeued (a replica
  killed under its requests) and tiered (one prefill and one decode
  replica) fleets equal the JAX fleet's unless the JAX model's top-2 gap
  at the first difference is below 1e-4 (each such tie named), and equal
  the port's bare engine exactly;
- the lifecycle (affinity, the shed latch, drain, restart, the canary's
  drain-and-restart, probes, a dead replica's card), the router's
  counters, ``replicas_doc`` and ``tiers_doc`` keys, flight notes and the
  QoS admit/throttle/preempt sequences equal the JAX package's exactly.

A kill lands while the victim's step lock is held, so the same requests
are stranded in both packages and the requeue counts are exact.
"""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elephas_tpu import obs as jax_obs
from elephas_tpu import serving as jax_serving
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.serving import fleet as jax_fleet
from elephas_tpu_torch import obs
from elephas_tpu_torch import serving
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.serving import fleet
from elephas_tpu_torch.utils import locksan


@pytest.fixture(scope="module", autouse=True)
def _lock_sanitizer(request):
    """The suite runs with the port's lock sanitizer on, seeded from
    ANALYSIS_TORCH.json (``locksan.SANITIZED_SUITES``): module fixtures
    included, so the scenarios they run are order-checked too."""
    with locksan.sanitized_suite(request.module.__name__):
        yield


VOCAB, SEQ = 97, 64
NEAR_TIE = 1e-4
PACKAGES = ("jax", "port")
PKG = {"jax": (jax_obs, jax_serving, jax_fleet), "port": (obs, serving, fleet)}
PROMPTS = [[5, 3, 9], [7, 2, 8, 4, 1, 6], [11, 12], [1, 2, 3, 4]]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Bad:
    """A ledger sample that busts every latency objective."""
    status, ttft_s, itl_s_avg = "completed", 9.0, 0.9


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


def _factory(models, pkg, **kw):
    kw = {"max_slots": 3, "max_prompt_len": 8, "max_len": 24, "queue_depth": 16, **kw}
    engine, model = PKG[pkg][1].InferenceEngine, models[0 if pkg == "jax" else 1]
    return lambda: engine(model, **kw)


def _flight(pkg):
    recorder = PKG[pkg][0].FlightRecorder(capacity=256)
    PKG[pkg][0].set_default_flight_recorder(recorder)
    return recorder


def _streams(router, prompts, new=6, **kw):
    ids = [router.submit(p, max_new_tokens=new, **kw) for p in prompts]
    return [list(router.result(i, timeout_s=120).tokens) for i in ids]


def _strand(rs, replica_id, submit):
    """Run ``submit`` while ``replica_id``'s engine cannot step, then kill
    the replica: every request ``submit`` routed there is stranded."""
    engine = rs.get(replica_id).engine
    with engine._step_lock:
        out = submit()
        engine.halt()
    rs.kill(replica_id)
    return out


def _streams_run(models, pkg):
    _, serving_pkg, _ = PKG[pkg]
    saved = PKG[pkg][0].default_flight_recorder()
    flight = _flight(pkg)
    factory = _factory(models, pkg)
    out = {}
    try:
        bare = factory()
        out["bare"] = [list(bare.result(bare.submit(p, max_new_tokens=6), timeout_s=120).tokens)
                       for p in PROMPTS]
        out["bare12"] = [list(bare.result(bare.submit(p, max_new_tokens=12),
                                          timeout_s=120).tokens) for p in PROMPTS]
        for n in (1, 2):
            router = serving_pkg.Router(serving_pkg.ReplicaSet(factory, initial=n))
            out[f"routed{n}"] = _streams(router, PROMPTS)
            if n == 2:
                router.result(router.submit([1, 2], max_new_tokens=2, session="s0"),
                              timeout_s=120)
                victim = router.session_replica("s0")
                rids = _strand(router.replica_set, victim, lambda: [
                    router.submit(p, max_new_tokens=12, session="s0") for p in PROMPTS])
                results = [router.result(r, timeout_s=120) for r in rids]
                out["requeued"] = [list(r.tokens) for r in results]
                out["requeue"] = ([r.status for r in results], router.requeues,
                                  router.session_replica("s0") != victim,
                                  router.replica_set.get(victim).state,
                                  router.replica_set.get(victim).drained)
            router.close()
        rs = serving_pkg.ReplicaSet(factory, tiers={"prefill": 1, "decode": 1})
        router = serving_pkg.Router(rs)
        out["tiered"] = _streams(router, PROMPTS)
        doc = router.tiers_doc()
        out["tiers"] = (router.handoffs, router.handoff_fails, doc["disagg_active"],
                        sorted(doc["tiers"]), doc["handoffs"]["count"],
                        doc["handoffs"]["p99_ms"] is not None,
                        len(flight.events(kind="kv_handoff")))
        out["tiers_doc_keys"] = (sorted(doc), sorted(doc["tiers"]["prefill"]),
                                 sorted(doc["handoffs"]))
        router.close()
    finally:
        PKG[pkg][0].set_default_flight_recorder(saved)
    return out


@pytest.fixture(scope="module")
def streams(models):
    return {pkg: _streams_run(models, pkg) for pkg in PACKAGES}


def _top2_gap(jc, context):
    logits = np.asarray(jc.module.apply({"params": jc.params},
                                        jnp.asarray([context], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _near_ties(jc, prompts, ref, got):
    """Each stream of ``got`` equals ``ref``'s or differs first where the
    JAX model's top-2 gap is below NEAR_TIE; returns those ties."""
    ties = []
    for i, (a, b) in enumerate(zip(ref, got)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = _top2_gap(jc, list(prompts[i]) + a[:k])
        assert gap < NEAR_TIE, f"request {i} differs at token {k} with a JAX gap of {gap}"
        ties.append((i, k, gap))
    assert len(ref) == len(got)
    return ties


@pytest.mark.parametrize("kind", ["routed1", "routed2", "requeued", "tiered"])
def test_fleet_streams_equal_the_jax_fleets(models, streams, kind):
    """The routed, requeued and tiered streams equal the JAX fleet's (up
    to a named JAX near-tie) and the port's bare engine's exactly: the
    router adds a hop, never a different computation."""
    bare = "bare12" if kind == "requeued" else "bare"
    port, ref = streams["port"], streams["jax"]
    assert port[kind] == port[bare]
    ties = _near_ties(models[0], PROMPTS, ref[kind], port[kind])
    assert ties == _near_ties(models[0], PROMPTS, ref[bare], port[bare])


def test_a_killed_replica_requeues_every_stranded_request(streams):
    assert streams["port"]["requeue"] == streams["jax"]["requeue"] == (
        ["completed"] * len(PROMPTS), len(PROMPTS), True, "dead", False)


def test_tiered_fleet_hands_every_request_off(streams):
    assert streams["port"]["tiers"] == streams["jax"]["tiers"] == (
        len(PROMPTS), 0, True, ["decode", "prefill"], len(PROMPTS), True, len(PROMPTS))
    assert streams["port"]["tiers_doc_keys"] == streams["jax"]["tiers_doc_keys"]


# -- the lifecycle: affinity, shed latch, drain, restart, canaries ------------------------


def _wait(router, predicate, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not predicate() and time.monotonic() < deadline:
        router.tick()
        time.sleep(0.01)
    return predicate()


def _lifecycle_run(models, pkg):
    _, serving_pkg, _ = PKG[pkg]
    saved = PKG[pkg][0].default_flight_recorder()
    flight = _flight(pkg)
    rec = {}
    rs = serving_pkg.ReplicaSet(_factory(models, pkg), initial=2)
    router = serving_pkg.Router(rs)
    try:
        with pytest.raises(KeyError):
            router.result(999)
        # Affinity: turn 2 lands on the pin.
        router.result(router.submit([5, 3], max_new_tokens=2, session="s0"), timeout_s=120)
        pin = router.session_replica("s0")
        router.result(router.submit([5, 3, 1], max_new_tokens=2, session="s0"), timeout_s=120)
        rec["affinity"] = (router.affinity_hits, router.affinity_misses)
        # The shed latch breaks the pin and steers new work away.
        for _ in range(6):
            rs.get(pin).engine.slo.record(_Bad())
        router.tick()
        rec["shedding"] = {rid: rep.shedding for rid, rep in rs.replicas.items()}
        router.result(router.submit([5, 3, 1, 2], max_new_tokens=2, session="s0"),
                      timeout_s=120)
        rec["shed_miss"] = (router.affinity_misses, router.session_replica("s0") != pin)
        other = router.session_replica("s0")
        engine = rs.get(other).engine
        with engine._step_lock:  # nothing finishes while the cards are read
            rids = [router.submit([1, 2], max_new_tokens=2) for _ in range(3)]
            cards = router.replicas_doc()["replicas"]
            rec["in_flight"] = {rid: card["in_flight"] for rid, card in cards.items()}
        rec["dispatched"] = [router.result(r, timeout_s=120).status for r in rids]
        # Drain: finishes what it holds, then dies drained.
        rid = router.submit([5, 3, 9], max_new_tokens=8, session="s1")
        drained = router.session_replica("s1")
        rs.drain(drained)
        rec["draining"] = rs.get(drained).state
        rec["drained_result"] = router.result(rid, timeout_s=120).status
        rec["drain"] = (_wait(router, lambda: rs.get(drained).state == "dead"),
                        rs.get(drained).drained)
        # Restart: the same slot, the next boot, a fresh engine.
        old = rs.get(drained).engine
        rs.restart(drained)
        rec["restart"] = (rs.get(drained).state, rs.get(drained).boot,
                          rs.get(drained).engine is not old)
        # A canary failure drains and restarts; the failure is consumed.
        victim = rs.get(drained)
        victim.canary.failures += 1
        acts = router.tick()
        rec["canary_drained"] = (acts["canary_drained"], victim.state, victim.pending_restart)
        rec["canary_restart"] = (_wait(router, lambda: victim.boot == 3 and
                                       victim.state == "serving"),
                                 router.tick()["canary_drained"])
        # Probes: one per serving replica per probing tick. The new boot
        # serves one request first, so that its probe does not wait on
        # the JAX engine's first compile (seconds under load, past the
        # probe's timeout).
        victim.engine.result(victim.engine.submit([1, 2], max_new_tokens=2), timeout_s=120)
        before = {r.replica_id: r.canary.probes for r in rs.serving()}
        router.tick(probe=True)
        rec["probes"] = {r.replica_id: r.canary.probes - before[r.replica_id]
                         for r in rs.serving()}
        # The router's own ledger leaves canaries out.
        evaluated = router.slo.snapshot()["evaluated"]
        router.result(router.submit([1, 2], max_new_tokens=2, canary=True), timeout_s=120)
        rec["router_slo"] = router.slo.snapshot()["evaluated"] - evaluated
        doc = router.replicas_doc()
        rec["router"] = {k: v for k, v in doc["router"].items() if k != "in_flight"}
        rec["doc_keys"] = (sorted(doc), sorted(doc["replicas"]["r0"]))
        # A dead replica's card reads no signals; no serving replica at all
        # refuses the submit.
        rs.kill("r0")
        card = router.replicas_doc()["replicas"]["r0"]
        rec["dead_card"] = (card["state"], card["load_score"], card["burn_worst"],
                            card["queue_depth"])
        rs.kill("r1")
        with pytest.raises(PKG[pkg][2].FleetUnavailable):
            router.submit([1, 2], max_new_tokens=2)
        rec["flight"] = [(e.kind, e.detail.get("replica"), e.detail.get("reason"))
                         for e in flight.events()
                         if e.kind in ("replica_drain", "replica_restart")]
    finally:
        router.close()
        PKG[pkg][0].set_default_flight_recorder(saved)
    return rec


@pytest.fixture(scope="module")
def lifecycle(models):
    return {pkg: _lifecycle_run(models, pkg) for pkg in PACKAGES}


@pytest.mark.parametrize("stage", ["affinity", "shedding", "shed_miss", "in_flight",
                                   "dispatched", "draining", "drained_result", "drain",
                                   "restart", "canary_drained", "canary_restart", "probes",
                                   "router_slo", "router", "doc_keys", "dead_card", "flight"])
def test_the_lifecycle_equals_the_jax_fleets(lifecycle, stage):
    assert lifecycle["port"][stage] == lifecycle["jax"][stage]


def test_the_lifecycle_reads_as_the_reference_pins_it(lifecycle):
    rec = lifecycle["port"]
    assert rec["affinity"] == (1, 0) and rec["shed_miss"] == (1, True)
    assert sorted(rec["in_flight"].values()) == [0, 3]
    assert rec["drain"] == (True, True) and rec["restart"] == ("serving", 2, True)
    assert rec["canary_restart"] == (True, [])
    assert set(rec["probes"].values()) == {1} and rec["router_slo"] == 0
    assert rec["dead_card"] == ("dead", None, None, None)


# -- the router's ops surface ------------------------------------------------------


def test_router_ops_serve_the_jax_documents(models):
    """``/replicas``, ``/tiers``, ``/tenants``, ``/rollout`` and
    ``/healthz`` of the port router's endpoint, keyed as the JAX router's
    documents are."""
    def get(url):
        with urllib.request.urlopen(url, timeout=5) as resp:
            return json.loads(resp.read())

    routers = {pkg: PKG[pkg][1].Router(PKG[pkg][1].ReplicaSet(_factory(models, pkg),
                                                              initial=1))
               for pkg in PACKAGES}
    try:
        for router in routers.values():
            router.result(router.submit([1, 2], max_new_tokens=2, tenant="a"), timeout_s=120)
        ops = routers["port"].mount_ops(port=0)
        jax_docs = {"/replicas": routers["jax"].replicas_doc(),
                    "/tiers": routers["jax"].tiers_doc(),
                    "/tenants": routers["jax"]._tenants_doc(),
                    "/rollout": routers["jax"]._rollout_doc()}
        for route, ref in jax_docs.items():
            doc = get(f"{ops.url}{route}")
            assert sorted(doc) == sorted(ref), route
        assert get(f"{ops.url}/replicas")["replicas"]["r0"]["boot"] == 1
        assert get(f"{ops.url}/tenants")["tenants"]["a"]["submitted"] == 1
        assert get(f"{ops.url}/rollout") == jax_docs["/rollout"]
        health = get(f"{ops.url}/healthz")
        assert health["serving"] == 1 and health["healthy"] and health["requests"] == 1
    finally:
        for router in routers.values():
            router.close()


# -- QoS ------------------------------------------------------------------------------


def _qos_script(pkg):
    """Bucket, fair-share and priority admissions on a scripted clock:
    the sequence of outcomes and the policy card."""
    qos_mod = PKG[pkg][2]
    clock = FakeClock()
    qos = qos_mod.QoSPolicy(buckets={"t": (10.0, 20.0)}, weights={"hog": 1.0, "meek": 2.0},
                            priorities={"vip": 0}, fairness_window=100.0, clock=clock)
    outcomes = []
    for tenant, cost, dt in (("t", 20.0, 0.0), ("t", 5.0, 0.0), ("t", 5.0, 0.5),
                             ("meek", 10.0, 0.1), ("hog", 150.0, 0.1), ("hog", 1.0, 0.0),
                             ("vip", 500.0, 0.0), ("vip", 500.0, 0.0), (None, 1e9, 0.0),
                             ("meek", 30.0, 1.0), ("hog", 1.0, 0.0)):
        clock.advance(dt)
        try:
            qos.try_admit(tenant, cost)
            outcomes.append((tenant, "admitted"))
        except qos_mod.AdmissionThrottled as err:
            assert isinstance(err, PKG[pkg][1].QueueFull)
            outcomes.append((tenant, err.reason, round(err.retry_after, 9)))
    qos.note_preempted("hog")
    return outcomes, qos.snapshot(), [qos.priority(t) for t in ("vip", "hog", None)]


def test_qos_admissions_equal_the_jax_policys():
    port, ref = _qos_script("port"), _qos_script("jax")
    assert port == ref
    assert port[0][1] == ("t", "bucket", 0.5) and port[0][5][:2] == ("hog", "fair_share")
    assert port[1]["tenants"]["hog"]["preempted"] == 1


def test_token_bucket_equals_jax():
    buckets = [PKG[pkg][2].TokenBucket(4.0, 8.0, now=0.0) for pkg in PACKAGES]
    for now, cost in ((0.0, 6.0), (0.1, 4.0), (0.5, 3.0), (3.0, 8.0), (3.0, 0.5)):
        got = [b.try_take(cost, now) for b in buckets]
        assert got[0] == got[1]
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            PKG[pkg][2].TokenBucket(0.0, 1.0)


def _preempt_run(models, pkg):
    """A full replica (one slot, one queue seat, its serve thread stopped
    so that only ``result`` steps it): a class-0 submit cancels the queued
    lower-priority request, which redispatches and completes after it."""
    _, serving_pkg, fleet_pkg = PKG[pkg]
    saved = PKG[pkg][0].default_flight_recorder()
    flight = _flight(pkg)
    qos = fleet_pkg.QoSPolicy(priorities={"vip": 0, "bulk": 2})
    rs = serving_pkg.ReplicaSet(_factory(models, pkg, max_slots=1, queue_depth=1), initial=1)
    router = serving_pkg.Router(rs, qos=qos)
    try:
        replica = rs.get("r0")
        replica._stop.set()
        replica._thread.join()
        rid_a = router.submit([5, 3, 9], max_new_tokens=6, tenant="bulk")
        rid_b = router.submit([9, 9], max_new_tokens=6, tenant="vip")
        results = [router.result(r, timeout_s=120) for r in (rid_b, rid_a)][::-1]
        events = [(e.detail["tenant"], e.detail["beneficiary"])
                  for e in flight.events(kind="tenant_preempted")]
        return (router.preemptions, events, [r.status for r in results],
                [list(r.tokens) for r in results], router.tiers_doc()["qos"]["tenants"]["bulk"])
    finally:
        router.close()
        PKG[pkg][0].set_default_flight_recorder(saved)


def test_class0_preempts_a_queued_request_as_the_jax_router_does(models):
    port, ref = _preempt_run(models, "port"), _preempt_run(models, "jax")
    assert port[:3] == ref[:3] == (1, [("bulk", "vip")], ["completed", "completed"])
    assert {k: v for k, v in port[4].items() if k != "bucket_fill"} == \
        {k: v for k, v in ref[4].items() if k != "bucket_fill"}
    _near_ties(models[0], [[5, 3, 9], [9, 9]], ref[3], port[3])


MODULES = ["obs.canary", "obs.fleet", "serving.fleet", "serving.fleet.replica",
           "serving.fleet.replica_set", "serving.fleet.qos", "serving.fleet.autoscaler",
           "serving.fleet.router", "rollout", "rollout.subscriber", "rollout.controller"]


@pytest.mark.parametrize("name", MODULES)
def test_the_modules_of_item_7b_carry_the_reference_public_names(name):
    """Each of the 11 modules imports under ``elephas_tpu_torch`` with the
    JAX module's ``__all__`` and every public class and function it
    defines."""
    import importlib
    import inspect

    def public(module):
        return {k for k, v in vars(module).items() if not k.startswith("_")
                and (inspect.isclass(v) or inspect.isfunction(v))
                and v.__module__ == module.__name__}

    ref = importlib.import_module(f"elephas_tpu.{name}")
    port = importlib.import_module(f"elephas_tpu_torch.{name}")
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
    assert public(port) == public(ref)
    for attr in getattr(ref, "__all__", []):
        assert hasattr(port, attr), attr
