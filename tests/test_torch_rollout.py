"""The port's live model delivery (``elephas_tpu_torch/rollout``) against
the JAX package's (``elephas_tpu/rollout``), on the CPU.

The counterparts of ``tests/test_rollout.py``:

- the subscriber's counters and cadence, and the controller's whole event
  sequence and ``digest`` (promotion tier by tier, rollback to the pinned
  version or to a peer's copy, the idle nudge, the PS outage, the
  ``/rollout`` document) under one scripted clock, judge and client, equal
  the JAX package's exactly;
- on engines of the same weights (a 2-layer LM of width 64, carried
  across with ``convert.from_flax_params``; PS trees crossing packages
  through ``to_flax_params``): a swap of the same weights at every step
  boundary leaves the streams the JAX engine's; a swap of new weights in
  the middle of a pipelined stream gives the JAX engine's stream (the
  tokens before the boundary from the old weights, after it from the
  new); a speculative window never spans a swap; a subscribed draft
  rides the target's cadence;
- a rollout through real PS groups (2 shards over sockets, a WAL with
  ``wal_keep=4``) and two-replica fleets of each package: the bake keeps
  the other replica bitwise at version 0, the promotion brings every
  replica to version 1 with the streams of an engine loaded with it, a
  failing judge's version 2 rolls back to 1, and the events and digest
  equal the JAX package's.

Streams are compared exactly; where one differs from the JAX stream, the
JAX model's top-2 gap at the first difference must be below 1e-4.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu import obs as jax_obs
from elephas_tpu import rollout as jax_rollout
from elephas_tpu import serving as jax_serving
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parameter import ShardGroup as JaxShardGroup
from elephas_tpu.parameter.client import VersionUnavailable as JaxVersionUnavailable
from elephas_tpu_torch import obs
from elephas_tpu_torch import rollout
from elephas_tpu_torch import serving
from elephas_tpu_torch.convert import from_flax_params, to_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parameter import ShardGroup
from elephas_tpu_torch.parameter.client import VersionUnavailable

VOCAB, SEQ = 97, 64
NEAR_TIE = 1e-4
PACKAGES = ("jax", "port")
PKG = {"jax": (jax_obs, jax_serving, jax_rollout, JaxVersionUnavailable),
       "port": (obs, serving, rollout, VersionUnavailable)}
PROMPTS = [[5, 3, 9], [7, 2, 8, 4, 1, 6], [11, 12], [1, 2, 3, 4]]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeVersionedClient:
    """``ShardedParameterClient.pull``'s stand-in: versioned trees with
    pinned history, injectable failures and an optional version bump at
    every live pull (identical content)."""

    def __init__(self, tree, unavailable, version=0, auto_bump=False):
        self.trees = {version: tree}
        self.version = version
        self.auto_bump = auto_bump
        self.unavailable = unavailable
        self.live_pulls = self.pinned_pulls = 0
        self.fail = False

    def push(self, tree=None):
        self.version += 1
        self.trees[self.version] = tree if tree is not None else self.trees[self.version - 1]

    def prune(self, version):
        self.trees.pop(version, None)

    def pull(self, version=None):
        if self.fail:
            raise ConnectionError("pull failed (injected)")
        if version is not None:
            self.pinned_pulls += 1
            if version not in self.trees:
                raise self.unavailable("fake:0", version)
            return version, self.trees[version]
        if self.auto_bump:
            self.push()
        self.live_pulls += 1
        return self.version, self.trees[self.version]


@pytest.fixture()
def flights():
    saved = {pkg: PKG[pkg][0].default_flight_recorder() for pkg in PACKAGES}
    fresh = {pkg: PKG[pkg][0].FlightRecorder(capacity=256) for pkg in PACKAGES}
    for pkg in PACKAGES:
        PKG[pkg][0].set_default_flight_recorder(fresh[pkg])
    try:
        yield fresh
    finally:
        for pkg in PACKAGES:
            PKG[pkg][0].set_default_flight_recorder(saved[pkg])


# -- the subscriber's counters ---------------------------------------------------------


class MiniEngine:
    def __init__(self):
        self.model_version = None
        self.subscriber = None
        self.spec = None

    def install_weights(self, tree, version=None):
        self.model_version = version


def _follow_run(pkg):
    sub_cls, unavailable = PKG[pkg][2].WeightSubscriber, PKG[pkg][3]
    eng, client = MiniEngine(), FakeVersionedClient({"w": 1}, unavailable)
    sub = sub_cls(client, every=1, follow=True).attach(eng)
    for _ in range(10):
        sub.on_step(eng)
    client.push({"w": 2})
    for _ in range(5):
        sub.on_step(eng)
    eng2 = MiniEngine()
    sub2 = sub_cls(FakeVersionedClient({"w": 1}, unavailable), every=3, follow=True).attach(eng2)
    for _ in range(9):
        sub2.on_step(eng2)
    eng3, failing = MiniEngine(), FakeVersionedClient({"w": 1}, unavailable)
    failing.fail = True
    sub3 = sub_cls(failing, follow=True).attach(eng3)
    sub3.on_step(eng3)
    sub3.pin(0)
    sub3.on_step(eng3)
    return sub.snapshot(), eng.model_version, sub2.snapshot(), sub3.snapshot()


def test_subscriber_counters_equal_the_jax_subscribers(flights):
    """Version-gated follow polls (one swap per version, the rest
    unchanged), the every-3 cadence and failures degrading, as the JAX
    subscriber counts them."""
    port, ref = _follow_run("port"), _follow_run("jax")
    assert port == ref
    assert (port[0]["pulls"], port[0]["swaps"], port[0]["unchanged"]) == (15, 2, 13)
    assert port[2]["pulls"] == 3 and port[3]["failures"] == 2
    kinds = {pkg: [e.kind for e in flights[pkg].events()] for pkg in PACKAGES}
    assert kinds["port"] == kinds["jax"]


# -- the controller's policy plane (fakes) ------------------------------------------------


class FakeLedger:
    def __init__(self):
        self.evaluated = 0
        self.good = 1.0

    def snapshot(self, now=None):
        return {"evaluated": self.evaluated}

    def goodput(self, window_s, now=None):
        return {"itl": self.good}


class FakeEngine:
    def __init__(self, pkg):
        self.model_version = None
        self.subscriber = None
        self.spec = None
        self.slo = FakeLedger()
        self.params = {"w": np.zeros(2) if pkg == "jax" else torch.zeros(2)}

    def install_weights(self, tree, version=None):
        self.params = tree
        self.model_version = None if version is None else int(version)

    def step(self):
        if self.subscriber is not None:
            self.subscriber.on_step(self)


class FakeReplica:
    def __init__(self, rid, tier, pkg):
        self.replica_id = rid
        self.tier = tier
        self.state = "serving"
        self.engine = FakeEngine(pkg)
        self.rollout_canary = False


class FakeSet:
    def __init__(self, reps):
        self.replicas = {r.replica_id: r for r in reps}

    def serving(self, tier=None):
        return [r for r in self.replicas.values()
                if r.state == "serving" and (tier is None or r.tier == tier)]


def _tree(pkg, value):
    return {"w": np.full(2, value) if pkg == "jax" else torch.full((2,), float(value))}


def _controller(pkg, tiers, verdict, bake_s=1.0, min_results=2, locks=False):
    reps = [FakeReplica(f"r{i}", t, pkg) for i, t in enumerate(tiers)]
    if locks:
        for r in reps:
            r.engine._step_lock = threading.Lock()
    client = FakeVersionedClient(_tree(pkg, 0.0), PKG[pkg][3])
    clock = FakeClock()
    ctrl = PKG[pkg][2].RolloutController(FakeSet(reps), client, bake_s=bake_s,
                                         min_results=min_results,
                                         judge=lambda *a: verdict, clock=clock)
    return reps, client, clock, ctrl


def _step_all(reps):
    for r in reps:
        r.engine.step()


def _promote(pkg):
    reps, client, clock, ctrl = _controller(
        pkg, ["prefill", "prefill", "mono", "decode", "decode"], True)
    phases = [ctrl.tick()]
    client.push(_tree(pkg, 1.0))
    phases.append(ctrl.tick())
    reps[0].engine.step()
    clock.advance(10.0)
    reps[0].engine.slo.evaluated = 5
    phases += [ctrl.tick(), ctrl.tick()]
    for _ in range(3):
        _step_all(reps)
        phases.append(ctrl.tick())
    return phases, [r.engine.model_version for r in reps], ctrl


def _rollback(pkg, prune):
    reps, client, clock, ctrl = _controller(pkg, ["prefill", "decode", "decode"], False)
    phases = [ctrl.tick()]
    client.push(_tree(pkg, 9.0))
    if prune:
        client.prune(0)
    phases.append(ctrl.tick())
    reps[0].engine.step()
    clock.advance(10.0)
    reps[0].engine.slo.evaluated = 5
    phases.append(ctrl.tick())
    reps[0].engine.step()
    phases += [ctrl.tick(), ctrl.tick()]
    reps[0].engine.step()
    phases += [ctrl.tick(), ctrl.tick()]
    return phases, [r.engine.model_version for r in reps], ctrl


def _nudge(pkg):
    reps, client, clock, ctrl = _controller(pkg, ["prefill", "decode", "decode"], True,
                                            locks=True)
    ctrl.tick()
    client.push(_tree(pkg, 1.0))
    ctrl.tick()
    clock.advance(10.0)
    reps[0].engine.slo.evaluated = 5
    phases = [ctrl.tick() for _ in range(6)]
    sub = ctrl.subscriber_of("r1")
    with reps[1].engine._step_lock:
        busy = sub.nudge(reps[1].engine)
    return phases, [r.engine.model_version for r in reps], ctrl, (busy,
                                                                  sub.nudge(reps[1].engine))


def _outage(pkg):
    reps, client, clock, ctrl = _controller(pkg, ["prefill", "decode"], True)
    ctrl.tick()
    client.fail = True
    phase = ctrl.tick()
    _step_all(reps)
    return [phase], [r.engine.model_version for r in reps], ctrl, (ctrl.probe_failures,
                                                                   client.live_pulls)


def _baking(pkg):
    reps, client, clock, ctrl = _controller(pkg, ["prefill", "decode"], True, bake_s=5.0,
                                            min_results=1)
    ctrl.tick()
    client.push(_tree(pkg, 1.0))
    ctrl.tick()
    reps[0].engine.step()
    clock.advance(2.0)
    phase = ctrl.tick()
    gauges = PKG[pkg][0].default_registry().snapshot()
    return [phase], [r.engine.model_version for r in reps], ctrl, (
        gauges["fleet_rollout_age_s"], gauges["fleet_version_skew"])


ARCS = {"promote": _promote, "rollback": lambda pkg: _rollback(pkg, False),
        "peer_copy": lambda pkg: _rollback(pkg, True), "nudge": _nudge, "outage": _outage,
        "baking": _baking}


def _comparable(doc):
    """A ``/rollout`` document without its clock readings."""
    return {k: v for k, v in doc.items() if k != "age_s"}


@pytest.mark.parametrize("arc", list(ARCS))
def test_controller_arcs_equal_the_jax_controllers(arc, flights):
    """Every phase, served version, event and the digest of one scripted
    arc, in both packages; the ``/rollout`` documents equal."""
    port, ref = ARCS[arc]("port"), ARCS[arc]("jax")
    assert port[0] == ref[0] and port[1] == ref[1] and port[3:] == ref[3:]
    pdoc, jdoc = port[2].doc(), ref[2].doc()
    assert _comparable(pdoc) == _comparable(jdoc)
    assert pdoc["digest"] == jdoc["digest"]
    notes = {pkg: [e.kind for e in flights[pkg].events()
                   if e.kind.startswith("rollout_")] for pkg in PACKAGES}
    assert notes["port"] == notes["jax"]


def test_controller_arcs_read_as_the_reference_pins_them():
    phases, versions, ctrl = _promote("port")
    assert phases[2] == "promoting" and phases[-1] == "idle" and versions == [1] * 5
    assert [(e["tier"], e["replica"]) for e in ctrl.doc()["events"] if e["kind"] == "pin"] == [
        ("prefill", "r1"), ("mono", "r2"), ("decode", "r3"), ("decode", "r4")]
    phases, versions, ctrl = _rollback("port", False)
    assert phases[2] == "rollback" and versions == [0, None, None] and ctrl.rollbacks == 1
    assert [e["kind"] for e in ctrl.doc()["events"]] == [
        "baseline", "canary_start", "rollback_start", "rolled_back"]
    _, versions, ctrl = _rollback("port", True)
    assert versions[0] == 0 and "rollback_peer_copy" in [e["kind"] for e in ctrl.doc()["events"]]
    _, versions, ctrl, busy = _nudge("port")
    assert ctrl.rollouts == 1 and versions == [1, 1, 1] and busy == (False, True)
    assert _outage("port")[3] == (1, 1)
    _, _, ctrl, gauges = _baking("port")
    assert gauges == (2.0, 0.0) and ctrl.doc()["skew"] == 0


def test_the_digest_is_replay_stable():
    """The same arc at another pace gives the same digest, and no event
    carries a time."""
    def run(advance):
        reps, client, clock, ctrl = _controller("port", ["prefill", "decode"], True,
                                                min_results=1)
        ctrl.tick()
        client.push(_tree("port", 1.0))
        ctrl.tick()
        reps[0].engine.step()
        clock.advance(advance)
        reps[0].engine.slo.evaluated = 3
        for _ in range(2):
            ctrl.tick()
            _step_all(reps)
        ctrl.tick()
        doc = ctrl.doc()
        assert doc["approved_version"] == 1
        assert all(set(e) <= {"seq", "kind", "version", "replica", "tier", "to"}
                   for e in doc["events"])
        return doc["digest"]

    assert run(2.0) == run(500.0)


# -- engines ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """(JAX compiled model, port module, a second JAX compiled model of
    other weights, that model's weights as a state_dict)."""
    def jax_lm(seed):
        return JaxCompiledModel(
            jax_get_model("transformer_lm", vocab_size=VOCAB, d_model=64, num_heads=4,
                          num_layers=2, max_seq_len=SEQ),
            optimizer={"name": "adam", "learning_rate": 3e-3},
            loss="sparse_categorical_crossentropy", metrics=[],
            input_shape=(SEQ,), input_dtype=jnp.int32, seed=seed)

    jc, jc1 = jax_lm(0), jax_lm(1)
    module = get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=64,
                       num_heads=4, num_layers=2, max_seq_len=SEQ)
    module.load_state_dict(from_flax_params(jax.tree_util.tree_map(np.asarray, jc.params),
                                            module))
    sd1 = from_flax_params(jax.tree_util.tree_map(np.asarray, jc1.params), module)
    return jc, module, jc1, sd1


def _engine(models, pkg, **kw):
    kw = {"max_slots": 3, "max_prompt_len": 8, "max_len": 24, "queue_depth": 8, **kw}
    return (jax_serving.InferenceEngine(models[0], **kw) if pkg == "jax"
            else serving.InferenceEngine(models[1], **kw))


def _serve(engine, prompts=PROMPTS, new=10):
    ids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    return [list(engine.result(i, timeout_s=120).tokens) for i in ids]


def _top2_gap(params, jc, context):
    logits = np.asarray(jc.module.apply({"params": params},
                                        jnp.asarray([context], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _assert_near(jc, params, ref, got, prompts=PROMPTS):
    """Equal streams, or a first difference at a JAX near-tie of the
    given weights (``params``: one tree, or one per request); the ties."""
    ties = []
    for i, (a, b) in enumerate(zip(ref, got)):
        if a == b:
            continue
        k = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        trees = params if isinstance(params, (list, tuple)) else [params]
        gap = min(_top2_gap(p, jc, list(prompts[i]) + a[:k]) for p in trees)
        assert gap < NEAR_TIE, f"request {i} differs at token {k} (JAX gap {gap})"
        ties.append((i, k, gap))
    assert len(ref) == len(got)
    return ties


def test_a_swap_of_the_same_weights_at_every_boundary_keeps_the_streams(models, flights):
    """A version bump (same content) pulled and installed at every step
    boundary mid-stream: the streams are the JAX engine's, every request
    completes, and the swaps are counted and noted."""
    jc, module = models[:2]
    oracle = _serve(_engine(models, "jax"))
    eng = _engine(models, "port")
    host = {k: v.clone() for k, v in module.state_dict().items()}
    client = FakeVersionedClient(host, VersionUnavailable, auto_bump=True)
    sub = rollout.WeightSubscriber(client, every=1, follow=True).attach(eng)
    got = _serve(eng)
    _assert_near(jc, jc.params, oracle, got)
    assert sub.swaps >= 2 and eng.model_version == client.version
    assert eng.stats()["model_version"] == client.version
    assert "weight_swap" in [e.kind for e in flights["port"].events()]


def _midswap(models, pkg, swap_at):
    """Two requests on the pipelined scheduler: ``swap_at`` steps with the
    first weights, then the second weights offered, installed at the next
    step boundary; the streams."""
    eng = _engine(models, pkg)
    sub = PKG[pkg][2].WeightSubscriber(None).attach(eng)
    ids = [eng.submit(p, max_new_tokens=10) for p in PROMPTS[:2]]
    for _ in range(swap_at):
        eng.step()
    tree = models[2].params if pkg == "jax" else models[3]
    sub.offer(tree, 1)
    eng.run_until_drained()
    assert sub.swaps == 1 and eng.model_version == 1
    return [list(eng.result(i).tokens) for i in ids]


def test_a_mid_stream_swap_gives_the_jax_engines_stream(models):
    """New weights offered after 4 pipelined steps: the port's streams
    equal the JAX engine's under the same steps — the tokens the old
    weights had emitted or had in flight at the boundary stay theirs, the
    rest are the new weights'."""
    jc, _, jc1, _ = models
    port, ref = _midswap(models, "port", 4), _midswap(models, "jax", 4)
    _assert_near(jc, [jc.params, jc1.params], ref, port, PROMPTS[:2])
    before = _serve(_engine(models, "port"), PROMPTS[:2])
    assert all(a[:3] == b[:3] for a, b in zip(port, before))
    assert port != before


def test_a_speculative_window_never_spans_a_swap(models, monkeypatch):
    """Swaps at every boundary of a speculative engine: the version a
    window dispatched with is the one it finished with, and the streams
    are plain decode's (the JAX engine's)."""
    from elephas_tpu_torch.serving import spec as spec_mod

    jc, module = models[:2]
    real = spec_mod.SpeculativeDecoder.dispatch
    windows = []

    def wrapped(self, *args, **kwargs):
        before = self.engine.model_version
        out = real(self, *args, **kwargs)
        windows.append((before, self.engine.model_version))
        return out

    monkeypatch.setattr(spec_mod.SpeculativeDecoder, "dispatch", wrapped)
    oracle = _serve(_engine(models, "jax"))
    eng = _engine(models, "port", speculative=True, gamma=3, draft_layers=1)
    host = {k: v.clone() for k, v in module.state_dict().items()}
    sub = rollout.WeightSubscriber(FakeVersionedClient(host, VersionUnavailable, auto_bump=True),
                                   every=1, follow=True).attach(eng)
    _assert_near(jc, jc.params, oracle, _serve(eng))
    assert windows and all(before == after for before, after in windows)
    assert sub.swaps >= 1


def test_a_subscribed_draft_rides_the_targets_cadence(models):
    """A subscribed ``DraftModelSource`` pulls once cold, then once per
    successful target poll, never on its own."""
    _, module = models[:2]

    class CountingClient:
        pulls = 0

        def get_parameters(self):
            self.pulls += 1
            return module.state_dict()

    draft_client = CountingClient()
    source = serving.DraftModelSource(module, draft_client, subscribed=True)
    eng = _engine(models, "port", speculative=True, gamma=3, prefix_cache=False,
                  draft_source=source)
    _serve(eng)
    assert draft_client.pulls == 1
    host = {k: v.clone() for k, v in module.state_dict().items()}
    sub = rollout.WeightSubscriber(FakeVersionedClient(host, VersionUnavailable,
                                                       auto_bump=True),
                                   every=1, follow=True).attach(eng)
    assert sub.draft is source
    _serve(eng)
    assert draft_client.pulls == source.pulls == 1 + sub.pulls


# -- real PS groups and fleets --------------------------------------------------------------


def test_pinned_pulls_serve_the_wal_history(tmp_path):
    """``pull(version=)`` of a port group answers from the WAL while the
    live version moves on, and a pruned version is ``VersionUnavailable``
    — as the JAX group answers."""
    params = {"a": np.arange(4, dtype=np.float32), "b": np.ones((2, 3), dtype=np.float32)}
    delta = {"a": np.full(4, 0.5, dtype=np.float32), "b": np.full((2, 3), 0.25, np.float32)}
    answers = {}
    for pkg, group_cls in (("port", ShardGroup), ("jax", JaxShardGroup)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        group = group_cls(params, 2, mode="socket", wal_root=str(tmp_path / pkg), wal_keep=4,
                          **kw)
        group.start()
        client = group.client()
        try:
            client.update_parameters(delta)
            client.update_parameters(delta)
            live = client.pull()
            pinned = client.pull(version=1)
            with pytest.raises(PKG[pkg][3]):
                client.pull(version=99)
            answers[pkg] = (live[0], pinned[0],
                            {k: np.asarray(v) for k, v in live[1].items()},
                            {k: np.asarray(v) for k, v in pinned[1].items()})
        finally:
            client.close()
            group.stop()
    (lv, pv, live, pinned), (jlv, jpv, jlive, jpinned) = answers["port"], answers["jax"]
    assert (lv, pv) == (jlv, jpv) == (2, 1)
    for k in params:
        np.testing.assert_array_equal(live[k], jlive[k])
        np.testing.assert_array_equal(pinned[k], jpinned[k])
    np.testing.assert_array_equal(pinned["a"], params["a"] - 0.5)


def _delta(module, scale=1e-2, seed=1):
    """A seeded delta of ``scale`` relative to each tensor's mean size."""
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.normal(size=tuple(v.shape)).astype(np.float32))
            * (scale * float(v.abs().mean()) + 1e-8)
            for k, v in module.state_dict().items()}


def _fleet_rollout(models, pkg, tmp):
    """A rollout through a 2-shard group and a two-replica fleet: version
    1 baked on r0 (r1 bitwise at version 0 during the bake) and promoted;
    version 2 under a failing judge rolled back to 1."""
    jc, module = models[:2]
    _, serving_pkg, rollout_pkg, _ = PKG[pkg]
    if pkg == "jax":
        tree = jax.tree_util.tree_map(np.asarray, jc.params)
        group = JaxShardGroup(tree, 2, mode="socket", wal_root=tmp, wal_keep=4)
        deltas = [to_flax_params(_delta(module, seed=s), module) for s in (1, 2)]
    else:
        tree = {k: v.clone() for k, v in module.state_dict().items()}
        group = ShardGroup(tree, 2, mode="socket", wal_root=tmp, wal_keep=4, device="cpu")
        deltas = [_delta(module, seed=s) for s in (1, 2)]
    group.start()
    client = group.client()
    verdict, clock = {"good": True}, FakeClock()
    rs = serving_pkg.ReplicaSet(lambda: _engine(models, pkg), initial=2, clock=clock)
    router = serving_pkg.Router(rs)
    ctrl = rollout_pkg.RolloutController(rs, client, bake_s=1.0, min_results=2,
                                         judge=lambda *a: verdict["good"], clock=clock)
    router.attach_rollout(ctrl)
    out = {}

    def canary_traffic():
        engine = rs.get("r0").engine
        for p in PROMPTS[:2]:
            engine.result(engine.submit(p, max_new_tokens=4), timeout_s=120)

    def snapshot(rep):
        params = rep.engine.params
        return {k: np.array(v) for k, v in params.items()} if pkg == "port" else \
            jax.tree_util.tree_map(np.array, params)

    try:
        router.tick()                       # the baseline
        r1_before = snapshot(rs.get("r1"))
        for version, delta in ((1, deltas[0]), (2, deltas[1])):
            verdict["good"] = version == 1
            client.update_parameters(delta)
            phases = [router.tick()["rollout"]]   # the canary pinned on r0
            canary_traffic()
            phases.append(router.tick()["rollout"])
            if version == 1:
                r1_during = snapshot(rs.get("r1"))
                out["bake_kept_r1"] = jax.tree_util.tree_all(jax.tree_util.tree_map(
                    np.array_equal, r1_before, r1_during))
                out["canary_version"] = rs.get("r0").engine.model_version
            clock.advance(2.0)
            canary_traffic()
            # Ticks until the arc is over (a pinned pull under load may
            # take more than one); the phases it went through, each once.
            deadline = time.monotonic() + 60
            while phases[-1] != "idle" or len(phases) < 3:
                assert time.monotonic() < deadline, f"version {version} stuck: {phases}"
                phases.append(router.tick()["rollout"])
                time.sleep(0.01)
            phases = [p for i, p in enumerate(phases) if i == 0 or p != phases[i - 1]]
            out[f"v{version}"] = (phases, {rid: rep.engine.model_version
                                           for rid, rep in rs.replicas.items()})
            if version == 1:
                out["streams_v1"] = [list(router.result(router.submit(p, max_new_tokens=8),
                                                        timeout_s=120).tokens)
                                     for p in PROMPTS]
        doc = ctrl.doc()
        out["events"], out["digest"] = doc["events"], doc["digest"]
        out["counts"] = (ctrl.rollouts, ctrl.rollbacks, doc["approved_version"])
    finally:
        router.close()
        client.close()
        group.stop()
    return out


def test_a_rollout_through_real_groups_equals_the_jax_rollout(models, tmp_path):
    jc, module, _, _ = models
    port = _fleet_rollout(models, "port", str(tmp_path / "port"))
    ref = _fleet_rollout(models, "jax", str(tmp_path / "jax"))
    assert port["bake_kept_r1"] and ref["bake_kept_r1"]
    assert port["canary_version"] == ref["canary_version"] == 1
    assert port["v1"] == ref["v1"] and port["v1"][1] == {"r0": 1, "r1": 1}
    assert port["v2"] == ref["v2"] and port["v2"][1] == {"r0": 1, "r1": 1}
    assert port["counts"] == ref["counts"] == (1, 1, 1)
    assert port["events"] == ref["events"] and port["digest"] == ref["digest"]
    # After the promotion the fleet serves version 1: the streams of a bare
    # engine loaded with it, and the JAX fleet's.
    v1 = {k: v - d for (k, v), d in zip(module.state_dict().items(),
                                         _delta(module, seed=1).values())}
    bare = serving.InferenceEngine(module, params=v1, max_slots=3, max_prompt_len=8,
                                   max_len=24, queue_depth=8)
    assert port["streams_v1"] == _serve(bare, new=8)
    jax_v1 = to_flax_params(v1, module)
    _assert_near(jc, jax_v1, ref["streams_v1"], port["streams_v1"])


def test_a_swap_forgets_the_prefixes_the_old_weights_wrote(models):
    """After new weights install, a prompt whose full block the old
    weights wrote is prefilled again: its stream is a fresh engine's on
    the new weights, and the prefix cache counts no hit. The JAX engine
    admits it onto the old weights' block (a hit), the difference the
    port keeps deliberately (ROADMAP, deliberate differences)."""
    jc, module, jc1, sd1 = models
    prompt = [7, 2, 8, 4, 1, 6, 9, 3]
    kw = {"kv_block_size": 4}
    hits = {}
    for pkg, new, fresh in (("port", sd1, lambda: serving.InferenceEngine(
                                 module, params=sd1, max_slots=3, max_prompt_len=8,
                                 max_len=24, kv_block_size=4)),
                            ("jax", jc1.params, lambda: jax_serving.InferenceEngine(
                                 jc1, max_slots=3, max_prompt_len=8, max_len=24,
                                 kv_block_size=4))):
        eng = _engine(models, pkg, **kw)
        _serve(eng, [prompt])
        before = eng.stats()["prefix_hits"]
        eng.install_weights(new, 1)
        got = _serve(eng, [prompt])
        hits[pkg] = eng.stats()["prefix_hits"] - before
        if pkg == "port":
            assert got == _serve(fresh(), [prompt])
            eng.pool.assert_block_invariants()
    assert hits == {"port": 0, "jax": 1}
