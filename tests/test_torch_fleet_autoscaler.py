"""The port's autoscaler (``elephas_tpu_torch/serving/fleet/autoscaler.py``)
against the JAX package's, on the CPU.

The counterparts of ``tests/test_fleet_autoscaler.py``: the pure decision
core fed the same observation ladders (seeded bursts, streaks, the
hysteresis band, cooldown, clamps) in both packages gives the same
decision sequences and policy cards, exactly; its narration (flight note
and counter) and its validation match; and the router actuating it
against live replicas (a 2-layer LM of width 64, carried across with
``convert.from_flax_params``) spawns and drains the same replicas, with
the same tick actions, as the JAX router does.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from elephas_tpu import obs as jax_obs
from elephas_tpu import serving as jax_serving
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.obs.slo import GoodputLedger as JaxLedger
from elephas_tpu_torch import obs
from elephas_tpu_torch import serving
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.obs.slo import GoodputLedger

VOCAB, SEQ = 97, 64
PACKAGES = ("jax", "port")
PKG = {"jax": (jax_obs, jax_serving, JaxLedger), "port": (obs, serving, GoodputLedger)}


def _auto(pkg, **kw):
    kw = {"min_replicas": 1, "max_replicas": 4, "up_burn": 1.0, "down_burn": 0.25,
          "up_after": 2, "down_after": 3, "cooldown_s": 60.0, **kw}
    return PKG[pkg][1].FleetAutoscaler(**kw)


def _drive(auto, schedule, n0=1):
    """Feed (t, burn) pairs, tracking the replica count the way the router
    would actuate it; the decisions and the card after each."""
    n, out = n0, []
    for t, burn in schedule:
        decision = auto.observe(burn=burn, n_replicas=n, now=t)
        n += {"up": 1, "down": -1}.get(decision, 0)
        out.append((decision, n, auto.snapshot()))
    return out


def _seeded_burst(seed):
    """A burst of burn from ``seed``: hot, then a quiet tail, with the
    dead band visited on the way."""
    rng = np.random.default_rng(seed)
    t, schedule = 0.0, []
    for level, count in ((5.0, 6), (0.6, 3), (3.0, 5), (0.0, 14), (2.0, 4), (0.1, 10)):
        for _ in range(count):
            t += float(rng.uniform(5.0, 30.0))
            schedule.append((t, float(level * rng.uniform(0.5, 1.5))))
    return schedule


POLICIES = {
    "default": {},
    "eager": {"up_after": 1, "down_after": 1, "cooldown_s": 0.0},
    "clamped": {"min_replicas": 1, "max_replicas": 2, "up_after": 1, "down_after": 1,
                "cooldown_s": 0.0},
    "slow": {"up_after": 3, "down_after": 2, "cooldown_s": 100.0, "max_replicas": 8},
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_decision_sequences_equal_the_jax_autoscalers(policy, seed):
    """Under a seeded burst every decision, replica count and policy card
    equals the JAX autoscaler's, and replays exactly."""
    schedule = _seeded_burst(seed)
    runs = {pkg: _drive(_auto(pkg, **POLICIES[policy]), schedule) for pkg in PACKAGES}
    assert runs["port"] == runs["jax"]
    assert runs["port"] == _drive(_auto("port", **POLICIES[policy]), schedule)
    assert any(d == "up" for d, _, _ in runs["port"])


def test_the_reference_ladders_decide_as_pinned():
    """The JAX tests' hand ladders (streaks, the dead band, cooldown,
    clamps), in both packages."""
    for pkg in PACKAGES:
        auto = _auto(pkg, up_after=3, down_after=2, cooldown_s=0.0)
        got = [auto.observe(burn=b, n_replicas=n, now=t) for t, b, n in (
            (0.0, 5.0, 1), (1.0, 5.0, 1), (2.0, 5.0, 1), (3.0, 0.0, 2), (4.0, 0.0, 2))]
        assert got == [None, None, "up", None, "down"]
        auto = _auto(pkg, up_after=2, cooldown_s=0.0)
        got = [auto.observe(burn=b, n_replicas=1, now=t) for t, b in (
            (0.0, 5.0), (1.0, 0.5), (2.0, 5.0), (3.0, 5.0))]
        assert got == [None, None, None, "up"] and auto.snapshot()["up_streak"] == 0
        auto = _auto(pkg, up_after=2, cooldown_s=100.0, max_replicas=8)
        got = [auto.observe(burn=5.0, n_replicas=n, now=t) for t, n in (
            (0.0, 1), (10.0, 1), (20.0, 2), (30.0, 2), (111.0, 2))]
        assert got == [None, "up", None, None, "up"]


def test_decisions_are_narrated_as_the_jax_autoscaler_narrates_them():
    """An actuation is one ``fleet_scale`` flight note and one
    ``fleet_scale_events_total{direction=}`` tick, with the JAX details."""
    notes = {}
    for pkg in PACKAGES:
        obs_pkg = PKG[pkg][0]
        saved = obs_pkg.default_flight_recorder()
        flight = obs_pkg.set_default_flight_recorder(obs_pkg.FlightRecorder(capacity=16))
        try:
            family = obs_pkg.default_registry().counter(
                "fleet_scale_events_total", help="autoscaler decisions actuated, by direction",
                labelnames=("direction",))
            up0 = family.labels(direction="up").value
            _auto(pkg, up_after=1, cooldown_s=0.0).observe(burn=5.0, n_replicas=1, now=0.0)
            assert family.labels(direction="up").value - up0 == 1
            notes[pkg] = [(e.kind, e.severity, e.detail) for e in flight.events()]
        finally:
            obs_pkg.set_default_flight_recorder(saved)
    assert notes["port"] == notes["jax"] == [
        ("fleet_scale", "info", {"direction": "up", "burn": 5.0, "replicas": 1})]


@pytest.mark.parametrize("kw", [{"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
                                {"up_burn": 0.2, "down_burn": 0.25}, {"up_after": 0},
                                {"cooldown_s": -1.0}])
def test_policy_validation_equals_jax(kw):
    messages = []
    for pkg in PACKAGES:
        with pytest.raises(ValueError) as err:
            PKG[pkg][1].FleetAutoscaler(**kw)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# -- the router actuating it -------------------------------------------------------------


class _Bad:
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


def _factory(models, pkg):
    engine, model = PKG[pkg][1].InferenceEngine, models[0 if pkg == "jax" else 1]
    return lambda: engine(model, max_slots=3, max_prompt_len=8, max_len=24, queue_depth=16)


def _actuation_run(models, pkg):
    """A seeded burn burst makes ``tick`` spawn a replica; once the burn
    clears and the cooldown passes, a tick drains one down and it stays
    down. Returns every tick's scale action, the roster and the notes."""
    obs_pkg, serving_pkg, ledger = PKG[pkg]
    saved = obs_pkg.default_flight_recorder()
    flight = obs_pkg.set_default_flight_recorder(obs_pkg.FlightRecorder(capacity=64))
    rs = serving_pkg.ReplicaSet(_factory(models, pkg), initial=1)
    router = serving_pkg.Router(rs, autoscaler=_auto(pkg, max_replicas=2, up_after=2,
                                                     down_after=3, cooldown_s=50.0))
    try:
        for _ in range(6):
            rs.get("r0").engine.slo.record(_Bad())
        scales = [router.tick(now=0.0)["scale"], router.tick(now=10.0)["scale"]]
        serving_after_up = sorted(r.replica_id for r in rs.serving())
        for rep in rs.serving():
            rep.engine.slo = ledger()
        down = None
        for t in (70.0, 80.0, 90.0, 100.0):
            scales.append(router.tick(now=t)["scale"])
            if scales[-1] == "down":
                down = t
                break
        victims = [r.replica_id for r in rs.replicas.values() if r.scale_down]
        deadline = time.monotonic() + 20
        while rs.get(victims[0]).state != "dead" and time.monotonic() < deadline:
            router.tick(now=down + 1.0)
            time.sleep(0.01)
        victim = rs.get(victims[0])
        return {"scales": scales, "after_up": serving_after_up, "victims": victims,
                "victim": (victim.state, victim.drained, victim.boot),
                "serving": sorted(r.replica_id for r in rs.serving()),
                "notes": [e.detail["direction"] for e in flight.events(kind="fleet_scale")],
                "autoscale": {k: v for k, v in router.replicas_doc()["autoscale"].items()
                              if k not in ("decisions", "last")}}
    finally:
        router.close()
        obs_pkg.set_default_flight_recorder(saved)


def test_router_tick_scales_as_the_jax_router_does(models):
    port, ref = _actuation_run(models, "port"), _actuation_run(models, "jax")
    assert port == ref
    assert port["scales"] == [None, "up", None, None, "down"]
    assert port["after_up"] == ["r0", "r1"] and len(port["serving"]) == 1
    assert port["victim"][:2] == ("dead", True) and port["notes"] == ["up", "down"]


def test_scale_down_victim_is_the_cheapest_replica(models):
    """The drain victim is the serving replica of lowest dispatch cost,
    in both packages."""
    victims = {}
    for pkg in PACKAGES:
        serving_pkg = PKG[pkg][1]
        rs = serving_pkg.ReplicaSet(_factory(models, pkg), initial=2)
        router = serving_pkg.Router(rs, autoscaler=_auto(pkg, max_replicas=2, down_after=1,
                                                         cooldown_s=0.0))
        try:
            rs.get("r0").load_score = lambda: 0.9
            assert router.tick(now=0.0)["scale"] == "down"
            victims[pkg] = [r.replica_id for r in rs.replicas.values() if r.scale_down]
        finally:
            router.close()
    assert victims["port"] == victims["jax"] == ["r1"]
