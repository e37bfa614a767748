"""The port's elastic ASHA tuner (``elephas_tpu_torch/tune``) held against
the JAX package's: digests string-equal, the same sampled trials, the
same halving decisions for the same result sequence, vault round trips
(tensor and NumPy trees; ``GroupVault`` on real port servers), and
``run_search`` documents equal to the JAX package's at 1, 2 and 3 pool
workers and under a worker kill."""

import contextlib
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from elephas_tpu import resilience as jax_resilience
from elephas_tpu import tune as jax_tune
from elephas_tpu.obs import FlightRecorder as JaxFlightRecorder
from elephas_tpu.obs import MetricsRegistry as JaxMetricsRegistry
from elephas_tpu.tune import cli as jax_cli
from elephas_tpu.tune import trial as jax_trial
from elephas_tpu_torch.obs import FlightRecorder, MetricsRegistry
from elephas_tpu_torch.obs.flight import KINDS
from elephas_tpu_torch.parameter.server import make_server
from elephas_tpu_torch import tune as port_tune
from elephas_tpu_torch.resilience import FaultInjector, FaultPlan
from elephas_tpu_torch.tune import (
    AshaScheduler,
    GroupVault,
    MemoryVault,
    TrialSpec,
    hp,
    run_search,
    sample_trials,
)
from elephas_tpu_torch.tune import cli, scheduler as port_scheduler, trial
from elephas_tpu_torch.tune.runner import TuneRunner, _diff_norm


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- digests and sampled trials --------------------------------------------------

PAYLOADS = [
    {"trial": 3, "seed": 12345, "config": {"lr": 0.001, "width": 64}},
    {"trial": 0, "seed": 2**40, "config": {"lr": np.float64(0.1) / 3, "width": np.int64(128),
                                             "layers": (np.int32(2), "relu"), "b": [1.5, None]}},
    {"nested": {"z": {"y": [np.float32(0.25), True]}, "a": "x"}, "n": -0.0},
]


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("n", [12, 64])
def test_canonical_digest_string_equal_to_jax(payload, n):
    got = trial.canonical_digest(payload, n)
    assert isinstance(got, str) and len(got) == n
    assert got == jax_trial.canonical_digest(payload, n)


SPACES = {
    "asha": {"lr": hp.loguniform(np.log(1e-3), np.log(0.9)), "width": hp.choice([32, 64, 128])},
    "mixed": {"lr": hp.uniform(0.0, 1.0), "q": hp.quniform(0.0, 0.5, 0.1),
              "layers": [hp.randint(3), "fixed"], "opt": hp.choice(["adam", "sgd"])},
}
JAX_SPACES = {
    "asha": {"lr": jax_tune.hp.loguniform(np.log(1e-3), np.log(0.9)),
             "width": jax_tune.hp.choice([32, 64, 128])},
    "mixed": {"lr": jax_tune.hp.uniform(0.0, 1.0), "q": jax_tune.hp.quniform(0.0, 0.5, 0.1),
              "layers": [jax_tune.hp.randint(3), "fixed"],
              "opt": jax_tune.hp.choice(["adam", "sgd"])},
}


@pytest.mark.parametrize("space", sorted(SPACES))
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_trials_equal_jax(space, seed):
    port = sample_trials(SPACES[space], 9, seed)
    ref = jax_tune.sample_trials(JAX_SPACES[space], 9, seed)
    assert [(t.trial_id, t.seed, t.digest, t.config, t.values) for t in port] == \
        [(t.trial_id, t.seed, t.digest, t.config, t.values) for t in ref]
    assert len({t.seed for t in port}) == 9


# -- AshaScheduler against the JAX package ----------------------------------------


def _scheds(n=9, **kw):
    kw.setdefault("eta", 3)
    kw.setdefault("rungs", 3)
    kw.setdefault("r0", 1)
    port = AshaScheduler([TrialSpec(i, {"tid": i}, seed=i) for i in range(n)],
                         clock=FakeClock(), registry=MetricsRegistry(),
                         flight=FlightRecorder(capacity=256), **kw)
    ref = jax_tune.AshaScheduler([jax_tune.TrialSpec(i, {"tid": i}, seed=i) for i in range(n)],
                                 clock=FakeClock(), registry=JaxMetricsRegistry(),
                                 flight=JaxFlightRecorder(capacity=256), **kw)
    return port, ref


def _drive(sched, order, loss, extra=()):
    """Feed rung-0 results in ``order`` and every promotion they unlock
    (breadth first); ``extra`` results (zombie duplicates) go in after."""
    log = []
    work = [(0, t) for t in order]
    while work:
        rung, tid = work.pop(0)
        sched.on_lease(tid, rung, "w0")
        res = sched.on_result(tid, rung, loss(tid, rung), None)
        log.append(res)
        work.extend(res["promotions"])
    for tid, rung, value, delta_norm in extra:
        log.append(sched.on_result(tid, rung, value, delta_norm))
    winner = sched.finalize()
    return log, sched.counts(), sched.epochs_spent, sched.search_digest(), \
        (winner.spec.digest, winner.rung_loss) if winner else None, sched.snapshot()


ORDERS = {
    "ascending": (list(range(9)), lambda t, r: t / 10.0 + r),
    "descending": (list(reversed(range(9))), lambda t, r: t / 10.0 + r),
    "straggler": ([*range(1, 9), 0], lambda t, r: t / 10.0 / (1 + r)),
    "shuffled": ([4, 7, 1, 8, 0, 3, 6, 2, 5], lambda t, r: ((t * 37) % 11) / 7.0 - r),
    "ties": ([2, 0, 1, 5, 4, 3, 8, 7, 6], lambda t, r: float(t % 3)),
}


@pytest.mark.parametrize("name", sorted(ORDERS))
def test_asha_decisions_equal_jax(name):
    order, loss = ORDERS[name]
    extra = [(0, 0, 0.01, None), (order[0], 0, -1.0, 2.0)]  # zombie re-reports
    port, ref = _scheds()
    assert _drive(port, order, loss, extra) == _drive(ref, order, loss, extra)


@pytest.mark.parametrize("plateau", [None, 1e-3])
def test_asha_plateau_and_delta_norms_equal_jax(plateau):
    port, ref = _scheds(plateau_delta_norm=plateau)
    out = []
    for sched in (port, ref):
        log = [sched.on_result(t, 0, 0.5 - t / 100.0, 10.0 ** -(t % 6)) for t in range(9)]
        out.append((log, sched.counts(), sched.epochs_spent, sched.search_digest()))
    assert out[0] == out[1]


def test_asha_rung_geometry_and_validation():
    port, _ = _scheds(r0=2)
    assert [port.cumulative_epochs(r) for r in range(3)] == [2, 6, 18]
    assert [port.rung_epochs(r) for r in range(3)] == [2, 4, 12]
    assert port.full_budget() == 18 and port.initial_units() == [(0, t) for t in range(9)]
    for bad in (dict(eta=1), dict(rungs=0)):
        with pytest.raises(ValueError):
            _scheds(**bad)


def test_asha_stall_detection_on_fake_clock():
    clock = FakeClock()
    sched = AshaScheduler([TrialSpec(i, {"tid": i}, seed=i) for i in range(9)],
                          clock=clock, stall_after=30.0, registry=MetricsRegistry(),
                          flight=FlightRecorder(capacity=16))
    sched.on_lease(3, 0, "w0")
    assert sched.stalled() == []
    clock.advance(31.0)
    assert sched.stalled() == [3]
    sched.on_result(3, 0, 0.3)
    assert sched.stalled() == []


def test_asha_counters_on_the_port_registry():
    reg = MetricsRegistry()
    sched = AshaScheduler([TrialSpec(i, {"tid": i}, seed=i) for i in range(9)],
                          clock=FakeClock(), registry=reg, flight=FlightRecorder(capacity=64))
    _drive(sched, list(range(9)), lambda t, r: t / 10.0 + r)
    text = reg.expose_text()
    for name in ("tune_trials_running", "tune_trials_completed_total",
                 "tune_trials_pruned_total", "tune_trials_promoted_total", "tune_epochs_total"):
        assert name in text
    assert isinstance(port_scheduler.locksan.make_lock("x"), type(sched._lock))


# -- vaults ------------------------------------------------------------------------


def _trees():
    numpy_tree = {"x": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
                  "steps": np.asarray(12.0), "ids": np.arange(3, dtype=np.int64)}
    tensor_tree = {"hidden.0.weight": torch.randn(4, 3, generator=torch.Generator()
                                                  .manual_seed(0)) / 3,
                   "mask_0": torch.tensor([1.0, 1.0, 0.0, 0.0]),
                   "half": torch.tensor([0.1, 0.7], dtype=torch.bfloat16),
                   "count": torch.tensor(5, dtype=torch.int64)}
    return numpy_tree, tensor_tree


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert torch.equal(got[k], v)
        else:
            assert isinstance(got[k], np.ndarray)
            assert got[k].dtype == np.asarray(v).dtype and got[k].shape == np.shape(v)
            np.testing.assert_array_equal(got[k], v)


def test_memory_vault_roundtrips_tensor_and_numpy_trees():
    vault = MemoryVault()
    assert vault.load(0) is None
    numpy_tree, tensor_tree = _trees()
    vault.save(0, rung=1, loss=0.25, state=numpy_tree)
    vault.save(1, rung=2, loss=0.125, state=tensor_tree)
    c0, c1 = vault.load(0), vault.load(1)
    assert (c0.rung, c0.loss, c1.rung, c1.loss) == (1, 0.25, 2, 0.125)
    _assert_same_tree(c0.state, numpy_tree)
    _assert_same_tree(c1.state, tensor_tree)
    # Loaded leaves are writable copies (a resumed trial trains in place).
    c0.state["x"][0, 0] = 99.0
    c1.state["mask_0"][0] = 7.0
    _assert_same_tree(vault.load(0).state, numpy_tree)
    _assert_same_tree(vault.load(1).state, tensor_tree)


@pytest.fixture(params=["local", "socket"])
def vault_server(request):
    numpy_tree, tensor_tree = _trees()
    template = {"a": numpy_tree, "b": tensor_tree}
    store = GroupVault.build_store([0, 1, 2], template)
    server = make_server(request.param, store, port=0, device="cpu")
    server.start()
    yield server, template
    server.stop()


def test_group_vault_on_a_port_server(vault_server):
    server, template = vault_server
    vault = GroupVault(server.client())
    assert vault.load(0) is None  # rung=-1 sentinel
    numpy_tree, tensor_tree = _trees()
    rng = np.random.default_rng(3)
    s0 = {"a": {k: (v + rng.normal(size=np.shape(v))).astype(v.dtype)
                for k, v in numpy_tree.items()},
          "b": {k: v * 3 - 1 for k, v in tensor_tree.items()}}
    s1 = {"a": numpy_tree, "b": tensor_tree}
    vault.save(0, 0, 0.5, s0)
    vault.save(1, 1, 1 / 3, s1)          # disjoint trials compose
    vault.save(0, 2, 0.1, s1)            # overwriting rounds nothing: bitwise
    vault.save(2, 0, 0.7, s0)
    c0, c1, c2 = vault.load(0), vault.load(1), vault.load(2)
    assert (c0.rung, c0.loss) == (2, 0.1)
    assert (c1.rung, c1.loss) == (1, 1 / 3)
    assert (c2.rung, c2.loss) == (0, 0.7)
    for got, want in ((c0, s1), (c1, s1), (c2, s0)):
        _assert_same_tree(got.state["a"], want["a"])
        _assert_same_tree(got.state["b"], want["b"])
    # The rung and loss leaves are float64 on the server; a fresh vault
    # (one that did not save) reads NumPy leaves, as the JAX package.
    slot = server.client().get_parameters()["t0"]
    assert slot["rung"].dtype == slot["loss"].dtype == torch.float64
    fresh = GroupVault(server.client()).load(1)
    assert isinstance(fresh.state["b"]["mask_0"], np.ndarray)
    assert fresh.state["b"]["half"].dtype == torch.bfloat16  # NumPy has no bfloat16
    np.testing.assert_array_equal(fresh.state["a"]["x"], numpy_tree["x"])


class _Interleaved:
    """A client whose first ``update_parameters`` runs ``between()`` right
    after it lands: a load from another vault between a save's pushes."""

    def __init__(self, client, between):
        self._client, self._between, self.seen = client, between, []

    def get_parameters(self):
        return self._client.get_parameters()

    def update_parameters(self, delta):
        self._client.update_parameters(delta)
        if self._between is not None:
            between, self._between = self._between, None
            self.seen.append(between())


def test_group_vault_load_during_a_save_sees_old_new_or_none(vault_server):
    """Another vault loading between a save's two pushes gets "no
    checkpoint", never rung 0 with loss 0.0 and zeroed state, nor a mix;
    before and after, the old and the new checkpoint, bitwise."""
    server, _ = vault_server
    numpy_tree, tensor_tree = _trees()
    old = {"a": numpy_tree, "b": tensor_tree}
    new = {"a": {k: (v * 2 + 1).astype(v.dtype) for k, v in numpy_tree.items()},
           "b": {k: v * 3 - 1 for k, v in tensor_tree.items()}}
    reader = GroupVault(server.client())
    for trial, before in ((0, None), (1, (0, 0.5))):
        if before is not None:
            GroupVault(server.client()).save(trial, *before, old)
            assert (reader.load(trial).rung, reader.load(trial).loss) == before
        client = _Interleaved(server.client(), lambda trial=trial: reader.load(trial))
        writer = GroupVault(client)
        writer.save(trial, 2, 1.25, new)
        assert client.seen == [None]
        after = writer.load(trial)
        assert (after.rung, after.loss) == (2, 1.25)
        _assert_same_tree(after.state["a"], new["a"])
        _assert_same_tree(after.state["b"], new["b"])


def test_runner_trains_a_rung_whose_save_is_in_flight():
    """A zombie re-saving trial 0 while the runner leases its rung 0: the
    runner's load sees no checkpoint and trains the rung (with the old
    two-push save it read rung 0, loss 0.0 and reused it untrained)."""
    template = {"steps": torch.tensor(0.0, dtype=torch.float64)}
    server = make_server("local", GroupVault.build_store(range(6), template), device="cpu")
    server.start()
    trained = []

    def recording(config, state, epochs, seed, rung):
        trained.append((config["tid"], rung))
        return _staircase(config, state, epochs, seed, rung)

    try:
        runner, _ = _runner(recording, vault=GroupVault(server.client()))
        zombie = GroupVault(_Interleaved(server.client(), runner.run))
        zombie.save(0, 0, 9.0, {"steps": torch.tensor(7.0, dtype=torch.float64)})
        doc = zombie._client.seen[0]
    finally:
        server.stop()
    assert (0, 0) in trained
    clean = _runner(_staircase)[0].run()
    assert (doc["winner_digest"], doc["best_loss"]) == (clean["winner_digest"],
                                                        clean["best_loss"])


def test_group_vault_store_matches_jax_layout():
    numpy_tree, _ = _trees()
    port = GroupVault.build_store([0, 4], numpy_tree)
    ref = jax_tune.GroupVault.build_store([0, 4], numpy_tree)
    assert list(port) == list(ref) == ["t0", "t4"]
    for key in port:
        for k in ("rung", "loss"):
            assert port[key][k] == ref[key][k] and port[key][k].dtype == ref[key][k].dtype
        for k, v in ref[key]["state"].items():
            assert port[key]["state"][k].dtype == v.dtype
            np.testing.assert_array_equal(port[key]["state"][k], v)


def test_diff_norm_over_tensor_and_numpy_leaves():
    a = {"w": torch.tensor([3.0, 4.0]), "n": np.array([1, 2]), "flag": torch.tensor([True])}
    b = {"w": torch.tensor([0.0, 0.0]), "n": np.array([1, 2]), "flag": torch.tensor([False])}
    assert _diff_norm(a, b) == pytest.approx(5.0)
    assert _diff_norm(a, None) == pytest.approx((9 + 16 + 1 + 4) ** 0.5)


# -- run_search against the JAX package ----------------------------------------------


def _space(pkg):
    return {"lr": pkg.hp.loguniform(np.log(1e-3), np.log(0.9)),
            "width": pkg.hp.choice([32, 64, 128])}


def _quiet():
    return dict(registry=MetricsRegistry(), flight=FlightRecorder(capacity=512))


def _jax_quiet():
    return dict(registry=JaxMetricsRegistry(), flight=JaxFlightRecorder(capacity=512))


def _doc_core(doc):
    return {k: doc[k] for k in ("winner_digest", "search_digest", "best_loss", "counts",
                                "epochs_spent", "full_budget_epochs", "lost_trials",
                                "pruned_frac", "trials")} | {"winner": doc["winner"]}


def _recording(monkeypatch):
    """Record every result the port's scheduler receives, in order."""
    arrivals = []
    original = port_scheduler.AshaScheduler.on_result

    def on_result(self, trial_id, rung, loss, delta_norm=None):
        arrivals.append((trial_id, rung, loss, delta_norm))
        return original(self, trial_id, rung, loss, delta_norm)

    monkeypatch.setattr(port_scheduler.AshaScheduler, "on_result", on_result)
    return arrivals


def _jax_replay(arrivals, seed, trials=9):
    """The JAX package's scheduler fed the port's arrival sequence."""
    specs = jax_tune.sample_trials(_space(jax_tune), trials, seed)
    sched = jax_tune.AshaScheduler(specs, eta=3, rungs=3, r0=1, **_jax_quiet())
    for tid, rung, loss, delta_norm in arrivals:
        sched.on_lease(tid, rung, "w0")
        sched.on_result(tid, rung, loss, delta_norm)
    sched.finalize()
    return sched


def test_run_search_one_worker_doc_equals_jax():
    port = run_search(cli.synthetic_trial_fn, _space(port_tune), num_trials=9, seed=4,
                      workers=1, **_quiet())
    ref = jax_tune.run_search(jax_cli.synthetic_trial_fn, _space(jax_tune), num_trials=9,
                              seed=4, workers=1, **_jax_quiet())
    assert _doc_core(port) == _doc_core(ref)
    assert port["lost_trials"] == 0 and port["pool"]["worker_deaths"] == 0


@pytest.mark.parametrize("workers", [2, 3])
def test_run_search_doc_equals_jax_across_pool_widths(monkeypatch, workers):
    """Pool threads interleave differently run to run, so which marginal
    trials climb may differ; the winner and search digests may not, and
    the counts and epochs are the JAX scheduler's for the same arrival
    sequence."""
    arrivals = _recording(monkeypatch)
    port = run_search(cli.synthetic_trial_fn, _space(port_tune), num_trials=9, seed=4,
                      workers=workers, **_quiet())
    ref = jax_tune.run_search(jax_cli.synthetic_trial_fn, _space(jax_tune), num_trials=9,
                              seed=4, workers=workers, **_jax_quiet())
    assert (port["winner_digest"], port["search_digest"], port["best_loss"]) == \
        (ref["winner_digest"], ref["search_digest"], ref["best_loss"])
    replay = _jax_replay(arrivals, seed=4)
    assert port["counts"] == replay.counts()
    assert port["epochs_spent"] == replay.epochs_spent
    assert port["search_digest"] == replay.search_digest()
    assert port["lost_trials"] == ref["lost_trials"] == 0


def _slow(fn):
    """``fn`` taking a while per epoch, its first call held until a second
    runs beside it: both pool workers hold a unit, so w1 reaches the kill
    plan's site (its second unit) however the threads are scheduled."""
    lock, calls = threading.Lock(), [0]

    def trial_fn(config, state, epochs, seed, rung):
        with lock:
            calls[0] += 1
        deadline = time.monotonic() + 10.0
        while calls[0] < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.003 * int(epochs))
        return fn(config, state, epochs, seed, rung)

    return trial_fn


def test_run_search_under_a_kill_plan_equals_jax(monkeypatch):
    arrivals = _recording(monkeypatch)
    plan = FaultPlan(seed=4, kill_worker_at={"w1": 1})
    port = run_search(_slow(cli.synthetic_trial_fn), _space(port_tune), num_trials=9,
                      seed=4, workers=2, injector=FaultInjector(plan), **_quiet())
    jax_plan = jax_resilience.FaultPlan(seed=4, kill_worker_at={"w1": 1})
    ref = jax_tune.run_search(_slow(jax_cli.synthetic_trial_fn), _space(jax_tune),
                              num_trials=9, seed=4, workers=2,
                              injector=jax_resilience.FaultInjector(jax_plan), **_jax_quiet())
    clean = jax_tune.run_search(jax_cli.synthetic_trial_fn, _space(jax_tune), num_trials=9,
                                seed=4, workers=1, **_jax_quiet())
    assert port["pool"]["worker_deaths"] == ref["pool"]["worker_deaths"] == 1
    assert plan.trace_digest() == jax_plan.trace_digest()
    assert port["lost_trials"] == ref["lost_trials"] == 0
    assert (port["winner_digest"], port["search_digest"]) == \
        (ref["winner_digest"], ref["search_digest"]) == \
        (clean["winner_digest"], clean["search_digest"])
    replay = _jax_replay(arrivals, seed=4)
    assert (port["counts"], port["epochs_spent"]) == (replay.counts(), replay.epochs_spent)


def _staircase(config, state, epochs, seed, rung):
    """Deterministic, resumable: loss = (tid+1) / (1 + total steps)."""
    steps = float(state["steps"]) if state is not None else 0.0
    steps += float(epochs)
    return {"loss": (config["tid"] + 1) / (1.0 + steps),
            "state": {"steps": torch.tensor(steps, dtype=torch.float64)}}


def _runner(trial_fn, n=6, vault=None):
    specs = [TrialSpec(i, {"tid": i}, seed=i) for i in range(n)]
    sched = AshaScheduler(specs, eta=3, rungs=3, r0=1, **_quiet())
    return TuneRunner(trial_fn, sched, vault=vault or MemoryVault(),
                      worker_ids=("w0", "w1"), **_quiet()), sched


def test_resume_from_rung_after_worker_death():
    clean = _runner(_staircase)[0].run()
    armed = {"live": True}

    def killing(config, state, epochs, seed, rung):
        if armed["live"] and config["tid"] == 0 and rung == 1:
            armed["live"] = False
            raise RuntimeError("injected mid-rung death")
        return _staircase(config, state, epochs, seed, rung)

    runner, sched = _runner(killing)
    chaos = runner.run()
    assert chaos["pool"]["worker_deaths"] == 1 and chaos["pool"]["requeued_units"] >= 1
    assert chaos["lost_trials"] == 0 and sched.trials[0].resumed >= 1
    assert len([o for o in sched.trials[0].owners if o[0] == 1]) == 2
    assert (chaos["winner_digest"], chaos["search_digest"], chaos["best_loss"]) == \
        (clean["winner_digest"], clean["search_digest"], clean["best_loss"])
    snap = runner.trials_snapshot()
    assert set(snap) >= {"eta", "rungs", "r0", "counts", "epochs_spent", "best",
                         "search_digest", "trials", "units"}


def test_run_search_counters_flight_and_group_vault():
    """End to end with a GroupVault on a port local server: every trial
    reaches a verdict, the counters land in the registry, and the flight
    events stay inside the registered vocabulary."""
    specs = sample_trials(_space(port_tune), 9, 3)
    template = cli.synthetic_trial_fn(specs[0].config, None, 1, specs[0].seed, 0)["state"]
    server = make_server("local", GroupVault.build_store(range(9), template), device="cpu")
    server.start()
    reg, flight = MetricsRegistry(), FlightRecorder(capacity=512)
    try:
        doc = run_search(cli.synthetic_trial_fn, _space(port_tune), num_trials=9, seed=3,
                         workers=2, vault=GroupVault(server.client()), registry=reg,
                         flight=flight)
    finally:
        server.stop()
    ref = jax_tune.run_search(jax_cli.synthetic_trial_fn, _space(jax_tune), num_trials=9,
                              seed=3, workers=1, **_jax_quiet())
    assert (doc["winner_digest"], doc["search_digest"]) == \
        (ref["winner_digest"], ref["search_digest"])
    assert doc["counts"]["pruned"] + doc["counts"]["completed"] == 9
    assert 0 < doc["epochs_spent"] < doc["full_budget_epochs"]
    text = reg.expose_text()
    assert "tune_epochs_total" in text and "tune_trials_promoted_total" in text
    kinds = {e.kind for e in flight.events()}
    assert kinds <= set(KINDS) and {"trial_promoted", "trial_pruned"} <= kinds


def test_cli_json_doc_equals_jax():
    def run(main, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        return json.loads(out.getvalue())

    argv = ["--trials", "9", "--workers", "1", "--seed", "7", "--json"]
    port, ref = run(cli.main, argv), run(jax_cli.main, argv)
    assert _doc_core(port) == _doc_core(ref)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli.main(["--workers", "2"])
    assert "search_digest:" in text.getvalue()
