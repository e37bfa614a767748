"""The port's autotune (``utils/compiler.py``), the capturable optimizers
(``api/optim.py``) the captured step runs on, and the synchronous
trainer's epoch spans and gauges, on the CPU.

On the CPU there is one candidate, the eager step; the captured step
(``engine.step.CapturedStep``) runs only on a card, where
``chip_smoke.py``'s ``fit_slice`` phase holds it against the eager step
to the bit. Here: the A/B's contract with injected candidates (the
JAX package's ``test_spark_model.py`` autotune tests, ported), the
decision shared by a gloo group (``test_multihost.py``'s), the
capturable optimizers against the plain ones to the bit, and the
replay's split of a step into its host part (``advance``) and its
kernels, which lets one step serve every learning rate and every width
of a ``mlp_masked`` bucket (``test_hyperparam.py``'s
``test_masked_widths_share_one_executable``).
"""

import logging
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import make_blobs

import elephas_tpu_torch as et
from elephas_tpu_torch import obs
from elephas_tpu_torch.api.compile import resolve_optimizer
from elephas_tpu_torch.data.rdd import ShardedDataset
from elephas_tpu_torch.engine import async_engine, sync
from elephas_tpu_torch.engine import step as step_module
from elephas_tpu_torch.engine.async_engine import AsyncTrainer
from elephas_tpu_torch.engine.step import CapturedStep, build_train_step, init_train_state
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parallel.mesh import build_mesh
from elephas_tpu_torch.utils import compiler

NUM_CLASSES, DIM = 4, 20


def fresh_model(features=(32,), seed=0):
    return et.compile_model(get_model("mlp", device="cpu", features=features,
                                      num_classes=NUM_CLASSES),
                            optimizer={"name": "adam", "learning_rate": 0.01},
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(DIM,), seed=seed)


@pytest.fixture(scope="module")
def data():
    return make_blobs(n=512, num_classes=NUM_CLASSES, dim=DIM, seed=0)


# -- the A/B ----------------------------------------------------------------------


def test_autotune_helper_picks_the_faster_candidate():
    forced = []

    def build(opts):
        delay = 0.004 if opts == {"slow": "1"} else 0.0

        def fn():
            time.sleep(delay)
            return opts

        return fn

    winner, opts, table = compiler.autotune_compile_options(
        build, lambda fn: fn(), forced.append, steps=3,
        candidates=[("slow", {"slow": "1"}), ("fast", {"fast": "1"})])
    assert winner == "fast" and opts == {"fast": "1"}
    assert set(table) == {"slow", "fast"} and table["fast"] < table["slow"]
    # One warm force and one trailing force per candidate, never one per run.
    assert len(forced) == 4
    # Off the card the candidate list is singular: nothing to time.
    assert compiler.autotune_candidates("cpu") == [("default", None)]
    w, o, t = compiler.autotune_compile_options(build, lambda fn: fn(), forced.append,
                                                candidates=compiler.autotune_candidates("cpu"))
    assert (w, o, t) == ("default", None, {}) and len(forced) == 4


def test_candidates_on_a_card_are_eager_and_captured(monkeypatch):
    labels = [label for label, _ in compiler.autotune_candidates("cuda:0")]
    assert labels == ["default", "cuda_graph"]
    assert dict(compiler.autotune_candidates("cuda"))["cuda_graph"] is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compiler.autotune_candidates() == [("default", None)]
    assert compiler.note_retrace is obs.note_retrace


def test_autotune_spans_each_candidate():
    tracer = obs.enable_tracing(annotate_device=False)
    try:
        compiler.autotune_compile_options(lambda o: (lambda: o), lambda fn: fn(),
                                          lambda out: None, steps=2,
                                          candidates=[("a", None), ("b", {})])
        names = [e.name for e in tracer.events()]
    finally:
        obs.disable_tracing()
    assert names.count("compile/autotune:a") == names.count("compile/autotune:b") == 1


@pytest.mark.parametrize("mode", ["synchronous", "hogwild"])
def test_autotune_fit_records_choice(data, mode):
    x, y = data
    model = et.SparkModel(fresh_model(), mode=mode, frequency="epoch", autotune=True,
                          **({} if mode == "synchronous" else {"mesh": ["cpu"] * 2}))
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=16)
    assert history["compile_autotune"] == "default"
    assert model.last_autotune == {"winner": "default", "ms_per_2batch": {}}
    assert history["acc"][-1] > 0.8


def test_autotune_skip_paths_are_visible(data, caplog):
    x, y = data
    parity = et.SparkModel(fresh_model(), mode="synchronous", frequency="fit", autotune=True)
    with caplog.at_level(logging.WARNING):
        hist = parity.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=16)
    assert hist["compile_autotune"] == "skipped" and "frequency='fit'" in caplog.text
    streamed = et.SparkModel(fresh_model(), mode="synchronous", frequency="epoch",
                             autotune=True)
    hist2 = streamed.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=16,
                         stream_batches=2)
    assert hist2["compile_autotune"] == "skipped"
    # A partition smaller than 2 batches cannot be timed.
    trainer = AsyncTrainer(fresh_model(), ["cpu"], autotune=True)
    with caplog.at_level(logging.WARNING):
        trainer.fit(ShardedDataset(x[:16], y[:16], 1), epochs=1, batch_size=16)
    assert trainer.autotune_choice == {"winner": "skipped", "ms_per_2batch": {}}
    assert "smaller than 2 batches" in caplog.text
    plain = et.SparkModel(fresh_model(), mode="synchronous")
    assert "compile_autotune" not in plain.fit(et.to_simple_rdd(None, x, y), epochs=1,
                                               batch_size=16)
    assert plain.last_autotune is None


@pytest.mark.parametrize("mode", ["synchronous", "asynchronous"])
def test_autotuned_fit_equals_a_fit_built_with_the_winner(data, monkeypatch, mode):
    """The A/B trains clones, so the fit it chose a step for equals, to
    the bit, a fit of the winner with no A/B."""
    x, y = data
    calls = []
    real_build = build_train_step

    def build(compiled, options=None, pmean_axis=None):
        calls.append(options)
        return real_build(compiled, None, pmean_axis=pmean_axis)

    def fit(autotune):
        kwargs = {} if mode == "synchronous" else {"mesh": ["cpu"], "pipelined_comms": False}
        model = et.SparkModel(fresh_model(), mode=mode, frequency="batch",
                              autotune=autotune, **kwargs)
        history = model.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=32)
        return model.get_weights(), history

    want, want_history = fit(False)
    candidates = [("a", {"label": "a"}), ("b", {"label": "b"})]
    for module in (sync, async_engine):
        monkeypatch.setattr(module, "build_train_step", build)
        monkeypatch.setattr(module, "autotune_candidates", lambda device=None: candidates)
    got, history = fit(True)
    assert history.pop("compile_autotune") in ("a", "b")
    assert {"label": "a"} in calls and {"label": "b"} in calls
    assert history == want_history
    for name, value in want.items():
        assert torch.equal(value, got[name]), name


def test_autotune_on_several_ranks_cards_keeps_the_eager_step(data, monkeypatch, caplog):
    """Capture under the 'batch' step's NCCL all-reduce is not checked on
    cards: a fit of several ranks on cards times the eager step alone and
    says why, in the log, the choice and the history."""
    x, y = data
    trainer = sync.SyncTrainer(fresh_model(), build_mesh(), frequency="batch", autotune=True)
    xs = torch.as_tensor(x[:32]).reshape(2, 16, -1)
    ys = torch.as_tensor(y[:32]).reshape(2, 16, -1)
    built = []
    with monkeypatch.context() as patch, caplog.at_level(logging.WARNING):
        patch.setattr(sync.SyncTrainer, "device", torch.device("cuda"))
        patch.setattr(trainer, "mesh", SimpleNamespace(size=2, rank=0))
        patch.setattr(sync, "decide_autotune", lambda local, mesh=None: local)
        patch.setattr(sync, "autotune_candidates",
                      lambda device=None: [("default", None), ("cuda_graph", True)])
        patch.setattr(sync, "build_train_step",
                      lambda *args, **kwargs: built.append(args) or (lambda s, x, y: None))
        trainer._run_autotune(xs, ys)
    assert trainer.autotune_choice == {"winner": "default", "ms_per_2batch": {},
                                       "note": sync._MULTI_RANK_EAGER}
    assert not built and "NCCL" in caplog.text

    def noted(self, xs, ys):
        self.autotune_choice = {"winner": "default", "ms_per_2batch": {}, "note": "why"}

    monkeypatch.setattr(sync.SyncTrainer, "_run_autotune", noted)
    history = et.SparkModel(fresh_model(), mode="synchronous", autotune=True).fit(
        et.to_simple_rdd(None, x, y), epochs=1, batch_size=16)
    assert (history["compile_autotune"], history["compile_autotune_note"]) == ("default", "why")


def test_decide_autotune_is_the_local_outcome_alone():
    outcome = ("default", None, {})
    assert sync.decide_autotune(outcome) is outcome
    assert sync.decide_autotune(outcome, build_mesh()) is outcome


def test_autotune_decision_is_group_wide(tmp_path):
    """Two gloo ranks: ``decide_autotune`` gives both rank 0's outcome,
    and a fit whose candidates time faster on different ranks trains
    every rank with rank 0's winner; an autotuned fit leaves both ranks
    with the same recorded choice and weights."""
    x, y = make_blobs(n=128, num_classes=NUM_CLASSES, dim=DIM, seed=1)
    np.savez(tmp_path / "data.npz", x=x, y=y)
    torch.save(fresh_model(features=(8,)).module.state_dict(), tmp_path / "w.pt")
    jobs = [{"kind": "autotune", "data": str(tmp_path / "data.npz"),
             "out": str(tmp_path / "decide")},
            {"data": str(tmp_path / "data.npz"), "weights": str(tmp_path / "w.pt"),
             "model": "mlp", "kwargs": {"features": [8], "num_classes": NUM_CLASSES},
             "optimizer": {"name": "adam", "learning_rate": 0.01},
             "loss": "categorical_crossentropy", "frequency": "batch", "epochs": 2,
             "batch_size": 16, "eval_batch": 64, "autotune": True, "all_ranks": True,
             "out": str(tmp_path / "fit")}]
    results = _spawn_all(tmp_path, jobs)
    decided = [results[("decide", r)]["decided"] for r in range(2)]
    assert decided == [("winner0", {"rank": 0}, {"winner0": 0.0})] * 2
    choices = [results[("decide", r)]["choice"] for r in range(2)]
    assert [c["winner"] for c in choices] == ["fast", "fast"]
    assert choices[0] == choices[1]
    fits = [results[("fit", r)] for r in range(2)]
    assert fits[0]["autotune"] == fits[1]["autotune"] == {"winner": "default",
                                                          "ms_per_2batch": {}}
    assert fits[0]["history"] == fits[1]["history"]
    for name, value in fits[0]["weights"].items():
        assert torch.equal(value, fits[1]["weights"][name]), name


def _spawn_all(tmp_path, jobs):
    """Run ``jobs`` on 2 gloo ranks; every rank's results by (tag, rank)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    config = tmp_path / "config.json"
    config.write_text(json.dumps({"store": str(tmp_path / "store"), "world": 2,
                                  "jobs": jobs}))
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    worker = Path(__file__).resolve().parent / "test_torch_dist_worker.py"
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(config), str(r)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=root)
             for r in range(2)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    assert codes == [0, 0], [(tmp_path / f"rank{r}.log").read_text()[-3000:] for r in range(2)]
    return {(Path(job["out"]).name, r): torch.load(f"{job['out']}.rank{r}", weights_only=False)
            for job in jobs for r in range(2)}


# -- the captured step's parts on the CPU ------------------------------------------


OPTIMIZERS = ["sgd", "momentum", "adam", "adamw", "rmsprop", "adagrad", "lamb"]
LEARNING_RATES = {"constant": 0.02,
                  "cosine": {"schedule": "cosine_decay", "init_value": 0.02, "decay_steps": 4}}


def _optimizer_run(name, lr, mode, extra=None, steps=6):
    """``steps`` updates of two seeded tensors with seeded gradients:
    ``plain``, ``capturable``, or ``replay`` (a captured step's protocol:
    ``advance`` on the host, then the kernels alone under ``in_graph``)."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(5, 3)), torch.nn.Parameter(torch.randn(4))]
    builder, _ = resolve_optimizer({"name": name, "learning_rate": lr, **(extra or {})})
    opt = builder(params)
    if mode != "plain":
        opt.capturable()
    gen = torch.Generator().manual_seed(1)
    scalars = None
    for _ in range(steps):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        if mode == "replay":
            opt.advance()
            with opt.in_graph():
                opt.step()
            ptrs = [t.data_ptr() for t in opt._device_scalars[0].values()]
            assert scalars is None or ptrs == scalars  # filled in place
            scalars = ptrs
        else:
            opt.step()
    state = {k: v.clone() for s in opt.state.values() for k, v in s.items()}
    return [p.detach().clone() for p in params], state, opt.param_groups[0]["count"]


@pytest.mark.parametrize("lr", sorted(LEARNING_RATES))
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_capturable_optimizers_equal_plain_to_the_bit(name, lr):
    want = _optimizer_run(name, LEARNING_RATES[lr], "plain")
    for mode in ("capturable", "replay"):
        got = _optimizer_run(name, LEARNING_RATES[lr], mode)
        assert all(torch.equal(a, b) for a, b in zip(want[0], got[0])), mode
        assert want[1].keys() == got[1].keys()
        assert all(torch.equal(want[1][k], got[1][k]) for k in want[1]), mode
        assert want[2] == got[2] == 6


@pytest.mark.parametrize("name,extra", [
    ("adam", {"nesterov": True}),
    ("rmsprop", {"bias_correction": True, "centered": True, "momentum": 0.9}),
    ("momentum", {"nesterov": True}),
])
def test_capturable_variants_equal_plain_to_the_bit(name, extra):
    want = _optimizer_run(name, LEARNING_RATES["cosine"], "plain", extra)
    got = _optimizer_run(name, LEARNING_RATES["cosine"], "replay", extra)
    assert all(torch.equal(a, b) for a, b in zip(want[0], got[0]))


def test_in_graph_needs_a_capturable_optimizer():
    builder, _ = resolve_optimizer("sgd")
    opt = builder([torch.nn.Parameter(torch.ones(2))])
    with pytest.raises(RuntimeError, match="capturable"):
        with opt.in_graph():
            pass


def test_one_step_serves_every_width_and_lr_of_a_bucket():
    """The port's counterpart of ``test_masked_widths_share_one_executable``:
    one module and one capturable optimizer, stepped by the replay's
    protocol, train width 8 at lr 1e-2, then take width 5's weights, mask
    and lr 3e-3 in place (every address kept) and train it to the bit
    as a fresh width-5 model does."""
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(8, 6)).astype(np.float32))
    y = torch.as_tensor(np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=8)])

    def build(active, lr):
        return et.compile_model(
            get_model("mlp_masked", device="cpu", features=(32,), active=(active,),
                      num_classes=3),
            optimizer={"name": "adam", "learning_rate": lr, "injected": True},
            loss="categorical_crossentropy", metrics=[], input_shape=(6,), seed=1)

    def replay_steps(compiled, state, n):
        step = step_module.make_train_step(compiled)
        for _ in range(n):
            state.optimizer.advance()
            with state.optimizer.in_graph():
                state, metrics = step(state, x, y)
        return float(metrics["loss"])

    shared = build(8, 1e-2)
    state = init_train_state(shared)
    state.optimizer.capturable()
    replay_steps(shared, state, 3)
    addresses = [t.data_ptr() for t in shared.module.state_dict().values()]
    fresh = build(5, 3e-3)
    shared.module.load_state_dict(fresh.module.state_dict())
    with torch.no_grad():
        for per_param in state.optimizer.state.values():
            for value in per_param.values():
                value.zero_()
    group = state.optimizer.param_groups[0]
    group["count"], group["lr"] = 0, 3e-3
    got_loss = replay_steps(shared, state, 3)
    assert [t.data_ptr() for t in shared.module.state_dict().values()] == addresses
    want_state = init_train_state(fresh)
    plain = step_module.make_train_step(fresh)
    for _ in range(3):
        want_state, metrics = plain(want_state, x, y)
    assert got_loss == float(metrics["loss"])
    for name, value in fresh.module.state_dict().items():
        assert torch.equal(value, shared.module.state_dict()[name]), name


def test_captured_step_needs_a_card():
    with pytest.raises(ValueError, match="card"):
        CapturedStep(fresh_model(), step_module.make_train_step(fresh_model()))
    with pytest.raises(ValueError, match="card"):
        build_train_step(fresh_model(), capture=True)


# -- the epoch loop's observability -------------------------------------------------


@pytest.mark.parametrize("stream", [None, 4])
def test_sync_fit_records_epoch_spans_and_gauges(data, stream):
    x, y = data
    registry = obs.default_registry()
    hist = registry.histogram("train_epoch_seconds",
                              help="wall seconds per dispatched training epoch")
    before = hist.count
    tracer = obs.enable_tracing(annotate_device=False)
    try:
        model = et.SparkModel(fresh_model(), mode="synchronous", frequency="batch")
        start = model.get_weights()
        model.fit(et.to_simple_rdd(None, x, y), epochs=2, batch_size=32,
                  validation_data=(x[:64], y[:64]), stream_batches=stream)
        events = tracer.events()
    finally:
        obs.disable_tracing()
    epochs = [e for e in events if e.name == "train/epoch"]
    assert [e.args["epoch"] for e in epochs] == [0, 1]
    assert {e.args["mode"] for e in epochs} == {"sync" if stream is None else "sync-stream"}
    assert [e.args["epoch"] for e in events if e.name == "train/eval"] == [0, 1]
    assert hist.count == before + 2
    assert epochs[-1].args["delta_norm"] > 0 and epochs[-1].args["effective_step"] > 0
    gauge = registry.gauge("train_unit_loss", help="last per-unit training loss",
                           labelnames=("worker",)).labels(worker="driver")
    assert gauge.value == pytest.approx(model.training_histories[-1]["loss"][-1])
    # The first epoch's recorded norm is the parameters' at the start.
    weights = [v for k, v in start.items() if k in dict(model.master_network.module
                                                         .named_parameters())]
    norm = float(torch.linalg.vector_norm(torch.cat([w.reshape(-1) for w in weights])))
    assert epochs[0].args["delta_norm"] / epochs[0].args["effective_step"] == \
        pytest.approx(norm, rel=1e-5)


def test_sync_trainer_mount_ops_names_item_7():
    trainer = sync.SyncTrainer(fresh_model(), build_mesh())
    with pytest.raises(NotImplementedError, match="item 7"):
        trainer.mount_ops()
