"""One rank of the port's multi-process parity runs (``test_torch_fit.py``,
``test_torch_hyperparam.py``); a script, not a test module: it holds no
tests.

    python tests/test_torch_dist_worker.py CONFIG.json RANK

Joins a gloo group on the CPU (``file://`` store, world size and rank
from the arguments), then runs each job of the config. A fit job runs
``SparkModel(mode="synchronous").fit`` (with the job's
``stream_batches`` and ``autotune`` where given), ``evaluate`` and
``predict`` and, on rank 0 (on every rank with ``"all_ranks"``), saves
the history, the final weights, the recorded autotune choice, and the
evaluation and predictions on all rows but the last two, with
``torch.save``. An autotune job (``"kind": "autotune"``) calls
``decide_autotune`` with a different outcome on each rank, then fits a
``SyncTrainer(autotune=True)`` whose two injected candidates time
faster on different ranks, and saves what every rank adopted. A
``"search_devices"`` job runs ``HyperParamModel(None)`` on a faked host
of several cards and saves the devices and slots each rank took. A search
job (``"kind": "search"``) runs ``HyperParamModel(device="cpu",
num_workers=...).minimize`` with ``search_objective``, a ``SyncTrainer``
fit per trial, and saves, from every rank, its trials, the winner it
returns and the winner's weights.
Imports the port only, no JAX.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def _run(job, rank):
    import elephas_tpu_torch as et
    from elephas_tpu_torch.engine import sync
    from elephas_tpu_torch.models import get_model

    data = np.load(job["data"])
    x, y = data["x"], data["y"]
    if job.get("perms"):
        perms = np.load(job["perms"])  # (epochs, shards, rows): the JAX package's orders

        def table(seed, epoch, shard, n):
            return torch.as_tensor(perms[epoch, shard][:n])

        sync.shard_permutation = table
    module = get_model(job["model"], device="cpu", **job["kwargs"])
    compiled = et.CompiledModel(module, torch.load(job["weights"]), optimizer=job["optimizer"],
                               loss=job["loss"], metrics=["acc"])
    model = et.SparkModel(compiled, mode="synchronous", frequency=job["frequency"],
                          num_workers=dist.get_world_size(),
                          autotune=job.get("autotune", False))
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=job["epochs"],
                        batch_size=job["batch_size"],
                        stream_batches=job.get("stream_batches"))
    result = {"history": history, "weights": model.get_weights(),
              "autotune": model.last_autotune,
              "evaluate": model.evaluate(x[:-2], y[:-2], batch_size=job["eval_batch"]),
              "predict": model.predict(x[:-2], batch_size=job["eval_batch"])}
    if job.get("all_ranks"):
        torch.save(result, f"{job['out']}.rank{rank}")
    elif rank == 0:
        torch.save(result, job["out"])


def _autotune(job, rank):
    """``decide_autotune`` adopts rank 0's outcome on every rank, for a
    given outcome and for a fit's A/B whose candidates time faster on
    different ranks."""
    import time

    import elephas_tpu_torch as et
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine import sync
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh()
    local = (f"winner{rank}", {"rank": rank}, {f"winner{rank}": float(rank)})
    decided = sync.decide_autotune(local, mesh)
    # Rank 0 finds "fast" faster, every other rank "slow".
    slow_here = "slow" if rank == 0 else "fast"
    real_build = sync.build_train_step

    def build(compiled, options=None, pmean_axis=None):
        step = real_build(compiled, None, pmean_axis=pmean_axis)
        if options != {"label": slow_here}:
            return step

        def slow(state, x, y):
            time.sleep(0.003)
            return step(state, x, y)

        return slow

    real_candidates = sync.autotune_candidates
    sync.build_train_step = build
    sync.autotune_candidates = lambda device=None: [("slow", {"label": "slow"}),
                                                    ("fast", {"label": "fast"})]
    try:
        data = np.load(job["data"])
        compiled = et.compile_model(
            get_model("mlp", device="cpu", features=(8,), num_classes=4),
            optimizer={"name": "sgd", "learning_rate": 0.1}, loss="categorical_crossentropy",
            metrics=["acc"], input_shape=(data["x"].shape[1],))
        # 'epoch': no collective inside a step, so each rank's timings are its own.
        trainer = sync.SyncTrainer(compiled, mesh, frequency="epoch", autotune=True)
        trainer.fit(ShardedDataset(data["x"], data["y"], mesh.size), epochs=1, batch_size=8)
    finally:
        sync.build_train_step, sync.autotune_candidates = real_build, real_candidates
    torch.save({"decided": decided, "choice": trainer.autotune_choice},
               f"{job['out']}.rank{rank}")


SEARCH_SPACE = {"lr": ("loguniform", 1e-4, 1e-1), "width": ("choice", [4, 8, 16])}


def search_space():
    from elephas_tpu_torch.hyperparam import hp

    _, lo, hi = SEARCH_SPACE["lr"]
    return {"lr": hp.loguniform(np.log(lo), np.log(hi)),
            "width": hp.choice(SEARCH_SPACE["width"][1])}


def search_data():
    """Seeded Gaussian blobs, 3 classes in 4 dimensions: 128 training
    rows and 32 held out."""
    rng = np.random.default_rng(5)
    centers = rng.normal(scale=3.0, size=(3, 4))
    labels = rng.integers(0, 3, size=160)
    x = (centers[labels] + rng.normal(size=(160, 4))).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[labels]
    return x[:128], y[:128], x[128:], y[128:]


def search_objective(sample, data):
    """A seeded ``mlp_masked`` on the trial's device, trained one epoch
    by a ``SyncTrainer`` on this process's own mesh; the loss is the
    held-out loss, and the winner carries the trained model for the
    ranks that did not hold it to rebuild."""
    import elephas_tpu_torch as et
    from elephas_tpu_torch.data.rdd import ShardedDataset
    from elephas_tpu_torch.engine.sync import SyncTrainer
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import build_mesh

    x, y, xv, yv = data
    width = int(sample["width"])
    model = et.compile_model(
        get_model("mlp_masked", features=(16,), active=(width,), num_classes=3,
                  device=et.current_trial_device()),
        optimizer={"name": "adam", "learning_rate": sample["lr"], "injected": True},
        loss="categorical_crossentropy", metrics=["acc"], input_shape=(4,),
        seed=int(1e6 * sample["lr"]))
    trainer = SyncTrainer(model, build_mesh(num_data=1), frequency="batch")
    state, _ = trainer.fit(ShardedDataset(x, y, 1), epochs=1, batch_size=32)
    val = trainer.evaluate_state(state, xv, yv)
    rank = dist.get_rank() if dist.is_initialized() else 0
    return {"loss": float(val["loss"]), "model": model, "built_by_rank": rank}


def _search(job, rank):
    from elephas_tpu_torch.hyperparam import HyperParamModel

    search = HyperParamModel(None, num_workers=job["workers"], device="cpu")
    best = search.minimize(search_objective, search_data, max_evals=job["max_evals"],
                           space=search_space(), seed=job["seed"], algo=job["algo"])
    torch.save({"rank": rank,
                "trials": [(t["worker"], t["trial"], t["sample"], t["loss"])
                           for t in search.trials],
                "best": {k: v for k, v in best.items() if k != "model"},
                "best_weights": best["model"].get_weights(),
                "best_model_is_live": best["model"] is search.best_model()
                and best["built_by_rank"] == rank},
               f"{job['out']}.rank{rank}")


def _search_devices(job, rank):
    """``HyperParamModel(None)`` inside the group, on a faked host of
    ``job["cards"]`` cards whose current card is this rank's: saves the
    devices it takes and the slots of its trials."""
    import contextlib

    from elephas_tpu_torch.hyperparam import HyperParamModel, hp

    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: job["cards"]
    torch.cuda.current_device = lambda: rank
    torch.cuda.device = lambda device: contextlib.nullcontext()  # no card to pin
    search = HyperParamModel(None)
    search.minimize(lambda sample, data: {"loss": float(sample["x"])}, lambda: None,
                    max_evals=job["max_evals"], space={"x": hp.uniform(0, 1)}, seed=0)
    torch.save({"devices": search.devices, "slots": [t["worker"] for t in search.trials]},
               f"{job['out']}.rank{rank}")


def main(config_path, rank):
    with open(config_path) as f:
        config = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{config['store']}",
                            world_size=config["world"], rank=rank)
    try:
        for job in config["jobs"]:
            {"search": _search, "autotune": _autotune,
             "search_devices": _search_devices}.get(job.get("kind"), _run)(job, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
