"""One rank of the port's multi-process parity runs (``test_torch_fit.py``);
a script, not a test module: it holds no tests.

    python tests/test_torch_dist_worker.py CONFIG.json RANK

Joins a gloo group on the CPU (``file://`` store, world size and rank
from the arguments), then runs each job of the config through
``SparkModel(mode="synchronous").fit``, ``evaluate`` and ``predict`` and,
on rank 0, saves the history, the final weights, and the evaluation and
predictions on all rows but the last two, with ``torch.save``. Imports the port only, no JAX.
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
                          num_workers=dist.get_world_size())
    history = model.fit(et.to_simple_rdd(None, x, y), epochs=job["epochs"],
                        batch_size=job["batch_size"])
    result = {"history": history, "weights": model.get_weights(),
              "evaluate": model.evaluate(x[:-2], y[:-2], batch_size=job["eval_batch"]),
              "predict": model.predict(x[:-2], batch_size=job["eval_batch"])}
    if rank == 0:
        torch.save(result, job["out"])


def main(config_path, rank):
    with open(config_path) as f:
        config = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{config['store']}",
                            world_size=config["world"], rank=rank)
    try:
        for job in config["jobs"]:
            _run(job, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
