"""How often the search phase's ASHA run gives another winner, on one GPU.

    env PYTHONPATH=. python3 scripts/torch_asha_order.py [RUNS]

Runs ``chip_smoke.py``'s ASHA setup (``examples/asha_search.py``: 9
``mlp_masked`` trials through ``SparkModel(mode="asynchronous")``, eta 3,
3 rungs, a ``MemoryVault``, deterministic algorithms) RUNS times (default
6) with 2 pool workers and twice with 1, and prints each run's digests,
epochs, units and every trial's top rung, last loss and owners. Async
halving promotes from the results that have arrived, so with two
workers the outcome may follow their arrival order; losses that tie
(at exactly 0.0) leave the trial id to break the tie among the arrived.
"""

import json
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from elephas_tpu_torch import SparkModel, compile_model, to_simple_rdd  # noqa: E402
from elephas_tpu_torch.hyperparam import width_bucket  # noqa: E402
from elephas_tpu_torch.models import get_model  # noqa: E402
from elephas_tpu_torch.tune import MemoryVault, run_search  # noqa: E402


def main(runs):
    if not torch.cuda.is_available():
        raise SystemExit("torch_asha_order: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit"), flush=True)
    card = torch.device("cuda", 0)
    ax, ay, axv, ayv = chip_smoke.asha_data()

    def trial_fn(config, state, epochs, seed, rung):  # chip_smoke.search_phase's
        width = int(config["width"])
        net = compile_model(
            get_model("mlp_masked", features=(width_bucket(width, chip_smoke.ASHA_BUCKETS),),
                      active=(width,), num_classes=4, device=card),
            optimizer={"name": "adam", "learning_rate": config["lr"], "injected": True},
            loss="categorical_crossentropy", metrics=["acc"], input_shape=(ax.shape[1],),
            seed=seed)
        if state is not None:
            net.set_weights(state)
        model = SparkModel(net, mode="asynchronous", frequency="epoch",
                           parameter_server_mode="local", num_workers=1)
        model.fit(to_simple_rdd(None, ax, ay, 1), epochs=int(epochs),
                  batch_size=int(config["batch_size"]))
        val = model.evaluate(axv, ayv)
        return {"loss": float(val["loss"]), "state": net.get_weights()}

    args = dict(num_trials=chip_smoke.ASHA_TRIALS, seed=chip_smoke.SEED, eta=chip_smoke.ASHA_ETA,
                rungs=chip_smoke.ASHA_RUNGS, r0=chip_smoke.ASHA_R0)
    torch.use_deterministic_algorithms(True)
    for workers in [2] * runs + [1, 1]:
        doc = run_search(trial_fn, chip_smoke.asha_space(), vault=MemoryVault(),
                         workers=workers, **args)
        trials = {tid: [t["top_rung"], t["loss"], t["owners"]]
                  for tid, t in doc["trials"].items()}
        print(json.dumps({"workers": workers, "winner_digest": doc["winner_digest"],
                          "search_digest": doc["search_digest"],
                          "epochs_spent": doc["epochs_spent"],
                          "completed_units": doc["pool"]["completed_units"],
                          "winner": doc["winner"]["trial"],
                          "trials (top rung, last loss, owners)": trials}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 6)
