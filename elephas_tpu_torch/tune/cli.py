"""Run an elastic ASHA search from the command line (counterpart of the
JAX package's ``elephas-tune``; run as ``python -m
elephas_tpu_torch.tune.cli``).

A deliberately small driver over ``tune.run_search`` for smoke runs and
demos: the built-in objective is a deterministic synthetic bowl (no
dataset download, no device requirements), so the command exercises the
full tuner stack — sampler, scheduler, elastic pool, vault, counters —
in a couple of seconds on any box::

    python -m elephas_tpu_torch.tune.cli --trials 12 --eta 3 --rungs 3 --workers 4 --seed 7
    python -m elephas_tpu_torch.tune.cli --json   # machine-readable search doc

For a real objective, import ``elephas_tpu_torch.tune.run_search`` and
pass your own ``trial_fn``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

from elephas_tpu_torch.tune.search import hp, run_search


def synthetic_trial_fn(config, state, epochs, seed, rung):
    """Deterministic toy objective: gradient descent on a quadratic
    bowl whose conditioning depends on the sampled config. Loss is a
    pure function of (config, seed, total steps) — resumable and
    replay-stable, which is exactly the contract ``trial_fn`` owes the
    tuner."""
    rng = np.random.default_rng([int(seed)])
    target = rng.normal(size=8)
    if state is None:
        state = {"x": np.zeros(8), "steps": np.zeros(())}
    x, steps = state["x"].copy(), float(state["steps"])
    lr = float(config["lr"])
    for _ in range(int(epochs) * 4):  # 4 steps per "epoch"
        x = x - lr * (x - target)
        steps += 1.0
    loss = float(np.mean((x - target) ** 2)) + 1e-4 * float(config["width"])
    return {"loss": loss, "state": {"x": x, "steps": np.asarray(steps)}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m elephas_tpu_torch.tune.cli",
        description="Elastic ASHA hyperparameter search (synthetic demo "
                    "objective; use tune.run_search for real ones)")
    ap.add_argument("--trials", type=int, default=9)
    ap.add_argument("--eta", type=int, default=3)
    ap.add_argument("--rungs", type=int, default=3)
    ap.add_argument("--r0", type=int, default=1,
                    help="epoch budget of rung 0")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="print the raw search doc")
    args = ap.parse_args(argv)

    space = {
        "lr": hp.loguniform(np.log(1e-3), np.log(0.9)),
        "width": hp.choice([32, 64, 128]),
    }
    doc = run_search(synthetic_trial_fn, space, num_trials=args.trials,
                     seed=args.seed, eta=args.eta, rungs=args.rungs,
                     r0=args.r0, workers=args.workers)
    if args.json:
        print(json.dumps(doc, indent=1, default=str))
        return 0
    winner = doc["winner"] or {}
    print(f"trials={args.trials} eta={args.eta} rungs={args.rungs} "
          f"workers={args.workers}")
    print(f"winner: trial {winner.get('trial')} "
          f"digest={doc['winner_digest']} loss={doc['best_loss']:.6g}")
    print(f"config: {winner.get('config')}")
    print(f"epochs: {doc['epochs_spent']} spent vs "
          f"{doc['full_budget_epochs']} full-budget "
          f"({100.0 * (1 - doc['epochs_spent'] / doc['full_budget_epochs']):.0f}% saved)")
    print(f"counts: {doc['counts']}  pruned_frac={doc['pruned_frac']:.2f}")
    print(f"search_digest: {doc['search_digest']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
