#!/usr/bin/env python3
"""Does a 10 Hz scrape of the parameter server's ops endpoint slow an
async fit? Alternating pairs of unpolled and polled fits.

    env PYTHONPATH=. python3 scripts/torch_ops_scrape_repeat.py [PAIRS]

Runs ``chip_smoke.py``'s ops-phase fit (``AsyncTrainer`` over HTTP with
``ps_ops_port=0`` and a WAL directory, ``ASYNC_WIRE_WORKERS`` workers on
cuda:0, batch frequency, one epoch of the synthetic MNIST CNN) once to
warm up, then PAIRS times (default 8) an unpolled fit followed by one
polled at 10 Hz on every route of ``OPS_PS_KEYS`` (the ``Poller`` of the
phase), in one process. Prints one JSON line a pair (samples/s of each,
polled / unpolled, poll rounds), then the pairs' mean ratio and its
spread. Where the polled fits are slower beyond the spread (the mean
ratio below 1 by more than the ratios' standard deviation), it times the
routes one at a time: for each of the seven, one more pair whose poller
scrapes that route alone. Last, the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs
from elephas_tpu_torch.data.rdd import ShardedDataset
from elephas_tpu_torch.engine.async_engine import AsyncTrainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

(x, y), _ = cs.mnist_cnn_data()
WORKERS = cs.ASYNC_WIRE_WORKERS
ROWS = WORKERS * (len(x) // WORKERS // cs.ASYNC_CNN_BATCH) * cs.ASYNC_CNN_BATCH


def fit(tmp, i, routes):
    """One ops-phase fit; ``routes`` the poller's routes (None: unpolled).
    Returns its samples/s and the poll rounds."""
    trainer = AsyncTrainer(cs.mnist_cnn(), ["cuda:0"] * WORKERS, frequency="batch",
                           parameter_server_mode="http", port=0, ps_ops_port=0,
                           ps_wal_dir=os.path.join(tmp, f"fit{i}"))

    def url():
        server = trainer.server
        ops = getattr(server, "ops", None) if server is not None else None
        return ops.url if ops is not None else None

    poller = cs.Poller(url if routes else (lambda: None), routes or {})
    with poller:
        t0 = time.perf_counter()
        trainer.fit(ShardedDataset(x, y, WORKERS), epochs=1, batch_size=cs.ASYNC_CNN_BATCH)
        seconds = time.perf_counter() - t0
    cs.check(not poller.bad, f"answers off the JAX keys: {poller.bad[:5]}")
    return ROWS / seconds, poller.rounds


def main():
    if not torch.cuda.is_available():
        print("torch_ops_scrape_repeat: no card", file=sys.stderr)
        return 1
    pairs = int(sys.argv[1]) if sys.argv[1:] else 8
    ratios = []
    with tempfile.TemporaryDirectory() as tmp:
        count = iter(range(10_000))
        fit(tmp, next(count), None)  # warm-up
        for p in range(pairs):
            unpolled, _ = fit(tmp, next(count), None)
            polled, rounds = fit(tmp, next(count), cs.OPS_PS_KEYS)
            ratios.append(polled / unpolled)
            print(json.dumps({"pair": p, "unpolled_samples_per_s": unpolled,
                              "polled_samples_per_s": polled, "ratio": ratios[-1],
                              "poll_rounds": rounds}), flush=True)
        mean, spread = float(np.mean(ratios)), float(np.std(ratios))
        cost = 1.0 - mean > spread
        print(json.dumps({"pairs": pairs, "ratio_mean": mean, "ratio_std": spread,
                          "ratio_min": min(ratios), "ratio_max": max(ratios),
                          "cost_beyond_spread": cost}), flush=True)
        if cost:
            for route, keys in cs.OPS_PS_KEYS.items():
                unpolled, _ = fit(tmp, next(count), None)
                polled, rounds = fit(tmp, next(count), {route: keys})
                print(json.dumps({"route": route, "unpolled_samples_per_s": unpolled,
                                  "polled_samples_per_s": polled,
                                  "ratio": polled / unpolled, "poll_rounds": rounds}),
                      flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__} cuda {torch.version.cuda}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
