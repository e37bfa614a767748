#!/usr/bin/env python3
"""How often the async phase's wire-transport fits pass their check, with
the comms pipeline on and off.

    env PYTHONPATH=. python3 scripts/torch_async_wire_repeat.py [RUNS]

Repeats ``chip_smoke.py``'s async-phase fits over the socket and the HTTP
parameter servers (2 workers on cuda:0, batch frequency, one epoch of the
synthetic MNIST CNN), each with ``pipelined_comms`` off and at its default
(on), and the local server's fits beside them, with the pipeline off (its
default) and on at the same batch frequency, RUNS times (default 8) in one
process. Prints one JSON line a fit: its evaluate loss and accuracy,
whether they pass the phase's check (accuracy above ``ASYNC_WIRE_MIN_ACC``,
loss under ``ASYNC_WIRE_MAX_LOSS``), the epoch's training loss and the
fit's seconds; then one line of each arm's accuracies and pass count, and
the card's name and power limit.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from elephas_tpu_torch import SparkModel, compile_model, to_simple_rdd
from elephas_tpu_torch.data.datasets import one_hot, synthetic_mnist
from elephas_tpu_torch.models import get_model

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def images(pair):
    x, y = pair
    x = x.astype(np.float32) / 255.0
    return (x[..., None] if x.ndim == 3 else x), one_hot(y, 10)


train, test = synthetic_mnist(*cs.ASYNC_CNN_ROWS)
(x, y), (xv, yv) = images(train), images(test)


def cnn():
    return compile_model(get_model("cnn"), optimizer={"name": "adam", "learning_rate": 1e-3},
                         loss="categorical_crossentropy", metrics=["acc"],
                         input_shape=(28, 28, 1), seed=cs.SEED)


# (transport, pipelined_comms): None is the transport's default (on over
# the wire, off for the local server).
ARMS = (("socket", False), ("socket", None), ("http", False), ("http", None),
        ("local", None), ("local", True))
runs = int(sys.argv[1]) if sys.argv[1:] else 8
arms = {}
for i in range(runs):
    for mode, pipelined in ARMS:
        kwargs = {} if mode == "local" else {"parameter_server_mode": mode, "port": 0}
        m = SparkModel(cnn(), mode="asynchronous", frequency="batch",
                       mesh=["cuda:0"] * cs.ASYNC_WIRE_WORKERS, pipelined_comms=pipelined,
                       **kwargs)
        t0 = time.perf_counter()
        h = m.fit(to_simple_rdd(None, x, y), epochs=1, batch_size=cs.ASYNC_CNN_BATCH)
        ev = m.evaluate(xv, yv)
        ok = ev["acc"] > cs.ASYNC_WIRE_MIN_ACC and ev["loss"] < cs.ASYNC_WIRE_MAX_LOSS
        arm = f"{mode}/pipelined={pipelined if pipelined is not None else mode != 'local'}"
        arms.setdefault(arm, []).append((ev["acc"], ev["loss"], ok))
        print(json.dumps({"run": i, "arm": arm, "ok": ok, "evaluate": ev,
                          "train_loss": h["loss"], "fit_s": time.perf_counter() - t0}),
              flush=True)
for arm, rows in arms.items():
    print(json.dumps({"arm": arm, "acc": [r[0] for r in rows], "loss": [r[1] for r in rows],
                      "passed": sum(r[2] for r in rows), "runs": len(rows),
                      "acc_min": min(r[0] for r in rows)}), flush=True)
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip(), flush=True)
