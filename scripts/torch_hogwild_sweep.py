"""The ResNet-18 hogwild fit on one card across optimizers and worker counts.

    env PYTHONPATH=. python3 scripts/torch_hogwild_sweep.py

Needs a CUDA device. The full-width ResNet-18 in bf16 on
``synthetic_cifar10(16384, 2048)`` (inputs / 255), ``SparkModel(mode=
"hogwild")`` at batch 256 per worker, 2 epochs, TF32 off, cudnn.benchmark
on, seed 0; each run prints one JSON line: the loss and ``val_acc`` per
epoch, samples/s over epoch 2, the applied share, and per train step the
host ms spent waiting for the card's dispatch lock and launching the
step (``engine.async_engine._taking_turns``, timed here). The runs: 1
worker and 4 workers with momentum 0.9 at lr 0.05 (the reference
config's, ``parity.py``), 4 workers with plain SGD at lr 0.05 and with
momentum at lr 0.0125, at batch frequency, and 4 workers with momentum
at epoch frequency. A line with the card's name and power limit comes
first.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from elephas_tpu_torch import SparkModel, compile_model, to_simple_rdd
from elephas_tpu_torch.data.datasets import one_hot, synthetic_cifar10
from elephas_tpu_torch.engine import async_engine
from elephas_tpu_torch.models import get_model

BATCH, EPOCHS = 256, 2
MOMENTUM = {"name": "momentum", "learning_rate": 0.05}
RUNS = [(1, MOMENTUM, "batch"), (4, MOMENTUM, "batch"),
        (4, {"name": "sgd", "learning_rate": 0.05}, "batch"),
        (4, {"name": "momentum", "learning_rate": 0.0125}, "batch"),
        (4, MOMENTUM, "epoch")]


def timed_turns(record):
    """``async_engine._taking_turns`` that also records, per step, the
    seconds spent waiting for the lock and the seconds holding it."""

    def taking_turns(step, lock):
        def timed(state, x, y):
            t0 = time.perf_counter()
            if lock is not None:
                lock.acquire()
            t1 = time.perf_counter()
            try:
                return step(state, x, y)
            finally:
                t2 = time.perf_counter()
                if lock is not None:
                    lock.release()
                record.append((t1 - t0, t2 - t1))

        return timed

    return taking_turns


def main():
    if not torch.cuda.is_available():
        print("torch_hogwild_sweep: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    (x, y), (xv, yv) = synthetic_cifar10(16384, 2048)
    x, xv = x.astype(np.float32) / 255, xv.astype(np.float32) / 255
    y, yv = one_hot(y, 10), one_hot(yv, 10)
    record = []
    async_engine._taking_turns = timed_turns(record)
    for workers, optimizer, frequency in RUNS:
        record.clear()
        net = compile_model(get_model("resnet18", dtype="bfloat16"), optimizer=optimizer,
                            loss="categorical_crossentropy", metrics=["acc"],
                            input_shape=(32, 32, 3), seed=0)
        model = SparkModel(net, mode="hogwild", frequency=frequency,
                           mesh=["cuda:0"] * workers)
        history = model.fit(to_simple_rdd(None, x, y), epochs=EPOCHS, batch_size=BATCH,
                            validation_data=(xv, yv))
        ends = model.last_epoch_end_times
        rows = workers * (len(x) // workers // BATCH) * BATCH
        second = np.array(record[len(record) // 2:])  # epoch 2's steps
        print(json.dumps({
            "workers": workers, "optimizer": optimizer, "frequency": frequency,
            "loss": history["loss"], "val_acc": history["val_acc"],
            "samples_per_s_epoch_2": rows / (ends[-1] - ends[-2]),
            "applied_share": model.async_trainer.server.buffer.applied_share(),
            "lock_wait_ms_mean": float(second[:, 0].mean() * 1e3),
            "step_ms_mean": float(second[:, 1].mean() * 1e3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
