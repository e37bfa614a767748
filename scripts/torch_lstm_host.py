#!/usr/bin/env python3
"""Host cost of the full-width LSTM's train step at batch 32 on the card,
in a fresh process and after ``chip_smoke.async_phase`` ran in it.

    env PYTHONPATH=. python3 scripts/torch_lstm_host.py

The step (``make_train_step``, Adam, f32, sequences of 200 tokens,
TF32 off, ``cudnn.benchmark`` on as ``chip_smoke.py`` leaves it) is
host-bound at batch 32, and ``chip_smoke.py``'s estimator phase, which
runs after every other phase, read it at 3.4-8.0 ms across calls. This
script times it (a) first thing in a process, (b) after the async phase
(which starts and stops parameter servers and worker threads), (c) after
``gc.collect()`` and ``gc.freeze()``, and prints for each the step's ms
over ``STEPS`` steps, the threads alive, the objects the collector
tracks, and the card's busy share over 10 steps (``torch.profiler``).
Prints the card's name and power limit first. Needs a CUDA device.
"""

import gc
import json
import sys
import threading
import time

import torch

import chip_smoke

STEPS, WARMUP, BATCH = 50, 5, 32


def measure(label, step, state, x, y):
    for _ in range(WARMUP):
        state, metrics = step(state, x, y)
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, metrics = step(state, x, y)
    float(metrics["loss"])
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    profile = chip_smoke.device_breakdown(lambda: [step(state, x, y) for _ in range(10)], top=3)
    print(json.dumps({"when": label, "step_ms": ms, "busy_share": profile["busy_share"],
                      "device_ms_per_step": profile["device_ms"] / 10,
                      "threads": sorted(t.name for t in threading.enumerate()),
                      "gc_objects": len(gc.get_objects())}), flush=True)


def main():
    if not torch.cuda.is_available():
        print("torch_lstm_host: no CUDA device", file=sys.stderr)
        return 1
    from elephas_tpu_torch import compile_model
    from elephas_tpu_torch.engine.step import init_train_state, make_train_step
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.ops import attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(chip_smoke.smi("name,power.limit"), flush=True)
    model = compile_model(get_model("lstm", **chip_smoke.LSTM_WIDTH),
                          optimizer=chip_smoke.IMDB_ADAM,
                          loss="sparse_categorical_crossentropy", metrics=["acc"],
                          input_shape=(chip_smoke.IMDB_MAXLEN,), input_dtype=torch.int32,
                          seed=chip_smoke.SEED)
    step, state = make_train_step(model), init_train_state(model)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    x = torch.randint(1, chip_smoke.LSTM_WIDTH["vocab_size"], (BATCH, chip_smoke.IMDB_MAXLEN),
                      generator=gen, device="cuda")
    y = torch.randint(0, 2, (BATCH,), generator=gen, device="cuda")
    measure("fresh process", step, state, x, y)
    chip_smoke.async_phase(attention_cuda)
    measure("after async_phase", step, state, x, y)
    gc.collect()
    gc.freeze()
    measure("after gc.collect() and gc.freeze()", step, state, x, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
