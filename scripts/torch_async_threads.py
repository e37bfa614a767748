"""How worker threads share one card in the port's async trainer.

    env PYTHONPATH=. python3 scripts/torch_async_threads.py [--steps 24] [--batch 256]

Needs a CUDA device. Builds the full-width ResNet-18 in bf16 (momentum
lr 0.05, seed 0, TF32 off, cudnn.benchmark on) and times, on one card,
each thread driving its own model copy on its own CUDA stream
(``engine.async_engine._WorkerModel``, as the async trainer's workers
do):

- train steps only: 1 thread, and N threads interleaving their launches
  or taking turns under one lock (``_taking_turns``);
- the Downpour unit against a lock-free local parameter server on the
  card (pull into the module, the step, the delta pushed): 1 thread, N
  threads interleaving, N threads taking turns for the step;
- a profile of one thread's units: host time of the top calls.

Each result is one JSON line (samples/s over all threads, host ms per
step per thread), after a line with the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import threading
import time

import torch

from elephas_tpu_torch import compile_model
from elephas_tpu_torch.engine.async_engine import _taking_turns, _WorkerModel, store_of
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.parameter.server import make_server

WARMUP = 3


def run(master, x, y, threads, steps, lock=False, ps=False, profile=False):
    device = torch.device("cuda:0")
    step_lock = threading.Lock() if lock else None
    workers = [_WorkerModel(master, device) for _ in range(threads)]
    for wm in workers:
        wm.train_step = _taking_turns(wm.train_step, step_lock)
    server = None
    if ps:
        params, buffers = store_of(master.module)
        server = make_server("local", {"params": params, "batch_stats": buffers}, lock=False,
                             device=device)
    wall = [0.0] * threads
    start = threading.Barrier(threads + 1)

    def body(i):
        wm = workers[i]
        with torch.cuda.stream(torch.cuda.Stream(device)):
            client = server.client() if server is not None else None
            for k in range(WARMUP + steps):
                if k == WARMUP:
                    torch.cuda.synchronize()
                    start.wait()
                    t0 = time.perf_counter()
                before = wm.load(client.get_parameters()) if client is not None else None
                wm.state, _ = wm.train_step(wm.state, x, y)
                if client is not None:
                    client.update_parameters(wm.tree(wm.delta(before)))
            torch.cuda.synchronize()
            wall[i] = time.perf_counter() - t0

    pool = [threading.Thread(target=body, args=(i,)) for i in range(threads)]
    for t in pool:
        t.start()
    start.wait()
    top = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for t in pool:
                t.join()
        events = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:20]
        top = [[e.key[:60], round(e.self_cpu_time_total / 1e3 / steps, 4), e.count // steps]
               for e in events]
    for t in pool:
        t.join()
    out = {"threads": threads, "taking_turns": lock, "parameter_server": ps,
           "samples_per_s": threads * steps * x.shape[0] / max(wall),
           "host_ms_per_step_per_thread": max(wall) / steps * 1e3}
    if top is not None:
        out["host_ms_per_step_by_call"] = top
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_async_threads: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    master = compile_model(get_model("resnet18", dtype="bfloat16"),
                           optimizer={"name": "momentum", "learning_rate": 0.05},
                           loss="categorical_crossentropy", metrics=["acc"],
                           input_shape=(32, 32, 3), seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((args.batch, 32, 32, 3), generator=gen, device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 10, (args.batch,), generator=gen, device="cuda"), 10).float()
    n = args.threads
    for threads, lock, ps in ((1, False, False), (n, False, False), (n, True, False),
                              (1, False, True), (n, False, True), (n, True, True)):
        print(json.dumps(run(master, x, y, threads, args.steps, lock=lock, ps=ps)), flush=True)
    print(json.dumps(run(master, x, y, 1, args.steps, ps=True, profile=True)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
