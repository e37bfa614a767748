#!/usr/bin/env python3
"""Where a tensor-parallel rank's time goes, on one card.

    env PYTHONPATH=. python3 scripts/torch_tp_trace.py

Four ranks of this script on cuda:0 in one gloo group (as
``chip_smoke.py``'s tensor-parallel phase runs them), model axis of 4:

1. one gloo all-reduce of CUDA tensors alone, at the train step's
   activation size (8 x 2048 x 256 f32, 16,777,216 B) and at the decode
   step's (16 x 256 f32), and one all_gather of the decode step's logits
   shard (16 x 8000 f32): mean ms over repeats, host clock after
   ``torch.cuda.synchronize``;
2. the full-width LM (f32, flash) sharded by ``LM_RULES``: two warm-up
   Adam steps, then one step under ``torch.profiler`` (CPU and CUDA);
3. ``shard_serving`` over model 4 serving the first 16 requests of
   ``chip_smoke.serving_traffic()``, 20 serving steps (decode, and any
   prefill chunk still due) under the profiler on rank 0.

Prints rank 0's step wall ms and, for each profiled window, its device
busy ms and the top operators by self CPU time, and writes every rank's
numbers to ``chiprun_out/tp_trace.json``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

RANKS = 4
TOP = 12


def _ms(fn, repeats):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / repeats


def _profile(fn):
    """``fn()`` under the profiler: wall ms, device busy ms (the sum of
    CUDA kernel time) and the top operators by self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP]
    return {"wall_ms": wall, "device_busy_ms": device,
            "top_self_cpu": [{"name": e.key, "calls": e.count,
                              "self_cpu_ms": e.self_cpu_time_total / 1e3,
                              "device_ms": e.self_device_time_total / 1e3} for e in top]}


def rank_main(store, rank):
    import torch.distributed as dist

    import chip_smoke
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel import distributed
    from elephas_tpu_torch.parallel.collectives import all_gather, all_reduce_
    from elephas_tpu_torch.parallel.mesh import MODEL_AXIS, build_mesh
    from elephas_tpu_torch.parallel.tensor_parallel import (
        init_lm_state_tp,
        make_lm_train_step_tp,
    )
    from elephas_tpu_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    distributed.initialize(f"file://{store}", RANKS, rank, heartbeat_timeout=600,
                           backend="gloo")
    mesh = build_mesh(num_data=1, num_model=RANKS)
    model_group = mesh.over(MODEL_AXIS)
    out = {"rank": rank}

    # 1. single collectives.
    act = torch.randn((8, 2048, 256), device="cuda")
    small = torch.randn((16, 256), device="cuda")
    logits = torch.randn((16, 8000), device="cuda")
    out["all_reduce_16MB_ms"] = _ms(lambda: all_reduce_(act, model_group), 10)
    out["all_reduce_16KB_ms"] = _ms(lambda: all_reduce_(small, model_group), 50)
    out["all_gather_logits_ms"] = _ms(lambda: all_gather(logits, model_group, -1), 50)
    cpu = small.cpu()
    out["all_reduce_16KB_host_tensor_ms"] = _ms(lambda: all_reduce_(cpu, model_group), 50)
    del act

    # 2. the train step.
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 32000, (8, 2049))
    compiled = CompiledModel(get_model("transformer_lm", attention="flash"),
                             optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="sparse_categorical_crossentropy", metrics=[], seed=0)
    step = make_lm_train_step_tp(compiled, mesh)
    state = init_lm_state_tp(compiled, mesh)
    for _ in range(2):
        step(state, tokens[:, :-1], tokens[:, 1:])
    out["train_step"] = _profile(lambda: step(state, tokens[:, :-1], tokens[:, 1:]))
    del compiled, step, state
    torch.cuda.empty_cache()

    # 3. the sharded serving engine's steps.
    module = CompiledModel(get_model("transformer_lm"), loss="sparse_categorical_crossentropy",
                           metrics=[], seed=0).module
    engine = InferenceEngine(module, **chip_smoke.SERVE_ENGINE).shard_serving(mesh)
    if rank != 0:
        engine.follow()
    else:
        traffic = chip_smoke.serving_traffic()[:16]
        for prompt, new in traffic:
            engine.submit(prompt, max_new_tokens=new)
        while engine.scheduler.has_work and engine.stats()["pool_active"] < 16:
            engine.step()  # admit and prefill every request first
        for _ in range(5):
            engine.step()

        def serve():
            for _ in range(20):
                engine.step()

        out["serve_20_steps"] = _profile(serve)
        engine.run_until_drained()
        engine.close()
    dist.barrier()
    dist.destroy_process_group()
    Path(f"{store}.rank{rank}").write_text(json.dumps(out))
    return 0


def main():
    if not torch.cuda.is_available():
        print("torch_tp_trace: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    print(chip_smoke.smi("name,power.limit"), flush=True)
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "2"}
    with tempfile.TemporaryDirectory() as tmp:
        store = f"{tmp}/store"
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", store, str(r)],
                                  env=env) for r in range(RANKS)]
        codes = [p.wait(timeout=900) for p in procs]
        if codes != [0] * RANKS:
            print(f"ranks exited {codes}", file=sys.stderr)
            return 1
        ranks = [json.loads(Path(f"{store}.rank{r}").read_text()) for r in range(RANKS)]
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/tp_trace.json").write_text(json.dumps(ranks, indent=1))
    for r in ranks:
        print(f"rank {r['rank']}: " + json.dumps({k: v for k, v in r.items()
                                                 if k.endswith("_ms")}), flush=True)
    for window in ("train_step", "serve_20_steps"):
        print(f"rank 0 {window}: " + json.dumps(ranks[0][window], indent=1), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
