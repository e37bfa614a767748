#!/usr/bin/env python3
"""One bf16 train step of the head_dim-256 LM (``chip_smoke.WIDE_LM`` at
``WIDE_BATCH``, seeded weights) under ``torch.profiler``: four steps'
times on the host's clock (the first warms up), then one profiled step's
device time by kernel (the top ten) and K1-K3's share of it.

    env PYTHONPATH=. python3 scripts/torch_wide_lm_profile.py [--root CHECKOUT]

``--root`` runs another checkout's port and ``chip_smoke.py`` (a
``git archive`` of a parent commit, say) with this script. Prints the
card's name and power limit first, then one JSON line. Needs a CUDA
device and ``nvcc``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
STEPS = 4  # timed steps before the profiled one


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose port is run")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_wide_lm_profile: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.engine.step import init_train_state, make_train_step
    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.ops import attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.smi("name,power.limit"), flush=True)
    attention_cuda.build_all()
    batch, seq = smoke.WIDE_BATCH
    rng = np.random.default_rng(smoke.SEED)
    tokens = torch.as_tensor(rng.integers(0, smoke.WIDE_LM["vocab_size"], (batch, seq + 1)),
                             device="cuda")
    x, y = tokens[:, :-1], tokens[:, 1:]
    model = CompiledModel(get_model("transformer_lm", attention="flash", dtype="bfloat16",
                                    **smoke.WIDE_LM), None,
                          optimizer={"name": "adam", "learning_rate": 1e-3},
                          loss="sparse_categorical_crossentropy", metrics=["acc"], seed=smoke.SEED)
    step, state = make_train_step(model), init_train_state(model)
    held = {"state": state}

    def one_step():
        held["state"], metrics = step(held["state"], x, y)
        return metrics

    step_ms = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(float(metrics["loss"])):
        raise AssertionError("head_dim-256 bf16 loss not finite")
    profile = smoke.device_breakdown(one_step, top=10)
    flash = sum(profile["flash_ms"].values())
    print(json.dumps({"root": str(Path(args.root).resolve()), "batch": batch, "seq": seq,
                      "step_ms": step_ms, "profiled": profile,
                      "flash_share": flash / profile["device_ms"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
