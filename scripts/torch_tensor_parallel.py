#!/usr/bin/env python3
"""The tensor-parallel phase of ``chip_smoke.py`` alone, on one card.

    env PYTHONPATH=. python3 scripts/torch_tensor_parallel.py

Builds the kernel libraries, then runs ``chip_smoke.tensor_parallel_phase``:
K1-K3 at the shards' head counts in this process, then four ranks of
``chip_smoke.py --tp-rank`` on cuda:0 in one gloo group (the full-width
LM on data 1 x model 4 in float32 and bf16 with a checkpoint, data 2 x
model 2, sp x tp ring and Ulysses and a fit, ``shard_serving`` over model
4). Every check raises on failure. Prints the card, the kernels' launches
summed over the ranks and the phase's seconds.
"""

import json
import sys
import time

import torch

import chip_smoke
from elephas_tpu_torch.ops import attention_cuda


def main():
    if not torch.cuda.is_available():
        print("torch_tensor_parallel: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    attention_cuda.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    total, report = chip_smoke.tensor_parallel_phase(attention_cuda)
    print(f"launches over the ranks: {json.dumps(total)}")
    print(f"phase {report['phase_s']:.1f} s, ranks {report['ranks_s']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
