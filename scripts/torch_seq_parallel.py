#!/usr/bin/env python3
"""The sequence-parallel phase of ``chip_smoke.py`` alone, on one card.

    env PYTHONPATH=. python3 scripts/torch_seq_parallel.py

Builds the kernel libraries, then runs ``chip_smoke.seq_parallel_phase``:
the ring's hop modes in this process at (8, 8, 512, 32), then four ranks
of ``chip_smoke.py --seq-rank`` on cuda:0 in one gloo group (ring and
Ulysses attention at (8, 8, 2048, 32), 3 Adam steps of the full-width LM
per layout, a data 2 x seq 2 fit). Every check raises on failure. Prints
the card, the kernels' launches summed over the ranks and the phase's
seconds. About 40 s of command, 15 s of it ``nvcc``.
"""

import json
import sys
import time

import torch

import chip_smoke
from elephas_tpu_torch.ops import attention_cuda


def main():
    if not torch.cuda.is_available():
        print("torch_seq_parallel: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    attention_cuda.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    total, report = chip_smoke.seq_parallel_phase(attention_cuda)
    print(f"launches over the ranks: {json.dumps(total)}")
    print(f"phase {report['phase_s']:.1f} s, ranks {report['ranks_s']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
