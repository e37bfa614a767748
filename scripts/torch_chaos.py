"""Runs ``chip_smoke.py``'s chaos phase alone on one GPU.

    env PYTHONPATH=. python3 scripts/torch_chaos.py

The phase (``chip_smoke.chaos_phase``) drives ``AsyncTrainer(elastic=True)``
on config 2's CNN under seeded chaos (a killed worker, a killed and
warm-restarted parameter server, a partition window, batch-range units),
fails a shard of the ResNet-18's tree over to its hot standby, runs an
elastic fit over the sharded group through a failover, reads pinned
versions out of the write-ahead log and prints what durability costs a
push. TF32 off, as in the full run. Prints the card's name and power
limit first and the phase's report last; builds no kernel (about a
minute).
"""

import json
import time

import chip_smoke
import torch
from elephas_tpu_torch.ops import attention_cuda


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_chaos: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    launches, report = chip_smoke.chaos_phase(attention_cuda)
    print("chaos: " + json.dumps(report), flush=True)
    print(json.dumps({"launches": launches, "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
