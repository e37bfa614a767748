"""How many streamed chunks a streamed fit holds on one GPU.

    env PYTHONPATH=. python3 scripts/torch_stream_residency.py

Runs ``chip_smoke.streamed_residency`` (one epoch of
``fit(stream_batches=4)`` at batch 1024 on 50,000 synthetic CIFAR-10
rows under ``chip_smoke.ResidencyProbe``) for the bf16 ResNet-18 and the
light ``mlp``, each as it is and on a device slowed by
``chip_smoke.STREAM_SLOW_CYCLES`` of ``torch.cuda._sleep`` after each
chunk's steps. Prints the card's name and power limit, then each run's
most streamed bytes and chunks held, and exits 1 if a run holds more
than ``chip_smoke.STREAM_RESIDENCY_LIMIT`` (three chunks). A copy of the
package whose streamed fit does not wait for chunk i-2's steps before
it uploads chunk i+1 exits 1 here (the slowed ``mlp`` run).
"""

import json
import sys

import chip_smoke
import numpy as np
import torch
from elephas_tpu_torch.data.datasets import one_hot, synthetic_cifar10


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_stream_residency: no CUDA device")
    print(chip_smoke.smi("name,power.limit"), flush=True)
    (x, y), _ = synthetic_cifar10(n_train=chip_smoke.STREAM_ROWS, n_test=1)
    x, y = x.astype(np.float32) / 255.0, one_hot(y, 10)
    ok = True
    for name in ("resnet18", "mlp"):
        for slow_cycles in (0, chip_smoke.STREAM_SLOW_CYCLES):
            run = chip_smoke.streamed_residency(x, y, name, slow_cycles)
            run["limit_bytes"] = chip_smoke.STREAM_RESIDENCY_LIMIT
            print(json.dumps(run), flush=True)
            ok &= run["streamed_data_peak_bytes"] <= chip_smoke.STREAM_RESIDENCY_LIMIT
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
