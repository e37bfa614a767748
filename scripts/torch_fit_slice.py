"""Runs ``chip_smoke.py``'s fit-slice phase alone on one GPU.

    env PYTHONPATH=. python3 scripts/torch_fit_slice.py

The phase (``chip_smoke.fit_slice_phase``) holds captured train steps
against eager ones to the bit, prints the autotune A/B table (eager
against captured, ms per 2-batch run), runs autotuned and streamed fits
beside plain ones, and checks the ``GroupVault`` and ``HyperParamModel``
repairs. TF32 off and ``cudnn.benchmark`` on, as in the full run.
Prints the card's name and power limit first and the phase's report
last; builds no kernel (about a minute).
"""

import json
import time

import chip_smoke
import torch
from elephas_tpu_torch.ops import attention_cuda


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_fit_slice: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    print(chip_smoke.smi("name,power.limit"), flush=True)
    t0 = time.perf_counter()
    launches, report = chip_smoke.fit_slice_phase(attention_cuda)
    print("fit_slice: " + json.dumps(report), flush=True)
    print(json.dumps({"launches": launches, "wall_s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
