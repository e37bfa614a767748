#!/usr/bin/env python3
"""The wide-head kernel instances alone on one GPU: the kernel build with
each instantiation's registers and ``HGMMA``/``UTMALDG`` counts, then
``chip_smoke.py``'s ``wide_head`` phase (K1-K3 at head_dim 256 against
their plain versions, timed at (2, 8, 4096, 256) beside their bounds and
SDPA; head_dim 192 on zero columns; the ring's hop helpers; the full-width
head_dim-256 LM at 2 x 4096 tokens against its dense twin, a bf16 step,
scoring and train tokens/s) or, with ``--phase wide_head_512``, its
``wide_head_512`` phase (the instances above 256 at head_dim 512 and 768,
timed at (2, 4, 4096, 512) beside SDPA under each backend; head_dim 320
on zero columns; the hop helpers; the LM in heads of 512).

    env PYTHONPATH=. python3 scripts/torch_wide_head.py [--phase wide_head_512]

Needs a CUDA device and ``nvcc``; exits non-zero if a check fails. Prints
the card's name and power limit first.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
import torch  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", choices=("wide_head", "wide_head_512"), default="wide_head")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wide_head: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from elephas_tpu_torch.ops import attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.smi("name,power.limit"), flush=True)
    libs = attention_cuda.build_all()
    cuobjdump = str(Path(attention_cuda._nvcc()).with_name("cuobjdump"))
    for lib in libs.values():
        print("ptxas: " + smoke.ptxas_summary(lib.with_suffix(".log").read_text()), flush=True)
        counts = smoke.sass_counts(lib, cuobjdump)
        wide = {name: ops for name, ops in counts.items()
                if name.endswith(("D=256", "D=256n"))}
        print(f"sass {lib.name}: {json.dumps(wide)}", flush=True)
        for name, ops in wide.items():
            smoke.check(all(ops.get(op, 0) > 0 for op in smoke.required_ops(name)),
                        f"{name} has {ops} in its SASS")
    phase = getattr(smoke, f"{args.phase}_phase")
    launches, timing, errors, report = phase(attention_cuda)
    print(f"{args.phase}: {json.dumps(report)}", flush=True)
    print(json.dumps({"launches": launches,
                      "timing": {str(d): t for d, t in timing.items()},
                      "max_err": {n: {str(d): e for d, e in v.items()} for n, v in errors.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
