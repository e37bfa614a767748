#!/usr/bin/env python3
"""Milliseconds of a head_dim-256 kernel instance with constants of its
shape changed, against the unchanged instance, in turns on one GPU.

    env PYTHONPATH=. python3 scripts/torch_fwd_variants.py [--kernel K] \\
        [--launches 20] [--turns 1] --variant kKSlots=3,kVSlots=2 \\
        --variant kSkipMasked=false

``--kernel`` names an instance as ``scripts/torch_fwd_clocks.py`` does
(``fwd_bf16`` by default). A variant rewrites, in a copy of the tree's
``csrc/`` source, every ``static constexpr <type> NAME = <value>;`` for
each ``NAME=VALUE`` it gives (so name a constant that only the instance's
own struct declares); the copies and the unchanged source are built at
once, one ``nvcc`` each, into ``_archive_check/variants/<i>/``
(git-ignored). Every build runs on the
same causal inputs of (2, 8, 4096, 256); a variant's outputs must equal
the unchanged build's bit for bit (a ring's depth or a skipped masked tile
changes no sum), and the script exits 1 if one does not. Then each is
timed with CUDA events over ``--launches`` launches, in turns: the
unchanged build, the variants, the variants again in reverse, the
unchanged build, all of it ``--turns`` times. Prints
the card's name and power limit, each build's ptxas line, and one JSON
line. Needs a CUDA device and ``nvcc``.
"""

import argparse
import ctypes
import json
import math
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import torch  # noqa: E402
from torch_fwd_clocks import KERNELS, SHAPE, build_copy, inputs  # noqa: E402


def substituted(source, assignments):
    """``source`` with each ``static constexpr <type> NAME = ...;`` of
    ``assignments`` (name -> value) set to the value."""
    for name, value in assignments.items():
        pattern = re.compile(rf"(static constexpr \w+ {name} = )[^;]+;")
        source, n = pattern.subn(lambda m: f"{m.group(1)}{value};", source)
        if n == 0:
            raise ValueError(f"no `static constexpr ... {name} = ...;` in the source")
    return source


def parse_variant(text):
    pairs = [item.split("=", 1) for item in text.split(",") if item]
    if not pairs or any(len(pair) != 2 for pair in pairs):
        raise argparse.ArgumentTypeError(f"{text!r} is not NAME=VALUE[,NAME=VALUE...]")
    return {name.strip(): value.strip() for name, value in pairs}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="fwd_bf16")
    parser.add_argument("--variant", type=parse_variant, action="append", required=True)
    parser.add_argument("--launches", type=int, default=20, help="launches a time")
    parser.add_argument("--turns", type=int, default=1, help="rounds of the turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from elephas_tpu_torch.ops import attention_cuda

    source, _, entry, dtype, _, _ = KERNELS[args.kernel]
    print(smoke.smi("name,power.limit"), flush=True)
    text = (attention_cuda.CSRC / source).read_text()
    labels = ["unchanged"] + [",".join(f"{k}={v}" for k, v in a.items()) for a in args.variant]
    texts = [text] + [substituted(text, a) for a in args.variant]
    work = REPO / "_archive_check" / "variants"
    with ThreadPoolExecutor(len(texts)) as pool:
        built = list(pool.map(lambda i: build_copy(texts[i], source, attention_cuda.CSRC,
                                                   work / str(i)), range(len(texts))))
    fns = []
    for label, (lib_path, log) in zip(labels, built):
        print(f"ptxas {label}: " + smoke.ptxas_summary(log), flush=True)
        for line in log.splitlines():
            if re.search(r"C75\d\d", line):
                print(f"  {line.strip()[:300]}", flush=True)
        fns.append(attention_cuda.bind(ctypes.CDLL(str(lib_path)), entry))

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, s, d = SHAPE
    scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream().cuda_stream
    q, k, v, do, lse, delta = inputs(dtype, gen)
    if entry == "flash_fwd":
        outs = [torch.empty_like(q), torch.empty(SHAPE[:3], device="cuda")]
        args_in = [q, k, v]
    else:
        outs = [torch.empty_like(q) for _ in range(1 if entry == "flash_bwd_dq" else 2)]
        args_in = [q, k, v, do, lse, delta]
    ptrs = [t.data_ptr() for t in (*args_in, *outs)]
    bf16 = int(dtype == torch.bfloat16)

    def launcher(fn):
        def launch():
            err = fn(*ptrs, b * h, s, d, bf16, 1, scale, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cudaError {err}")
        return launch

    launches = [launcher(fn) for fn in fns]
    results = []
    for launch in launches:
        launch()
        torch.cuda.synchronize()
        results.append([t.clone() for t in outs])
    equal = {label: all(torch.equal(a, b) for a, b in zip(got, results[0]))
             for label, got in zip(labels, results)}
    order = list(range(len(labels))) + list(range(len(labels) - 1, 0, -1)) + [0]
    ms = {label: [] for label in labels}
    for i in order * args.turns:
        ms[labels[i]].append(smoke.cuda_ms(launches[i], args.launches))
    print(json.dumps({"kernel": args.kernel, "shape": SHAPE, "causal": True,
                      "launches_per_time": args.launches, "ms_in_turns": ms,
                      "equal_to_unchanged": equal}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
