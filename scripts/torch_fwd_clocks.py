#!/usr/bin/env python3
"""Per-phase cycles a tile of float32 K1 at head_dim 256, from ``clock()``
stamps in a copy of a checkout's ``csrc/flash_fwd.cu``.

The ``flash_fwd_f32_kernel<256>`` specialisation names its phases in
``// clock: <phase>`` comments: a stamp goes after each such line (after
``start`` the stamps' state is declared, after ``store`` a warpgroup
stores its sums). Each phase gets the cycles from the stamp before it to
its own, summed over the block's tiles in every thread (a name may
repeat: its stamps add into one sum) and stored, for thread 0 of each
warpgroup of the block with the longest query tile of the first head,
into a ``__device__`` array that an extra ``extern "C"`` function reads
back. The copy, its headers and the library go into
``_archive_check/clocks/`` (git-ignored); the checkout's own sources are
not touched.

    env PYTHONPATH=. python3 scripts/torch_fwd_clocks.py [--root CHECKOUT]

Runs one launch at (2, 8, 4096, 256) causal after a warm-up, prints the
card's name and power limit, its SM clock during the run, and one JSON
line: cycles a tile per phase and warpgroup, and the stamped kernel's
milliseconds (CUDA events over 5 launches; the stamps cost some).
Needs a CUDA device and ``nvcc``.
"""

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

SHAPE = (2, 8, 4096, 256)
PHASES = 16
MARK = re.compile(r"//.*\bclock: (.+?)\s*$")

PRELUDE = f"""
__device__ unsigned int k1_clk[2][{PHASES}];
#define CLK_DECL unsigned int clk_acc[{PHASES}] = {{}}; unsigned int clk_t = static_cast<unsigned int>(clock());
#define CLK(i) {{ const unsigned int n_ = static_cast<unsigned int>(clock()); clk_acc[i] += n_ - clk_t; clk_t = n_; }}
#define CLK_STORE if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 128 == 0) {{ \\
    for (int i_ = 0; i_ < {PHASES}; ++i_) k1_clk[threadIdx.x / 128][i_] = clk_acc[i_]; }}
"""

READER = f"""
extern "C" int k1_clocks(unsigned int* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, k1_clk, sizeof(unsigned int) * 2 * {PHASES}));
}}
extern "C" int k1_clocks_reset() {{
  unsigned int zero[2 * {PHASES}] = {{}};
  return static_cast<int>(cudaMemcpyToSymbol(k1_clk, zero, sizeof(zero)));
}}
"""


def stamped(source):
    """``source`` (flash_fwd.cu's text) with a stamp after each line of
    the D = 256 float32 kernel that carries a ``clock:`` comment; returns
    it and the phase names by index."""
    lines = source.splitlines()
    start = next(i for i, line in enumerate(lines) if "flash_fwd_f32_kernel<256>(" in line)
    end = next(i for i in range(start, len(lines)) if lines[i].startswith("}"))
    marks = [(i, m.group(1)) for i in range(start, end) if (m := MARK.search(lines[i]))]
    names = list(dict.fromkeys(name for _, name in marks if name not in ("start", "store")))
    if not names or [name for _, name in marks].count("start") != 1 or len(names) > PHASES:
        raise ValueError("the D = 256 float32 kernel has no usable `clock:` comments")
    special = {"start": "CLK_DECL", "store": "CLK_STORE"}
    after = {i: special[name] if name in special else f"CLK({names.index(name)});"
             for i, name in marks}
    out = []
    for i, line in enumerate(lines):
        out.append(line)
        if i in after:
            out.append(after[i])
    text = "\n".join(out) + "\n" + READER
    text = re.sub(r'(#include "tf32.cuh"\n)', lambda m: m.group(1) + PRELUDE, text, count=1)
    return text, names


def build(root):
    from elephas_tpu_torch.ops import attention_cuda

    csrc = Path(root) / "elephas_tpu_torch" / "csrc"
    work = REPO / "_archive_check" / "clocks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, work / header.name)
    text, names = stamped((csrc / "flash_fwd.cu").read_text())
    (work / "flash_fwd.cu").write_text(text)
    lib = work / "flash_fwd_clocks.so"
    proc = subprocess.run(attention_cuda.nvcc_command(work / "flash_fwd.cu", lib),
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (work / "build.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    return lib, names, log


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose flash_fwd.cu is stamped")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_clocks: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from elephas_tpu_torch.ops import attention_cuda

    print(smoke.smi("name,power.limit"), flush=True)
    lib_path, names, log = build(args.root)
    print("ptxas: " + smoke.ptxas_summary(log), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = attention_cuda.bind(lib, "flash_fwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(SHAPE, device="cuda", generator=gen) for _ in range(3))
    o = torch.empty_like(q)
    lse = torch.empty(SHAPE[:3], device="cuda")
    b, h, s, d = SHAPE

    def launch():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b * h,
                 s, d, 0, 1, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")

    launch()
    torch.cuda.synchronize()
    ms = smoke.cuda_ms(launch, 5)
    if lib.k1_clocks_reset() != 0:
        raise RuntimeError("k1_clocks_reset failed")
    launch()
    torch.cuda.synchronize()
    clock = smoke.smi("clocks.sm")
    raw = (ctypes.c_uint * (2 * PHASES))()
    if lib.k1_clocks(raw) != 0:
        raise RuntimeError("k1_clocks failed")
    tiles = s // 16  # the longest query tile's key tiles
    per_tile = {}
    for wg in range(2):
        row = {name: raw[wg * PHASES + i] / tiles for i, name in enumerate(names)
               if raw[wg * PHASES + i]}
        if row:
            row["total"] = sum(row.values())
            per_tile[f"warpgroup {wg}"] = row
    print(json.dumps({"shape": SHAPE, "causal": True, "tiles": tiles,
                      "sm_clock_after": clock, "stamped_ms": ms,
                      "cycles_per_tile": per_tile}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
