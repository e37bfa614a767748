#!/usr/bin/env python3
"""Per-phase cycles a tile of a head_dim-256 kernel instance, from
``clock()`` stamps in a copy of a checkout's ``csrc/`` source: float32 K1
(``--kernel fwd_f32``, the default), bf16 K1 (``fwd_bf16``), or bf16 K2
(``dq_bf16``) or K3 (``dkv_bf16``).

The instance names its phases in ``// clock: <phase>`` comments: a stamp
goes after each such line (after ``start`` the stamps' state is declared,
after ``store`` a warpgroup stores its sums). The instance is the
function's ``<256>`` specialisation where the source has one, else the
template itself (whose other instantiations then carry the stamps too).
Each phase gets the cycles from the stamp before it to its own, summed
over the block's tiles in every thread (a name may repeat: its stamps add
into one sum) and stored, for thread 0 of each warpgroup of the block that
holds the longest loop of the first head, into a ``__device__`` array that
an extra ``extern "C"`` function reads back. The copy, its headers and the
library go into ``_archive_check/clocks/`` (git-ignored); the checkout's
own sources are not touched.

    env PYTHONPATH=. python3 scripts/torch_fwd_clocks.py [--kernel K] [--root CHECKOUT]

Runs one launch at (2, 8, 4096, 256) causal after a warm-up, prints the
card's name and power limit, its SM clock during the run, and one JSON
line: cycles a tile per phase and warpgroup (a tile: the instance's key
tile for K1 and K2, its query tile for K3, at the checkout's own tiling),
and the stamped kernel's milliseconds (CUDA events over 5 launches; the
stamps cost some). Needs a CUDA device and ``nvcc``.
"""

import argparse
import ctypes
import importlib.util
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
WARPGROUPS = 4
MARK = re.compile(r"//.*\bclock: (.+?)\s*$")
# --kernel: source, function, C entry point, dtype, the kernel's name in
# kernel_tiles, and which side of its tiling a tile of the loop is.
KERNELS = {
    "fwd_f32": ("flash_fwd.cu", "flash_fwd_f32_kernel", "flash_fwd", torch.float32, "flash_fwd", 1),
    "fwd_bf16": ("flash_fwd.cu", "flash_fwd_bf16_kernel", "flash_fwd", torch.bfloat16,
                 "flash_fwd", 1),
    "dq_bf16": ("flash_bwd.cu", "flash_dq_bf16_kernel", "flash_bwd_dq", torch.bfloat16,
                "flash_dq", 1),
    "dkv_bf16": ("flash_bwd.cu", "flash_dkv_bf16_kernel", "flash_bwd_dkv", torch.bfloat16,
                 "flash_dkv", 0),
}

PRELUDE = f"""
__device__ unsigned int clk_sums[{WARPGROUPS}][{PHASES}];
#define CLK_DECL unsigned int clk_acc[{PHASES}] = {{}}; unsigned int clk_t = static_cast<unsigned int>(clock());
#define CLK(i) {{ const unsigned int n_ = static_cast<unsigned int>(clock()); clk_acc[i] += n_ - clk_t; clk_t = n_; }}
#define CLK_STORE if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x % 128 == 0) {{ \\
    for (int i_ = 0; i_ < {PHASES}; ++i_) clk_sums[threadIdx.x / 128][i_] = clk_acc[i_]; }}
"""

READER = f"""
extern "C" int clocks_read(unsigned int* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, clk_sums, sizeof(clk_sums)));
}}
extern "C" int clocks_reset() {{
  unsigned int zero[{WARPGROUPS} * {PHASES}] = {{}};
  return static_cast<int>(cudaMemcpyToSymbol(clk_sums, zero, sizeof(zero)));
}}
"""


def stamped(source, function):
    """``source`` with a stamp after each line of ``function``'s head_dim-256
    instance that carries a ``clock:`` comment; returns it and the phase
    names by index."""
    lines = source.splitlines()
    starts = [i for i, line in enumerate(lines) if f"{function}<256>(" in line]
    starts = starts or [i for i, line in enumerate(lines) if f"{function}(" in line]
    if not starts:
        raise ValueError(f"no {function} in the source")
    start = starts[0]
    end = next(i for i in range(start, len(lines)) if lines[i].startswith("}"))
    marks = [(i, m.group(1)) for i in range(start, end) if (m := MARK.search(lines[i]))]
    names = list(dict.fromkeys(name for _, name in marks if name not in ("start", "store")))
    if not names or [name for _, name in marks].count("start") != 1 or len(names) > PHASES:
        raise ValueError(f"{function}'s head_dim-256 instance has no usable `clock:` comments")
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


def build_copy(text, source, csrc, work):
    """``text`` as ``source`` beside the headers of ``csrc`` in ``work``
    (emptied first), built as the wrappers build; returns the library and
    nvcc's log (also in ``work/build.log``)."""
    from elephas_tpu_torch.ops import attention_cuda

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    for header in Path(csrc).glob("*.cuh"):
        shutil.copy(header, work / header.name)
    (work / source).write_text(text)
    lib = work / f"{Path(source).stem}.so"
    proc = subprocess.run(attention_cuda.nvcc_command(work / source, lib),
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (work / "build.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    return lib, log


def build(root, source, function):
    csrc = Path(root) / "elephas_tpu_torch" / "csrc"
    text, names = stamped((csrc / source).read_text(), function)
    lib, log = build_copy(text, source, csrc, REPO / "_archive_check" / "clocks")
    return lib, names, log


def checkout_tiles(root, name, dtype):
    """``kernel_tiles`` of the checkout at ``root`` (its own module, loaded
    from its file) for ``name`` at head_dim 256."""
    path = Path(root) / "elephas_tpu_torch" / "ops" / "attention_cuda.py"
    spec = importlib.util.spec_from_file_location("_checkout_attention_cuda", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.kernel_tiles(name, dtype, SHAPE[3])


def inputs(dtype, gen):
    """q, k, v, dO of ``SHAPE`` and, for the backward, the forward's f32 lse
    and delta = rowsum(dO * O), by plain PyTorch (causal)."""
    q, k, v, do = (torch.randn(SHAPE, device="cuda", generator=gen).to(dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(SHAPE[3])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s.masked_fill_(torch.ones(SHAPE[2], SHAPE[2], device="cuda", dtype=torch.bool).triu(1),
                   float("-inf"))
    lse = torch.logsumexp(s, -1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.float())
    delta = (do.float() * o).sum(-1)
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="fwd_f32")
    parser.add_argument("--root", default=str(REPO), help="checkout whose source is stamped")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_clocks: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from elephas_tpu_torch.ops import attention_cuda

    source, function, entry, dtype, name, side = KERNELS[args.kernel]
    print(smoke.smi("name,power.limit"), flush=True)
    lib_path, names, log = build(args.root, source, function)
    print("ptxas: " + smoke.ptxas_summary(log), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = attention_cuda.bind(lib, entry)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, s, d = SHAPE
    scale = 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream().cuda_stream
    if entry == "flash_fwd":
        q, k, v = (torch.randn(SHAPE, device="cuda", generator=gen).to(dtype) for _ in range(3))
        o = torch.empty_like(q)
        lse = torch.empty(SHAPE[:3], device="cuda")
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr()]
    else:
        q, k, v, do, lse, delta = inputs(dtype, gen)
        outs = [torch.empty_like(q) for _ in range(1 if entry == "flash_bwd_dq" else 2)]
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]
    bf16 = int(dtype == torch.bfloat16)

    def launch():
        err = fn(*ptrs, b * h, s, d, bf16, 1, scale, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")

    launch()
    torch.cuda.synchronize()
    ms = smoke.cuda_ms(launch, 5)
    if lib.clocks_reset() != 0:
        raise RuntimeError("clocks_reset failed")
    launch()
    torch.cuda.synchronize()
    clock = smoke.smi("clocks.sm")
    raw = (ctypes.c_uint * (WARPGROUPS * PHASES))()
    if lib.clocks_read(raw) != 0:
        raise RuntimeError("clocks_read failed")
    tiles = s // checkout_tiles(args.root, name, dtype)[side]  # the longest loop's tiles
    per_tile = {}
    for wg in range(WARPGROUPS):
        row = {phase: raw[wg * PHASES + i] / tiles for i, phase in enumerate(names)
               if raw[wg * PHASES + i]}
        if row:
            row["total"] = sum(row.values())
            per_tile[f"warpgroup {wg}"] = row
    print(json.dumps({"kernel": args.kernel, "shape": SHAPE, "causal": True, "tiles": tiles,
                      "sm_clock_after": clock, "stamped_ms": ms,
                      "cycles_per_tile": per_tile}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
