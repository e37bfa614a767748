#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elephas_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the process exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions;
2. build: ``csrc/flash_fwd.cu`` compiled with ``nvcc`` for ``sm_90a``;
3. kernel: the flash-attention forward against its plain PyTorch version
   (``blockwise_reference``) on the card, at the LM's shape in float32
   and bf16, at head_dim 64 and 128 and at a 37-token sequence, causal and
   full; timed beside the
   plain version and one ``F.scaled_dot_product_attention`` call (the
   yardstick, never called by the port) and printed with its bound;
4. slice: the Transformer LM at the registry's full width
   (``get_model("transformer_lm")``, random weights from a NumPy seed) —
   scoring forwards of 8 x 2048 tokens in float32 and bf16 through the
   kernel, checked against the dense-attention model, then greedy and
   sampled ``generate`` on 8 ragged prompts, two rows of the greedy
   stream checked against the same port on the CPU; a ``torch.profiler``
   kernel breakdown of one scoring forward per dtype and of one greedy
   ``generate``;
5. a JSON line with the kernel's launches on the slice, errors, times and
   bound;
6. the last line: ``{"ok": true, "device": {...}}``.

Needs a CUDA device, ``nvcc`` and this repository; exits non-zero without
them. Imports nothing of JAX.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
BATCH, SEQ = 8, 2048          # scoring batch: the LM's full context
NEW_TOKENS = 128
PROMPT_LENS = np.linspace(128, 1024, 8).astype(int)
CPU_ROWS = (0, 1)             # greedy rows re-run on the CPU
MARGIN = 1e-3                 # top-2 logit gap below which a tie may flip

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # (O, lse)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn`` over ``iters`` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(shape, dtype, causal):
    """Least time (ms) for the work: operations over the dtype's peak, and
    each input read once and each output written once over memory rate."""
    b, h, s, d = shape
    ops = (2.0 if causal else 4.0) * b * h * s * s * d
    itemsize = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4.0 * b * h * s * d * itemsize + 4.0 * b * h * s
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_summary(log):
    """Registers and spills per kernel instantiation from nvcc's -Xptxas -v."""
    parts, name = [], None
    for line in log.splitlines():
        entry = re.search(r"flash_fwd_(bf16|f32)_kernelILi(\d+)E", line)
        if "Compiling entry function" in line and entry:
            name = f"{entry.group(1)} D={entry.group(2)}"
            spill = "spills not reported"
        elif name and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            parts.append(f"{name}: {regs} registers, {spill}")
            name = None
    return "; ".join(parts)


def device_breakdown(fn, top=6):
    """Kernel time by name over one call of ``fn`` under torch.profiler,
    beside the call's wall time (which includes the profiler's cost)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def kernel_phase(attention_cuda, blockwise_reference):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [((BATCH, 8, SEQ, 32), True, torch.float32),
             ((BATCH, 8, SEQ, 32), True, torch.bfloat16)]
    cases += [((2, 8, 1000, d), causal, dtype)
              for d in (64, 128) for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [((3, 2, 37, 32), causal, dtype) for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    errors = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timing = {}
    for shape, causal, dtype in cases:
        q, k, v = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                   for _ in range(3))
        o, lse = attention_cuda.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = blockwise_reference(q, k, v, causal)
        err_o = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_o, tol_lse = TOL[dtype]
        print(f"kernel {tuple(shape)} causal={causal} {dtype}: "
              f"max|dO|={err_o:.3e} (atol {tol_o}) max|dlse|={err_lse:.3e} "
              f"(atol {tol_lse})", flush=True)
        check(err_o <= tol_o and err_lse <= tol_lse,
              f"flash_fwd disagrees with blockwise_reference at {shape} {dtype}")
        errors[dtype] = max(errors[dtype], err_o, err_lse)
        if shape[2] == SEQ:
            bound_ms, bound_by = flash_bound(shape, dtype, causal)
            timing[dtype] = {
                "ms": cuda_ms(lambda: attention_cuda.flash_fwd(q, k, v, causal), 20),
                "plain_ms": cuda_ms(lambda: blockwise_reference(q, k, v, causal), 3, 1),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), 20),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            print(f"timing {tuple(shape)} {dtype}: {json.dumps(timing[dtype])}",
                  flush=True)
    return errors, timing


def slice_phase(attention_cuda):
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.metrics import mfu, peak_flops, transformer_flops_per_token
    from elephas_tpu_torch.models import generate, get_model

    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, 32000, (BATCH, SEQ)), device="cuda")

    def compiled(**kw):
        return CompiledModel(get_model("transformer_lm", **kw),
                             loss="sparse_categorical_crossentropy",
                             metrics=["acc"], seed=SEED)

    report = {}
    flash_forwards = 0
    attention_cuda.launches = 0
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model = compiled(attention="flash", dtype=dtype)
        layers = model.module.num_layers
        before = attention_cuda.launches
        logits[dtype] = model.apply_eval(tokens)
        torch.cuda.synchronize()
        flash_forwards += 1
        check(attention_cuda.launches - before == layers,
              f"{dtype} forward launched flash_fwd "
              f"{attention_cuda.launches - before} times, expected {layers}")
        check(tuple(logits[dtype].shape) == (BATCH, SEQ, 32000)
              and bool(torch.isfinite(logits[dtype]).all()),
              f"{dtype} logits not finite or misshapen")
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            model.apply_eval(tokens)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / reps
        flash_forwards += reps
        tok_s = BATCH * SEQ / elapsed
        fpt = transformer_flops_per_token(model.count_params(), layers,
                                          model.module.d_model, SEQ)
        out = logits[dtype][:, :-1]
        report[f"profile_score_{dtype}"] = device_breakdown(
            lambda: model.apply_eval(tokens))
        flash_forwards += 1
        report[f"score_{dtype}"] = {
            "forward_ms": elapsed * 1e3,
            "tokens_per_s": tok_s,
            "mfu_vs_bf16_peak": mfu(tok_s, fpt, peak_flops()),
            "loss": float(model.loss_fn(out, tokens[:, 1:]).mean()),
            "acc": float(model.metric_fns[0](out, tokens[:, 1:]).mean()),
        }
        print(f"score {dtype}: {json.dumps(report[f'score_{dtype}'])}", flush=True)
        print(f"profile score {dtype}: "
              f"{json.dumps(report[f'profile_score_{dtype}'])}", flush=True)
        del model
    dense = compiled(attention="dense")
    err = (dense.apply_eval(tokens) - logits["float32"]).abs().max().item()
    print(f"score float32 flash vs dense: max|dlogits|={err:.3e} (atol 1e-3)")
    check(err <= 1e-3, "flash and dense float32 logits disagree")
    report["bf16_vs_f32_max_dlogits"] = (
        logits["bfloat16"] - logits["float32"]).abs().max().item()
    del dense, logits

    model = compiled(attention="flash")
    prompts = [rng.integers(1, 32000, n).tolist() for n in PROMPT_LENS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy = generate(model, prompts, NEW_TOKENS)
    elapsed = time.perf_counter() - t0
    plen = int(PROMPT_LENS.max())
    check(greedy.shape == (len(prompts), plen + NEW_TOKENS)
          and ((greedy >= 0) & (greedy < 32000)).all(), "greedy stream misshapen")
    for row, p in zip(greedy, prompts):
        check(row[plen - len(p):plen].tolist() == p, "prompt not carried through")
    report["generate_greedy"] = {"s": elapsed,
                                 "new_tokens_per_s": len(prompts) * NEW_TOKENS / elapsed}
    report["profile_generate_greedy"] = device_breakdown(
        lambda: generate(model, prompts, NEW_TOKENS))
    t0 = time.perf_counter()
    sampled = generate(model, prompts, NEW_TOKENS, temperature=0.8, top_k=40, seed=1)
    report["generate_sampled"] = {"s": time.perf_counter() - t0}
    check(sampled.shape == greedy.shape
          and ((sampled >= 0) & (sampled < 32000)).all(), "sampled stream misshapen")
    check((generate(model, prompts, NEW_TOKENS, temperature=0.8, top_k=40, seed=1)
           == sampled).all(), "sampled stream not reproducible from its seed")
    launches = attention_cuda.launches
    check(launches == flash_forwards * 4,
          f"flash_fwd launched {launches} times on the slice, expected "
          f"{flash_forwards * 4}")
    print(f"generate: {json.dumps(report['generate_greedy'])} "
          f"sampled {json.dumps(report['generate_sampled'])}", flush=True)

    # Greedy rows against the same port on the CPU, same weights: the CPU's
    # own stream up to its first step whose top-2 logit gap is below
    # MARGIN, and, teacher-forced on the GPU's stream, every step whose
    # CPU gap is at least MARGIN.
    cpu = CompiledModel(get_model("transformer_lm", device="cpu"),
                        params=model.get_weights())
    cpu_prompts = [prompts[i] for i in CPU_ROWS]
    cpu_out = generate(cpu, cpu_prompts, NEW_TOKENS)
    cpu_plen = max(len(p) for p in cpu_prompts)

    def cpu_steps(prompt, new):
        """CPU argmax and top-2 gap of each step, given prompt + new."""
        stream = torch.as_tensor(np.concatenate([prompt, new[:-1]]))[None]
        top2 = torch.topk(cpu.apply_eval(stream)[0, len(prompt) - 1:], 2, dim=-1)
        return top2.indices[:, 0].numpy(), (top2.values[:, 0] - top2.values[:, 1]).numpy()

    compared, forced = [], []
    for i, row in zip(CPU_ROWS, cpu_out):
        check(row[cpu_plen - len(prompts[i]):cpu_plen].tolist() == prompts[i],
              "CPU prompt not carried through")
        new_cpu, new_gpu = row[cpu_plen:], greedy[i, plen:]
        _, gaps = cpu_steps(prompts[i], new_cpu)
        n = int(np.argmax(gaps < MARGIN)) if (gaps < MARGIN).any() else NEW_TOKENS
        check((new_cpu[:n] == new_gpu[:n]).all(),
              f"row {i}: GPU greedy stream differs from the CPU's within the "
              f"first {n} steps")
        compared.append(n)
        best, gaps = cpu_steps(prompts[i], new_gpu)
        clear = gaps >= MARGIN
        check((best[clear] == new_gpu[clear]).all(),
              f"row {i}: a GPU greedy token is not the CPU's argmax on the "
              "GPU's own stream")
        forced.append(int(clear.sum()))
    print(f"generate: GPU greedy rows {CPU_ROWS} equal the CPU's stream over "
          f"{compared} of {NEW_TOKENS} steps (cut at top-2 gap < {MARGIN}); "
          f"teacher-forced, the GPU's token is the CPU's argmax at {forced} "
          f"steps (all with gap >= {MARGIN})", flush=True)
    report["cpu_rows_stream_steps"] = compared
    report["cpu_rows_forced_steps"] = forced
    return launches, report


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from elephas_tpu_torch.ops import attention_cuda
    from elephas_tpu_torch.ops.attention import blockwise_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    lib = attention_cuda.build()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    print("ptxas: " + ptxas_summary(lib.with_suffix(".log").read_text()), flush=True)

    errors, timing = kernel_phase(attention_cuda, blockwise_reference)
    launches, report = slice_phase(attention_cuda)
    print(f"slice: {json.dumps(report)}")

    f32, bf16 = timing[torch.float32], timing[torch.bfloat16]
    entry = {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "elephas_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "elephas_tpu/ops/attention_pallas.py:36",
        "launches": launches,
        "max_abs_err": errors[torch.float32],
        "max_err_f32": errors[torch.float32],
        "max_err_bf16": errors[torch.bfloat16],
        **f32,
        "bf16": bf16,
    }
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
