#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``elephas_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the process exits non-zero:

1. environment: the card's name and power limit (``nvidia-smi``), torch
   and CUDA versions;
2. build: ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` compiled with
   ``nvcc`` for ``sm_90a``, one ``nvcc`` each, both at once; ptxas's
   registers and spills per kernel, and from ``cuobjdump -sass`` the
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions of each
   kernel instantiation: every kernel, K1-K3 in bf16 and in float32 (split
   tf32), runs on wgmma fed by TMA, and the run fails if an instantiation
   has none of either (``required_ops``);
3. kernels: the flash-attention forward (K1) against its plain PyTorch
   version (``blockwise_reference``), then the backward kernels (K2 dq,
   K3 dk/dv) against theirs (``flash_backward_reference``, on K1's o and
   lse and a seeded dO; by max error and by norm, over each output and
   each 64-row block), on the card, at the LM's shape in float32 and
   bf16, at head_dim 64 and 128 and at a 37-token sequence, causal and
   full, the plain versions at each kernel's own tiling
   (``attention_cuda.kernel_tiles``); each timed at the LM's shape beside
   its plain version and one PyTorch call
   (``F.scaled_dot_product_attention`` and its backward: the yardsticks,
   never called by the port) and printed with its bound (each float32
   kernel also with the split-tf32 tensor-core bound, ``bound_tc_ms``), the floor the
   exponentials set (one per valid score, 16 a clock per SM at the card's
   maximum SM clock) and the card's clock, power draw and temperature;
4. inference: the Transformer LM at the registry's full width
   (``get_model("transformer_lm")``, random weights from a NumPy seed) —
   scoring forwards of 8 x 2048 tokens in float32 and bf16 through K1,
   checked against the dense-attention model, then greedy and sampled
   ``generate`` on 8 ragged prompts, two rows of the greedy stream checked
   against the same port on the CPU; a ``torch.profiler`` kernel breakdown
   of one scoring forward per dtype and of one greedy ``generate``;
5. training: the same LM through ``make_train_step`` (Adam, lr 1e-3) on
   a seeded 8 x 2048 batch — float32 and bf16 loss and gradients through
   K1-K3 checked against the dense-attention model, then 20 steps in float32
   and in bf16 (loss falls, stays finite, exactly 4 launches of each
   kernel per step), train tokens/s, MFU and a kernel breakdown of one
   step per dtype;
6. a JSON line with each kernel's launches on the paths, errors, times
   and bound;
7. the last line: ``{"ok": true, "device": {...}}``.

Needs a CUDA device, ``nvcc`` and this repository; exits non-zero without
them. Imports nothing of JAX.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
BATCH, SEQ = 8, 2048          # scoring batch: the LM's full context
NEW_TOKENS = 128
PROMPT_LENS = np.linspace(128, 1024, 8).astype(int)
CPU_ROWS = (0, 1)             # greedy rows re-run on the CPU
MARGIN = 1e-3                 # top-2 logit gap below which a tie may flip

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}  # (O, lse)
# K2/K3: max |error| <= tol * max(1, max |reference|), per output.
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K2/K3: ||error|| <= tol * ||reference||, per output and per 64-row block
# of each (batch, head): the late rows and keys of a causal sequence carry
# gradients far below the early ones' max, which the max-abs limit misses.
TOL_BWD_NORM = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
TRAIN_STEPS, TRAIN_WARMUP = 20, 2  # steps per dtype; untimed leading steps
LOSS_DROP = 2.0                    # the loss falls by at least this over the steps
GRAD_RTOL = 1e-3                   # flash vs dense f32 grads, relative to each max
LOSS_ATOL = 1e-4                   # flash vs dense f32 loss
BF16_GRAD_RTOL = 5e-2              # flash vs dense bf16 grads, by norm, per parameter
BF16_LOSS_ATOL = 1e-2              # flash vs dense bf16 loss


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


def bound_ms(ops, nbytes, dtype):
    """Least time (ms) for the work: operations over the dtype's peak, and
    each input read once and each output written once over memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_work(shape, itemsize, causal):
    """FLOPs and bytes of each kernel at ``shape`` (B, H, S, D), from the
    Pallas kernels' CostEstimates: K1 2·B·H·S²·D FLOPs causal (4 full),
    reading q, k, v and writing o and lse; K2 3 (6) and K3 4 (8), both
    reading q, k, v, dO, lse and delta, K2 writing dq and K3 dk and dv."""
    b, h, s, d = shape
    flops = (1.0 if causal else 2.0) * b * h * s * s * d
    tensor, rows = b * h * s * d * itemsize, 4.0 * b * h * s
    return {"flash_fwd": (2 * flops, 4 * tensor + rows),
            "flash_dq": (3 * flops, 5 * tensor + 2 * rows),
            "flash_dkv": (4 * flops, 6 * tensor + 2 * rows)}


def split_tf32_bound_ms(flops, nbytes):
    """A float32 kernel on tf32 tensor cores in split tf32: three products
    for each of its FLOPs over the tf32 peak, or its bytes over the memory
    rate."""
    return max(3 * flops / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3


def exp_floor_ms(shape, causal, sms, clock_mhz):
    """Least time (ms) the special-function units take for the kernel's
    exponentials: one per valid score element, 16 per clock per SM."""
    b, h, s, _ = shape
    valid = b * h * (s * (s + 1) / 2 if causal else s * s)
    return valid / (16.0 * sms * clock_mhz * 1e6) * 1e3


def smi(fields):
    """The card's ``nvidia-smi`` values of ``fields`` (comma-separated), as
    printed (units included)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sass_counts(lib, cuobjdump):
    """``HGMMA`` and ``UTMALDG`` instructions per kernel instantiation in
    the library's SASS (``cuobjdump -sass``)."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        entry = re.search(r"Function : \S*?(flash_[a-z]+)_(bf16|f32)_kernelILi(\d+)E", line)
        if entry:
            name = f"{entry.group(1)} {entry.group(2)} D={entry.group(3)}"
            counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name:
            for op in counts[name]:
                counts[name][op] += line.count(op)
    return counts


def required_ops(instance):
    """SASS instructions the instantiation ``instance`` (``"flash_fwd f32
    D=32"``) must hold: ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load), as
    every kernel, K1-K3 in bf16 and in float32, is built for Hopper."""
    name, dtype, _ = instance.split()
    if name not in ("flash_fwd", "flash_dq", "flash_dkv") or dtype not in ("bf16", "f32"):
        raise ValueError(f"unknown kernel instantiation {instance!r}")
    return ("HGMMA", "UTMALDG")


def ptxas_summary(log):
    """Registers and spills per kernel instantiation from nvcc's -Xptxas -v."""
    parts, name = [], None
    for line in log.splitlines():
        entry = re.search(r"(flash_[a-z]+)_(bf16|f32)_kernelILi(\d+)E", line)
        if "Compiling entry function" in line and entry:
            name = f"{entry.group(1)} {entry.group(2)} D={entry.group(3)}"
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
    beside the call's wall time (which includes the profiler's cost), and
    each flash kernel's total. User annotations (the optimizer's
    ``Optimizer.step`` range) are left out: their device time is that of
    the kernels inside them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    flash_ms = {name: sum(e.self_device_time_total for e in kernels
                          if f"{name}_" in e.key) / 1e3 for name in KERNELS}
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms, "flash_ms": flash_ms,
            "top": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


def norm_errors(got, ref, rows=64):
    """||got - ref|| / ||ref|| over the whole tensor, and the largest over
    blocks of ``rows`` rows of each (batch, head) of a (B, H, S, D) pair."""
    got, ref = got.float(), ref.float()
    whole = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    b, h, s, d = ref.shape
    pad = (0, 0, 0, -s % rows)
    diff = F.pad(got - ref, pad).reshape(b, h, -1, rows * d)
    ref = F.pad(ref, pad).reshape(b, h, -1, rows * d)
    block = (diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max().item()
    return whole, block


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def kernel_phase(attention_cuda):
    """Every kernel against its plain version at 14 cases, the plain
    version at the kernel's own tiling; times at the LM's shape. Returns
    per-kernel max errors and timings by dtype."""
    from elephas_tpu_torch.ops.attention import (
        blockwise_reference,
        flash_backward_reference,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [((BATCH, 8, SEQ, 32), True, torch.float32),
             ((BATCH, 8, SEQ, 32), True, torch.bfloat16)]
    cases += [((2, 8, 1000, d), causal, dtype)
              for d in (64, 128) for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [((3, 2, 37, 32), causal, dtype) for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    errors = {name: {torch.float32: 0.0, torch.bfloat16: 0.0} for name in KERNELS}
    norm_worst = {name: {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
                  for name in KERNELS if name != "flash_fwd"}
    timing = {name: {} for name in KERNELS}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_clock = float(smi("clocks.max.sm").split()[0])
    for shape, causal, dtype in cases:
        tiles = {name: attention_cuda.kernel_tiles(name, dtype, shape[3]) for name in KERNELS}
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype)
                       for _ in range(4))
        o, lse = attention_cuda.flash_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1)
        dq = attention_cuda.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        dk, dv = attention_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = blockwise_reference(q, k, v, causal, *tiles["flash_fwd"])
        err_o = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol_o, tol_lse = TOL[dtype]
        print(f"kernel {tuple(shape)} causal={causal} {dtype}: "
              f"max|dO|={err_o:.3e} (atol {tol_o}) max|dlse|={err_lse:.3e} "
              f"(atol {tol_lse})", flush=True)
        check(err_o <= tol_o and err_lse <= tol_lse,
              f"flash_fwd disagrees with blockwise_reference at {shape} {dtype}")
        errors["flash_fwd"][dtype] = max(errors["flash_fwd"][dtype], err_o, err_lse)

        # K2's dq and K3's dk, dv each from the plain version at its tiling.
        ref = dict(zip(("dq", "dk", "dv"), flash_backward_reference(
            q, k, v, o, lse, do, causal, *tiles["flash_dq"])))
        if tiles["flash_dkv"] != tiles["flash_dq"]:
            ref["dk"], ref["dv"] = flash_backward_reference(
                q, k, v, o, lse, do, causal, *tiles["flash_dkv"])[1:]
        parts = []
        for name, label, got in (("flash_dq", "dq", dq), ("flash_dkv", "dk", dk),
                                 ("flash_dkv", "dv", dv)):
            err = (got.float() - ref[label].float()).abs().max().item()
            allowed = TOL_BWD[dtype] * max(1.0, ref[label].float().abs().max().item())
            whole, block = norm_errors(got, ref[label])
            parts.append(f"max|d{label}|={err:.3e} (allowed {allowed:.3e}) "
                         f"norm {whole:.2e} worst block {block:.2e}")
            check(err <= allowed, f"{name} {label} disagrees with "
                  f"flash_backward_reference at {shape} causal={causal} {dtype}")
            check(max(whole, block) <= TOL_BWD_NORM[dtype],
                  f"{name} {label} norm error {whole:.2e} (worst block {block:.2e}) "
                  f"above {TOL_BWD_NORM[dtype]} at {shape} causal={causal} {dtype}")
            errors[name][dtype] = max(errors[name][dtype], err)
            worst = norm_worst[name][dtype]
            worst[:] = max(worst[0], whole), max(worst[1], block)
        print(f"kernel bwd {tuple(shape)} causal={causal} {dtype}: " + "; ".join(parts)
              + f" (norm limit {TOL_BWD_NORM[dtype]})", flush=True)

        if shape[2] == SEQ:
            work = kernel_work(shape, q.element_size(), causal)
            bounds = {name: bound_ms(*work[name], dtype) for name in KERNELS}
            exp_floor = exp_floor_ms(shape, causal, sms, max_clock)
            timing["flash_fwd"][dtype] = {
                "ms": cuda_ms(lambda: attention_cuda.flash_fwd(q, k, v, causal), 20),
                "plain_ms": cuda_ms(lambda: blockwise_reference(
                    q, k, v, causal, *tiles["flash_fwd"]), 3, 1),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), 20),
            }
            # The plain version and SDPA's backward each compute dq, dk and
            # dv together; SDPA's forward runs once, outside the timing.
            plain_ms = cuda_ms(lambda: flash_backward_reference(
                q, k, v, o, lse, do, causal, *tiles["flash_dkv"]), 3, 1)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            library_ms = cuda_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), 20)
            launch = {
                "flash_dq": lambda: attention_cuda.flash_bwd_dq(
                    q, k, v, do, lse, delta, causal),
                "flash_dkv": lambda: attention_cuda.flash_bwd_dkv(
                    q, k, v, do, lse, delta, causal),
            }
            for name, fn in launch.items():
                timing[name][dtype] = {"ms": cuda_ms(fn, 20), "plain_ms": plain_ms,
                                       "library_ms": library_ms}
            for name in KERNELS:
                bound, by = bounds[name]
                timing[name][dtype].update(bound_ms=bound, bound_by=by, exp_floor_ms=exp_floor)
                if dtype == torch.float32:
                    timing[name][dtype]["bound_tc_ms"] = split_tf32_bound_ms(*work[name])
            print(f"card during the timings ({dtype}): "
                  f"{smi('clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu')} "
                  "(clocks.sm, clocks.max.sm, power.draw, power.limit, temperature.gpu)",
                  flush=True)
            for name in KERNELS:
                print(f"timing {name} {tuple(shape)} {dtype}: "
                      f"{json.dumps(timing[name][dtype])}", flush=True)
    for name, by_dtype in norm_worst.items():
        for dtype, (whole, block) in by_dtype.items():
            print(f"kernel bwd {name} {dtype}: worst norm error {whole:.3e}, worst "
                  f"64-row block {block:.3e} over the cases", flush=True)
    return errors, timing


def inference_phase(attention_cuda):
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
    attention_cuda.reset_launches()
    logits = {}
    for dtype in ("float32", "bfloat16"):
        model = compiled(attention="flash", dtype=dtype)
        layers = model.module.num_layers
        before = attention_cuda.launches["flash_fwd"]
        logits[dtype] = model.apply_eval(tokens)
        torch.cuda.synchronize()
        flash_forwards += 1
        launched = attention_cuda.launches["flash_fwd"] - before
        check(launched == layers,
              f"{dtype} forward launched flash_fwd {launched} times, expected {layers}")
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
    launches = dict(attention_cuda.launches)
    check(launches == {"flash_fwd": flash_forwards * 4, "flash_dq": 0, "flash_dkv": 0},
          f"inference launched {launches}, expected {flash_forwards * 4} flash_fwd "
          "and no backward kernel")
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


def train_phase(attention_cuda):
    """LM training at full width through K1-K3: f32 loss and gradients
    against the dense model, then TRAIN_STEPS steps per dtype."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.engine.step import (
        init_train_state,
        make_loss_fn,
        make_train_step,
    )
    from elephas_tpu_torch.metrics import mfu, peak_flops, transformer_flops_per_token
    from elephas_tpu_torch.models import get_model

    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, 32000, (BATCH, SEQ + 1)), device="cuda")
    x, y = tokens[:, :-1], tokens[:, 1:]

    def compiled(**kw):
        return CompiledModel(get_model("transformer_lm", **kw),
                             optimizer={"name": "adam", "learning_rate": 1e-3},
                             loss="sparse_categorical_crossentropy",
                             metrics=["acc"], seed=SEED)

    def expect_launches(before, steps, what):
        launched = {k: attention_cuda.launches[k] - before[k] for k in KERNELS}
        layers = 4
        check(launched == {k: layers * steps for k in KERNELS},
              f"{what} launched {launched}, expected {layers * steps} of each")

    report = {}
    attention_cuda.reset_launches()

    def loss_and_grads(attention, dtype):
        """One loss and gradient; the key third of each qkv bias is left
        out, its exact gradient being 0 (softmax ignores a shift shared by
        all of a query's scores), so that what is left is rounding."""
        model = compiled(attention=attention, dtype=dtype)
        before = dict(attention_cuda.launches)
        loss, _ = make_loss_fn(model)(x, y)
        loss.backward()
        torch.cuda.synchronize()
        if attention == "flash":
            expect_launches(before, 1, f"the {dtype} flash loss and gradient")
        grads = {}
        for n, p in model.module.named_parameters():
            g = p.grad
            if n.endswith("attn.qkv.bias"):
                third = len(g) // 3
                g = torch.cat([g[:third], g[2 * third:]])
            grads[n] = g
        return loss.item(), grads

    def norm_rel(got, ref):
        """Worst parameter's ||got - ref|| / ||ref||, and its name."""
        rel = {n: ((got[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
               for n, g in ref.items()}
        name = max(rel, key=rel.get)
        return rel[name], name

    # (a) One float32 loss and gradient through the kernels, and through
    # plain autograd of the dense-attention model on the same weights;
    # then the same in bf16, each also held against the f32 dense one.
    losses, grads = {}, {}
    for attention in ("flash", "dense"):
        losses[attention], grads[attention] = loss_and_grads(attention, "float32")
    worst = max(((grads["flash"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
                for n, g in grads["dense"].items())
    dloss = abs(losses["flash"] - losses["dense"])
    print(f"train f32 flash vs dense: loss {losses['flash']:.6f} vs {losses['dense']:.6f} "
          f"(|d| {dloss:.2e}, atol {LOSS_ATOL}); worst gradient max|d| / max|g| "
          f"{worst:.2e} (rtol {GRAD_RTOL}) over {len(grads['dense'])} parameters",
          flush=True)
    check(dloss <= LOSS_ATOL, "flash and dense f32 losses disagree")
    check(worst <= GRAD_RTOL, "flash and dense f32 gradients disagree")
    report["f32_flash_vs_dense"] = {"loss_abs_err": dloss, "grad_rel_err": worst}
    f32 = grads.pop("dense")
    for attention in ("flash", "dense"):
        losses[attention], grads[attention] = loss_and_grads(attention, "bfloat16")
    rel, rel_name = norm_rel(grads["flash"], grads["dense"])
    flash_f32, flash_f32_name = norm_rel(grads["flash"], f32)
    dense_f32, dense_f32_name = norm_rel(grads["dense"], f32)
    dloss = abs(losses["flash"] - losses["dense"])
    print(f"train bf16 flash vs dense: loss {losses['flash']:.6f} vs {losses['dense']:.6f} "
          f"(|d| {dloss:.2e}, atol {BF16_LOSS_ATOL}); worst gradient ||d|| / ||g|| "
          f"{rel:.3e} at {rel_name} (rtol {BF16_GRAD_RTOL}); against the f32 dense "
          f"gradients: flash {flash_f32:.3e} at {flash_f32_name}, dense {dense_f32:.3e} "
          f"at {dense_f32_name}", flush=True)
    check(dloss <= BF16_LOSS_ATOL, "flash and dense bf16 losses disagree")
    check(rel <= BF16_GRAD_RTOL, "flash and dense bf16 gradients disagree")
    report["bf16_flash_vs_dense"] = {"loss_abs_err": dloss, "grad_norm_rel_err": rel,
                                     "flash_vs_f32_dense": flash_f32,
                                     "dense_vs_f32_dense": dense_f32}
    del grads, f32

    # (b)-(d) TRAIN_STEPS steps per dtype on the fixed batch.
    for dtype in ("float32", "bfloat16"):
        model = compiled(attention="flash", dtype=dtype)
        step = make_train_step(model)
        state = init_train_state(model)
        before = dict(attention_cuda.launches)
        history = []
        for i in range(TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, metrics = step(state, x, y)
            history.append(metrics)
        torch.cuda.synchronize()
        elapsed = (time.perf_counter() - t0) / (TRAIN_STEPS - TRAIN_WARMUP)
        expect_launches(before, TRAIN_STEPS, f"{TRAIN_STEPS} {dtype} train steps")
        curve = [float(m["loss"]) for m in history]
        print(f"train {dtype} loss: {[round(v, 4) for v in curve]}", flush=True)
        check(all(np.isfinite(curve)), f"{dtype} training loss not finite")
        check(curve[-1] <= curve[0] - LOSS_DROP,
              f"{dtype} loss fell {curve[0] - curve[-1]:.3f} over {TRAIN_STEPS} steps, "
              f"expected at least {LOSS_DROP}")
        tok_s = BATCH * SEQ / elapsed
        fpt = transformer_flops_per_token(model.count_params(), model.module.num_layers,
                                          model.module.d_model, SEQ, backward=True)
        report[f"train_{dtype}"] = {
            "step_ms": elapsed * 1e3,
            "tokens_per_s": tok_s,
            "mfu_vs_bf16_peak": mfu(tok_s, fpt, peak_flops()),
            "loss_first": curve[0],
            "loss_last": curve[-1],
            "acc_last": float(history[-1]["acc"]),
        }
        report[f"profile_train_{dtype}"] = device_breakdown(lambda: step(state, x, y))
        print(f"train {dtype}: {json.dumps(report[f'train_{dtype}'])}", flush=True)
        print(f"profile train {dtype}: {json.dumps(report[f'profile_train_{dtype}'])}",
              flush=True)
        del model, step, state, history
    return dict(attention_cuda.launches), report


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from elephas_tpu_torch.ops import attention_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi("name,power.limit"))
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    t0 = time.perf_counter()
    libs = attention_cuda.build_all()
    print(f"build: {', '.join(lib.name for lib in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cuobjdump = str(Path(attention_cuda._nvcc()).with_name("cuobjdump"))
    instances = {"flash_fwd": [f"flash_fwd {t} D={d}" for t in ("bf16", "f32")
                               for d in attention_cuda.HEAD_DIMS],
                 "flash_bwd": [f"flash_{k} {t} D={d}" for k in ("dq", "dkv")
                               for t in ("bf16", "f32") for d in attention_cuda.HEAD_DIMS]}
    for source, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        summary = ptxas_summary(log)
        print("ptxas: " + summary, flush=True)
        check(all(f"{name}:" in summary for name in instances[source]),
              f"ptxas summary of {lib.name} misses a kernel of {instances[source]}")
        for line in log.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"nvcc: {line.strip()}", flush=True)
        counts = sass_counts(lib, cuobjdump)
        print(f"sass {lib.name}: {json.dumps(counts)}", flush=True)
        for name in instances[source]:
            need, ops = required_ops(name), counts.get(name, {})
            print(f"sass {name}: requires {' and '.join(need) or 'nothing'}, has {ops}",
                  flush=True)
            check(all(ops.get(op, 0) > 0 for op in need),
                  f"{name} has {ops} in its SASS: it needs {need}")

    errors, timing = kernel_phase(attention_cuda)
    launches = {}
    launches["inference"], report = inference_phase(attention_cuda)
    print(f"inference: {json.dumps(report)}", flush=True)
    launches["train"], report = train_phase(attention_cuda)
    print(f"train: {json.dumps(report)}", flush=True)

    sources = {
        "flash_fwd": ("elephas_tpu_torch/csrc/flash_fwd.cu",
                      "elephas_tpu/ops/attention_pallas.py:36"),
        "flash_dq": ("elephas_tpu_torch/csrc/flash_bwd.cu",
                     "elephas_tpu/ops/attention_pallas.py:248"),
        "flash_dkv": ("elephas_tpu_torch/csrc/flash_bwd.cu",
                      "elephas_tpu/ops/attention_pallas.py:307"),
    }
    entries = []
    for name in KERNELS:
        f32, bf16 = timing[name][torch.float32], timing[name][torch.bfloat16]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches["train"][name],
            "launches_by_path": {path: counts[name] for path, counts in launches.items()},
            "max_abs_err": errors[name][torch.float32],
            "max_err_f32": errors[name][torch.float32],
            "max_err_bf16": errors[name][torch.bfloat16],
            **f32,
            "bf16": bf16,
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
