"""``chip_smoke.py``'s own parsing and arithmetic, on the CPU: the SASS
and ptxas reports it reads to show the kernels built for Hopper run on
wgmma and TMA, the instructions each instantiation must hold, the work
and bounds it prints for each kernel, the exponentials' floor, and its
refusal to run without a card.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


HOPPER_FWD = ("_ZN45_GLOBAL__N__f79979d2_12_flash_fwd_cu_b294bfd06hopper21"
              "flash_fwd_bf16_kernelILi64EEEv14CUtensorMap_stS2_S2_P13__nv_bfloat16Pfiif")
F32_FWD = "_ZN45_GLOBAL__N__f79979d2_12_flash_fwd_cu_b294bfd020flash_fwd_f32_kernelILi32EEvPKfS1_S1_PfS2_iif"


def test_sass_counts_per_instantiation(smoke, monkeypatch):
    sass = "\n".join([
        f"\t\tFunction : {HOPPER_FWD}",
        "        /*0410*/                   UTMALDG.3D [UR8], [UR4] ;",
        "        /*0420*/                   UTMALDG.3D [UR16], [UR4] ;",
        "        /*0900*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT ;",
        f"\t\tFunction : {F32_FWD}",
        "        /*0100*/                   FFMA R4, R5, R6, R4 ;",
    ])

    def fake_run(cmd, **kwargs):
        assert cmd[1:] == ["-sass", "lib.so"]
        return subprocess.CompletedProcess(cmd, 0, sass, "")

    monkeypatch.setattr(smoke.subprocess, "run", fake_run)
    assert smoke.sass_counts("lib.so", "cuobjdump") == {
        "flash_fwd bf16 D=64": {"HGMMA": 1, "UTMALDG": 2},
        "flash_fwd f32 D=32": {"HGMMA": 0, "UTMALDG": 0},
    }


@pytest.mark.parametrize("instance, want", [
    ("flash_fwd bf16 D=32", ("HGMMA", "UTMALDG")),
    ("flash_fwd f32 D=128", ("HGMMA", "UTMALDG")),
    ("flash_dq bf16 D=64", ("HGMMA", "UTMALDG")),
    ("flash_dkv bf16 D=128", ("HGMMA", "UTMALDG")),
    ("flash_dq f32 D=32", ("HGMMA", "UTMALDG")),
    ("flash_dkv f32 D=64", ("HGMMA", "UTMALDG")),
    ("flash_dq f32 D=128", ("HGMMA", "UTMALDG")),
    ("flash_dkv f32 D=128", ("HGMMA", "UTMALDG")),
])
def test_required_ops_per_instantiation(smoke, instance, want):
    """Every kernel, K1-K3 in bf16 and in float32 (split tf32), is built
    for Hopper and must show wgmma and TMA loads in its SASS; a name that
    is no kernel instantiation raises."""
    assert smoke.required_ops(instance) == want
    with pytest.raises(ValueError, match="unknown"):
        smoke.required_ops(instance.replace("flash_", "flush_"))


def test_split_tf32_bound(smoke):
    """The float32 kernels' tensor-core bound, three tf32 products for each
    FLOP over 495 TFLOP/s, at the LM's causal shape: K1 (2·B·H·S²·D FLOPs)
    0.1041 ms, K2 (3·B·H·S²·D) 0.1562 ms, K3 (4·B·H·S²·D) 0.2082 ms; full
    attention twice each."""
    shape = (8, 8, 2048, 32)
    causal = smoke.kernel_work(shape, 4, True)
    full = smoke.kernel_work(shape, 4, False)
    for name, want in (("flash_fwd", 0.10412), ("flash_dq", 0.15618),
                       ("flash_dkv", 0.20824)):
        flops, nbytes = causal[name]
        assert flops == {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}[name] * 8 * 8 * 2048**2 * 32
        assert smoke.split_tf32_bound_ms(flops, nbytes) == pytest.approx(want, abs=1e-5)
        assert smoke.split_tf32_bound_ms(*full[name]) == pytest.approx(
            2 * smoke.split_tf32_bound_ms(flops, nbytes), rel=1e-12)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_kernel_work_counts_each_tensor_once(smoke, itemsize):
    """Bytes: K1 reads q, k, v and writes o (each B·H·S·D elements) and the
    float32 lse; K2 reads q, k, v, dO and writes dq, K3 writes dk and dv,
    both reading the float32 lse and delta."""
    shape = (2, 3, 100, 64)
    tensor, rows = 2 * 3 * 100 * 64 * itemsize, 4 * 2 * 3 * 100
    work = smoke.kernel_work(shape, itemsize, True)
    assert [work[n][1] for n in ("flash_fwd", "flash_dq", "flash_dkv")] == [
        4 * tensor + rows, 5 * tensor + 2 * rows, 6 * tensor + 2 * rows]


def test_ptxas_summary_names_the_hopper_kernels(smoke):
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{HOPPER_FWD}' for 'sm_90a'",
        f"ptxas info    : Function properties for {HOPPER_FWD}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{F32_FWD}' for 'sm_90a'",
        f"ptxas info    : Function properties for {F32_FWD}",
        "    80 bytes stack frame, 128 bytes spill stores, 124 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 80 bytes cumulative stack size",
    ])
    assert smoke.ptxas_summary(log) == (
        "flash_fwd bf16 D=64: 128 registers, 0 bytes spill stores; "
        "flash_fwd f32 D=32: 255 registers, 128 bytes spill stores")


@pytest.mark.parametrize("causal", [True, False])
def test_exp_floor_counts_valid_scores(smoke, causal):
    """One exp2 per valid score, 16 a clock per SM: the LM's causal shape
    on 132 SMs at 1980 MHz takes 0.0321 ms; full attention about twice."""
    shape = (8, 8, 2048, 32)
    valid = 8 * 8 * (2048 * 2049 / 2 if causal else 2048 * 2048)
    got = smoke.exp_floor_ms(shape, causal, 132, 1980.0)
    assert got == pytest.approx(valid / (16 * 132 * 1980e6) * 1e3, rel=1e-12)
    if causal:
        assert got == pytest.approx(0.03211, abs=1e-5)


def test_refuses_to_run_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_resnet_flops_per_sample_hand_count(smoke):
    """Width 8, 32x32: stem 2·9·3·8·1024 = 442,368; stage 0 four 3x3 convs
    8→8 at 32x32, 4 × 1,179,648; stages 1-3 each 589,824 (the stride-2
    conv) + 65,536 (its 1x1 shortcut) + 3 × 1,179,648; head 2·64·10.
    It equals 2·k²·C_in·C_out·H_out·W_out summed over the port model's
    own convs."""
    assert smoke.resnet_flops_per_sample(width=8) == 17_745_152
    # Width 64: the 3x3 convs scale as width², the stem as width, the head
    # as the last stage's width: 1.1108 GFLOPs a forward image.
    assert smoke.resnet_flops_per_sample() == (64 * (17_745_152 - 442_368 - 1280)
                                               + 8 * 442_368 + 2 * 512 * 10) == 1_110_845_440

    import torch
    from elephas_tpu_torch.models import get_model

    model = get_model("resnet18", width=8, device="cpu")
    model.eval()
    counted = []

    def hook(module, args, out):
        w = module.conv.weight
        counted.append(2 * w.shape[1] * w.shape[2] * w.shape[3] * w.shape[0]
                       * out.shape[2] * out.shape[3])

    for module in model.modules():
        if type(module).__name__ == "Conv":
            module.register_forward_hook(hook)
    model(torch.zeros(1, 32, 32, 3))
    assert sum(counted) + 2 * 64 * 10 == smoke.resnet_flops_per_sample(width=8)


def test_step_errors_and_breaches(smoke):
    import torch

    ref = {"loss": 2.0, "logits": torch.tensor([[1.0, -3.0]]),
           "grads": {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1.0])},
           "stats": {"m": torch.tensor([0.5, 2.0])},
           "update": {"a": torch.tensor([0.3, 0.4]), "b": torch.tensor([0.0, 0.1])}}
    got = {"loss": 2.002, "logits": torch.tensor([[1.0, -3.3]]),
           "grads": {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([0.0, 1.0])},
           "stats": {"m": torch.tensor([0.5, 2.2])},
           "update": {"a": torch.tensor([0.3, 0.4]), "b": torch.tensor([0.0, 0.2])}}
    errors = smoke.step_errors(got, ref)
    assert errors["loss"] == pytest.approx(1e-3)
    assert errors["logits"] == pytest.approx(0.1)  # 0.3 over max(1, 3)
    assert errors["stats"] == pytest.approx(0.1) and errors["stats_worst"] == "m"
    assert errors["grads"] == pytest.approx(0.1) and errors["grads_worst"] == "a"
    assert errors["grads_all"] == pytest.approx(0.5 / 26 ** 0.5)
    assert errors["update"] == pytest.approx(1.0) and errors["update_worst"] == "b"
    limits = {"loss": 1e-2, "logits": 0.05, "grads": 0.2}
    assert smoke.breaches(errors, limits) == ["logits"]
    assert smoke.breaches({**errors, "loss": float("nan")}, limits) == ["loss", "logits"]
    assert smoke.breaches({}, {"grads": 1.0}) == ["grads"]
    for limits in (smoke.RESNET_F32_LIMITS, smoke.RESNET_F32_GRAD_LIMITS,
                   smoke.RESNET_BF16_LIMITS):
        assert set(limits) <= set(errors)


def test_kernel_line_carries_every_path(smoke):
    """Each kernel's entry holds its launches on the LM train run (the
    main path of the kernels) and on every path, the ResNet's and the
    repair checks' included."""
    import torch

    timing = {name: {torch.float32: {"ms": 1.0, "bound_ms": 0.5},
                     torch.bfloat16: {"ms": 0.5}} for name in smoke.KERNELS}
    errors = {name: {torch.float32: 1e-6, torch.bfloat16: 1e-3} for name in smoke.KERNELS}
    launches = {"inference": {"flash_fwd": 56, "flash_dq": 0, "flash_dkv": 0},
                "train": {k: 176 for k in smoke.KERNELS},
                "resnet": {k: 0 for k in smoke.KERNELS},
                "repair": {k: 12 for k in smoke.KERNELS},
                "serving": {k: 0 for k in smoke.KERNELS},
                "async": {k: 0 for k in smoke.KERNELS},
                "estimator": {k: 0 for k in smoke.KERNELS},
                "search": {k: 0 for k in smoke.KERNELS},
                "fit_slice": {k: 0 for k in smoke.KERNELS}}
    entries = smoke.kernel_entries(timing, errors, launches)
    assert [e["name"] for e in entries] == list(smoke.KERNELS)
    for e in entries:
        assert e["launches"] == 176 and e["launches_by_path"]["resnet"] == 0
        assert e["launches_by_path"]["repair"] == 12
        assert e["launches_by_path"]["serving"] == 0
        assert e["launches_by_path"]["async"] == 0
        assert e["launches_by_path"]["estimator"] == 0
        assert e["launches_by_path"]["search"] == 0
        assert e["launches_by_path"]["fit_slice"] == 0
        assert e["route"] == "cuda"
        assert e["replaces"].startswith("elephas_tpu/ops/attention_pallas.py:")
        assert e["ms"] == 1.0 and e["bf16"] == {"ms": 0.5}
    assert entries[0]["launches_by_path"]["inference"] == 56


def test_serving_config_is_the_full_width_deployment(smoke):
    """16 slots of 1024 columns in 64-column blocks, 512-token prompts in
    128-token chunks at 2 a step, a 64-deep queue: a KV pool of 134 MB at
    the registry LM's width (4 layers, K and V, 8 heads of 32, f32)."""
    cfg = smoke.SERVE_ENGINE
    assert cfg == {"max_slots": 16, "max_prompt_len": 512, "max_len": 1024,
                   "queue_depth": 64, "kv_block_size": 64, "prefill_chunk": 128,
                   "prefill_chunks_per_step": 2, "prefix_cache": True}
    pool_bytes = cfg["max_slots"] * cfg["max_len"] * 4 * 2 * 8 * 32 * 4
    assert pool_bytes == 134_217_728
    assert smoke.SERVE_SAMPLING["temperature"] == 0.8 and smoke.SERVE_SAMPLING["top_k"] == 40
    assert len(smoke.SERVE_CPU_REQUESTS) == 3 and smoke.SERVE_STEPS == 50


def test_serving_traffic_is_seeded_and_shaped(smoke):
    traffic = smoke.serving_traffic()
    assert traffic == smoke.serving_traffic()  # same seed, same requests
    assert traffic != smoke.serving_traffic(seed=1)
    assert len(traffic) == smoke.SERVE_REQUESTS == 48
    lens = [len(p) for p, _ in traffic]
    assert min(lens) >= 64 and max(lens) <= smoke.SERVE_ENGINE["max_prompt_len"]
    assert all(64 <= n <= 128 for _, n in traffic)
    prefix = traffic[0][0][:smoke.SERVE_PREFIX]
    shared = [i for i, (p, _) in enumerate(traffic) if p[:smoke.SERVE_PREFIX] == prefix]
    assert shared == list(range(0, 48, 4))  # a quarter carry the system prompt
    assert all(len(traffic[i][0]) > smoke.SERVE_PREFIX for i in shared)
    assert all(0 < t < 32000 for p, _ in traffic for t in p)


def test_compare_streams_accepts_near_ties_and_rejects_the_rest(smoke):
    ref = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 9, 9, 9]]
    got = [[1, 2, 3, 4], [5, 6, 0, 0], [9, 9, 9, 9]]
    gaps = {(1, 2): 4e-4}
    out = smoke.compare_streams(ref, got, lambda i, k: gaps[(i, k)])
    assert out == {"identical": 2, "near_ties": [[1, 2, 4e-4]]}
    with pytest.raises(AssertionError, match="top-2 gap"):
        smoke.compare_streams(ref, got, lambda i, k: 2e-3)  # a clear argmax differs
    with pytest.raises(AssertionError, match="prefix"):
        smoke.compare_streams([[1, 2, 3]], [[1, 2]], lambda i, k: 0.0)
    with pytest.raises(AssertionError, match="streams against"):
        smoke.compare_streams(ref, got[:2], lambda i, k: 0.0)
    assert smoke.first_difference([3, 4], [3, 4]) is None
    assert smoke.first_difference([3, 4], [3, 5]) == 1


def test_async_config_is_the_baseline_configs(smoke):
    """BASELINE config 2 (the MNIST CNN, 4 asynchronous workers, 3 epochs
    at batch 64 on 8192 synthetic rows) and config 4 (the ResNet-18,
    hogwild, 4 workers at batch 256: a global batch of 1024, on 16384
    synthetic rows), the limits stated before the first card run."""
    assert smoke.ASYNC_WORKERS == 4
    assert smoke.ASYNC_CNN_ROWS == (8192, 2048)
    assert (smoke.ASYNC_CNN_EPOCHS, smoke.ASYNC_CNN_BATCH) == (3, 64)
    assert smoke.HOGWILD_ROWS == (16384, 2048)
    assert smoke.ASYNC_WORKERS * smoke.HOGWILD_BATCH == 1024
    assert smoke.ASYNC_CPU_ROWS // smoke.ASYNC_CNN_BATCH == 16
    assert smoke.ASYNC_CPU_LIMITS == {"weights_all": 1e-3, "loss": 1e-4}
    assert smoke.ASYNC_SUM_LIMIT == 1e-6
    assert smoke.HOGWILD_OPTIMIZER == {"name": "sgd", "learning_rate": 0.05}
    assert 0.1 < smoke.ASYNC_MIN_VAL_ACC < 0.2 and 0.1 < smoke.ASYNC_WIRE_MIN_ACC
    assert abs(smoke.ASYNC_WIRE_MAX_LOSS - 2.302585) < 1e-6  # the untrained loss, ln 10


def test_span_ms_and_epoch_rate(smoke):
    class Event:
        def __init__(self, name, begin, end):
            self.name, self.begin_s, self.end_s = name, begin, end

    events = [Event("async/pull", 0.0, 0.002), Event("async/pull", 1.0, 1.004),
              Event("async/push", 2.0, 2.001)]
    out = smoke.span_ms(events, ("async/pull", "async/push", "async/train"))
    assert out["async/pull"]["count"] == 2
    assert abs(out["async/pull"]["mean_ms"] - 3.0) < 1e-9
    assert abs(out["async/pull"]["total_ms"] - 6.0) < 1e-9
    assert abs(out["async/push"]["mean_ms"] - 1.0) < 1e-9
    assert out["async/train"] == {"mean_ms": None, "total_ms": 0.0, "count": 0}
    assert smoke.epoch_rate([10.0, 12.0, 14.0], 1000) == 500.0
    assert smoke.epoch_rate([10.0], 1000) is None


def _main_source():
    import ast

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    phases = [n.func.id for n in ast.walk(main) if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Name) and n.func.id.endswith("_phase")]
    return ast.unparse(main), phases


def test_main_runs_and_reports_the_estimator_phase():
    """``main`` drives ``estimator_phase`` after ``async_phase`` and the
    two phases that follow it (the multi-process async phase and the ops
    phase), keeps its launches under ``"estimator"`` and prints its report
    line, before the kernel line and the last line."""
    source, phases = _main_source()
    at = phases.index("estimator_phase")
    assert phases[at - 3:at] == ["async_phase", "async_multiproc_phase", "ops_phase"]
    assert "launches['estimator'], report = estimator_phase(attention_cuda)" in source
    assert source.index("estimator: ") < source.index("'kernels'") < source.index("'ok': True")


def test_main_runs_the_search_phase_last_and_keeps_the_last_line():
    """Phase 11, ``search_phase``, runs after every earlier phase (only
    the fit-slice and chaos phases follow it), keeps its launches under
    ``"search"`` and prints its report before the kernel line; the last
    line is still the ``{"ok": true, "device": ...}`` object with the
    card's name and count."""
    source, phases = _main_source()
    assert phases == ["kernel_phase", "inference_phase", "train_phase", "seq_parallel_phase",
                      "tensor_parallel_phase", "resnet_phase", "repair_phase", "serving_phase",
                      "async_phase", "async_multiproc_phase", "ops_phase",
                      "estimator_phase", "search_phase", "fit_slice_phase", "chaos_phase"]
    assert "launches['search'], report = search_phase(attention_cuda)" in source
    assert source.index("estimator: ") < source.index("search: ") < source.index("'kernels'")
    last = source[source.index("'ok': True"):]
    for key in ("'platform': 'gpu'", "'kind': torch.cuda.get_device_name(0)",
                "'count': torch.cuda.device_count()"):
        assert key in last


def test_main_runs_the_fit_slice_phase_after_the_search(smoke):
    """Phase 12, ``fit_slice_phase``, runs after the search (only the
    chaos phase follows it), keeps its launches under ``"fit_slice"`` and
    prints one ``fit_slice: {...}`` line before the kernel line."""
    source, phases = _main_source()
    assert phases[-3:-1] == ["search_phase", "fit_slice_phase"]
    assert "launches['fit_slice'], report = fit_slice_phase(attention_cuda)" in source
    assert source.index("search: ") < source.index("fit_slice: ") < source.index("'kernels'")


def test_fit_slice_config(smoke):
    """The streamed fit is CIFAR-10's training size at the ResNet fit's
    batch; its data bound is 3 chunks of 4 batches of 12,328-byte rows
    (151 MB); the capture check runs past its 3 warm-up steps."""
    assert (smoke.STREAM_ROWS, smoke.STREAM_BATCH, smoke.STREAM_CHUNK) == (50_000, 1024, 4)
    assert smoke.STREAM_RESIDENCY_LIMIT == 3 * 4 * 1024 * 12_328 == 151_486_464
    assert smoke.CAPTURE_STEPS > 3 + 1 and smoke.CAPTURE_BATCH == 256
    assert smoke.AB_RESNET_BATCHES == (256, 2048)
    assert smoke.CAPTURE_MASKED == (128, (100, 64))


def test_bitwise_equal_names_each_differing_tensor(smoke):
    import torch

    a = {"w": torch.ones(3), "b": torch.zeros(2), "m": torch.ones(2, dtype=torch.bfloat16)}
    b = {"w": torch.ones(3), "b": torch.tensor([0.0, 1e-30]), "m": torch.ones(2)}
    assert smoke.bitwise_equal(a, a) == []
    assert smoke.bitwise_equal(a, b) == ["b", "m"]  # a value, and a dtype
    assert smoke.bitwise_equal({"z": torch.tensor([0.0])}, {"z": torch.tensor([-0.0])}) == []


def test_search_config_is_baseline_config_5(smoke):
    """parity.py's hyperparam_search at full size: 4096 synthetic MNIST
    rows and 1024 held out, mlp_masked at buckets (128, 256) over widths
    64/128/256, Adam's lr log-uniform in [1e-4, 1e-2], 2 epochs at batch
    64, 16 TPE trials; the ASHA run of examples/asha_search.py (9 trials,
    eta 3, 3 rungs, r0 1, 2 workers, w1 killed at its second unit); the
    limits set before the first card run."""
    assert smoke.SEARCH_ROWS == (4096, 1024)
    assert smoke.SEARCH_BUCKETS == (128, 256) and smoke.SEARCH_WIDTHS == (64, 128, 256)
    assert smoke.SEARCH_LR == (1e-4, 1e-2)
    assert (smoke.SEARCH_EPOCHS, smoke.SEARCH_BATCH, smoke.SEARCH_EVALS) == (2, 64, 16)
    assert smoke.SEARCH_MIN_VAL_ACC == 0.6 and smoke.MASKED_LIMIT == 1e-5
    assert smoke.MASKED_CHECK == (128, 100)
    assert (smoke.ASHA_TRIALS, smoke.ASHA_ETA, smoke.ASHA_RUNGS, smoke.ASHA_R0,
            smoke.ASHA_WORKERS) == (9, 3, 3, 1, 2)
    assert smoke.ASHA_KILL == {"w1": 1} and smoke.ASHA_MIN_SAVED == 0.4
    assert smoke.ASHA_BUCKETS == (128,) and max(smoke.ASHA_SPACE["width"]) <= 128
    space = smoke.search_space()
    assert space["width"].options == [64, 128, 256]
    assert np.exp(space["lr"].low) == pytest.approx(1e-4)
    x, y, xv, yv = smoke.asha_data()
    assert x.shape == (1536, 20) and xv.shape == (512, 20) and y.shape == (1536, 4)


def test_steady_trials_leave_out_each_workers_first_per_bucket(smoke):
    trials = [{"worker": w, "trial": t, "sample": {"width": width}}
              for w, widths in ((0, [64, 256, 128, 256]), (1, [256, 64]))
              for t, width in enumerate(widths)]
    first, steady = smoke.steady_trials(trials, (128, 256))
    assert [(t["worker"], t["trial"]) for t in first] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [(t["worker"], t["trial"]) for t in steady] == [(0, 2), (0, 3)]


def test_replay_tpe_reproduces_the_search_and_catches_a_change(smoke):
    from elephas_tpu_torch.hyperparam import HyperParamModel

    space = smoke.search_space()
    search = HyperParamModel(None, num_workers=2, device="cpu")
    search.minimize(lambda s, d: {"loss": abs(np.log(s["lr"]) + 6.0) + s["width"] / 1e3},
                    lambda: None, max_evals=14, space=space, seed=0, algo="tpe")
    recorded = [(t["worker"], t["trial"], t["sample"]) for t in
                sorted(search.trials, key=lambda t: (t["worker"], t["trial"]))]
    assert smoke.replay_tpe(search.trials, space, 0) == recorded
    search.trials[-1]["loss"] = -1.0  # a loss the samplers never saw
    search.trials[5]["loss"] = 99.0
    assert smoke.replay_tpe(search.trials, space, 0) != recorded


def test_masked_vs_plain_reads_live_and_padded_entries(smoke):
    import torch

    active = 3
    plain = {"loss": 2.0, "logits": torch.tensor([[1.0, 2.0]]),
             "grads": {"hidden.0.weight": torch.ones(3, 2), "hidden.0.bias": torch.ones(3),
                       "out.weight": torch.ones(2, 3), "out.bias": torch.ones(2)}}
    plain["update"] = plain["grads"]
    grads = {"hidden.0.weight": torch.ones(5, 2), "hidden.0.bias": torch.ones(5),
             "out.weight": torch.ones(2, 5), "out.bias": torch.ones(2)}
    grads["hidden.0.weight"][3:] = 0.0
    grads["hidden.0.bias"][3:] = 0.0
    grads["out.weight"][:, 3:] = 0.0
    grads["out.weight"][0, 0] = 1.5  # a live error
    update = {k: v.clone() for k, v in grads.items()}
    update["out.weight"][1, 4] = 0.25  # a padded entry that moved
    masked = {"loss": 2.0, "logits": torch.tensor([[1.0, 2.0]]), "grads": grads,
              "update": update}
    out = smoke.masked_vs_plain(masked, plain, active)
    assert out["logits"] == 0.0 and out["loss"] == 0.0
    assert out["grads"] == pytest.approx(0.5 / 6 ** 0.5) and out["grads_worst"] == "out.weight"
    assert out["padded_grads_max"] == 0.0 and out["padded_update_max"] == 0.25


def test_estimator_config_is_baseline_config_3(smoke):
    """The registry's full-width LSTM (2,691,842 parameters) on 8192
    synthetic IMDB rows of 200 tokens, 2048 held out, batch 32, 3
    epochs, Adam 1e-3 (parity.py's settings), the limits set before the
    first card run."""
    from elephas_tpu_torch.models import get_model

    assert smoke.LSTM_WIDTH == {"vocab_size": 20000, "embed_dim": 128, "hidden_dim": 128,
                                "num_classes": 2}
    module = get_model("lstm", device="cpu", **smoke.LSTM_WIDTH)
    assert sum(p.numel() for p in module.parameters()) == smoke.LSTM_PARAMS == 2_691_842
    assert smoke.IMDB_ROWS == (8192, 2048) and smoke.IMDB_MAXLEN == 200
    assert (smoke.IMDB_BATCH, smoke.IMDB_EPOCHS) == (32, 3)
    assert smoke.IMDB_ADAM == {"name": "adam", "learning_rate": 1e-3}
    assert smoke.IMDB_MIN_ACC == 0.7
    assert smoke.LSTM_CPU_LIMITS == {"logits": 1e-4, "loss": 1e-5, "grads": 1e-3,
                                     "params": 1e-4}
    assert smoke.LSTM_SWEEP == (32, 256, 1024)
    assert smoke.IMDB_RELOAD_LIMIT == smoke.IMDB_RESUME_LIMIT == 1e-6
    assert smoke.IMDB_PAYLOAD_LIMIT == 1e-4


def test_lstm_step_errors(smoke):
    import torch

    ref = {"loss": 0.5, "logits": torch.tensor([[0.1, -0.2]]),
           "grads": {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0])},
           "params": {"a": torch.tensor([6.0, 8.0]), "b": torch.tensor([1.0, 1.0])}}
    got = {"loss": 0.5005, "logits": torch.tensor([[0.1, -0.2003]]),
           "grads": {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([1.0, 0.0])},
           "params": {"a": torch.tensor([6.0, 8.0]), "b": torch.tensor([1.0, 1.2])}}
    errors = smoke.lstm_step_errors(got, ref)
    assert errors["loss"] == pytest.approx(1e-3)
    assert errors["logits"] == pytest.approx(3e-4, rel=1e-3)  # absolute
    assert errors["grads"] == pytest.approx(0.1) and errors["grads_worst"] == "a"
    assert errors["params"] == pytest.approx(0.2 / 2 ** 0.5) and errors["params_worst"] == "b"
    assert smoke.breaches(errors, smoke.LSTM_CPU_LIMITS) == ["logits", "loss", "grads",
                                                            "params"]


def test_asha_runs_are_held_to_their_replayed_arrivals(smoke, monkeypatch):
    """The search phase's ASHA checks on a toy objective: a two-worker
    run's outcome is the scheduler's fed its own arrivals serially, and a
    unit's loss is one across runs; a changed loss shows in both."""
    from elephas_tpu_torch.tune import MemoryVault, cli, run_search
    from elephas_tpu_torch.tune.scheduler import AshaScheduler

    arrivals = []
    on_result = AshaScheduler.on_result

    def record(self, trial_id, rung, loss, delta_norm=None):
        arrivals.append((trial_id, rung, loss, delta_norm))
        return on_result(self, trial_id, rung, loss, delta_norm)

    monkeypatch.setattr(AshaScheduler, "on_result", record)
    docs, runs = [], []
    for workers in (2, 1):
        arrivals.clear()
        docs.append(run_search(cli.synthetic_trial_fn, smoke.asha_space(),
                               num_trials=smoke.ASHA_TRIALS, seed=smoke.SEED,
                               eta=smoke.ASHA_ETA, rungs=smoke.ASHA_RUNGS, r0=smoke.ASHA_R0,
                               workers=workers, vault=MemoryVault()))
        runs.append(list(arrivals))
    monkeypatch.setattr(AshaScheduler, "on_result", on_result)
    for doc, sequence in zip(docs, runs):
        want = smoke.replay_asha(sequence)
        assert {k: doc[k] for k in want} == want
    assert smoke.unequal_units(runs) == []
    winner = docs[0]["winner"]["trial"]
    top = max(rung for tid, rung, _, _ in runs[0] if tid == winner)
    changed = [(tid, rung, loss + 1.0 if (tid, rung) == (winner, top) else loss, dn)
               for tid, rung, loss, dn in runs[0]]
    assert smoke.unequal_units([changed, runs[1]]) == [(winner, top)]
    assert smoke.replay_asha(changed)["search_digest"] != docs[0]["search_digest"]


# -- the chaos phase's host-side helpers --------------------------------------------


def test_main_runs_the_chaos_phase_last(smoke):
    """Phase 13, ``chaos_phase``, runs last of the phases, keeps its
    launches under ``"chaos"`` (the kernel line's by-path column) and
    prints one ``chaos: {...}`` line before the kernel line."""
    source, phases = _main_source()
    assert phases[-2:] == ["fit_slice_phase", "chaos_phase"]
    assert "launches['chaos'], report = chaos_phase(attention_cuda)" in source
    assert source.index("fit_slice: ") < source.index("chaos: ") < source.index("'kernels'")


def test_chaos_config_is_the_baseline_configs(smoke):
    """Config 2's CNN at the async phase's settings over 4 pool workers
    (12 units), the JAX package's chaos plans, an outage longer than the
    client's retry budget, config 4's ResNet-18 in 2 shards with a
    standby each."""
    from elephas_tpu_torch.parameter.client import _RETRY_DELAYS

    assert smoke.CHAOS_WORKERS == smoke.ASYNC_WORKERS == 4
    assert smoke.CHAOS_UNITS == 4 * smoke.ASYNC_CNN_EPOCHS == 12
    assert smoke.CHAOS_KILL_PLAN == {"seed": 11, "kill_worker_at": {"w1": 0},
                                     "stall_worker_at": {"w0": 0}, "stall_seconds": 0.4}
    assert smoke.CHAOS_PARTITION_PLAN == {"seed": 23, "partition": {"*": (6, 14)}}
    assert smoke.CHAOS_OUTAGE_S > sum(_RETRY_DELAYS)
    assert smoke.CHAOS_GROUP == {"k": 2, "standby": 1, "suspect_after": 0.5}
    assert smoke.RESNET_PARAMS == 11_173_962 and smoke.CHAOS_GROUP_PUSHES == 8
    assert smoke.WAL_COST_EVERY == (1, 8) and smoke.WAL_KEEP == 3
    assert smoke.CHAOS_LOSS_TOL == 0.02


def test_mttr_summary(smoke):
    assert smoke.mttr_summary([]) == {"n": 0, "min_s": None, "median_s": None, "max_s": None}
    assert smoke.mttr_summary([4.0, None, 1.0, 2.5]) == {"n": 3, "min_s": 1.0,
                                                          "median_s": 2.5, "max_s": 4.0}


def test_first_success_counts_attempts_and_times_out(smoke):
    now, calls = [0.0], []

    def sleep(dt):
        now[0] += dt

    def flaky():
        calls.append(now[0])
        if len(calls) < 3:
            raise ConnectionError("down")
        return "up"

    value, seconds, attempts = smoke.first_success(flaky, 10.0, errors=(ConnectionError,),
                                                   clock=lambda: now[0], sleep=sleep,
                                                   interval=0.5)
    assert (value, seconds, attempts) == ("up", 1.0, 3)

    def never():
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        smoke.first_success(never, 2.0, errors=(ConnectionError,), clock=lambda: now[0],
                            sleep=sleep, interval=0.5)
    with pytest.raises(KeyError):  # only the named errors are retried
        smoke.first_success(lambda: {}["x"], 2.0, errors=(ConnectionError,))


def test_frame_differences_reads_a_wal_frame_bitwise(smoke, tmp_path):
    import torch

    from elephas_tpu_torch.resilience import SnapshotWAL

    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)},
            "batch_stats": {"n": torch.tensor(7)}}
    wal = SnapshotWAL(str(tmp_path))
    wal.append(tree, version=4)
    _, frame = wal.restore_latest()
    assert smoke.frame_differences(frame, tree) == []
    other = {"params": {"w": tree["params"]["w"].clone(), "b": torch.tensor([0.0, -0.0, 1e-45])},
             "batch_stats": {"n": torch.tensor(7)}}
    assert smoke.frame_differences(frame, other) == ["params/b"]
    assert smoke.frame_differences(frame, {"params": tree["params"]}) == ["batch_stats/n"]


def test_wal_cost_splits_each_durable_snapshot(smoke, tmp_path):
    """On the CPU (the card's numbers come from the chaos phase): every
    ``every``-th push is one durable snapshot, each split into its copy
    to the host, its encode and its write with the fsync; the frame is
    the tree's bytes and the WAL keeps two."""
    import torch

    from elephas_tpu_torch.resilience import SnapshotWAL

    tree = {"params": {"w": torch.ones(64, 32), "b": torch.zeros(32)},
            "batch_stats": {"n": torch.tensor(0)}}
    for every, snapshots in ((1, 6), (2, 3), (4, 1)):
        out = smoke.wal_cost(tree, torch.device("cpu"), every, 6, str(tmp_path / str(every)))
        assert (out["every"], out["pushes"], out["snapshots"]) == (every, 6, snapshots)
        assert out["frame_bytes"] > (64 * 32 + 32) * 4
        for key in ("ms_per_push", "no_wal_ms_per_push", "d2h_ms", "encode_ms"):
            assert out[key] is not None and out[key] >= 0.0, key
        assert out["write_fsync_ms"] is not None  # the append less the encode
        assert len(SnapshotWAL(str(tmp_path / str(every))).versions()) <= 2


def test_fs_type_names_the_mount(smoke, tmp_path):
    kind = smoke.fs_type(str(tmp_path))
    assert kind is None or (isinstance(kind, str) and kind)


# -- the seq-parallel phase --------------------------------------------------------


def test_main_runs_the_seq_parallel_phase_after_training():
    """``seq_parallel_phase`` follows the LM train phase, keeps its launches
    (summed over its ranks) under ``"seq_parallel"`` and prints its report
    before the kernel line; ``--seq-rank`` runs one rank instead of main."""
    source, phases = _main_source()
    assert phases[phases.index("seq_parallel_phase") - 1] == "train_phase"
    assert "launches['seq_parallel'], report = seq_parallel_phase(attention_cuda)" in source
    assert source.index("train: ") < source.index("seq_parallel: ") < source.index("'kernels'")
    text = (ROOT / "chip_smoke.py").read_text()
    assert 'if sys.argv[1:2] == ["--seq-rank"]:' in text


def test_seq_launch_schedule_is_the_ring_and_ulysses_hops(smoke):
    """Per full-width train step (4 layers) at 4 ranks: the ring launches
    40 of each kernel over the ranks (rank r: 4 * (1 + r)), Ulysses 16;
    a full (non-causal) ring 4 * 4 a rank."""
    ring = smoke.seq_launch_schedule("ring", 4, 4)
    assert ring == [4, 8, 12, 16] and sum(ring) == 40
    assert sum(smoke.seq_launch_schedule("ulysses", 4, 4)) == 16
    assert smoke.seq_launch_schedule("ring", 4, 4, causal=False) == [16] * 4
    with pytest.raises(ValueError):
        smoke.seq_launch_schedule("tree", 4, 4)


def test_seq_parallel_config(smoke):
    """Four ranks on one card; a ring hop at the LM's full shape over 4;
    limits no looser than the kernels' oracles and the LM's (PERF.md §2)."""
    import torch

    assert smoke.SP_RANKS == 4 and smoke.SP_HOP == (8, 8, 512, 32)
    assert smoke.SP_TOL == {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 3e-2)}
    assert smoke.SP_LOSS_RTOL == 1e-4 and smoke.GRAD_RTOL == 1e-3 and smoke.SP_STEPS == 3
    assert smoke.SP_FIT == {"rows": 32, "val_rows": 8, "batch_size": 8, "epochs": 1}
    assert set(smoke.SP_PATHS) >= {"lm_ring", "lm_ulysses", "lm_auto", "fit"}


# -- the tensor-parallel phase -----------------------------------------------------


def test_main_runs_the_tensor_parallel_phase_after_the_seq_parallel_phase():
    """``tensor_parallel_phase`` follows the seq-parallel phase, keeps its
    launches (summed over its ranks) under ``"tensor_parallel"`` and prints
    its report before the kernel line; ``--tp-rank`` runs one rank."""
    source, phases = _main_source()
    assert phases[phases.index("tensor_parallel_phase") - 1] == "seq_parallel_phase"
    assert ("launches['tensor_parallel'], report = tensor_parallel_phase(attention_cuda)"
            in source)
    assert source.index("seq_parallel: ") < source.index("tensor_parallel: ") < \
        source.index("'kernels'")
    text = (ROOT / "chip_smoke.py").read_text()
    assert 'if sys.argv[1:2] == ["--tp-rank"]:' in text


def test_tensor_parallel_config(smoke):
    """Four ranks; the shards' kernel shapes are the LM's heads over model
    4 and over data 2 x model 2, and the sp x tp ring's hop is 4 heads over
    half the sequence; the limits are the seq-parallel phase's."""
    assert smoke.TP_RANKS == 4 and smoke.TP_STEPS == 3
    assert smoke.TP_SHAPES == ((8, 2, 2048, 32), (4, 4, 2048, 32))
    assert smoke.TP_HOP == (8, 4, 1024, 32)
    assert 'hop_checks(attention_cuda, TP_HOP, "tensor_parallel")' in \
        (ROOT / "chip_smoke.py").read_text()
    assert 0 < smoke.TP_SERVE_REQUESTS <= smoke.SERVE_REQUESTS
    assert set(smoke.TP_PATHS) >= {"lm_model4_float32", "lm_model4_bfloat16",
                                   "lm_data2_model2", "lm_sptp_ring", "lm_sptp_ulysses",
                                   "fit", "serving"}


@pytest.mark.parametrize("layout,want", [("ring", 24), ("ulysses", 16)])
def test_sptp_launches_a_step(smoke, layout, want):
    """sp x tp on data 1 x seq 2 x model 2: each model index runs the
    seq layout's schedule over 2 seq ranks on its own heads."""
    assert 2 * sum(smoke.seq_launch_schedule(layout, 2, 4)) == want


def test_replicated_digest_reads_only_replicated_parameters(smoke):
    """Equal for modules whose replicated parameters are equal, whatever
    their shards hold; unequal once a replicated one moves."""
    import torch

    from elephas_tpu_torch.models import get_model
    from elephas_tpu_torch.parallel.mesh import Mesh
    from elephas_tpu_torch.parallel.tensor_parallel import shard_module

    config = dict(device="cpu", vocab_size=32, d_model=16, num_heads=2, num_layers=1,
                  max_seq_len=8)
    a, b = (shard_module(get_model("transformer_lm", **config), Mesh(model_size=2,
                                                                     model_rank=r))
            for r in (0, 1))
    b.load_state_dict({k: v for k, v in a.state_dict().items()
                       if k in dict(b.named_parameters()) and v.shape == b.get_parameter(
                           k).shape and k not in b._tensor_parallel.layout}, strict=False)
    with torch.no_grad():
        b.blocks[0].fc1.weight.add_(1.0)  # a shard: not in the digest
    assert smoke.replicated_digest(a) == smoke.replicated_digest(b)
    with torch.no_grad():
        b.ln_f.weight.add_(1e-7)
    assert smoke.replicated_digest(a) != smoke.replicated_digest(b)


def test_main_runs_the_async_multiproc_and_ops_phases_after_async():
    """The multi-process async phase follows the async phase (whose
    in-process CNN fit it reports beside its own samples/s), then the ops
    phase; each keeps its launches under its own key and prints its
    report before the kernel line; ``--async-rank`` runs one rank."""
    source, phases = _main_source()
    at = phases.index("async_phase")
    assert phases[at:at + 3] == ["async_phase", "async_multiproc_phase", "ops_phase"]
    assert "launches['async_multiproc'], report = async_multiproc_phase(attention_cuda, " \
        "report['cnn_async'])" in source
    assert "launches['ops'], report = ops_phase(attention_cuda)" in source
    assert source.index("async: ") < source.index("async_multiproc: ") < \
        source.index("ops: ") < source.index("'kernels'")
    text = (ROOT / "chip_smoke.py").read_text()
    assert 'if sys.argv[1:2] == ["--async-rank"]:' in text


def test_async_multiproc_and_ops_config(smoke):
    """Two ranks of two workers on config 2's CNN, two epochs, the three
    fits (asynchronous over socket, hogwild over HTTP with
    autotune, hogwild over HTTP streamed), a 12 s barrier timeout for the
    peer-death run; the ops phase polls at 10 Hz and captures 3 LM steps,
    whose f32 kernels the trace must name."""
    assert (smoke.MP_RANKS, smoke.MP_WORKERS, smoke.MP_EPOCHS) == (2, 2, 2)
    assert smoke.MP_FITS == {"async_socket": ("asynchronous", "socket", None, False),
                             "hogwild_http": ("hogwild", "http", None, True),
                             "hogwild_http_streamed": ("hogwild", "http", 4, False)}
    assert smoke.MP_BARRIER_TIMEOUT_S == 12
    assert smoke.OPS_POLL_S == 0.1 and smoke.OPS_PROFILE_STEPS == 3
    assert smoke.OPS_TRACE_KERNELS == {"flash_fwd": "flash_fwd_f32", "flash_dq": "flash_dq_f32",
                                       "flash_dkv": "flash_dkv_f32"}
    for name in smoke.OPS_TRACE_KERNELS.values():
        source = "flash_fwd.cu" if name == "flash_fwd_f32" else "flash_bwd.cu"
        assert f"{name}_kernel(" in (ROOT / "elephas_tpu_torch" / "csrc" / source).read_text()


def test_ops_keys_are_the_jax_packages_documents(smoke, tmp_path):
    """The top-level keys the ops phase holds each scrape to are those of
    the JAX package's documents: its PS endpoint after a push, and its
    serving trackers' snapshots."""
    import json
    import urllib.request

    from elephas_tpu import obs
    from elephas_tpu.parameter.server import make_server

    server = make_server("http", {"w": np.ones(3, np.float32)}, port=0, ops_port=0,
                         wal_dir=str(tmp_path))
    server.start()
    try:
        client = server.client()
        client.worker_id = "w0"
        client.update_parameters({"w": np.ones(3, np.float32)})
        client.close()
        for route, keys in smoke.OPS_PS_KEYS.items():
            with urllib.request.urlopen(f"{server.ops.url}{route}", timeout=5.0) as resp:
                assert sorted(json.loads(resp.read())) == sorted(keys), route
    finally:
        server.stop()
    load = obs.LoadTracker()
    load.observe(queue_depth=1, queue_limit=4, active=1, max_slots=2, kv_free_frac=0.5)
    docs = {"/load": load.snapshot(), "/slo": obs.GoodputLedger().snapshot(),
            "/tenants": obs.CostLedger().snapshot(), "/alerts": obs.AlertEngine().scrape()}
    for route, keys in smoke.OPS_SERVING_KEYS.items():
        assert sorted(docs[route]) == sorted(keys), route


def test_apply_chain_holds_the_surviving_deltas(smoke):
    """``ApplyChain`` on a lock-free buffer: a racing apply that read an
    older tree drops the delta it raced with; the final tree holds the
    survivors' sum and count, and ``received`` every delta."""
    import torch

    from elephas_tpu_torch.parameter.buffer import ParameterBuffer

    chain = smoke.ApplyChain()
    try:
        buffer = ParameterBuffer({"params": {"w": torch.ones(3)}}, lock=False, device="cpu")
        delta = {"params": {"w": torch.full((3,), 0.5)}}
        buffer.apply_delta(delta)
        stale = buffer._head  # a racer's read before the next apply ...
        buffer.apply_delta({"params": {"w": torch.full((3,), 0.25)}})
        params = ParameterBuffer._subtract(stale[0], delta)  # ... lands after it
        buffer._head = (params, stale[1] + 1)
        cum, count = chain.final(buffer)
        assert count == 2 == buffer._head[1]
        np.testing.assert_allclose(cum["w"], [1.0, 1.0, 1.0])
        np.testing.assert_allclose(chain.received["w"], [1.25] * 3)
        np.testing.assert_allclose(buffer._head[0]["params"]["w"].numpy(), [0.0] * 3)
    finally:
        chain.close()
    assert ParameterBuffer._subtract is chain._real


def test_summing_pushes_and_sum_error(smoke):
    import torch

    from elephas_tpu_torch.parameter import client as client_mod
    from elephas_tpu_torch.parameter.server import make_server

    real = client_mod.HttpClient.update_parameters
    sums, count = {}, [0]
    restore = smoke.summing_pushes(sums, count)
    server = make_server("http", {"params": {"w": np.ones(3, np.float32)}}, port=0, device="cpu")
    server.start()
    try:
        client = server.client()
        for _ in range(2):
            client.update_parameters({"params": {"w": torch.full((3,), 0.25)}})
        client.close()
        final = {"w": server.get_parameters()["params"]["w"].cpu()}
    finally:
        server.stop()
        restore()
    assert client_mod.HttpClient.update_parameters is real
    assert count == [2]
    np.testing.assert_allclose(sums["w"], [0.5] * 3)
    assert smoke.sum_error_by_norm(final, {"w": torch.ones(3)}, sums) < 1e-7


def test_poller_counts_rounds_and_drops_an_unmounted_round(smoke, monkeypatch):
    """A round cut short by the endpoint's unmount is dropped; a wrong
    answer from a mounted endpoint is kept; a right one counts."""
    answers = iter([(500, None), (200, ["b"]), (200, ["a"])])
    urls = iter(["u", None, "u", "u", "u"])
    monkeypatch.setattr(smoke, "scrape", lambda url: next(answers))
    poller = smoke.Poller(lambda: next(urls), {"/x": ["a"]})
    poller.poll_once()
    assert (poller.rounds, poller.bad) == (0, [])
    poller.poll_once()
    assert (poller.rounds, poller.bad) == (1, [["/x", 200, ["b"]]])
    poller.poll_once()
    assert poller.rounds == 2 and len(poller.bad) == 1
