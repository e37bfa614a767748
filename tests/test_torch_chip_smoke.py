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
                "repair": {k: 12 for k in smoke.KERNELS}}
    entries = smoke.kernel_entries(timing, errors, launches)
    assert [e["name"] for e in entries] == list(smoke.KERNELS)
    for e in entries:
        assert e["launches"] == 176 and e["launches_by_path"]["resnet"] == 0
        assert e["launches_by_path"]["repair"] == 12
        assert e["route"] == "cuda"
        assert e["replaces"].startswith("elephas_tpu/ops/attention_pallas.py:")
        assert e["ms"] == 1.0 and e["bf16"] == {"ms": 0.5}
    assert entries[0]["launches_by_path"]["inference"] == 56
