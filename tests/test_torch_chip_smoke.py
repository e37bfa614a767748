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
