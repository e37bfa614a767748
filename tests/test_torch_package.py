"""The port's package boundary: it imports no JAX and nothing of
``elephas_tpu``, and its entry points take the GPU unless told otherwise."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import elephas_tpu_torch
from elephas_tpu_torch.models import get_model, registered_models
from elephas_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "elephas_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "elephas_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_submodule_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import elephas_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'elephas_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from elephas_tpu_torch.ops import attention_cuda\n"
        "print(json.dumps({'imported': names, 'loaded': sorted(sys.modules),\n"
        "                  'kernel_loaded': bool(attention_cuda._libs)}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "elephas_tpu_torch.ops.attention_cuda" in doc["imported"]
    assert [m for m in doc["loaded"] if _forbidden(m)] == []
    assert not doc["kernel_loaded"]  # importing builds and loads no kernel


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            found += [node.module] if _forbidden(node.module) else []
    assert found == []


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("transformer_lm")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    module = get_model("transformer_lm", device="cpu", vocab_size=50, d_model=16,
                       num_heads=2, num_layers=1, max_seq_len=8)
    assert module.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("lstm")
    lstm = get_model("lstm", device="cpu", vocab_size=50, embed_dim=8, hidden_dim=8)
    assert {p.device for p in lstm.parameters()} == {torch.device("cpu")}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elephas_tpu_torch.ElephasTransformer(model_payload={}).get_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("mlp_masked")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elephas_tpu_torch.HyperParamModel()


def test_registry():
    assert registered_models() == ["cnn", "lstm", "mlp", "mlp_masked", "resnet18",
                                   "transformer_lm"]
    with pytest.raises(ValueError, match="unknown model"):
        get_model("simple_cnn", device="cpu")
    masked = get_model("mlp_masked", device="cpu", features=(16,), active=(4,))
    assert masked._elephas_config == {"name": "mlp_masked", "kwargs": {
        "device": "cpu", "features": (16,), "active": (4,)}}
    lstm = get_model("lstm", device="cpu", vocab_size=50, embed_dim=8, hidden_dim=8)
    assert lstm._elephas_config == {"name": "lstm", "kwargs": {
        "device": "cpu", "vocab_size": 50, "embed_dim": 8, "hidden_dim": 8}}
    with pytest.raises(ValueError, match="attention"):
        get_model("transformer_lm", attention="sparse", device="cpu")
    assert elephas_tpu_torch.__version__


SEARCH_MODULES = ["hyperparam", "tune", "tune.trial", "tune.search", "tune.scheduler",
                  "tune.vault", "tune.runner", "tune.cli", "resilience.elastic",
                  "resilience.faults", "resilience.liveness"]


def test_search_modules_are_the_ports_own():
    """The search slice's modules load in a process holding no JAX, and
    keep their own copies of the JAX package's NumPy code."""
    code = (f"import importlib, json, sys\n"
            f"for name in {SEARCH_MODULES!r}:\n"
            f"    importlib.import_module('elephas_tpu_torch.' + name)\n"
            f"print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{list(FORBIDDEN)!r})))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
