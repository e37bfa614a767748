"""Where a captured Adam step leaves the eager one, on one GPU.

    env PYTHONPATH=. python3 scripts/torch_capture_diag.py

Compares ``torch._foreach_div`` by a Python scalar with the same
division by a 0-d device tensor (and with true division and with a
multiplication by the reciprocal), then trains ``mlp_masked`` (bucket
128, width 100, Adam) for 8 steps from the same weights: with the plain
optimizer, with the capturable one run eagerly (as it is, and dividing
by its device divisors as ``api/optim.py`` did before ``_divide``), and
with the step captured as a CUDA graph (``engine.step.CapturedStep``);
prints the steps at which each leaves the plain run, under
deterministic algorithms, after the card's name and power limit.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from elephas_tpu_torch import compile_model  # noqa: E402
from elephas_tpu_torch.api import optim  # noqa: E402
from elephas_tpu_torch.engine.step import (  # noqa: E402
    CapturedStep,
    init_train_state,
    make_train_step,
)
from elephas_tpu_torch.models import get_model  # noqa: E402


def divisions(gen):
    a = torch.randn(100_000, device="cuda", generator=gen)
    for v in (0.1, 0.0199, 1 - 0.999 ** 3, 0.271):
        f = float(torch.tensor(v, dtype=torch.float32))
        t = torch.tensor(f, device="cuda")
        by_scalar = torch._foreach_div([a], f)[0]
        print(f"divisor {v}: scalar == tensor {torch.equal(by_scalar, torch._foreach_div([a], t)[0])}, "
              f"scalar == a / t {torch.equal(by_scalar, a / t)}, "
              f"scalar == a * (1 / t) {torch.equal(by_scalar, a * (1 / t))}", flush=True)


def run(mode, data):
    model = compile_model(get_model("mlp_masked", features=(128,), active=(100,)),
                          optimizer={"name": "adam", "learning_rate": 1e-3},
                          loss="categorical_crossentropy", metrics=["acc"], input_shape=(784,),
                          seed=1)
    step, state = make_train_step(model), init_train_state(model)
    if mode.startswith("capturable"):
        state.optimizer.capturable()
    if mode == "graph":
        step = CapturedStep(model, step)
    snaps = []
    for x, y in data:
        state, metrics = step(state, x, y)
        torch.cuda.synchronize()
        snaps.append([p.detach().clone() for p in model.module.parameters()])
    return snaps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_capture_diag: no CUDA device")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit"), flush=True)
    print(torch.__version__, torch.version.cuda, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    divisions(gen)
    data = [(torch.rand((64, 784), generator=gen, device="cuda"),
             F.one_hot(torch.randint(0, 10, (64,), generator=gen, device="cuda"), 10).float())
            for _ in range(8)]
    plain = run("plain", data)
    divide, divisors = optim._divide, optim._DIVISORS
    for mode in ("capturable_dividing", "capturable", "graph"):
        if mode == "capturable_dividing":  # device divisors, divided by
            optim._divide = lambda tensors, divisor: torch._foreach_div(tensors, divisor)
            optim._DIVISORS = frozenset()
        try:
            other = run(mode, data)
        finally:
            optim._divide, optim._DIVISORS = divide, divisors
        steps = [i for i, (a, b) in enumerate(zip(plain, other))
                 if not all(torch.equal(u, v) for u, v in zip(a, b))]
        print(f"{mode}: differs from the plain optimizer at steps {steps}", flush=True)


if __name__ == "__main__":
    main()
