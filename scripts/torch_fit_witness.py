#!/usr/bin/env python3
"""How well ``SparkModel.fit`` trains the CIFAR-10 ResNet-18 in 3 epochs,
by batch and dtype, and why, on one GPU (the PyTorch port only).

    env PYTHONPATH=. python3 scripts/torch_fit_witness.py [--seeds 3]

For bf16 and float32 at batches 1024 and 2048 (16 and 8 steps an epoch)
and each weight seed, ``chip_smoke.py``'s fit: the registry's
``resnet18`` at full width, momentum lr 0.1, ``SparkModel(mode=
"synchronous", frequency="batch")`` on ``synthetic_cifar10(16384, 2048)``
scaled to [0, 1], 3 epochs with the held-out set evaluated after each.
Beside the history it reads the held-out accuracy three ways, to show
what the eval-mode accuracy measures:

- ``val_acc``: eval mode, the running statistics (what ``fit`` reports);
- ``acc_batch_stats``: train-mode BatchNorm, each 1024-row chunk
  normalised by its own statistics (running statistics restored after);
- ``acc_recalibrated``: eval mode after 30 forward passes in train mode
  over training batches, which bring the running statistics to the
  final weights (0.9^30 of the old ones left).

If the last two are high where ``val_acc`` is low, the running
statistics lag the weights; if float32 fails where bf16 fails, bf16 is
not the cause.

First, one train step of the ResNet at batch 64 on the card, as
``chip_smoke.py`` holds it: float32 against float64 and bf16 against
float32, healthy and with a planted fault (torch's symmetric padding on
the stride-2 convs): the readings between which
``RESNET_F32_GRAD_LIMITS`` and ``RESNET_BF16_LIMITS`` sit.

Last, the host ops of ``elephas_tpu_torch.native`` against numpy on the
fit's training set (``gather_rows`` of a permutation, ``encode_onehot``).

Prints one JSON line per measurement and writes them all to
``chiprun_out/fit_witness.json``.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the fit's settings and the step check)

BATCHES = (1024, 2048)
DTYPES = ("bfloat16", "float32")
RECALIBRATION_PASSES = 30


def compiled_resnet(dtype, seed, device=None, params=None):
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.models import get_model

    return CompiledModel(get_model("resnet18", dtype=dtype, device=device), params,
                         optimizer={"name": "momentum", "learning_rate": 0.1},
                         loss="categorical_crossentropy", metrics=["acc"],
                         input_shape=(32, 32, 3), seed=seed)


def accuracy(module, x, y, chunk=1024):
    """Top-1 accuracy of ``module`` as it stands (train or eval mode)."""
    hits = 0
    with torch.no_grad():
        for i in range(0, len(x), chunk):
            logits = module(x[i:i + chunk])
            hits += (logits.argmax(-1) == y[i:i + chunk].argmax(-1)).sum().item()
    return hits / len(x)


def fit_case(dtype, batch, seed, data):
    from elephas_tpu_torch import SparkModel, to_simple_rdd

    x_train, y_train, x_test, y_test = data
    net = compiled_resnet(dtype, seed)
    model = SparkModel(net, mode="synchronous", frequency="batch")
    t0 = time.perf_counter()
    history = model.fit(to_simple_rdd(None, x_train, y_train), epochs=chip_smoke.FIT_EPOCHS,
                        batch_size=batch, validation_data=(x_test, y_test))
    fit_s = time.perf_counter() - t0
    module = net.module
    xt, yt = (torch.as_tensor(a, device="cuda") for a in (x_test, y_test))
    xs, ys = (torch.as_tensor(a[:2048], device="cuda") for a in (x_train, y_train))
    buffers = {n: b.clone() for n, b in module.named_buffers()}
    module.train()
    batch_stats = accuracy(module, xt, yt)
    for (n, b) in module.named_buffers():
        b.copy_(buffers[n])
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for _ in range(RECALIBRATION_PASSES):
            rows = rng.choice(len(x_train), batch, replace=False)
            module(torch.as_tensor(x_train[rows], device="cuda"))
    module.eval()
    out = {"dtype": dtype, "batch": batch, "seed": seed, "steps_per_epoch": len(x_train) // batch,
           "loss": history["loss"], "acc": history["acc"], "val_acc": history["val_acc"],
           "acc_batch_stats": batch_stats, "acc_recalibrated": accuracy(module, xt, yt),
           "train_acc_recalibrated": accuracy(module, xs, ys), "fit_s": fit_s,
           "loss_falls": history["loss"][-1] < history["loss"][0]}
    return out


def step_readings():
    """The ResNet's train step at batch 64 on the card, as ``chip_smoke.py``
    holds it (``chip_smoke.step_errors``): float32 against float64, and
    bf16 against float32, each healthy and with a planted fault (torch's
    symmetric padding on the stride-2 3x3 convs instead of flax's SAME)."""
    from elephas_tpu_torch.data.datasets import one_hot
    from elephas_tpu_torch.models import resnet

    rng = np.random.default_rng(chip_smoke.SEED)
    x = torch.as_tensor(rng.random((chip_smoke.RESNET_CPU_BATCH, 32, 32, 3),
                                   dtype=np.float32), device="cuda")
    y = torch.as_tensor(one_hot(rng.integers(0, 10, chip_smoke.RESNET_CPU_BATCH), 10),
                        device="cuda")
    weights = compiled_resnet("float32", chip_smoke.SEED, device="cpu").get_weights()
    wide = compiled_resnet("float64", chip_smoke.SEED, params=weights)
    wide.module.double()
    exact = chip_smoke.step_record(wide, x.double(), y.double())
    same_padding = resnet.same_padding

    def torch_padding(size, kernel, stride):
        return (kernel // 2, kernel // 2) if stride > 1 else same_padding(size, kernel, stride)

    records = {}
    for fault in ("healthy", "symmetric stride-2 padding"):
        resnet.same_padding = same_padding if fault == "healthy" else torch_padding
        try:
            for dtype in ("float32", "bfloat16"):
                model = compiled_resnet(dtype, chip_smoke.SEED, params=weights)
                records[dtype, fault] = chip_smoke.step_record(model, x, y)
        finally:
            resnet.same_padding = same_padding
    keys = ("loss", "logits", "stats", "grads_all", "update_all", "grads", "grads_worst")
    readings = {}
    for fault in ("healthy", "symmetric stride-2 padding"):
        for what, got, ref in (("float32 vs float64", records["float32", fault], exact),
                               ("bfloat16 vs float32", records["bfloat16", fault],
                                records["float32", "healthy"])):
            errors = chip_smoke.step_errors(got, ref)
            readings[f"{what}, {fault}"] = {k: errors[k] for k in keys}
    return readings


def host_ops(x, labels):
    """Best of 5 seconds of each host op, native and numpy."""
    from elephas_tpu_torch import native

    perm = np.random.default_rng(0).permutation(len(x))
    y = np.eye(10, dtype=np.float32)[labels]

    def best(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    gx, gy = native.gather_rows(x, y, perm)
    assert np.array_equal(gx, x[perm]) and np.array_equal(gy, y[perm])
    assert np.array_equal(native.encode_onehot(labels, 10), y)
    return {"native_available": native.available(), "rows": len(x),
            "row_bytes": int(x[0].nbytes), "cpu_count": len(os.sched_getaffinity(0)),
            "gather_rows_native_s": best(lambda: native.gather_rows(x, y, perm)),
            "gather_rows_numpy_s": best(lambda: (x[perm], y[perm])),
            "encode_onehot_native_s": best(lambda: native.encode_onehot(labels, 10)),
            "encode_onehot_numpy_s": best(lambda: np.eye(10, dtype=np.float32)[labels])}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_fit_witness: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from elephas_tpu_torch.data.datasets import one_hot, synthetic_cifar10

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(chip_smoke.smi("name,power.limit"), flush=True)
    results = {"device": chip_smoke.smi("name,power.limit"), "steps": step_readings()}
    print(json.dumps({"steps": results["steps"]}), flush=True)

    torch.backends.cudnn.benchmark = True
    (x_train, y_train), (x_test, y_test) = synthetic_cifar10(
        n_train=chip_smoke.FIT_TRAIN, n_test=chip_smoke.FIT_TEST)
    labels = y_train
    x_train, x_test = x_train.astype(np.float32) / 255.0, x_test.astype(np.float32) / 255.0
    data = (x_train, one_hot(y_train, 10), x_test, one_hot(y_test, 10))
    results["fits"] = []
    for dtype in DTYPES:
        for batch in BATCHES:
            for seed in range(args.seeds):
                case = fit_case(dtype, batch, seed, data)
                results["fits"].append(case)
                print(json.dumps({"fit": case}), flush=True)
    results["host_ops"] = host_ops(x_train, labels)
    print(json.dumps({"host_ops": results["host_ops"]}), flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "fit_witness.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
