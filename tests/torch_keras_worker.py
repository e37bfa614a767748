"""One package's Keras bridge on one Keras backend, for
``tests/test_torch_keras_bridge.py``.

    python tests/torch_keras_worker.py jax|torch OUT.json PERMS.npy

A Keras backend is fixed for each process, so each backend runs in a
process of its own: ``jax`` drives the JAX package's bridge
(``elephas_tpu.serialize.keras_bridge``, KERAS_BACKEND=jax), ``torch``
the port's (``elephas_tpu_torch.serialize.keras_bridge``,
KERAS_BACKEND=torch), on the CPU. Both build the same Keras
architectures with the same weights (drawn with NumPy from a seed) and
the same compile configurations, and OUT.json holds what the tests
compare: the mapped optimizer, loss, metrics and schedules, logits, the
weights after one synchronous epoch (the port's rows in the JAX
package's order, PERMS.npy), the error each refusal raises and the
``keras_param_rules`` table. The ``torch`` run adds the port's own
fits through ``SparkModel`` and a save/load round trip.
"""

import json
import os
import sys
import tempfile

BACKEND, OUT, PERMS = sys.argv[1], sys.argv[2], sys.argv[3]
os.environ["KERAS_BACKEND"] = BACKEND
if BACKEND == "jax":
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import keras  # noqa: E402

if BACKEND == "jax":
    import elephas_tpu as pkg
    from elephas_tpu.api.compile import resolve_schedule
    from elephas_tpu.parallel import tensor_parallel as tp
    from elephas_tpu.serialize import keras_bridge as bridge
    from elephas_tpu_torch.serialize import keras_bridge as other_bridge

    SPARK = {"num_workers": 1}
    ADAPTER_KW = {}
    OTHER_KW = {"device": "cpu"}
else:
    import torch

    import elephas_tpu_torch as pkg
    from elephas_tpu.serialize import keras_bridge as other_bridge
    from elephas_tpu_torch.api.compile import resolve_schedule
    from elephas_tpu_torch.engine import sync
    from elephas_tpu_torch.parallel import tensor_parallel as tp
    from elephas_tpu_torch.serialize import keras_bridge as bridge

    SPARK = {}
    ADAPTER_KW = {"device": "cpu"}
    OTHER_KW = {}


def from_keras(model, **kw):
    return bridge.from_keras(model, **ADAPTER_KW, **kw)


def blobs(n, num_classes, dim, seed):
    """tests/conftest.py's Gaussian blobs, one-hot labels."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=3.0, size=(num_classes, dim))
    labels = rng.integers(0, num_classes, size=n)
    x = (centers[labels] + rng.normal(scale=1.0, size=(n, dim))).astype(np.float32)
    return x, np.eye(num_classes, dtype=np.float32)[labels]


def mlp(compiled=True, dropout=True):
    layers = [keras.layers.Input((12,)), keras.layers.Dense(24, activation="relu")]
    layers += [keras.layers.Dropout(0.1)] if dropout else []
    model = keras.Sequential(layers + [keras.layers.Dense(3)])
    if compiled:
        model.compile(optimizer=keras.optimizers.Adam(0.01), loss="categorical_crossentropy")
    return model


def mlp_bn():
    model = keras.Sequential([keras.layers.Input((12,)),
                              keras.layers.Dense(16, activation="relu"),
                              keras.layers.BatchNormalization(), keras.layers.Dense(3)])
    model.compile(optimizer=keras.optimizers.SGD(0.1), loss="categorical_crossentropy")
    return model


def softmax_out():
    model = keras.Sequential([keras.layers.Input((12,)),
                              keras.layers.Dense(24, activation="relu"),
                              keras.layers.Dense(3, activation="softmax")])
    model.compile(optimizer=keras.optimizers.Adam(0.01), loss="categorical_crossentropy")
    return model


def sigmoid_out():
    model = keras.Sequential([keras.layers.Input((8,)),
                              keras.layers.Dense(16, activation="relu"),
                              keras.layers.Dense(1, activation="sigmoid")])
    model.compile(optimizer=keras.optimizers.Adam(0.02), loss="binary_crossentropy")
    return model


def from_logits():
    model = mlp(compiled=False)
    model.compile(optimizer=keras.optimizers.Adam(0.01),
                  loss=keras.losses.CategoricalCrossentropy(from_logits=True))
    return model


def softmax_layer():
    model = keras.Sequential([keras.layers.Input((6,)), keras.layers.Dense(3),
                              keras.layers.Softmax()])
    model.compile(optimizer="adam", loss="categorical_crossentropy")
    return model


def rmsprop_sparse():
    model = keras.Sequential([keras.layers.Input((6,)), keras.layers.Dense(4)])
    model.compile(optimizer=keras.optimizers.RMSprop(0.005),
                  loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True))
    return model


def regression():
    model = keras.Sequential([keras.layers.Input((4,)), keras.layers.Dense(1)])
    model.compile(optimizer=keras.optimizers.AdamW(0.003), loss="mse")
    return model


ARCHS = {"mlp": mlp, "mlp_bn": mlp_bn, "softmax": softmax_out, "sigmoid": sigmoid_out,
         "from_logits": from_logits, "softmax_layer": softmax_layer,
         "rmsprop_sparse": rmsprop_sparse, "regression": regression}
INPUT = {"mlp": 12, "mlp_bn": 12, "softmax": 12, "sigmoid": 8, "softmax_layer": 6}


def seeded(model, seed=0):
    """The same weights on every backend: each variable but the seed
    generators' drawn with NumPy in ``model.weights`` order."""
    rng = np.random.default_rng(seed)
    for v in model.weights:
        if "seed_generator" in v.path:
            continue
        shape = tuple(v.shape)
        if v.path.endswith("moving_variance"):
            v.assign(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            v.assign((0.3 * rng.standard_normal(shape)).astype(np.float32))
    return model


def spark(compiled, **kw):
    return pkg.SparkModel(compiled, **{**SPARK, **kw})


def rdd(x, y):
    return pkg.to_simple_rdd(None, x, y, 1) if BACKEND == "jax" else pkg.to_simple_rdd(None, x, y)


def outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - recorded for the tests
        return [type(exc).__name__, str(exc)]
    return None


def arrays(tree, keep):
    return {k: np.asarray(v, np.float64).tolist() for k, v in tree.items() if keep(k)}


out = {"backend": keras.backend.backend()}

# The mapped compile configurations.
out["configs"] = {}
for name, build in ARCHS.items():
    compiled = from_keras(build())
    out["configs"][name] = {"loss": compiled.loss_name, "optimizer": compiled.optimizer_config,
                            "metrics": list(compiled.metric_names),
                            "params": int(compiled.count_params())}
out["explicit"] = from_keras(mlp(compiled=False), optimizer="sgd",
                             loss="categorical_crossentropy").optimizer_config

# Logits on seeded weights and inputs.
out["logits"] = {}
for name, dim in INPUT.items():
    x = np.random.default_rng(1).standard_normal((16, dim)).astype(np.float32)
    out["logits"][name] = np.asarray(
        spark(from_keras(seeded(ARCHS[name]())), mode="synchronous").predict(x),
        np.float64).tolist()

# One synchronous epoch in the JAX package's row order.
x, y = blobs(128, 3, 12, seed=4)
fit = spark(from_keras(seeded(mlp_bn())), mode="synchronous", frequency="epoch")
if BACKEND == "torch":
    perms, own = np.load(PERMS), sync.shard_permutation
    sync.shard_permutation = lambda seed, epoch, shard, n: torch.as_tensor(perms[epoch, shard])
    history = fit.fit(rdd(x, y), epochs=1, batch_size=16)
    sync.shard_permutation = own
else:
    history = fit.fit(rdd(x, y), epochs=1, batch_size=16)
if BACKEND == "jax":
    net = fit.master_network
    trained = {**arrays(net.params, lambda k: True),
               **{f"nt{k[1:]}": v for k, v in arrays(net.batch_stats, lambda k: True).items()}}
else:
    trained = arrays(fit.get_weights(), lambda k: True)
out["fit"] = {"weights": trained, "loss": [float(v) for v in history["loss"]]}

# Schedules: the mapped config, its values, Keras' own values.
schedules = keras.optimizers.schedules
cases = {
    "exponential": (schedules.ExponentialDecay(0.1, decay_steps=100, decay_rate=0.5),
                    (0, 50, 100, 150)),
    "piecewise": (schedules.PiecewiseConstantDecay([100, 200], [0.1, 0.01, 0.001]),
                  (99, 100, 101, 150, 200, 201, 250)),
    "warmup_cosine": (schedules.CosineDecay(0.01, decay_steps=200, warmup_target=0.1,
                                            warmup_steps=50), (0, 25, 50, 150, 250)),
    "cosine": (schedules.CosineDecay(0.05, decay_steps=100, alpha=0.1), (0, 50, 100, 150)),
}
out["schedules"] = {}
for name, (sched, steps) in cases.items():
    cfg = bridge._optimizer_from_keras(keras.optimizers.SGD(learning_rate=sched))
    fn = resolve_schedule(cfg["learning_rate"])
    out["schedules"][name] = {"config": cfg, "steps": list(steps),
                              "mapped": [float(fn(s)) for s in steps],
                              "keras": [float(sched(s)) for s in steps]}

# Refusals.


def unmapped_optimizer():
    model = mlp(compiled=False)
    model.compile(optimizer=keras.optimizers.Nadam(), loss="categorical_crossentropy")
    return from_keras(model)


def unmapped_loss():
    model = mlp(compiled=False)
    model.compile(optimizer="adam", loss="huber")
    return from_keras(model)


def mismatched():
    model = keras.Sequential([keras.layers.Input((8,)),
                              keras.layers.Dense(3, activation="softmax")])
    model.compile(optimizer="adam", loss="binary_crossentropy")
    return from_keras(model)


out["errors"] = {
    "unbuilt": outcome(lambda: bridge.KerasModuleAdapter(
        keras.Sequential([keras.layers.Dense(4)]), **ADAPTER_KW)),
    "uncompiled": outcome(lambda: from_keras(mlp(compiled=False))),
    "spark_uncompiled": outcome(lambda: pkg.SparkModel(
        mlp(compiled=False), **({"device": "cpu"} if BACKEND == "torch" else {}))),
    "mismatched": outcome(mismatched),
    "unmapped_optimizer": outcome(unmapped_optimizer),
    "unmapped_loss": outcome(unmapped_loss),
    "other_backend": outcome(lambda: other_bridge.KerasModuleAdapter(mlp(), **OTHER_KW)),
}

# keras_param_rules over one model's variable paths.
rules = ((r".*dense.*/kernel$", tp.P(None, "model")), (r".*/bias$", tp.P("model")))
out["param_rules"] = [[k, list(v)] for k, v in tp.keras_param_rules(mlp(), rules)]

if BACKEND == "torch":
    port = {}
    x, y = blobs(384, 3, 12, seed=9)
    model = spark(from_keras(mlp()), mode="synchronous", frequency="batch")
    history = model.fit(rdd(x, y), epochs=3, batch_size=16)
    port["sync"] = {"acc": history["acc"][-1], "evaluate": model.evaluate(x, y)["acc"],
                    "predict_shape": list(model.predict(x[:5]).shape)}
    x, y = blobs(256, 3, 12, seed=10)
    model = spark(from_keras(mlp()), mode="hogwild", frequency="epoch", mesh=["cpu"] * 2)
    model.fit(rdd(x, y), epochs=3, batch_size=16)
    port["hogwild"] = {"evaluate": model.evaluate(x, y)["acc"]}
    x, y = blobs(384, 3, 12, seed=11)
    compiled = from_keras(softmax_out())
    model = spark(compiled, mode="synchronous", frequency="batch")
    port["softmax"] = {"loss": compiled.loss_name,
                       "acc": model.fit(rdd(x, y), epochs=3, batch_size=16)["acc"][-1]}
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 8)).astype(np.float32)
    y = (x @ rng.normal(size=(8, 1)).astype(np.float32) > 0).astype(np.float32)
    compiled = from_keras(sigmoid_out())
    model = spark(compiled, mode="synchronous", frequency="batch")
    history = model.fit(rdd(x, y), epochs=10, batch_size=16)
    port["sigmoid"] = {"loss": compiled.loss_name, "metrics": list(compiled.metric_names),
                       "acc": history["binary_accuracy_probs"][-1]}
    x, y = blobs(256, 3, 12, seed=5)
    model = pkg.SparkModel(mlp(), mode="synchronous", frequency="epoch", device="cpu")
    history = model.fit(rdd(x, y), epochs=3, batch_size=16)
    port["direct"] = {"acc": history["acc"][-1],
                      "predict_shape": list(model.predict(x[:32]).shape),
                      "adapter": type(model.master_network.module).__name__}
    x, y = blobs(192, 3, 12, seed=6)
    model = pkg.SparkModel(mlp(), mode="synchronous", frequency="epoch", device="cpu")
    model.fit(rdd(x, y), epochs=2, batch_size=16)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "keras_model.pkl")
        model.save(path)
        loaded = pkg.load_spark_model(path, device="cpu")
        port["save_load"] = {"max_abs": float(np.abs(loaded.predict(x[:16])
                                                     - model.predict(x[:16])).max())}
    out["port"] = port

with open(OUT, "w") as f:
    json.dump(out, f)
