"""The port's ``model_to_dict``/``dict_to_model`` and
``SparkModel.save``/``load_spark_model`` against the JAX package's, on
the CPU.

A registry model's payload is the JAX package's: its architecture by
registry name, its weights in the flax layout. So a payload (and a saved
``SparkModel``) written by either package loads in the other, and the
two predict the same outputs on the same inputs within 1e-5 (absolute,
outputs of order 1). The port's ``device`` keyword never reaches a
payload, and ``dict_to_model`` builds where its caller asks.
"""

import inspect
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

import elephas_tpu_torch as et
from elephas_tpu import SparkModel as JaxSparkModel
from elephas_tpu import load_spark_model as jax_load_spark_model
from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.serialize import dict_to_model as jax_dict_to_model
from elephas_tpu.serialize import model_to_dict as jax_model_to_dict
from elephas_tpu_torch.models import get_model, registered_models
from elephas_tpu_torch.serialize import dict_to_model, model_to_dict

# name -> (kwargs, per-example input shape, input dtype name, loss)
REGISTRY = {
    "cnn": ({"channels": (4, 8), "dense_width": 16, "num_classes": 3}, (12, 12, 1),
            "float32", "categorical_crossentropy"),
    "lstm": ({"vocab_size": 50, "embed_dim": 8, "hidden_dim": 8}, (12,), "int32",
             "sparse_categorical_crossentropy"),
    "mlp": ({"features": (16,), "num_classes": 3}, (8,), "float32",
            "categorical_crossentropy"),
    "mlp_masked": ({"features": (16,), "active": (5,), "num_classes": 3}, (8,), "float32",
                   "categorical_crossentropy"),
    "resnet18": ({"width": 8, "num_classes": 3}, (16, 16, 3), "float32",
                 "categorical_crossentropy"),
    "transformer_lm": ({"vocab_size": 50, "d_model": 16, "num_heads": 2, "num_layers": 1,
                        "max_seq_len": 8}, (8,), "int32", "sparse_categorical_crossentropy"),
}
ADAM = {"name": "adam", "learning_rate": 0.01}


def _inputs(name, rows=3):
    _, shape, dtype, _ = REGISTRY[name]
    rng = np.random.default_rng(7)
    if dtype == "int32":
        return rng.integers(0, 50, (rows, *shape)).astype(np.int32)
    return rng.normal(size=(rows, *shape)).astype(np.float32)


def _port(name, seed=0):
    kwargs, shape, dtype, loss = REGISTRY[name]
    return et.CompiledModel(get_model(name, device="cpu", **kwargs), optimizer=ADAM, loss=loss,
                            metrics=["acc"], input_shape=shape,
                            input_dtype=getattr(torch, dtype), seed=seed)


def _jax(name):
    """The JAX model, initialized under ``jit`` (eager flax init of the
    ResNet takes seconds)."""
    kwargs, shape, dtype, loss = REGISTRY[name]
    module = jax_get_model(name, **kwargs)
    train = {"train": False} if "train" in inspect.signature(type(module).__call__).parameters \
        else {}
    variables = jax.jit(lambda x: module.init(jax.random.PRNGKey(0), x, **train))(
        jnp.zeros((1, *shape), dtype))
    return JaxCompiledModel(module, variables["params"], optimizer=ADAM, loss=loss,
                            metrics=["acc"], input_shape=shape, input_dtype=jnp.dtype(dtype),
                            batch_stats=variables.get("batch_stats", {}))


def _port_out(compiled, x):
    return compiled.apply_eval(torch.as_tensor(x)).numpy()


def _jax_out(compiled, x):
    return np.asarray(compiled.apply_eval(compiled.params, compiled.batch_stats, x))


def test_registry_covers_the_jax_serializable_models():
    assert sorted(REGISTRY) == registered_models()


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_port_payload_loads_in_jax(name):
    port = _port(name)
    payload = pickle.loads(pickle.dumps(model_to_dict(port)))
    assert payload["arch"] == {"kind": "registry",
                               "config": {"name": name, "kwargs": REGISTRY[name][0]}}
    assert payload["input_dtype"] == REGISTRY[name][2]
    restored = jax_dict_to_model(payload)
    x = _inputs(name)
    np.testing.assert_allclose(_jax_out(restored, x), _port_out(port, x), rtol=0, atol=1e-5)
    assert restored.optimizer_config == port.optimizer_config
    assert restored.loss_name == port.loss_name and restored.metric_names == ["acc"]


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_jax_payload_loads_in_port(name):
    jm = _jax(name)
    restored = dict_to_model(pickle.loads(pickle.dumps(jax_model_to_dict(jm))), device="cpu")
    x = _inputs(name)
    np.testing.assert_allclose(_port_out(restored, x), _jax_out(jm, x), rtol=0, atol=1e-5)
    assert restored.model_config == {"name": name, "kwargs": REGISTRY[name][0]}
    assert restored.input_shape == REGISTRY[name][1]
    assert restored.input_dtype == getattr(torch, REGISTRY[name][2])
    assert next(restored.module.parameters()).device == torch.device("cpu")
    # ... and back: the port's payload of it equals the JAX one leaf for leaf.
    again = model_to_dict(restored)
    for a, b in zip(jax.tree_util.tree_leaves(again["weights"]),
                    jax.tree_util.tree_leaves(jax.device_get(jm.params))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_device_never_reaches_the_payload(monkeypatch):
    port = _port("mlp")
    assert port.model_config["kwargs"]["device"] == "cpu"  # get_model records it
    payload = model_to_dict(port)
    assert "device" not in payload["arch"]["config"]["kwargs"]
    # A payload carrying one anyway (hand-made) loads where the caller says.
    payload["arch"]["config"]["kwargs"]["device"] = "cuda"
    restored = dict_to_model(payload, device="cpu")
    assert next(restored.module.parameters()).device == torch.device("cpu")
    # No device given: the card, as every entry point; none here.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dict_to_model(model_to_dict(port))


def test_custom_objects_override_the_registry():
    calls = []

    def builder(**kwargs):
        calls.append(kwargs)
        return get_model("mlp", **kwargs)

    restored = dict_to_model(model_to_dict(_port("mlp")), custom_objects={"mlp": builder},
                             device="cpu")
    assert calls == [{**REGISTRY["mlp"][0], "device": torch.device("cpu")}]
    assert restored.count_params() == _port("mlp").count_params()


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.LazyLinear(2)

    def forward(self, x, train=False):
        return self.lin(x)


def _squared_loss(preds, targets):
    return ((preds - targets) ** 2).mean(dim=-1)


def test_pickle_fallback_for_a_module_outside_the_registry():
    compiled = et.CompiledModel(_Tiny(), loss="mse", metrics=[], input_shape=(3,))
    payload = model_to_dict(compiled)
    assert payload["arch"]["kind"] == "pickle"
    assert set(payload["weights"]) == {"lin.weight", "lin.bias"}
    restored = dict_to_model(pickle.loads(pickle.dumps(payload)), device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_array_equal(_port_out(restored, x), _port_out(compiled, x))
    # Anything else pickled (a JAX package payload's flax module) is refused.
    other = {**payload, "arch": {"kind": "pickle", "payload": pickle.dumps({"not": "torch"})}}
    with pytest.raises(TypeError, match="not a torch module"):
        dict_to_model(other, device="cpu")


def test_custom_callable_loss_and_optimizer_round_trip():
    compiled = et.CompiledModel(get_model("mlp", device="cpu", features=(8,), num_classes=3),
                                optimizer=lambda params: torch.optim.SGD(params, lr=0.1),
                                loss=_squared_loss, metrics=[_squared_loss],
                                input_shape=(4,))
    with pytest.raises((pickle.PicklingError, AttributeError, TypeError)):
        model_to_dict(compiled)  # a lambda optimizer cannot be pickled
    compiled = et.CompiledModel(compiled.module, compiled.module.state_dict(),
                                loss=_squared_loss, metrics=[_squared_loss])
    payload = pickle.loads(pickle.dumps(model_to_dict(compiled)))
    assert payload["loss"]["kind"] == "pickle"
    restored = dict_to_model(payload, device="cpu")
    assert restored.loss_name == "_squared_loss" and restored.metric_names == ["_squared_loss"]
    assert restored.clone().loss_name == "_squared_loss"


def test_unknown_optimizer_and_loss_raise():
    payload = model_to_dict(_port("mlp"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        dict_to_model({**payload, "optimizer": {"kind": "config", "config": {"name": "nope"}}},
                      device="cpu")
    with pytest.raises(ValueError):
        dict_to_model({**payload, "loss": "nope"}, device="cpu")
    with pytest.raises(ValueError, match="architecture kind"):
        dict_to_model({**payload, "arch": {"kind": "keras"}}, device="cpu")


def test_bfloat16_parameters_raise():
    compiled = _port("mlp")
    compiled.module.to(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        model_to_dict(compiled)


def test_spark_model_takes_a_payload():
    jm = _jax("mlp")
    model = et.SparkModel(jax_model_to_dict(jm), mode="synchronous", device="cpu")
    x = _inputs("mlp")
    np.testing.assert_allclose(model.predict(x), _jax_out(jm, x), rtol=0, atol=1e-5)


def test_save_and_load_spark_model_across_packages(tmp_path):
    """The port saves what the JAX package loads and the other way round:
    the constructor's settings and the model, predicting the same."""
    port = et.SparkModel(_port("lstm"), mode="asynchronous", frequency="batch",
                         parameter_server_mode="socket", batch_size=16, port=0,
                         hogwild_granularity="leaf", max_failures=2)
    port.save(tmp_path / "port.pkl")
    loaded = et.load_spark_model(tmp_path / "port.pkl", device="cpu")
    x = _inputs("lstm")
    np.testing.assert_array_equal(loaded.predict(x), port.predict(x))
    for key in ("mode", "frequency", "parameter_server_mode", "batch_size", "port",
                "hogwild_granularity", "max_failures", "num_workers"):
        assert getattr(loaded, key) == getattr(port, key), key
    theirs = jax_load_spark_model(str(tmp_path / "port.pkl"))
    np.testing.assert_allclose(_jax_out(theirs.master_network, x), port.predict(x),
                               rtol=0, atol=1e-5)
    assert theirs.hogwild_granularity == "leaf" and theirs.frequency == "batch"

    jax_model = JaxSparkModel(_jax("lstm"), mode="synchronous", frequency="epoch")
    jax_model.save(str(tmp_path / "jax.pkl"))
    ours = et.load_spark_model(tmp_path / "jax.pkl", device="cpu")
    assert (ours.mode, ours.frequency) == ("synchronous", "epoch")
    np.testing.assert_allclose(ours.predict(x), _jax_out(jax_model.master_network, x),
                               rtol=0, atol=1e-5)
    labels = np.array([0, 1, 1])
    np.testing.assert_allclose(ours.evaluate(x, labels)["loss"],
                               jax_model.evaluate(x, labels)["loss"], rtol=1e-5)


def test_keras_models_still_raise_naming_the_bridge(monkeypatch):
    """A Keras model now goes to the Keras bridge, whose refusal of a
    backend other than torch names the ingestion (keras itself is not
    imported here: this process may hold it on another backend)."""
    from elephas_tpu_torch.serialize import keras_bridge

    monkeypatch.setattr(keras_bridge, "_keras_backend", lambda: "jax")
    Keras = type("Model", (), {"__module__": "keras.src.models"})
    with pytest.raises(ValueError, match="Keras ingestion needs the torch backend"):
        et.SparkModel(Keras(), device="cpu")
