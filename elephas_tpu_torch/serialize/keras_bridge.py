"""Keras-3 (torch backend) model ingestion (counterpart of
``elephas_tpu/serialize/keras_bridge.py``).

Reference parity: elephas's entire API surface takes *Keras* models
(SURVEY.md §0 — ``SparkModel(model, ...)`` with a compiled Keras model).
Keras 3 on the torch backend builds a model that is itself a
``torch.nn.Module`` and exposes ``stateless_call`` (a pure function of
explicit variables). This bridge adapts a built Keras model to the
module protocol the port's ``CompiledModel`` expects:

- trainable variables   -> parameters ``v0..vN`` (the JAX bridge's
  ``params`` keys, in the same order)
- non-trainable vars    -> buffers ``nt0..ntM`` (BN statistics, seed
  generator states; the JAX bridge's ``batch_stats``)
- ``forward(x, train)`` -> ``stateless_call(..., training=train)``, the
  new non-trainable values written back into the buffers in training.

The adapter's own parameters hold the weights, on the device the caller
names (``from_keras(..., device=...)``), and the call runs under
``keras.device`` of that device; the Keras model's own variables are
never read. Requires ``KERAS_BACKEND=torch`` (set before importing
keras): a model of another backend cannot take torch tensors and is
refused with a clear error.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn


def _keras_backend() -> str:
    import keras

    return keras.backend.backend()


class KerasModuleAdapter(nn.Module):
    """A built Keras-3 torch-backend model as a module of the port."""

    def __init__(self, keras_model, device=None):
        from elephas_tpu_torch.utils.device import resolve_device

        backend = _keras_backend()
        if backend != "torch":
            raise ValueError(
                "Keras ingestion needs the torch backend: set KERAS_BACKEND=torch "
                f"before importing keras (current backend: {backend!r})"
            )
        if not keras_model.built:
            raise ValueError(
                "build the Keras model first (call it once or model.build(shape))"
            )
        super().__init__()
        device = resolve_device(device)
        # Held outside the module tree: its variables are not the adapter's.
        self.__dict__["_model"] = keras_model
        for i, v in enumerate(keras_model.trainable_variables):
            self.register_parameter(f"v{i}", nn.Parameter(_host_copy(v).to(device)))
        for i, v in enumerate(keras_model.non_trainable_variables):
            self.register_buffer(f"nt{i}", _host_copy(v).to(device))

    @property
    def _n_trainable(self) -> int:
        return len(self._model.trainable_variables)

    @property
    def _n_non_trainable(self) -> int:
        return len(self._model.non_trainable_variables)

    def _device_name(self) -> str:
        tensors = list(self.parameters()) + list(self.buffers())
        device = tensors[0].device if tensors else torch.device("cpu")
        return "cpu" if device.type == "cpu" else f"{device.type}:{device.index or 0}"

    def forward(self, x, train: bool = False):
        import keras

        trainable = [getattr(self, f"v{i}") for i in range(self._n_trainable)]
        non_trainable = [getattr(self, f"nt{i}") for i in range(self._n_non_trainable)]
        with keras.device(self._device_name()):
            outputs, new_non_trainable = self._model.stateless_call(
                trainable, non_trainable, x, training=train
            )
        if train:
            with torch.no_grad():
                for buf, value in zip(non_trainable, new_non_trainable):
                    buf.copy_(value)
        return outputs


def _host_copy(variable) -> torch.Tensor:
    """A Keras variable's current value as a fresh CPU tensor."""
    return torch.as_tensor(np.array(variable.numpy()))


_KERAS_LOSS_NAMES = {
    "categorical_crossentropy": "categorical_crossentropy",
    "CategoricalCrossentropy": "categorical_crossentropy",
    "sparse_categorical_crossentropy": "sparse_categorical_crossentropy",
    "SparseCategoricalCrossentropy": "sparse_categorical_crossentropy",
    "binary_crossentropy": "binary_crossentropy",
    "BinaryCrossentropy": "binary_crossentropy",
    "mse": "mse",
    "mean_squared_error": "mse",
    "MeanSquaredError": "mse",
    "mae": "mae",
    "mean_absolute_error": "mae",
    "MeanAbsoluteError": "mae",
}

_KERAS_OPTIMIZERS = {"SGD": "sgd", "Adam": "adam", "AdamW": "adamw", "RMSprop": "rmsprop",
                     "Adagrad": "adagrad"}


def _optimizer_from_keras(keras_opt) -> dict:
    name = _KERAS_OPTIMIZERS.get(type(keras_opt).__name__)
    if name is None:
        raise ValueError(
            f"unmapped Keras optimizer {type(keras_opt).__name__}; pass "
            "optimizer=... explicitly"
        )
    lr = keras_opt.learning_rate
    schedule = getattr(keras_opt, "_learning_rate", None)
    schedule_config = _schedule_from_keras(schedule)
    if schedule_config is not None:
        return {"name": name, "learning_rate": schedule_config}
    try:
        lr = float(lr.value if hasattr(lr, "value") else lr)
    except TypeError:  # unmapped schedule object: start-of-training value
        lr = float(lr(0))
    return {"name": name, "learning_rate": lr}


def _schedule_from_keras(schedule) -> Optional[dict]:
    """Map a Keras LearningRateSchedule to a serializable schedule config
    (``api.compile.resolve_schedule``, optax's names and semantics).
    Unmapped schedules return None and fall back to the schedule's
    step-0 value.

    Keras counts ITERATIONS exactly as the port's optimizers count
    updates, so the decay step semantics line up 1:1.
    """
    if schedule is None or not hasattr(schedule, "get_config"):
        return None
    kind = type(schedule).__name__
    cfg = schedule.get_config()
    if kind == "ExponentialDecay":
        return {
            "schedule": "exponential_decay",
            "init_value": float(cfg["initial_learning_rate"]),
            "transition_steps": int(cfg["decay_steps"]),
            "decay_rate": float(cfg["decay_rate"]),
            "staircase": bool(cfg.get("staircase", False)),
        }
    if kind == "CosineDecay":
        if cfg.get("warmup_steps"):
            peak = float(cfg.get("warmup_target") or cfg["initial_learning_rate"])
            return {
                "schedule": "warmup_cosine",
                # Keras warmup ramps linearly FROM initial_learning_rate
                # to warmup_target.
                "init_value": float(cfg["initial_learning_rate"]),
                "peak_value": peak,
                "warmup_steps": int(cfg["warmup_steps"]),
                # decay_steps is the TOTAL schedule length including
                # warmup; Keras decay_steps counts only the cosine phase.
                "decay_steps": int(cfg["warmup_steps"]) + int(cfg["decay_steps"]),
                "end_value": float(cfg.get("alpha", 0.0)) * peak,
            }
        return {
            "schedule": "cosine_decay",
            "init_value": float(cfg["initial_learning_rate"]),
            "decay_steps": int(cfg["decay_steps"]),
            "alpha": float(cfg.get("alpha", 0.0)),
        }
    if kind == "PiecewiseConstantDecay":
        bounds = [int(b) for b in cfg["boundaries"]]
        values = [float(v) for v in cfg["values"]]
        return {
            "schedule": "piecewise_constant",
            "init_value": values[0],
            # piecewise_constant multiplies by scale_i =
            # values[i+1]/values[i] at count >= boundary, while Keras
            # keeps the OLD value at step == boundary — shift each
            # boundary by +1 so fn(boundary) matches Keras exactly.
            "boundaries_and_scales": {
                int(b) + 1: float(values[i + 1] / values[i])
                for i, b in enumerate(bounds)
            },
        }
    return None


def _final_activation_name(keras_model) -> str:
    """Best-effort name of the output layer's activation ('linear' when
    none / undeterminable). Handles both fused activations
    (``Dense(n, activation=...)``) and standalone activation layers
    (``keras.layers.Softmax()``, ``Activation('sigmoid')``)."""
    try:
        layer = keras_model.layers[-1]
        cls = type(layer).__name__
        if cls == "Softmax":
            return "softmax"
        if cls in ("Sigmoid",):
            return "sigmoid"
        act = getattr(layer, "activation", None)
        return getattr(act, "__name__", "linear") if act is not None else "linear"
    except Exception:
        return "linear"


def _loss_from_keras(keras_loss, keras_model) -> str:
    """Map a Keras loss to an engine loss, honoring ``from_logits``.

    Keras losses default ``from_logits=False`` and are typically paired
    with a softmax/sigmoid output layer; the engine's plain crossentropy
    losses expect *logits*. Mapping a probability-output model onto a
    logit loss would apply softmax twice (silently wrong gradients), so:

    - ``from_logits=True``            -> logit loss (plain name)
    - probability output (softmax /
      sigmoid final activation)       -> ``*_probs`` loss variant
    - linear output, from_logits=False -> logit loss (the model emits
      logits; this is the common "forgot from_logits" Keras setup and the
      logit loss is the numerically sound interpretation)
    - mismatched pairs (e.g. softmax output + binary loss) -> error
    """
    key = keras_loss if isinstance(keras_loss, str) else type(keras_loss).__name__
    if key not in _KERAS_LOSS_NAMES:
        raise ValueError(f"unmapped Keras loss {key!r}; pass loss=... explicitly")
    name = _KERAS_LOSS_NAMES[key]
    if name not in ("categorical_crossentropy", "sparse_categorical_crossentropy",
                    "binary_crossentropy"):
        return name  # regression losses: logits/probs distinction is moot

    from_logits = bool(getattr(keras_loss, "from_logits", False))
    if from_logits:
        return name
    activation = _final_activation_name(keras_model)
    if activation == "linear":
        return name
    if activation == "softmax" and name in (
        "categorical_crossentropy", "sparse_categorical_crossentropy"
    ):
        return name + "_probs"
    if activation == "sigmoid" and name == "binary_crossentropy":
        return name + "_probs"
    raise ValueError(
        f"cannot map Keras loss {key!r} (from_logits=False) with final "
        f"activation {activation!r}: expected a logits output, softmax + "
        "categorical crossentropy, or sigmoid + binary crossentropy. Pass "
        "loss=... explicitly (use the '*_probs' losses for probability "
        "outputs)."
    )


def from_keras(
    keras_model,
    optimizer=None,
    loss=None,
    metrics: Optional[Sequence] = None,
    device=None,
):
    """Wrap a built Keras-3 torch-backend model as a ``CompiledModel`` on
    ``device`` (None: ``cuda``, as every entry point).

    ``optimizer``/``loss``/``metrics`` default from the Keras model's own
    ``compile(...)`` configuration when present (the reference reads the
    compiled Keras model the same way).
    """
    from elephas_tpu_torch.api.compile import CompiledModel

    adapter = KerasModuleAdapter(keras_model, device=device)

    if optimizer is None:
        if getattr(keras_model, "optimizer", None) is None:
            raise ValueError("model is not compiled; pass optimizer=...")
        optimizer = _optimizer_from_keras(keras_model.optimizer)
    if loss is None:
        keras_loss = getattr(keras_model, "loss", None)
        if keras_loss is None:
            raise ValueError("model is not compiled; pass loss=...")
        loss = _loss_from_keras(keras_loss, keras_model)
    if metrics is None:
        if str(loss).startswith("binary_crossentropy"):
            metrics = [
                "binary_accuracy_probs"
                if str(loss).endswith("_probs")
                else "binary_accuracy"
            ]
        elif "crossentropy" in str(loss):
            metrics = ["acc"]
        else:
            metrics = []

    return CompiledModel(
        adapter,
        params=adapter.state_dict(),
        optimizer=optimizer,
        loss=loss,
        metrics=list(metrics),
    )
