"""CompiledModel (counterpart of ``elephas_tpu/api/compile.py``).

Binds a module (with its weights) to an optimizer, a named loss and
named metrics, as the JAX ``CompiledModel`` binds a flax module to optax
and losses. Optimizers and schedules resolve by the JAX package's names
to ``api/optim.py``'s copies of optax's rules, and serialize to the same
``optimizer_config``.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from elephas_tpu_torch.api import optim
from elephas_tpu_torch.engine.losses import resolve_loss, resolve_metric

# name -> (builder, default kwargs). Learning-rate defaults follow Keras.
OPTIMIZERS: Dict[str, Tuple[Callable, Dict[str, Any]]] = {
    "sgd": (optim.sgd, {"learning_rate": 0.01}),
    "momentum": (optim.sgd, {"learning_rate": 0.01, "momentum": 0.9}),
    "adam": (optim.adam, {"learning_rate": 0.001}),
    "adamw": (optim.adamw, {"learning_rate": 0.001}),
    "rmsprop": (optim.rmsprop, {"learning_rate": 0.001}),
    "adagrad": (optim.adagrad, {"learning_rate": 0.01}),
    "lamb": (optim.lamb, {"learning_rate": 0.001}),
}

# Serializable learning-rate schedules, functions of the update count.
SCHEDULES: Dict[str, Callable] = {
    "constant": optim.constant_schedule,
    "exponential_decay": optim.exponential_decay,
    "cosine_decay": optim.cosine_decay_schedule,
    "piecewise_constant": optim.piecewise_constant_schedule,
    "warmup_cosine": optim.warmup_cosine_decay_schedule,
}


def resolve_schedule(lr):
    """A learning rate may be a float, a schedule callable, or a
    serializable ``{"schedule": <name>, **kwargs}`` config (per-update
    schedules, counted from 0 as optax counts them)."""
    if isinstance(lr, dict):
        spec = dict(lr)
        name = spec.pop("schedule", None)
        if not isinstance(name, str):
            raise ValueError(
                "dict learning_rate must look like {'schedule': <name str>, "
                f"**kwargs}}; got {lr!r}"
            )
        name = name.lower()
        if name not in SCHEDULES:
            raise ValueError(
                f"unknown lr schedule {name!r}; known: {sorted(SCHEDULES)}"
            )
        return SCHEDULES[name](**spec)
    return lr


def resolve_optimizer(optimizer) -> Tuple[Callable, Optional[dict]]:
    """Resolve an optimizer spec to ``(builder, serializable_config)``;
    ``builder(params)`` returns the ``torch.optim.Optimizer``.

    Accepts such a builder (config None — not re-serializable), a
    Keras-style name, or ``{"name": ..., **kwargs}`` where
    ``learning_rate`` may be a float or a ``{"schedule": ...}`` config.
    ``"injected": True`` is kept in the config; the port's optimizers
    always hold the learning rate in their param groups, where a caller
    can change it without rebuilding (optax's ``inject_hyperparams``).
    """
    if isinstance(optimizer, str):
        spec = {"name": optimizer}
    elif isinstance(optimizer, dict):
        spec = dict(optimizer)
    else:
        return optimizer, None
    name = spec.pop("name").lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}; known: {sorted(OPTIMIZERS)}")
    builder, defaults = OPTIMIZERS[name]
    inject = bool(spec.pop("injected", False))
    kwargs = {**defaults, **spec}
    build_kwargs = dict(kwargs)
    build_kwargs["learning_rate"] = resolve_schedule(build_kwargs["learning_rate"])
    config = {"name": name, "injected": True, **kwargs} if inject else {"name": name, **kwargs}
    return functools.partial(builder, **build_kwargs), config


def seeded_state(module: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``module`` drawn with NumPy from ``seed``, so
    one seed gives the same weights on every device: Linear weights
    N(0, 1/fan_in) and zero biases, LayerNorms at identity, embeddings
    and other bare parameters N(0, 0.02²)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, param in module.state_dict().items():
        owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
        leaf = name.rpartition(".")[2]
        if isinstance(owner, nn.LayerNorm):
            value = np.ones(param.shape) if leaf == "weight" else np.zeros(param.shape)
        elif isinstance(owner, nn.Linear) and leaf == "weight":
            value = rng.normal(0.0, 1.0 / np.sqrt(param.shape[1]), param.shape)
        elif isinstance(owner, nn.Linear):
            value = np.zeros(param.shape)
        else:
            value = rng.normal(0.0, 0.02, param.shape)
        state[name] = torch.as_tensor(value, dtype=param.dtype).to(param.device)
    return state


class CompiledModel:
    """A module bound to optimizer/loss/metrics, with its weights.

    Parameters
    ----------
    module: the port's ``nn.Module`` (``models.get_model``); it stays on
        the device it was built on and holds the weights.
    params: a ``state_dict`` (e.g. ``convert.from_flax_params``); if
        ``None``, weights are drawn from ``seed`` (``seeded_state``).
    optimizer: builder | name | ``{"name": ..., **kw}`` (``resolve_optimizer``).
    loss / metrics: Keras-style names or callables (``engine.losses``).
    model_config: ``{"name": ..., "kwargs": ...}`` when the module came
        from the registry.
    """

    def __init__(
        self,
        module: nn.Module,
        params: Optional[Dict[str, torch.Tensor]] = None,
        *,
        optimizer="sgd",
        loss="categorical_crossentropy",
        metrics: Sequence = ("acc",),
        seed: int = 0,
        model_config: Optional[dict] = None,
    ):
        self.module = module
        self.loss_spec = loss
        self.metric_specs = list(metrics)
        self.loss_name = loss if isinstance(loss, str) else getattr(loss, "__name__", "custom")
        self.loss_fn = resolve_loss(loss)
        self.metric_names = [
            m if isinstance(m, str) else getattr(m, "__name__", "metric") for m in metrics
        ]
        self.metric_fns = [resolve_metric(m) for m in metrics]
        self.optimizer, self.optimizer_config = resolve_optimizer(optimizer)
        self.model_config = model_config or getattr(module, "_elephas_config", None)
        self.set_weights(params if params is not None else seeded_state(module, seed))

    def apply_train(self, x):
        """Training-mode forward, with autograd."""
        self.module.train()
        return self.module(x, train=True)

    def apply_eval(self, x):
        """Inference-mode forward, without autograd."""
        self.module.eval()
        with torch.no_grad():
            return self.module(x)

    def init_opt_state(self) -> torch.optim.Optimizer:
        """A fresh optimizer over the module's parameters."""
        return self.optimizer(self.module.parameters())

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """Current weights as a CPU ``state_dict`` copy."""
        return {k: v.detach().cpu().clone() for k, v in self.module.state_dict().items()}

    def set_weights(self, params: Dict[str, torch.Tensor]) -> None:
        self.module.load_state_dict(params, strict=True)

    def count_params(self) -> int:
        return int(sum(p.numel() for p in self.module.parameters()))

    def clone(self) -> "CompiledModel":
        """Same architecture and hyperparameters, a deep copy of the
        module with the same current weights."""
        module = copy.deepcopy(self.module)
        return CompiledModel(
            module,
            params=module.state_dict(),
            optimizer=self.optimizer_config or self.optimizer,
            loss=self.loss_spec,
            metrics=list(self.metric_specs),
            model_config=self.model_config,
        )


def compile_model(module, **kwargs) -> CompiledModel:
    """Functional alias mirroring ``keras.Model.compile`` usage."""
    return CompiledModel(module, **kwargs)
