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
from torch.nn.parameter import is_lazy

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
    one seed gives the same weights on every device: Linear and Conv2d
    weights N(0, 1/fan_in) (lecun_normal's variance) and zero biases,
    LayerNorms at identity, BatchNorms at identity with running mean 0
    and variance 1, embeddings and other bare parameters N(0, 0.02²). A
    layer fed by a masked one (``MaskedMLP``) draws at its live fan-in
    (``live_fan_in``), and other buffers (its masks) keep their values."""
    rng = np.random.default_rng(seed)
    state = {}
    buffers = dict(module.named_buffers())
    for name, param in module.state_dict().items():
        owner = module.get_submodule(name.rpartition(".")[0]) if "." in name else module
        leaf = name.rpartition(".")[2]
        if isinstance(owner, (nn.LayerNorm, nn.BatchNorm2d)):
            ones = leaf in ("weight", "running_var")
            value = np.ones(param.shape) if ones else np.zeros(param.shape)
        elif name in buffers:
            state[name] = param.detach().clone()
            continue
        elif isinstance(owner, (nn.Linear, nn.Conv2d)) and leaf == "weight":
            fan_in = getattr(owner, "live_fan_in", None) or int(np.prod(param.shape[1:]))
            value = rng.normal(0.0, 1.0 / np.sqrt(fan_in), param.shape)
        elif isinstance(owner, (nn.Linear, nn.Conv2d)):
            value = np.zeros(param.shape)
        else:
            value = rng.normal(0.0, 0.02, param.shape)
        state[name] = torch.as_tensor(value, dtype=param.dtype).to(param.device)
    return state


def _materialize(module: nn.Module, input_shape, input_dtype) -> None:
    """Give the lazy layers of ``module`` (a model's first layer infers
    its input width, as flax's does) their shapes from one example of
    ``input_shape``."""
    if not any(is_lazy(p) for p in module.parameters()):
        return
    if input_shape is None:
        raise ValueError("need either params or input_shape to initialize")
    device = next(module.parameters()).device
    module.eval()
    with torch.no_grad():
        module(torch.zeros((1, *input_shape), dtype=input_dtype, device=device))


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
    input_shape: per-example shape (no batch dim) that gives lazy layers
        their shapes when ``params`` is None.
    input_dtype: dtype of that example (e.g. ``torch.int64`` for tokens).
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
        input_shape: Optional[Tuple[int, ...]] = None,
        input_dtype=torch.float32,
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
        self.input_shape = tuple(input_shape) if input_shape is not None else None
        self.input_dtype = input_dtype
        if params is None:
            _materialize(module, self.input_shape, input_dtype)
            params = seeded_state(module, seed)
        self.set_weights(params)

    def apply_train(self, x, **kwargs):
        """Training-mode forward, with autograd; ``kwargs`` go to the
        module (``local_logits`` for a tensor-parallel LM)."""
        self.module.train()
        return self.module(x, train=True, **kwargs)

    def apply_eval(self, x, **kwargs):
        """Inference-mode forward, without autograd."""
        self.module.eval()
        with torch.no_grad():
            return self.module(x, **kwargs)

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
            input_shape=self.input_shape,
            input_dtype=self.input_dtype,
            model_config=self.model_config,
        )


def compile_model(module, **kwargs) -> CompiledModel:
    """Functional alias mirroring ``keras.Model.compile`` usage."""
    return CompiledModel(module, **kwargs)
