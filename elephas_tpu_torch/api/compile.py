"""CompiledModel — the inference half of ``elephas_tpu/api/compile.py``.

Binds a module (with its weights) to a named loss and named metrics, as
the JAX ``CompiledModel`` binds a flax module to optax and losses. The
optimizer spec is stored as given: resolving it to ``torch.optim``
arrives with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from elephas_tpu_torch.engine.losses import resolve_loss, resolve_metric


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
    """A module bound to loss/metrics, with its weights.

    Parameters
    ----------
    module: the port's ``nn.Module`` (``models.get_model``); it stays on
        the device it was built on.
    params: a ``state_dict`` (e.g. ``convert.from_flax_params``); if
        ``None``, weights are drawn from ``seed`` (``seeded_state``).
    optimizer: stored as given.
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
        self.optimizer_spec = optimizer
        self.loss_spec = loss
        self.metric_specs = list(metrics)
        self.loss_name = loss if isinstance(loss, str) else getattr(loss, "__name__", "custom")
        self.loss_fn = resolve_loss(loss)
        self.metric_names = [
            m if isinstance(m, str) else getattr(m, "__name__", "metric") for m in metrics
        ]
        self.metric_fns = [resolve_metric(m) for m in metrics]
        self.model_config = model_config or getattr(module, "_elephas_config", None)
        self.set_weights(params if params is not None else seeded_state(module, seed))

    def apply_eval(self, x):
        """Inference-mode forward, without autograd."""
        self.module.eval()
        with torch.no_grad():
            return self.module(x)

    def get_weights(self) -> Dict[str, torch.Tensor]:
        """Current weights as a CPU ``state_dict`` copy."""
        return {k: v.detach().cpu().clone() for k, v in self.module.state_dict().items()}

    def set_weights(self, params: Dict[str, torch.Tensor]) -> None:
        self.module.load_state_dict(params, strict=True)

    def count_params(self) -> int:
        return int(sum(p.numel() for p in self.module.parameters()))


def compile_model(module, **kwargs) -> CompiledModel:
    """Functional alias mirroring ``keras.Model.compile`` usage."""
    return CompiledModel(module, **kwargs)
