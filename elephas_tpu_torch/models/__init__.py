"""Model registry (counterpart of ``elephas_tpu/models/__init__.py``).

Architectures serialize by name: ``get_model`` tags each module with the
name and keyword arguments it was built from. Only ``transformer_lm`` is
registered so far; the other models of the JAX package arrive with their
slices of the port.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    """Register a module builder under ``name`` for arch serialization."""

    def wrap(builder: Callable) -> Callable:
        _REGISTRY[name] = builder
        return builder

    return wrap


def get_model(name: str, **kwargs):
    """Build a registered module; tags it so its arch serializes by name."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    module = _REGISTRY[name](**kwargs)
    module._elephas_config = {"name": name, "kwargs": kwargs}
    return module


def registered_models():
    return sorted(_REGISTRY)


# Import for side effect: populate the registry.
from elephas_tpu_torch.models import transformer  # noqa: E402,F401
from elephas_tpu_torch.models.transformer import (  # noqa: E402,F401
    TransformerLM,
    generate,
)
