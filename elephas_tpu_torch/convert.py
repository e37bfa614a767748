"""Weight bridge between the JAX package's flax parameters and the port's modules.

``from_flax_params(params, module)`` takes a flax ``params`` tree as
nested dicts of NumPy arrays (``jax.device_get`` of the JAX package's
params) and returns the ``state_dict`` of the port's module. It raises
on any flax leaf it did not consume and on any torch parameter it left
unset, so a layout change on either side fails loudly.
``to_flax_params(state_dict, module)`` is its inverse, so weights trained
in the port go back to the JAX package.

``from_optax_state(opt_state, compiled)`` carries an optax optimizer
state (``jax.device_get`` of a JAX ``TrainState.opt_state``) into the
port's optimizer, so a JAX run resumes in the port.

Layouts (``TransformerLM``):

- ``tok_embed/embedding`` (V, d) -> ``tok_embed.weight``; ``pos_embed``
  (max_seq_len, d) -> ``pos_embed``;
- ``Block_i/SelfAttention_0/qkv/kernel`` (d, 3, H, hd) and ``bias``
  (3, H, hd) -> ``Linear(d, 3d)``: ``kernel.reshape(d, 3d).T``, so the
  output splits C-order into (q/k/v, head, hd) as the flax model's
  ``moveaxis(qkv, -3, 0)`` does;
- every other Dense kernel is (in, out) -> ``Linear.weight`` (out, in);
- ``LayerNorm_k/{scale, bias}`` -> ``weight``, ``bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from elephas_tpu_torch.models.transformer import TransformerLM

# Optimizers whose optax state ``from_optax_state`` carries across.
_STATE_OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _dense(flax_name: str, torch_name: str, qkv_shape=None):
    """(flax leaf, torch name, to torch, to flax) rows of one Dense layer.
    ``qkv_shape`` (3, H, hd) folds the fused qkv kernel's output axes."""

    def kernel(a):
        return (a.reshape(a.shape[0], -1) if qkv_shape else a).T

    def kernel_back(a):
        return a.T.reshape(a.shape[1], *qkv_shape) if qkv_shape else a.T

    def bias_back(a):
        return a.reshape(qkv_shape) if qkv_shape else a

    return [
        (f"{flax_name}/kernel", f"{torch_name}.weight", kernel, kernel_back),
        (f"{flax_name}/bias", f"{torch_name}.bias", lambda a: a.reshape(-1), bias_back),
    ]


def _same(a):
    return a


def _layer_norm(flax_name: str, torch_name: str):
    return [
        (f"{flax_name}/scale", f"{torch_name}.weight", _same, _same),
        (f"{flax_name}/bias", f"{torch_name}.bias", _same, _same),
    ]


def _transformer_lm_rows(module: TransformerLM):
    qkv = (3, module.num_heads, module.d_model // module.num_heads)
    rows = [
        ("tok_embed/embedding", "tok_embed.weight", _same, _same),
        ("pos_embed", "pos_embed", _same, _same),
    ]
    for i in range(module.num_layers):
        blk, t = f"Block_{i}", f"blocks.{i}"
        rows += _layer_norm(f"{blk}/LayerNorm_0", f"{t}.ln1")
        rows += _dense(f"{blk}/SelfAttention_0/qkv", f"{t}.attn.qkv", qkv_shape=qkv)
        rows += _dense(f"{blk}/SelfAttention_0/out", f"{t}.attn.out")
        rows += _layer_norm(f"{blk}/LayerNorm_1", f"{t}.ln2")
        rows += _dense(f"{blk}/Dense_0", f"{t}.fc1")
        rows += _dense(f"{blk}/Dense_1", f"{t}.fc2")
    rows += _layer_norm("LayerNorm_0", "ln_f")
    rows += _dense("lm_head", "lm_head")
    return rows


def _rows(module):
    if not isinstance(module, TransformerLM):
        raise TypeError(f"no flax layout known for {type(module).__name__}")
    return _transformer_lm_rows(module)


def from_flax_params(params: Mapping, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` holding the flax ``params``."""
    rows = _rows(module)
    flat = _flatten(params)
    expected = module.state_dict()
    state = {}
    for flax_name, torch_name, transform, _ in rows:
        if flax_name not in flat:
            raise KeyError(f"flax params lack {flax_name!r}")
        value = transform(flat.pop(flax_name))
        target = expected[torch_name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{flax_name} -> {torch_name}: shape {value.shape} does not "
                f"fit {tuple(target.shape)}"
            )
        state[torch_name] = torch.tensor(value, dtype=target.dtype).to(target.device)
    if flat:
        raise KeyError(f"flax params not consumed: {sorted(flat)}")
    unset = sorted(set(expected) - set(state))
    if unset:
        raise KeyError(f"torch parameters left unset: {unset}")
    return state


def to_flax_params(state_dict: Mapping[str, torch.Tensor],
                   module: torch.nn.Module) -> dict:
    """The flax ``params`` tree (nested dicts of NumPy arrays) holding
    ``state_dict``, the inverse of ``from_flax_params``."""
    rows = _rows(module)
    missing = sorted({torch_name for _, torch_name, _, _ in rows} - set(state_dict))
    if missing:
        raise KeyError(f"state_dict lacks {missing}")
    tree: dict = {}
    for flax_name, torch_name, _, back in rows:
        *path, leaf = flax_name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = back(state_dict[torch_name].detach().cpu().numpy())
    return tree


def _optax_leaves(state):
    """(field name, value) of every named-tuple field in an optax state."""
    if hasattr(state, "_fields"):
        for name in state._fields:
            yield name, getattr(state, name)
    elif isinstance(state, (tuple, list)):
        for item in state:
            yield from _optax_leaves(item)


def from_optax_state(opt_state, compiled) -> torch.optim.Optimizer:
    """A fresh optimizer over ``compiled``'s module holding the optax
    ``opt_state`` of the same optimizer: ``trace`` (sgd with momentum),
    ``mu``, ``nu`` and ``count`` (adam, adamw), and the update count that
    drives a schedule. Other optimizers' states raise."""
    name = (compiled.optimizer_config or {}).get("name")
    if name not in _STATE_OPTIMIZERS or (compiled.optimizer_config or {}).get("injected"):
        raise NotImplementedError(
            f"carrying optax state across is ported for {_STATE_OPTIMIZERS} "
            f"(not injected), not {compiled.optimizer_config!r}; the rest arrives "
            "with serialization (ROADMAP.md, queue 1)"
        )
    optimizer = compiled.init_opt_state()
    params = dict(compiled.module.named_parameters())
    count = 0
    for field, value in _optax_leaves(opt_state):
        if field in ("trace", "mu", "nu"):
            for torch_name, tensor in from_flax_params(value, compiled.module).items():
                optimizer.state[params[torch_name]][field] = tensor
        elif field == "count":
            count = int(np.asarray(value))
        else:
            raise ValueError(f"unexpected optax state field {field!r} for {name}")
    for group in optimizer.param_groups:
        group["count"] = count
    return optimizer
