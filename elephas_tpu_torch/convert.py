"""Weight bridge between the JAX package's flax variables and the port's modules.

``from_flax_params(params, module, batch_stats)`` takes a flax ``params``
tree, and the ``batch_stats`` tree of a model with BatchNorm, as nested
dicts of NumPy arrays (``jax.device_get`` of the JAX package's) and
returns the ``state_dict`` of the port's module. It raises on any flax
leaf it did not consume and on any torch tensor it left unset, so a
layout change on either side fails loudly. ``to_flax_params(state_dict,
module)`` and ``to_flax_batch_stats(state_dict, module)`` are its
inverse, so weights trained in the port go back to the JAX package.

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

Layouts (``ResNet``, ``MLP``):

- ``Conv_k/kernel`` HWIO -> ``Conv2d.weight`` OIHW;
- ``BatchNorm_k/{scale, bias}`` -> ``weight``, ``bias``, and the
  ``batch_stats`` ``BatchNorm_k/{mean, var}`` -> ``running_mean``,
  ``running_var``; ``num_batches_tracked`` is set to 0 on the way in and
  has no flax leaf on the way out;
- ``Dense_k`` as above.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from elephas_tpu_torch.models.mlp import MLP
from elephas_tpu_torch.models.resnet import ResNet
from elephas_tpu_torch.models.transformer import TransformerLM

# Optimizers whose optax state ``from_optax_state`` carries across.
_STATE_OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")
_COLLECTIONS = ("params", "batch_stats")


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
    """(collection, flax leaf, torch name, to torch, to flax) rows of one
    Dense layer. ``qkv_shape`` (3, H, hd) folds the fused qkv kernel's
    output axes."""

    def kernel(a):
        return (a.reshape(a.shape[0], -1) if qkv_shape else a).T

    def kernel_back(a):
        return a.T.reshape(a.shape[1], *qkv_shape) if qkv_shape else a.T

    def bias_back(a):
        return a.reshape(qkv_shape) if qkv_shape else a

    return [
        ("params", f"{flax_name}/kernel", f"{torch_name}.weight", kernel, kernel_back),
        ("params", f"{flax_name}/bias", f"{torch_name}.bias", lambda a: a.reshape(-1),
         bias_back),
    ]


def _same(a):
    return a


def _layer_norm(flax_name: str, torch_name: str):
    return [
        ("params", f"{flax_name}/scale", f"{torch_name}.weight", _same, _same),
        ("params", f"{flax_name}/bias", f"{torch_name}.bias", _same, _same),
    ]


def _conv(flax_name: str, torch_name: str):
    """HWIO kernel -> OIHW weight."""
    return [("params", f"{flax_name}/kernel", f"{torch_name}.weight",
             lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0))]


def _batch_norm(flax_name: str, torch_name: str):
    return _layer_norm(flax_name, torch_name) + [
        ("batch_stats", f"{flax_name}/mean", f"{torch_name}.running_mean", _same, _same),
        ("batch_stats", f"{flax_name}/var", f"{torch_name}.running_var", _same, _same),
    ]


def _transformer_lm_rows(module: TransformerLM):
    qkv = (3, module.num_heads, module.d_model // module.num_heads)
    rows = [
        ("params", "tok_embed/embedding", "tok_embed.weight", _same, _same),
        ("params", "pos_embed", "pos_embed", _same, _same),
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


def _resnet_rows(module: ResNet):
    rows = _conv("Conv_0", "stem.conv") + _batch_norm("BatchNorm_0", "stem_norm")
    for i, block in enumerate(module.blocks):
        blk, t = f"ResidualBlock_{i}", f"blocks.{i}"
        rows += _conv(f"{blk}/Conv_0", f"{t}.conv1.conv")
        rows += _batch_norm(f"{blk}/BatchNorm_0", f"{t}.norm1")
        rows += _conv(f"{blk}/Conv_1", f"{t}.conv2.conv")
        rows += _batch_norm(f"{blk}/BatchNorm_1", f"{t}.norm2")
        if block.shortcut is not None:
            rows += _conv(f"{blk}/Conv_2", f"{t}.shortcut.conv")
            rows += _batch_norm(f"{blk}/BatchNorm_2", f"{t}.shortcut_norm")
    return rows + _dense("Dense_0", "head")


def _mlp_rows(module: MLP):
    rows = []
    for i in range(len(module.hidden)):
        rows += _dense(f"Dense_{i}", f"hidden.{i}")
    return rows + _dense(f"Dense_{len(module.hidden)}", "out")


_LAYOUTS = ((TransformerLM, _transformer_lm_rows), (ResNet, _resnet_rows), (MLP, _mlp_rows))


def _rows(module, collections=_COLLECTIONS):
    """The rows of ``module``'s tensors held in one of ``collections``."""
    for kind, rows_of in _LAYOUTS:
        if isinstance(module, kind):
            return [row for row in rows_of(module) if row[0] in collections]
    raise TypeError(f"no flax layout known for {type(module).__name__}")


def _from_flax(trees: Mapping, module, expected: Mapping) -> Dict[str, torch.Tensor]:
    """Each tensor of ``expected`` (torch name -> target) filled from the
    flax ``trees`` (collection -> tree). Raises on a leaf not consumed and
    on a target left unset."""
    flat = {c: _flatten(tree) for c, tree in trees.items()}
    state = {}
    for collection, flax_name, torch_name, transform, _ in _rows(module, tuple(trees)):
        if flax_name not in flat[collection]:
            raise KeyError(f"flax {collection} lack {flax_name!r}")
        value = transform(flat[collection].pop(flax_name))
        target = expected[torch_name]
        # A lazy layer (a model's first) takes its shape from the value.
        if not is_lazy(target) and tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{flax_name} -> {torch_name}: shape {value.shape} does not "
                f"fit {tuple(target.shape)}"
            )
        state[torch_name] = torch.tensor(value, dtype=target.dtype).to(target.device)
    for torch_name, target in expected.items():
        if torch_name.endswith("num_batches_tracked"):
            state[torch_name] = torch.zeros_like(target)
    left = sorted(f"{c}/{name}" for c in flat for name in flat[c])
    if left:
        raise KeyError(f"flax leaves not consumed: {left}")
    unset = sorted(set(expected) - set(state))
    if unset:
        raise KeyError(f"torch tensors left unset: {unset}")
    return state


def from_flax_params(params: Mapping, module: torch.nn.Module,
                     batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` holding the flax ``params`` and,
    for a model with BatchNorm, its ``batch_stats``."""
    return _from_flax({"params": params, "batch_stats": batch_stats or {}}, module,
                      module.state_dict())


def _to_flax(state_dict: Mapping[str, torch.Tensor], module, collection: str) -> dict:
    rows = _rows(module, (collection,))
    missing = sorted({row[2] for row in rows} - set(state_dict))
    if missing:
        raise KeyError(f"state_dict lacks {missing}")
    tree: dict = {}
    for _, flax_name, torch_name, _, back in rows:
        *path, leaf = flax_name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = back(state_dict[torch_name].detach().cpu().numpy())
    return tree


def to_flax_params(state_dict: Mapping[str, torch.Tensor],
                   module: torch.nn.Module) -> dict:
    """The flax ``params`` tree (nested dicts of NumPy arrays) holding
    ``state_dict``, the inverse of ``from_flax_params``."""
    return _to_flax(state_dict, module, "params")


def to_flax_batch_stats(state_dict: Mapping[str, torch.Tensor],
                        module: torch.nn.Module) -> dict:
    """The flax ``batch_stats`` tree holding ``state_dict``'s running
    statistics (empty for a model without BatchNorm)."""
    return _to_flax(state_dict, module, "batch_stats")


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
    drives a schedule. Other optimizers' states raise. Only parameters
    have optimizer state, so BatchNorm statistics take no part."""
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
            for torch_name, tensor in _from_flax({"params": value}, compiled.module,
                                                 params).items():
                optimizer.state[params[torch_name]][field] = tensor
        elif field == "count":
            count = int(np.asarray(value))
        else:
            raise ValueError(f"unexpected optax state field {field!r} for {name}")
    for group in optimizer.param_groups:
        group["count"] = count
    return optimizer
