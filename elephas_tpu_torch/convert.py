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

A tensor-parallel module (``parallel.tensor_parallel.shard_module``)
holds shards: ``from_flax_params`` and ``from_optax_state`` give it this
rank's shard of each full flax array, and ``to_flax_params`` gathers
its shards whole first (a collective: every rank of the model group
calls it).

Layouts (``LSTMClassifier``): ``Embed_0/embedding`` -> ``embed.weight``;
``OptimizedLSTMCell_0/{ii,if,ig,io}/kernel`` (in, out) ->
``cell.i*.weight`` (out, in); ``OptimizedLSTMCell_0/{hi,hf,hg,ho}/{kernel,
bias}`` -> ``cell.h*.{weight, bias}``; ``Dense_0`` -> ``out``. The port
keeps flax's leaves one for one, so each is a plain transpose.

Layouts (``TransformerLM``):

- ``tok_embed/embedding`` (V, d) -> ``tok_embed.weight``; ``pos_embed``
  (max_seq_len, d) -> ``pos_embed``;
- ``Block_i/SelfAttention_0/qkv/kernel`` (d, 3, H, hd) and ``bias``
  (3, H, hd) -> ``Linear(d, 3d)``: ``kernel.reshape(d, 3d).T``, so the
  output splits C-order into (q/k/v, head, hd) as the flax model's
  ``moveaxis(qkv, -3, 0)`` does;
- every other Dense kernel is (in, out) -> ``Linear.weight`` (out, in);
- ``LayerNorm_k/{scale, bias}`` -> ``weight``, ``bias``.

Layouts (``ResNet``, ``MLP``, ``MaskedMLP``, ``SimpleCNN``):

- ``Conv_k/kernel`` HWIO -> ``Conv2d.weight`` OIHW (and the CNN's
  ``Conv_k/bias`` -> ``bias``);
- ``BatchNorm_k/{scale, bias}`` -> ``weight``, ``bias``, and the
  ``batch_stats`` ``BatchNorm_k/{mean, var}`` -> ``running_mean``,
  ``running_var``; ``num_batches_tracked`` is set to 0 on the way in and
  has no flax leaf on the way out;
- ``Dense_k`` as above; ``MaskedMLP``'s ``batch_stats/mask_{i}`` ->
  the buffer ``mask_{i}``. The CNN's first dense layer takes the feature
  map flattened in flax's (H, W, C) order, so its kernel maps as any
  other.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.nn.parameter import is_lazy

from elephas_tpu_torch.models.cnn import SimpleCNN
from elephas_tpu_torch.models.lstm import GATES, LSTMClassifier
from elephas_tpu_torch.models.mlp import MLP, MaskedMLP
from elephas_tpu_torch.models.resnet import ResNet
from elephas_tpu_torch.models.transformer import TransformerLM

# The optax state fields that hold one tensor per parameter (the port's
# optimizers keep them in ``optimizer.state[p]`` under the same names).
_PER_PARAM = ("trace", "mu", "nu", "sum_of_squares")
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


def _masked_mlp_rows(module: MaskedMLP):
    """The MLP's dense layers, then each hidden layer's mask: flax's
    ``batch_stats/mask_{i}`` is the buffer ``mask_{i}``."""
    return _mlp_rows(module) + [("batch_stats", f"mask_{i}", f"mask_{i}", _same, _same)
                                for i in range(len(module.hidden))]


def _cnn_rows(module: SimpleCNN):
    """The convs (HWIO kernel and bias), then the two denses; the port's
    CNN flattens its feature map in flax's (H, W, C) order, so the first
    dense kernel's rows need no permutation."""
    rows = []
    for i in range(len(module.convs)):
        rows += _conv(f"Conv_{i}", f"convs.{i}")
        rows.append(("params", f"Conv_{i}/bias", f"convs.{i}.bias", _same, _same))
    return rows + _dense("Dense_0", "dense") + _dense("Dense_1", "out")


def _transpose(a):
    return a.T


def _lstm_rows(module: LSTMClassifier):
    """The embedding, flax's 12 cell leaves (input kernels without
    bias, hidden kernels with one), then the dense head."""
    cell = "OptimizedLSTMCell_0"
    rows = [("params", "Embed_0/embedding", "embed.weight", _same, _same)]
    rows += [("params", f"{cell}/i{g}/kernel", f"cell.i{g}.weight", _transpose, _transpose)
             for g in GATES]
    for g in GATES:
        rows += _dense(f"{cell}/h{g}", f"cell.h{g}")
    return rows + _dense("Dense_0", "out")


# A subclass comes before its base (``MaskedMLP`` before ``MLP``).
_LAYOUTS = ((TransformerLM, _transformer_lm_rows), (ResNet, _resnet_rows),
            (MaskedMLP, _masked_mlp_rows), (MLP, _mlp_rows), (SimpleCNN, _cnn_rows),
            (LSTMClassifier, _lstm_rows))


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
    tp = getattr(module, "_tensor_parallel", None)
    state = {}
    for collection, flax_name, torch_name, transform, _ in _rows(module, tuple(trees)):
        if flax_name not in flat[collection]:
            raise KeyError(f"flax {collection} lack {flax_name!r}")
        value = transform(flat[collection].pop(flax_name))
        if tp is not None:
            value = tp.local(torch_name, torch.from_numpy(np.ascontiguousarray(value))).numpy()
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
    tp = getattr(module, "_tensor_parallel", None)
    if tp is not None:
        state_dict = tp.full_state({row[2]: state_dict[row[2]] for row in rows})
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


def _optax_fields(state):
    """(field name, value) of every named-tuple field in an optax state,
    those of the states it wraps included: an injected state's
    ``inner_state`` and its schedules' ``hyperparams_states``."""
    if hasattr(state, "_fields"):
        for name in state._fields:
            value = getattr(state, name)
            if name == "inner_state":
                yield from _optax_fields(value)
            elif name == "hyperparams_states":
                for wrapped in value.values():
                    yield from _optax_fields(wrapped)
            else:
                yield name, value
    elif isinstance(state, (tuple, list)):
        for item in state:
            yield from _optax_fields(item)


def from_optax_state(opt_state, compiled) -> torch.optim.Optimizer:
    """A fresh optimizer over ``compiled``'s module holding the optax
    ``opt_state`` of the same optimizer: ``trace`` (sgd with momentum,
    rmsprop with momentum), ``mu`` and ``nu`` (adam, adamw, lamb; a
    centered rmsprop's ``mu``), ``nu`` (rmsprop), ``sum_of_squares``
    (adagrad), and the update count that drives bias corrections and
    schedules. An injected state (``optax.inject_hyperparams``) also
    hands over its hyperparameters, the learning rate as ``lr``. Only
    parameters have optimizer state, so BatchNorm statistics take no
    part."""
    name = (compiled.optimizer_config or {}).get("name")
    if name is None:
        raise ValueError("from_optax_state needs a model compiled from an optimizer "
                         "config (a name or {'name': ...})")
    optimizer = compiled.init_opt_state()
    params = dict(compiled.module.named_parameters())
    count, hyper = 0, {}
    for field, value in _optax_fields(opt_state):
        if field in _PER_PARAM:
            for torch_name, tensor in _from_flax({"params": value}, compiled.module,
                                                 params).items():
                optimizer.state[params[torch_name]][field] = tensor
        elif field == "count":
            count = int(np.asarray(value))
        elif field == "hyperparams":
            hyper = {("lr" if k == "learning_rate" else k): float(np.asarray(v))
                     for k, v in value.items()}
        else:
            raise ValueError(f"unexpected optax state field {field!r} for {name}")
    for group in optimizer.param_groups:
        group["count"] = count
        group.update({k: v for k, v in hyper.items() if isinstance(group.get(k), float)})
    return optimizer
