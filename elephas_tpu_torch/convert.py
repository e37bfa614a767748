"""Weight bridge from the JAX package's flax parameters to the port's modules.

``from_flax_params(params, module)`` takes a flax ``params`` tree as
nested dicts of NumPy arrays (``jax.device_get`` of the JAX package's
params) and returns the ``state_dict`` of the port's module. It raises
on any flax leaf it did not consume and on any torch parameter it left
unset, so a layout change on either side fails loudly.

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


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def _dense(flax_name: str, torch_name: str, reshape_in: bool = False):
    """(flax leaf, torch name, transform) rows of one Dense layer."""

    def kernel(a):
        return (a.reshape(a.shape[0], -1) if reshape_in else a).T

    def bias(a):
        return a.reshape(-1)

    return [
        (f"{flax_name}/kernel", f"{torch_name}.weight", kernel),
        (f"{flax_name}/bias", f"{torch_name}.bias", bias),
    ]


def _layer_norm(flax_name: str, torch_name: str):
    return [
        (f"{flax_name}/scale", f"{torch_name}.weight", None),
        (f"{flax_name}/bias", f"{torch_name}.bias", None),
    ]


def _transformer_lm_rows(num_layers: int):
    rows = [
        ("tok_embed/embedding", "tok_embed.weight", None),
        ("pos_embed", "pos_embed", None),
    ]
    for i in range(num_layers):
        blk, t = f"Block_{i}", f"blocks.{i}"
        rows += _layer_norm(f"{blk}/LayerNorm_0", f"{t}.ln1")
        rows += _dense(f"{blk}/SelfAttention_0/qkv", f"{t}.attn.qkv", reshape_in=True)
        rows += _dense(f"{blk}/SelfAttention_0/out", f"{t}.attn.out")
        rows += _layer_norm(f"{blk}/LayerNorm_1", f"{t}.ln2")
        rows += _dense(f"{blk}/Dense_0", f"{t}.fc1")
        rows += _dense(f"{blk}/Dense_1", f"{t}.fc2")
    rows += _layer_norm("LayerNorm_0", "ln_f")
    rows += _dense("lm_head", "lm_head")
    return rows


def from_flax_params(params: Mapping, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``module`` holding the flax ``params``."""
    if not isinstance(module, TransformerLM):
        raise TypeError(f"no flax layout known for {type(module).__name__}")
    flat = _flatten(params)
    expected = module.state_dict()
    state = {}
    for flax_name, torch_name, transform in _transformer_lm_rows(module.num_layers):
        if flax_name not in flat:
            raise KeyError(f"flax params lack {flax_name!r}")
        value = flat.pop(flax_name)
        value = transform(value) if transform is not None else value
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
