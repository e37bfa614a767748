"""Tensor parallelism over the mesh's ``'model'`` axis (counterpart of
``elephas_tpu/parallel/tensor_parallel.py``).

The JAX package annotates parameters with ``NamedSharding``s and lets
GSPMD insert the collectives. The port runs one process per device, so
each process holds its own shard of every sharded parameter, and the
layers that hold shards place the collectives themselves, as Megatron-LM
does (``parallel/collectives.py``):

- a column-parallel ``Linear`` (its flax kernel (in, out) sharded on
  ``out``; the torch weight on dim 0) takes a replicated input through
  ``copy_to_model`` and yields this rank's output features;
- a row-parallel ``Linear`` (kernel sharded on ``in``; weight dim 1)
  takes this rank's input features, all-reduces its partial products
  (``reduce_from_model``) and adds its replicated bias once, after the
  reduce;
- a vocab-parallel ``Embedding`` (embedding sharded on the vocabulary)
  looks up the tokens of its vocabulary range, zeros the rest and
  all-reduces.

For the ``TransformerLM`` under ``LM_RULES``: each rank's attention runs
on its ``num_heads / M`` heads (``flash_attention``, K1-K3, or the ring
and Ulysses hops under sequence parallelism), ``out`` and ``Dense_1``
(``fc2``) are row-parallel, ``Dense_0`` (``fc1``) column-parallel, the
token embedding vocab-parallel, and ``lm_head`` column-parallel over the
vocabulary: its logits stay sharded into the vocab-parallel
cross-entropy (``engine.losses.vocab_parallel_sparse_crossentropy``) and
are gathered only for metrics, ``predict`` and sampling. The result is
the unsharded model's, whatever the layout; the tests hold it there.

Rules stay written over the JAX package's flax paths, so a user's JAX
table carries over unchanged: (regex over the '/'-joined flax path,
``P``) pairs. ``convert.py``'s rows map each flax path to its torch
tensor; ``resolve_layout`` turns each spec into a torch dim. The qkv
kernel (d, 3, H, hd) shards its heads: in the port's ``Linear(d, 3d)``
a rank's rows are ``weight.view(3, H, hd, d)[:, heads]``, not a
contiguous third of 3d rows. A spec the port cannot lay out raises
``ValueError`` naming the path. ``param_specs`` raises when no rule
shards anything, unless ``allow_replicated``.

Optimizer state needs no counterpart of the JAX package's
``_state_shardings``: the port's optimizers create their slots lazily at
each parameter's shape, which is its local shard, so the slots follow
their parameter by construction. ``checkpoint/`` gathers parameters and
slots before rank 0 writes, and a restore slices them again.

Usage, on every process of a ``build_mesh(num_data=D, num_model=M)``::

    step = make_lm_train_step_tp(compiled, mesh)   # shards compiled.module
    state = init_lm_state_tp(compiled, mesh)
    state, metrics = step(state, tokens, targets)  # the global batch
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import is_lazy

from elephas_tpu_torch.engine.state import TrainState
from elephas_tpu_torch.engine.step import init_train_state, make_train_step
from elephas_tpu_torch.parallel.collectives import (
    all_gather,
    copy_to_model,
    gather_from_model,
    local_chunk,
    reduce_from_model,
    scatter_to_model,
)
from elephas_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


class P(tuple):
    """A PartitionSpec: one entry per array dim, an axis name or None
    (replicated along that dim); missing trailing entries are None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


Rules = Sequence[Tuple[str, P]]

# Path-pattern -> PartitionSpec for TransformerLM parameters (paths are
# '/'-joined flax keys; kernels listed with their flax layouts).
LM_RULES: Rules = (
    # qkv DenseGeneral: kernel (d_model, 3, heads, head_dim) — shard heads.
    (r".*/qkv/kernel$", P(None, None, MODEL_AXIS, None)),
    (r".*/qkv/bias$", P(None, MODEL_AXIS, None)),
    # attention output projection: kernel (d_model, d_model) — row-parallel.
    (r".*/out/kernel$", P(MODEL_AXIS, None)),
    (r".*/out/bias$", P()),
    # MLP: first Dense column-parallel, second row-parallel.
    (r".*/Dense_0/kernel$", P(None, MODEL_AXIS)),
    (r".*/Dense_0/bias$", P(MODEL_AXIS)),
    (r".*/Dense_1/kernel$", P(MODEL_AXIS, None)),
    (r".*/Dense_1/bias$", P()),
    # Vocabulary-sharded embedding and LM head.
    (r".*tok_embed/embedding$", P(MODEL_AXIS, None)),
    (r".*lm_head/kernel$", P(None, MODEL_AXIS)),
    (r".*lm_head/bias$", P(MODEL_AXIS)),
)

_LM_RULES = LM_RULES  # the JAX package's alias


def _spec_for(path: str, rules: Rules) -> P:
    for pattern, spec in rules:
        if re.match(pattern, path):
            return spec
    return P()  # LayerNorms, pos_embed, scalars: replicated


def _flax_rows(module):
    from elephas_tpu_torch.convert import _rows

    return _rows(module, ("params",))


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def _nest(flat: Mapping[str, object]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *keys, leaf = path.split("/")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _uses_model(spec) -> bool:
    return any(a == MODEL_AXIS or (isinstance(a, tuple) and MODEL_AXIS in a) for a in spec)


def param_specs(params, rules: Optional[Rules] = None, *,
                allow_replicated: bool = False) -> Dict:
    """``P`` tree for ``params`` from (pattern, spec) rules.

    ``params``: a flax-layout tree (nested dicts, e.g.
    ``convert.to_flax_params``) or a port module (its flax paths).
    ``rules`` defaults to ``LM_RULES``. Unmatched leaves replicate. If NO
    rule shards ANY parameter, tensor parallelism would be a no-op, so
    that raises unless ``allow_replicated=True``."""
    if rules is None:
        rules = LM_RULES
    paths = ([row[1] for row in _flax_rows(params)] if isinstance(params, nn.Module)
             else list(_flatten(params)))
    specs = {path: _spec_for(path, rules) for path in paths}
    if not allow_replicated and not any(_uses_model(s) for s in specs.values()):
        sample = sorted(specs)[:8]
        raise ValueError(
            "tensor-parallel rules shard NO parameter of this model — "
            "training would silently run fully replicated. Pass rules="
            "[(path_regex, P(...)), ...] matching your parameter "
            f"paths (e.g. {sample}), or allow_replicated=True to opt in to "
            "replication."
        )
    return _nest(specs)


def lm_param_specs(params, rules: Optional[Rules] = None) -> Dict:
    """``P`` tree for a ``TransformerLM``'s parameters."""
    return param_specs(params, rules)


def decode_cache_specs(cache, axis: str = MODEL_AXIS):
    """``P``s for a ``TransformerLM`` decode cache: K/V leaves shard their
    HEADS axis (dim 1 of ``(batch|slots|blocks, heads, len, head_dim)``),
    as the qkv kernel's heads shard under ``LM_RULES``, so decode
    attention runs on local heads; the column index replicates.

    ``cache``: the port's ``DecodeCache`` (contiguous or paged; returns a
    ``DecodeCache`` of specs) or the JAX package's nested-dict layout
    (``cached_key``/``cached_value`` leaves; returns the same tree)."""
    from elephas_tpu_torch.models.transformer import DecodeCache

    def kv(leaf, name):
        if leaf.ndim != 4:
            raise ValueError(f"{name}: expected rank-4, got {tuple(leaf.shape)}")
        return P(None, axis, None, None)

    if isinstance(cache, DecodeCache):
        return DecodeCache(keys=[kv(k, "keys") for k in cache.keys],
                           values=[kv(v, "values") for v in cache.values], index=P())
    flat = _flatten(cache)
    return _nest({path: kv(leaf, path) if path.rsplit("/", 1)[-1] in (
        "cached_key", "cached_value") else P() for path, leaf in flat.items()})


def keras_param_rules(keras_model, rules: Rules) -> Rules:
    """Translate rules over Keras variable paths into bridge-key rules.

    The Keras bridge packs trainable variables as ``v0..vN``
    (serialize/keras_bridge.py), which hides layer names from the
    path-regex matcher. Keras-3 variables carry their own ``.path``
    (e.g. ``'sequential/dense_1/kernel'``); this matches ``rules``
    against those and returns an exact-key table.
    """
    out = []
    for i, var in enumerate(keras_model.trainable_variables):
        for pattern, spec in rules:
            if re.match(pattern, var.path):
                out.append((rf"^v{i}$", spec))
                break
    return tuple(out)


# -- the torch layout ---------------------------------------------------------------


@dataclass(frozen=True)
class Shard:
    """How a torch tensor splits over the model axis: into equal chunks
    along ``dim``, or, for the fused qkv tensors (``heads`` = (3, H,
    hd)), along the heads of its ``view(3, H, hd, ...)``."""

    dim: int = 0
    heads: Optional[Tuple[int, int, int]] = None

    def local(self, full: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """This rank's shard of the full tensor (contiguous)."""
        if self.heads is None:
            return local_chunk(full, mesh, self.dim).contiguous()
        rest = full.shape[1:]
        grouped = full.reshape(*self.heads, *rest)
        return local_chunk(grouped, mesh, 1).reshape(-1, *rest).contiguous()

    def gather(self, local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        """The full tensor from every rank's shard (a collective)."""
        if self.heads is None:
            return all_gather(local, mesh, self.dim)
        three, heads, hd = self.heads
        rest = local.shape[1:]
        grouped = local.reshape(three, heads // mesh.size, hd, *rest)
        return all_gather(grouped, mesh, 1).reshape(-1, *rest)


def _fused_qkv(module, torch_name: str) -> bool:
    from elephas_tpu_torch.models.transformer import TransformerLM

    return isinstance(module, TransformerLM) and ".attn.qkv." in torch_name


def _kind(module, torch_name: str) -> Tuple[str, int]:
    """(kind, flax ndim) of a parameter: 'kernel', 'bias', 'embedding' or
    'other'."""
    owner = module.get_submodule(torch_name.rpartition(".")[0]) if "." in torch_name \
        else module
    leaf = torch_name.rpartition(".")[2]
    qkv = _fused_qkv(module, torch_name)
    if isinstance(owner, nn.Linear) and leaf == "weight":
        return "kernel", 4 if qkv else 2
    if isinstance(owner, nn.Linear) and leaf == "bias":
        return "bias", 3 if qkv else 1
    if isinstance(owner, nn.Embedding):
        return "embedding", 2
    return "other", module.get_parameter(torch_name).dim()


def _torch_shard(module, flax_name: str, torch_name: str, spec) -> Optional[Shard]:
    kind, ndim = _kind(module, torch_name)
    axes = tuple(spec)
    if len(axes) > ndim:
        raise ValueError(f"{flax_name}: spec {spec!r} has more entries than the leaf's "
                         f"{ndim} dims")
    axes = axes + (None,) * (ndim - len(axes))
    norm = []
    for a in axes:
        if isinstance(a, tuple):
            a = a[0] if len(a) == 1 else a
        if a not in (None, MODEL_AXIS):
            raise ValueError(f"{flax_name}: spec {spec!r} shards over {a!r}; the port shards "
                             f"parameters over the '{MODEL_AXIS}' axis only")
        norm.append(a)
    where = [i for i, a in enumerate(norm) if a == MODEL_AXIS]
    if not where:
        return None
    qkv = _fused_qkv(module, torch_name)
    heads = (3, module.num_heads, module.d_model // module.num_heads) if qkv else None
    layouts = {("kernel", 4, 2): Shard(0, heads), ("bias", 3, 1): Shard(0, heads),
               ("kernel", 2, 1): Shard(0), ("kernel", 2, 0): Shard(1),
               ("bias", 1, 0): Shard(0), ("embedding", 2, 0): Shard(0)}
    shard = layouts.get((kind, ndim, where[0])) if len(where) == 1 else None
    if shard is None:
        raise ValueError(f"{flax_name}: the port has no tensor-parallel layout for spec "
                         f"{spec!r} on a {ndim}-d {kind} (it shards a Dense kernel's in or out "
                         "dim, a bias with its kernel's out dim, the qkv heads, and an "
                         "embedding's vocabulary)")
    return shard


def resolve_layout(module: nn.Module, rules: Optional[Rules] = None, *,
                   allow_replicated: bool = False) -> Dict[str, Shard]:
    """The torch name and ``Shard`` of every parameter ``rules`` shards
    (the others replicate), through ``convert.py``'s rows."""
    specs = _flatten(param_specs(module, rules, allow_replicated=allow_replicated))
    layout = {}
    for _, flax_name, torch_name, _, _ in _flax_rows(module):
        shard = _torch_shard(module, flax_name, torch_name, specs[flax_name])
        if shard is not None:
            layout[torch_name] = shard
    return layout


# -- the parallel layers ----------------------------------------------------------------


class ColumnParallelLinear(nn.Linear):
    """A ``Linear`` whose weight rows (output features) are this rank's
    shard. Its input arrives replicated (``copy_to_model``); its output
    stays sharded unless ``gather_output``."""

    tp_mesh: Mesh
    gather_output: bool = False

    def parallel_dense(self, x, dtype=None, gather=None):
        mesh = self.tp_mesh
        x = copy_to_model(x, mesh)
        dtype = dtype or x.dtype
        bias = self.bias.to(dtype) if self.bias is not None else None
        y = F.linear(x.to(dtype), self.weight.to(dtype), bias)
        gather = self.gather_output if gather is None else gather
        return gather_from_model(y, mesh, -1) if gather else y

    def forward(self, x):
        return self.parallel_dense(x)


class RowParallelLinear(nn.Linear):
    """A ``Linear`` whose weight columns (input features) are this rank's
    shard: partial products all-reduced in float32, then the replicated
    bias added once. A replicated input is split first."""

    tp_mesh: Mesh
    sharded_input = True  # a column-parallel predecessor leaves its output sharded

    def parallel_dense(self, x, dtype=None):
        mesh = self.tp_mesh
        if x.shape[-1] != self.weight.shape[1]:
            x = scatter_to_model(x, mesh, -1)
        dtype = dtype or x.dtype
        y = reduce_from_model(F.linear(x.to(dtype), self.weight.to(dtype)).float(), mesh)
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(dtype)

    def forward(self, x):
        return self.parallel_dense(x)


class VocabParallelEmbedding(nn.Embedding):
    """An ``Embedding`` holding this rank's rows of the vocabulary: tokens
    outside them look up zeros, and the ranks' lookups are summed."""

    tp_mesh: Mesh

    def forward(self, tokens):
        mesh = self.tp_mesh
        rows = self.weight.shape[0]
        local = tokens - mesh.rank * rows
        outside = (local < 0) | (local >= rows)
        x = F.embedding(local.clamp(0, rows - 1), self.weight)
        return reduce_from_model(x.masked_fill(outside[..., None], 0.0), mesh)


class TensorParallel:
    """What a sharded module carries (``tensor_parallel_of``): the mesh,
    its model group (``model``), the rules and the ``layout`` (``state_dict``
    key -> ``Shard``: the sharded parameters and buffers). ``logits_mesh`` is the model group where the module's
    outputs are vocab-sharded (an LM's ``lm_head``), else None."""

    def __init__(self, mesh: Mesh, rules, layout: Dict[str, Shard], logits_mesh=None):
        self.mesh, self.rules, self.layout = mesh, rules, layout
        self.model = mesh.over(MODEL_AXIS)
        self.logits_mesh = logits_mesh

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        shard = self.layout.get(name)
        return full if shard is None else shard.local(full, self.model)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        shard = self.layout.get(name)
        return local if shard is None else shard.gather(local, self.model)

    def local_state(self, full: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A full ``state_dict`` as this rank's."""
        return {k: self.local(k, v) for k, v in full.items()}

    def full_state(self, local: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's ``state_dict`` gathered whole: every rank of the
        model group calls it, with the same keys."""
        return {k: self.gather(k, v) for k, v in local.items()}


def tensor_parallel_of(module) -> Optional[TensorParallel]:
    """The ``TensorParallel`` of a sharded module, None for another."""
    return getattr(module, "_tensor_parallel", None)


def _linear_roles(module, layout) -> Dict[str, str]:
    """'column', 'row' or 'plain' for each Linear, from its weight's and
    bias's shards."""
    roles = {}
    for name, layer in module.named_modules():
        if not isinstance(layer, nn.Linear):
            continue
        w, b = layout.get(f"{name}.weight"), layout.get(f"{name}.bias")
        has_bias = layer.bias is not None
        if w is None and b is None:
            roles[name] = "plain"
        elif w is not None and w.dim == 0 and (b == w or not has_bias):
            roles[name] = "column"
        elif w is not None and w.dim == 1 and b is None:
            roles[name] = "row"
        else:
            raise ValueError(
                f"{name}: weight shard {w} with bias shard {b} has no layout: a "
                "column-parallel kernel needs its bias sharded alike, a row-parallel "
                "kernel a replicated bias, and a replicated kernel a replicated bias")
    return roles


def _next_is_row(order, roles, i) -> bool:
    return i + 1 < len(order) and roles[order[i + 1]] == "row"


def _gathers(module, roles) -> Dict[str, bool]:
    """Whether each column-parallel layer gathers its output: not where
    its consumer takes sharded features (the attention, a row-parallel
    successor, the LM's vocab-sharded logits)."""
    from elephas_tpu_torch.models.mlp import MLP
    from elephas_tpu_torch.models.transformer import TransformerLM

    out = {name: True for name, role in roles.items() if role == "column"}
    if isinstance(module, TransformerLM):
        for i in range(module.num_layers):
            out.pop(f"blocks.{i}.attn.qkv", None)  # head-local attention
            if roles[f"blocks.{i}.fc2"] == "row":
                out.pop(f"blocks.{i}.fc1", None)
        out.pop("lm_head", None)
    elif isinstance(module, MLP):
        order = [f"hidden.{i}" for i in range(len(module.hidden))] + ["out"]
        for i, name in enumerate(order):
            if roles[name] == "column" and _next_is_row(order, roles, i):
                out[name] = False
    return out


def _mask_shards(module, roles, gathers) -> Dict[str, Shard]:
    """A ``MaskedMLP``'s masks of the hidden layers whose outputs stay
    sharded: each rank multiplies its own units by its chunk of the mask."""
    from elephas_tpu_torch.models.mlp import MaskedMLP

    if not isinstance(module, MaskedMLP):
        return {}
    return {f"mask_{i}": Shard(0) for i in range(len(module.hidden))
            if roles[f"hidden.{i}"] == "column" and not gathers[f"hidden.{i}"]}


def _check_divisible(module, layout, m: int) -> None:
    for name, shard in layout.items():
        p = module.get_parameter(name)
        size = shard.heads[1] if shard.heads else p.shape[shard.dim]
        if size % m:
            what = "num_heads" if shard.heads else f"dim {shard.dim} of {name}"
            raise ValueError(f"{what} ({size}) does not divide over the '{MODEL_AXIS}' "
                             f"axis ({m})")


def shard_module(module: nn.Module, mesh: Mesh, rules: Optional[Rules] = None, *,
                 allow_replicated: bool = False) -> nn.Module:
    """Shard ``module`` in place over ``mesh``'s model axis by ``rules``
    (default ``LM_RULES``) and return it.

    Every process of the model group calls it on the same full weights
    (a seed, or ``convert.from_flax_params``); each keeps its shard. The
    parameters keep their identity (their ``data`` is replaced), so an
    optimizer built before still steps them. The sharded Linears and
    Embeddings become ``ColumnParallelLinear``, ``RowParallelLinear`` and
    ``VocabParallelEmbedding``; a ``MaskedMLP``'s mask is sharded with the
    units it masks. A second call with the same mesh and
    rules does nothing; with others it raises. At a model axis of 1 the
    rules are checked and nothing changes."""
    from elephas_tpu_torch.models.mlp import MLP
    from elephas_tpu_torch.models.transformer import TransformerLM

    rules = LM_RULES if rules is None else rules
    done = tensor_parallel_of(module)
    if done is not None:
        if done.mesh is mesh and tuple(done.rules) == tuple(rules):
            return module
        raise ValueError("the module is already sharded under another mesh or rules")
    if any(is_lazy(p) for p in module.parameters()):
        raise ValueError("shard a module whose layers have their shapes (give "
                         "CompiledModel an input_shape or a state_dict first)")
    for layer in module.modules():
        if isinstance(layer, LazyModuleMixin):
            # Loaded but never called: one call turns it into its plain class.
            with torch.no_grad():
                layer(layer.weight.new_zeros((1, layer.weight.shape[1])))
    layout = resolve_layout(module, rules, allow_replicated=allow_replicated)
    roles = _linear_roles(module, layout)
    if layout and not isinstance(module, (TransformerLM, MLP)):
        raise ValueError(f"the port lays tensor parallelism out for TransformerLM and MLP "
                         f"models; {type(module).__name__} has no sharded forward")
    model = mesh.over(MODEL_AXIS)
    if model.size == 1:
        return module
    _check_divisible(module, layout, model.size)
    gathers = _gathers(module, roles)
    with torch.no_grad():
        for name, shard in layout.items():
            p = module.get_parameter(name)
            p.data = shard.local(p.data, model)
            p.tp_mesh = model  # global norms (lamb's trust ratio) reduce over it
        masks = _mask_shards(module, roles, gathers)
        for name, shard in masks.items():
            setattr(module, name, shard.local(module.get_buffer(name), model))
    layout.update(masks)
    for name, layer in module.named_modules():
        role = roles.get(name, "plain")
        if role == "column":
            layer.__class__ = ColumnParallelLinear
            layer.gather_output = gathers.get(name, False)
        elif role == "row":
            layer.__class__ = RowParallelLinear
        elif isinstance(layer, nn.Embedding) and f"{name}.weight" in layout:
            layer.__class__ = VocabParallelEmbedding
        else:
            continue
        layer.tp_mesh = model
    logits_mesh = None
    if isinstance(module, TransformerLM):
        for block in module.blocks:
            if roles_of(block.attn.qkv) == "column":
                block.attn.local_heads = module.num_heads // model.size
        module.local_heads = module.blocks[0].attn.local_heads if module.blocks \
            else module.num_heads
        if roles.get("lm_head") == "column":
            logits_mesh = model
    module._tensor_parallel = TensorParallel(mesh, rules, layout, logits_mesh)
    return module


def roles_of(layer) -> str:
    """'column', 'row' or 'plain': the tensor-parallel role of a Linear."""
    if isinstance(layer, ColumnParallelLinear):
        return "column"
    return "row" if isinstance(layer, RowParallelLinear) else "plain"


# -- the step builders --------------------------------------------------------------------


def _data_block(a, mesh: Mesh, device) -> torch.Tensor:
    """This rank's rows of a global batch (the data axis's block)."""
    t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    if t.shape[0] % mesh.size:
        raise ValueError(f"batch of {t.shape[0]} rows does not divide over the "
                         f"'{DATA_AXIS}' axis ({mesh.size})")
    rows = t.shape[0] // mesh.size
    return t[mesh.rank * rows:(mesh.rank + 1) * rows].to(device)


# The JAX package's ``_state_shardings`` (optimizer slots laid out like
# their parameters) has no counterpart: the port's optimizers create each
# slot lazily at its parameter's local shape, so the slots are shards too.


def make_train_step_tp(compiled, mesh: Mesh, rules: Optional[Rules] = None):
    """``step(state, x, y) -> (state, metrics)`` under dp × tp: the
    module sharded over ``'model'`` by ``rules`` (default ``LM_RULES``;
    any model with its own table; ``param_specs`` raises if nothing
    shards), the batch over ``'data'``. Every process passes the same
    global ``x`` and ``y`` (host arrays or tensors) and trains on its data
    block; gradients are averaged over the data group of the rank's own
    model index."""
    shard_module(compiled.module, mesh, rules)
    device = next(compiled.module.parameters()).device
    data = mesh.over(DATA_AXIS)
    train = make_train_step(compiled, pmean_axis=data)

    def step(state: TrainState, x, y):
        return train(state, _data_block(x, data, device), _data_block(y, data, device))

    return step


def init_state_tp(compiled, mesh: Mesh, rng=None, rules: Optional[Rules] = None) -> TrainState:
    """A ``TrainState`` over the module sharded by ``rules`` (the module
    is sharded here if it is not yet)."""
    shard_module(compiled.module, mesh, rules)
    return init_train_state(compiled, rng=rng)


# LM-named aliases (the flagship call sites).
make_lm_train_step_tp = make_train_step_tp
init_lm_state_tp = init_state_tp
