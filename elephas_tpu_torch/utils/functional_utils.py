"""Weight/update algebra over ``state_dict``s (counterpart of
``elephas_tpu/utils/functional_utils.py``).

Reference: ``elephas/utils/functional_utils.py::{add_params,
subtract_params, divide_by, get_neutral_vector}`` (SURVEY.md §2.1) — the
reference's whole gradient-aggregation math, there over Python lists of
numpy arrays. The JAX package runs it over pytrees; the port runs it
over mappings of name to tensor (a module's ``state_dict``), key by key.

The parameter server's trees are nested: ``{"params": state, "batch_stats":
state}``. ``tree_map`` and ``tree_leaves_with_path`` are the port's own
pytree walk over nested dicts, lists and tuples, the latter in the JAX
package's leaf order (a dict's keys sorted, as ``jax.tree_util``
flattens them).
"""

from __future__ import annotations

from typing import Any, List, Mapping, Sequence, Tuple

import torch


def _map(fn, *trees: Mapping[str, torch.Tensor]):
    first = trees[0]
    for tree in trees[1:]:
        if tree.keys() != first.keys():
            raise ValueError("state_dicts hold different keys")
    return {k: fn(*(t[k] for t in trees)) for k in first}


def add_params(tree_a, tree_b):
    """Elementwise ``a + b`` over two matching state_dicts."""
    return _map(torch.add, tree_a, tree_b)


def subtract_params(tree_a, tree_b):
    """Elementwise ``a - b``; ``subtract_params(before, after)`` is the
    reference's definition of a worker's weight *delta*."""
    return _map(torch.sub, tree_a, tree_b)


def divide_by(tree, num_workers):
    """Divide every tensor by a scalar (delta averaging)."""
    return _map(lambda x: x / num_workers, tree)


def scale_params(tree, factor):
    """Multiply every tensor by a scalar."""
    return _map(lambda x: x * factor, tree)


def get_neutral_vector(tree):
    """A zeros-like state_dict — the neutral element of ``add_params``."""
    return _map(torch.zeros_like, tree)


def average_params(trees: Sequence[Mapping[str, torch.Tensor]]):
    """Mean of a non-empty sequence of matching state_dicts (the
    reference's fold of ``add_params`` over collected deltas, then a
    division)."""
    if not trees:
        raise ValueError("average_params needs at least one state_dict")
    total = trees[0]
    for tree in trees[1:]:
        total = add_params(total, tree)
    return divide_by(total, float(len(trees)))


def tree_size(tree) -> int:
    """Total number of scalar elements across all tensors."""
    return sum(t.numel() for t in tree.values())


def global_norm(tree):
    """L2 norm over all tensors, as a 0-d float32 tensor."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its containers: dicts in ``tree``'s key order,
    lists and tuples in order, ``None`` as an empty subtree. Raises
    ``ValueError`` where the trees differ in structure."""
    if isinstance(tree, Mapping):
        for other in rest:
            if not isinstance(other, Mapping) or other.keys() != tree.keys():
                raise ValueError("trees differ in structure (dict keys)")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        for other in rest:
            if not isinstance(other, (list, tuple)) or len(other) != len(tree):
                raise ValueError("trees differ in structure (sequence length)")
        out = [tree_map(fn, v, *(o[i] for o in rest)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in the JAX package's order: a dict's keys
    sorted, sequences in order; ``None`` holds no leaf."""
    if isinstance(tree, Mapping):
        return [item for k in sorted(tree)
                for item in tree_leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_leaves_with_path(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]

