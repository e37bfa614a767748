"""Ulysses-style (all-to-all) sequence-parallel attention (counterpart of
``elephas_tpu/parallel/ulysses.py``).

The second of the two long-context layouts beside ``ring_attention``.
Instead of rotating K/V shards around the ring (n − 1 hops), Ulysses
re-shards with two ``all_to_all`` exchanges a call (q/k/v ride one
stacked exchange; the output rides the inverse one back):

1. sequence-sharded → head-sharded: each rank trades its sequence shard
   of every head for the FULL sequence of ``heads / seq_size`` heads;
2. full-length causal attention runs locally on that head subset through
   ``flash_attention``: the hand-written kernels (K1 forward, K2 and K3
   backward under their autograd Function) on CUDA inputs, at the global
   length;
3. head-sharded → sequence-sharded: the outputs trade back.

It needs ``num_heads % seq_size == 0``. Differentiable end to end: each
``all_to_all``'s backward is the inverse exchange, and ``flash_attention``
carries its own backward.

Usage: inside a bound mesh (``parallel.mesh.bind_mesh``) with q/k/v this
rank's sequence shard; ``ulysses_self_attention`` wires the global case,
and ``TransformerLM(attention='ulysses')`` with
``seq_parallel.make_lm_train_step`` is the trained path.
"""

from __future__ import annotations

import torch

from elephas_tpu_torch.ops.attention import flash_attention
from elephas_tpu_torch.parallel.collectives import all_to_all
from elephas_tpu_torch.parallel.mesh import SEQ_AXIS, bind_mesh
from elephas_tpu_torch.parallel.ring_attention import _GatherSeq, _seq_mesh, _shard


def ulysses_attention(q, k, v, axis_name: str = SEQ_AXIS, causal: bool = True):
    """Exact attention over a sequence-sharded group via head re-sharding.

    q, k, v: this rank's shards (batch, heads, local_len, head_dim); the
    global sequence is the concatenation of the shards in rank order.
    Returns this rank's output shard, same shape. ``num_heads`` must
    divide by the seq-axis size.
    """
    mesh = _seq_mesh(axis_name, feature="attention='ulysses'")
    n = mesh.size
    h = q.shape[1]
    if h % n != 0:
        raise ValueError(
            f"attention='ulysses' needs num_heads ({h}) divisible by the "
            f"'{axis_name}' mesh axis size ({n}) — each device takes "
            f"heads/seq_size full-length heads; use attention='ring' for "
            f"head counts the mesh doesn't divide, or attention='auto' to "
            f"have the layout picked from the topology"
        )
    if n == 1:
        return flash_attention(q, k, v, causal=causal)
    # One exchange for q/k/v together: (3, b, h, L/n, d) -> (3, b, h/n, L, d).
    qkv = all_to_all(torch.stack((q, k, v)), mesh, split_axis=2, concat_axis=3)
    out = flash_attention(qkv[0], qkv[1], qkv[2], causal=causal)
    # The inverse: (b, h/n, L, d) -> (b, h, L/n, d).
    return all_to_all(out, mesh, split_axis=2, concat_axis=1)


def ulysses_self_attention(mesh, q, k, v, causal: bool = True):
    """Ulysses attention over ``mesh``'s seq axis on global (batch, heads,
    seq, head_dim) q, k, v held by every rank; returns the global output
    on every rank (the gradient reaches each rank's own sequence shard)."""
    seq = mesh.over(SEQ_AXIS)
    if q.shape[2] % seq.size:
        raise ValueError(f"sequence length {q.shape[2]} does not divide by the seq-axis "
                         f"size {seq.size}")
    with bind_mesh(mesh):
        out = ulysses_attention(_shard(q, seq), _shard(k, seq), _shard(v, seq),
                                causal=causal)
    return _GatherSeq.apply(out, seq)
