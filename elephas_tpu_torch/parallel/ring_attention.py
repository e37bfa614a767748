"""Ring attention: exact causal attention over a sequence-sharded group
(counterpart of ``elephas_tpu/parallel/ring_attention.py``).

Each process of the mesh's ``'seq'`` axis holds one contiguous shard of
the sequence. Key/value shards rotate around the ring (``ppermute``:
to the next rank, from the previous), and each query shard folds every
shard it holds into its output with a streaming (online) softmax. After
``seq_size`` hops every query has attended to every key: exact attention.

Two hop paths (``impl='auto'`` picks):

- **dense**: the (local_q × local_k) scores per hop with a streaming
  softmax, differentiated by autograd through ``ppermute``'s inverse
  rotation; the JAX package's path off the TPU, and the port's on
  tensors that are not on a card;
- **flash**: the hand-written kernels per hop, K1 returning (o, lse)
  partials combined in float32 (``_combine``). Contiguous shards make the
  causal structure blockwise: the own shard's hop is locally causal,
  earlier owners' hops are full attention, later owners' hops launch
  nothing. The backward (``_RingFlash``) re-rotates K/V with their
  float32 dk/dv accumulators and runs K2 and K3 per hop with the GLOBAL
  lse and delta = rowsum(dO * O) of the combined output, computed once a
  call, so each hop's gradients are its slice of the exact ones. Only q,
  k, v, the output and the lse are kept for the backward, not every
  hop's K/V.

Per call at ``n`` ranks, causal, rank ``r`` launches 1 + r forward hops
(K1) and 1 + r backward hops (K2 and K3 each): n(n + 1)/2 of each over
the ring, against n² for full attention.

Usage: inside a bound mesh (``parallel.mesh.bind_mesh``, as the JAX
package runs inside ``shard_map``) with q/k/v this rank's sequence shard,
(batch, heads, local_len, head_dim); ``ring_self_attention`` and
``seq_parallel.make_lm_train_step`` are the wired-up paths.
"""

from __future__ import annotations

import math

import torch

from elephas_tpu_torch.ops.attention import (
    flash_attention_bwd,
    flash_attention_fwd,
    use_kernels,
)
from elephas_tpu_torch.parallel.collectives import ppermute, ppermute_
from elephas_tpu_torch.parallel.mesh import SEQ_AXIS, bind_mesh, bound_mesh

_TINY = 1e-30


def seq_axis_size_or_none(axis_name: str = SEQ_AXIS):
    """Size of the bound mesh's sequence axis, or None outside a bound
    mesh (single-device eval and predict). It drives
    ``attention='auto'``'s layout choice."""
    mesh = bound_mesh()
    return None if mesh is None else mesh.over(axis_name).size


def _seq_mesh(axis_name: str = SEQ_AXIS, feature: str = "attention='ring'"):
    """The bound mesh's ``axis_name`` group as a one-axis Mesh; raises the
    JAX package's error outside a bound mesh."""
    mesh = bound_mesh()
    if mesh is None:
        raise ValueError(
            f"{feature} requires running inside a bound mesh with a "
            f"'{axis_name}' mesh axis (parallel.mesh.bind_mesh; see "
            f"elephas_tpu_torch.parallel.seq_parallel.make_lm_train_step). For "
            f"single-device eval/predict, rebuild the model with attention='dense' "
            f"or 'flash' — the parameters are identical."
        )
    return mesh.over(axis_name)


def require_seq_axis(axis_name: str = SEQ_AXIS, feature: str = "attention='ring'") -> int:
    """This process's index on the bound mesh's ``axis_name``, with an
    actionable error outside a bound mesh (``feature`` names the
    caller's configuration in it)."""
    return _seq_mesh(axis_name, feature).rank


def ring_attention(q, k, v, axis_name: str = SEQ_AXIS, causal: bool = True,
                   impl: str = "auto"):
    """Attention across a sequence-sharded ring.

    q, k, v: this rank's shards, (batch, heads, local_len, head_dim); the
    global sequence is the concatenation of the shards in rank order.
    Returns this rank's output shard, same shape.

    ``impl``: 'auto' (the flash hops on the kernels for CUDA inputs, as
    ``ops.attention.use_kernels`` decides every dispatch, the dense ring
    elsewhere), 'dense', or 'flash' (on the plain hop versions off a
    card). Differentiable on every path.
    """
    if impl not in ("auto", "dense", "flash"):
        raise ValueError(f"impl must be auto|dense|flash, got {impl!r}")
    mesh = _seq_mesh(axis_name)
    use_flash = use_kernels(q, k, v) if impl == "auto" else impl == "flash"
    if not use_flash:
        return _ring_dense(q, k, v, mesh, causal)
    return _RingFlash.apply(q, k, v, mesh, causal)


# ------------------------------------------------------------------ dense


def _ring_dense(q, k, v, mesh, causal: bool):
    """Per-hop dense scores with a streaming softmax."""
    my_idx, n = mesh.rank, mesh.size
    b, h, local_len, d = q.shape
    qf = q.float() * (1.0 / math.sqrt(d))
    q_pos = my_idx * local_len + torch.arange(local_len, device=q.device)
    acc = torch.zeros((b, h, local_len, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, local_len), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, local_len), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    # At hop s this rank holds the shard owned by (my_idx - s) mod n: shards
    # travel forward while ownership walks back.
    for s in range(n):
        owner = (my_idx - s) % n
        scores = qf @ k_cur.float().transpose(-1, -2)
        if causal:
            k_pos = owner * local_len + torch.arange(local_len, device=q.device)
            scores = scores.masked_fill(k_pos[None, :] > q_pos[:, None], -math.inf)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(scores - shift[..., None])
        correction = torch.where(torch.isfinite(m), torch.exp(m - shift), 0.0)
        acc = acc * correction[..., None] + p @ v_cur.float()
        l = l * correction + p.sum(dim=-1)
        m = m_new
        if s < n - 1:
            k_cur, v_cur = ppermute((k_cur, v_cur), mesh)
    # Fully-masked rows (none under causal with aligned shards) guard.
    return (acc / l.clamp_min(_TINY)[..., None]).to(q.dtype)


# ------------------------------------------------------------------ flash


def _combine(o1, lse1, o2, lse2):
    """Merge two (o, lse) partial-softmax results (float32 o's)."""
    m = torch.maximum(lse1, lse2)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = (w1 + w2).clamp_min(_TINY)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / denom[..., None]
    return o, m + torch.log(denom)


def _folds(owner: int, my_idx: int, causal: bool) -> bool:
    """Whether a hop holding ``owner``'s shard computes anything: every
    hop when full, only earlier owners' when causal."""
    return not causal or owner < my_idx


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, causal):
        my_idx, n = mesh.rank, mesh.size
        # Hop 0 is the own shard, locally causal (or full).
        o, lse = flash_attention_fwd(q, k, v, causal)
        of = o.float()
        kv = (k, v)
        for s in range(1, n):
            kv = ppermute_(kv, mesh)
            if _folds((my_idx - s) % n, my_idx, causal):
                o2, lse2 = flash_attention_fwd(q, *kv, causal=False)
                of, lse = _combine(of, lse, o2.float(), lse2)
        out = of.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.causal = mesh, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, causal = ctx.mesh, ctx.causal
        my_idx, n = mesh.rank, mesh.size
        # Each hop's gradient is recomputed from the GLOBAL (out, lse), so
        # its p is that hop's slice of the global softmax and the hops'
        # gradients sum to the exact ones; delta comes from out, once.
        delta = (g.float() * out.float()).sum(-1)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, delta, causal)
        dq = dq.float()
        # Each K/V shard travels with its gradient accumulator, collecting
        # every rank's contribution; n rotations bring the accumulators home.
        cur = (k, v, dk.float(), dv.float())
        for s in range(1, n):
            cur = ppermute_(cur, mesh)
            if _folds((my_idx - s) % n, my_idx, causal):
                dqc, dkc, dvc = flash_attention_bwd(q, cur[0], cur[1], out, lse, g, delta,
                                                    causal=False)
                dq += dqc.float()
                cur[2].add_(dkc.float())
                cur[3].add_(dvc.float())
        dk_acc, dv_acc = ppermute_(cur[2:], mesh)
        return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype), None, None


def _shard(t, mesh):
    """This rank's contiguous sequence shard of a global (b, h, seq, d)."""
    local = t.shape[2] // mesh.size
    return t[:, :, mesh.rank * local:(mesh.rank + 1) * local]


class _GatherSeq(torch.autograd.Function):
    """Every rank's (b, h, local, d) shard concatenated along the sequence
    on every rank. Every rank holds the same global value, as a
    replicated array does, so the backward takes this rank's slice of the
    gradient and sums nothing."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        if mesh.size == 1:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        torch.distributed.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        return _shard(g, ctx.mesh), None


def ring_self_attention(mesh, q, k, v, causal: bool = True, impl: str = "auto"):
    """Ring attention over ``mesh``'s seq axis on global (batch, heads,
    seq, head_dim) q, k, v, every rank holding the same arrays (SPMD): the
    sequence must divide by the axis size. Returns the global output on
    every rank; under autograd the gradient reaches each rank's own
    sequence shard of q, k and v."""
    seq = mesh.over(SEQ_AXIS)
    if q.shape[2] % seq.size:
        raise ValueError(f"sequence length {q.shape[2]} does not divide by the seq-axis "
                         f"size {seq.size}")
    with bind_mesh(mesh):
        out = ring_attention(_shard(q, seq), _shard(k, seq), _shard(v, seq),
                             causal=causal, impl=impl)
    return _GatherSeq.apply(out, seq)
