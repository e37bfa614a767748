"""Blockwise (flash) attention (counterpart of ``elephas_tpu/ops/attention.py``).

``flash_attention(q, k, v, causal)`` computes softmax attention in tiles
so the (seq × seq) score matrix never exists in device memory, forward
or backward. The device decides the implementation: a CUDA tensor
launches the hand-written kernels (``ops/attention_cuda.py``; K1
forward, K2 and K3 backward) or raises; a CPU tensor runs
``blockwise_reference``, K1's plain PyTorch version with the same
numerics, and autograd differentiates it. ``flash_backward_reference``
is the plain version of K2 and K3.

Shapes: q, k, v are (batch, heads, seq, head_dim); the output is the
same, and the optional lse is (batch, heads, seq) float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from elephas_tpu_torch.ops import attention_cuda

# The plain versions' default tile: 64 query rows by 64 keys. The CUDA
# kernels tile as ``attention_cuda.kernel_tiles`` says, and their plain
# versions take that tiling to sum in their order.
BLOCK_Q = 64
BLOCK_K = 64


def blockwise_reference(q, k, v, causal: bool = True, block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K):
    """Plain PyTorch version of the flash forward, returning ``(o, lse)``.

    Follows the numerics of ``attention_pallas.py::_flash_fwd_kernel``:
    q is scaled in float32, masked scores are ``-inf``, the running max
    is replaced by 0 where it is not finite (so a fully-masked row gives
    0 weights and a finite lse instead of NaN), the output is
    ``acc / max(l, 1e-30)`` cast to the input dtype and the lse is
    ``shift + log(max(l, 1e-30))`` in float32. Causal k-tiles that lie
    wholly above the diagonal are skipped, as the kernel skips them.
    """
    b, h, s, d = q.shape
    sk = k.shape[2]
    qf = q.float() * (1.0 / math.sqrt(d))
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for q0 in range(0, s, block_q):
        q_blk = qf[:, :, q0:q0 + block_q]
        n = q_blk.shape[2]
        q_pos = torch.arange(q0, q0 + n, device=q.device)
        acc = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
        row_max = torch.full((b, h, n), -math.inf, dtype=torch.float32,
                             device=q.device)
        row_sum = torch.zeros((b, h, n), dtype=torch.float32, device=q.device)
        k_end = min(sk, q0 + n) if causal else sk
        for k0 in range(0, k_end, block_k):
            k_blk = kf[:, :, k0:k0 + block_k]
            v_blk = vf[:, :, k0:k0 + block_k]
            scores = q_blk @ k_blk.transpose(-1, -2)
            if causal:
                k_pos = torch.arange(k0, k0 + k_blk.shape[2], device=q.device)
                scores = scores.masked_fill(
                    k_pos[None, :] > q_pos[:, None], -math.inf
                )
            new_max = torch.maximum(row_max, scores.amax(dim=-1))
            shift = torch.where(torch.isfinite(new_max), new_max, 0.0)
            p = torch.exp(scores - shift[..., None])
            correction = torch.where(
                torch.isfinite(row_max), torch.exp(row_max - shift), 0.0
            )
            acc = acc * correction[..., None] + p @ v_blk
            row_sum = row_sum * correction + p.sum(dim=-1)
            row_max = new_max
        denom = row_sum.clamp_min(1e-30)
        outs.append((acc / denom[..., None]).to(q.dtype))
        shift = torch.where(torch.isfinite(row_max), row_max, 0.0)
        lses.append(shift + torch.log(denom))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def cache_attention_mask(max_len, seq, idx, pad_offset=None, device=None):
    """Validity mask for KV-cache incremental attention.

    The current block of ``seq`` queries lands at cache columns
    ``idx + [0, seq)``; each query may attend every cached column up to
    its own, but never the leading left-pad columns of its row.

    ``idx``: an int (one shared write position, the ``generate`` path) or
    a (batch,) tensor of per-row positions. ``pad_offset``: None, or a
    (batch,) tensor of left-pad counts; column ``j`` is a pad key of row
    ``b`` iff ``j < pad_offset[b]``.

    Returns a bool mask broadcastable against (batch, heads, seq,
    max_len) scores: (1, 1, seq, max_len) when both idx and pad_offset
    are row-independent, else (batch, 1, seq, max_len).
    """
    if device is None:
        device = pad_offset.device if pad_offset is not None else (
            idx.device if torch.is_tensor(idx) else None
        )
    cols = torch.arange(max_len, device=device)
    rows = torch.arange(seq, device=device)
    if not torch.is_tensor(idx) or idx.dim() == 0:
        valid = (cols[None, :] <= idx + rows[:, None])[None]  # (1, seq, max_len)
    else:
        valid = cols[None, None, :] <= idx[:, None, None] + rows[None, :, None]
    if pad_offset is not None:
        valid = valid & (cols[None, None, :] >= pad_offset[:, None, None])
    return valid[:, None]  # broadcast over heads


def flash_backward_reference(q, k, v, o, lse, do, causal: bool = True,
                             block_q: int = BLOCK_Q, block_k: int = BLOCK_K):
    """Plain PyTorch version of the flash backward (K2 and K3), returning
    ``(dq, dk, dv)`` in the input dtypes.

    Follows the numerics of ``attention_pallas.py::_flash_dq_kernel`` and
    ``_flash_dkv_kernel``: ``delta = rowsum(dO * O)`` in float32; p is
    recomputed as ``exp(scale * q.k - lse)`` from the forward's lse and
    is 0 where the key is masked; ``ds = p * (dO.v - delta)``; ``dq =
    scale * sum ds k``, ``dv = sum p^T dO`` and ``dk = scale * sum ds^T q``
    accumulate in float32 over tiles in increasing order. Causal tiles
    wholly above the diagonal are skipped, as the kernels skip them.
    """
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    lse = lse.float()
    delta = (dof * o.float()).sum(-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))
    for q0 in range(0, s, block_q):
        rows = slice(q0, q0 + block_q)
        q_pos = torch.arange(q0, min(s, q0 + block_q), device=q.device)
        k_end = min(s, q0 + block_q) if causal else s
        for k0 in range(0, k_end, block_k):
            cols = slice(k0, k0 + block_k)
            scores = scale * (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2))
            p = torch.exp(scores - lse[:, :, rows, None])
            if causal:
                k_pos = torch.arange(k0, min(s, k0 + block_k), device=q.device)
                p = p.masked_fill(k_pos[None, :] > q_pos[:, None], 0.0)
            dp = dof[:, :, rows] @ vf[:, :, cols].transpose(-1, -2)
            ds = p * (dp - delta[:, :, rows, None])
            dq[:, :, rows] += ds @ kf[:, :, cols]
            dv[:, :, cols] += p.transpose(-1, -2) @ dof[:, :, rows]
            dk[:, :, cols] += ds.transpose(-1, -2) @ qf[:, :, rows]
    return (scale * dq).to(q.dtype), (scale * dk).to(k.dtype), dv.to(v.dtype)


class _FlashAttentionCUDA(torch.autograd.Function):
    """The CUDA kernels under autograd: K1 forward, K2 and K3 backward,
    as the JAX package's ``custom_vjp`` pairs the Pallas kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = attention_cuda.flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, grad_o, grad_lse):
        q, k, v, o, lse = ctx.saved_tensors
        # The model's head merge hands the gradient back as a strided view.
        do = grad_o.contiguous()
        delta = (do.float() * o.float()).sum(-1)
        dq = attention_cuda.flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = attention_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    return_lse: bool = False):
    """Blockwise attention; ``(o, lse)`` with ``return_lse=True``.

    A CUDA tensor launches the hand-written kernels, which tile as
    ``attention_cuda.kernel_tiles`` says for the forward; other block
    sizes raise there. A CPU tensor runs ``blockwise_reference`` at the
    given tiling (default ``BLOCK_Q`` x ``BLOCK_K``). q, k and v must have
    one shape: the kernel assumes equal query and key lengths, as the JAX
    package's does.
    """
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(
            "flash_attention needs q, k, v of one (batch, heads, seq, "
            f"head_dim) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if q.device.type == "cuda":
        tiles = attention_cuda.kernel_tiles("flash_fwd", q.dtype, q.shape[-1])
        if (block_q or tiles[0], block_k or tiles[1]) != tiles:
            raise ValueError(
                f"the CUDA kernel tiles at {tiles[0]}x{tiles[1]} here; "
                f"got block_q={block_q}, block_k={block_k}"
            )
        o, lse = _FlashAttentionCUDA.apply(q, k, v, causal)
    elif q.device.type == "cpu":
        o, lse = blockwise_reference(q, k, v, causal, block_q or BLOCK_Q, block_k or BLOCK_K)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return (o, lse) if return_lse else o
