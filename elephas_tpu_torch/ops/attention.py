"""Blockwise (flash) attention (counterpart of ``elephas_tpu/ops/attention.py``).

``flash_attention(q, k, v, causal)`` computes softmax attention in tiles
so the (seq × seq) score matrix never exists in device memory, forward
or backward. Every CUDA input runs the hand-written kernels
(``ops/attention_cuda.py``; K1 forward, K2 and K3 backward), at every
head_dim and length: ``takes_kernels`` is that rule, decided by the
device, and ``kernel_layout`` says at which head_dim and dtype the
kernels compute the input (up to 256 the smallest instance that holds
it, above 256 the next multiple of 256). Inputs on another device run
``blockwise_reference``, K1's plain PyTorch version with the same
numerics, and autograd differentiates it: the JAX package's own route
off the TPU (its XLA blockwise path). ``flash_backward_reference`` is
the plain version of K2 and K3.

Shapes: q, k, v are (batch, heads, seq, head_dim); the output is the
same, and the optional lse is (batch, heads, seq) float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from elephas_tpu_torch.ops import attention_cuda

# The plain versions' default tile: 64 query rows by 64 keys. The CUDA
# kernels tile as ``attention_cuda.kernel_tiles`` says, and their plain
# versions take that tiling to sum in their order.
BLOCK_Q = 64
BLOCK_K = 64


def blockwise_reference(q, k, v, causal: bool = True, block_q: int = BLOCK_Q,
                        block_k: int = BLOCK_K, scale: Optional[float] = None):
    """Plain PyTorch version of the flash forward, returning ``(o, lse)``.

    Follows the numerics of ``attention_pallas.py::_flash_fwd_kernel``:
    q is scaled in float32, masked scores are ``-inf``, the running max
    is replaced by 0 where it is not finite (so a fully-masked row gives
    0 weights and a finite lse instead of NaN), the output is
    ``acc / max(l, 1e-30)`` cast to the input dtype and the lse is
    ``shift + log(max(l, 1e-30))`` in float32. Causal k-tiles that lie
    wholly above the diagonal are skipped, as the kernel skips them. The
    scores' scale is ``1 / sqrt(head_dim)`` unless ``scale`` is given.
    """
    b, h, s, d = q.shape
    sk = k.shape[2]
    qf = q.float() * (1.0 / math.sqrt(d) if scale is None else scale)
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


# -- paged KV-cache gather/scatter ------------------------------------------
#
# The serving pool's paged layout stores K/V as physical blocks
# (num_blocks, heads, block_size, head_dim) shared across slots through a
# (max_slots, blocks_per_slot) block table. These helpers bridge that
# layout and the contiguous (slots, heads, len, head_dim) view the dense
# cache-attention path consumes (reference
# ``elephas_tpu/ops/attention.py:124-181``). Unallocated table entries
# carry the OUT-OF-RANGE id ``num_blocks``. XLA clamps it in a gather and
# drops it in a ``mode="drop"`` scatter; torch would raise on the CPU and
# assert on the GPU, so the gathers clamp the ids first and the scatters
# turn each dropped write into a copy of a kept one (``_scatter_kept``).
# Every op is a fixed-shape tensor op with no host read, so the decode
# step that runs them can be captured in a CUDA graph.


def _scatter_kept(pool_leaf, blocks, cols, values, keep):
    """``pool_leaf[blocks[i], :, cols[i]] = values[i]`` in place for the
    rows where ``keep`` is set; the other rows write nothing.

    A boolean selection of the kept rows would give a shape that depends
    on the data (a host sync). Instead each dropped row repeats the first
    kept row's write — the same value to the same place, so the order of
    the duplicates cannot matter — or, when no row is kept, writes back
    the value already at ``pool_leaf[0, :, 0]`` (read before the write).
    ``values``: (N, heads, head_dim)."""
    # A (1,) index: indexing with a 0-d tensor would read it on the host.
    first = torch.argmax(keep.to(torch.int32)).view(1)
    kept = keep[first]
    zero = torch.zeros_like(blocks[first])
    fb_block = torch.where(kept, blocks[first], zero)
    fb_col = torch.where(kept, cols[first], zero)
    fb_value = torch.where(kept[:, None, None], values[first], pool_leaf[0, :, 0][None])
    blocks = torch.where(keep, blocks, fb_block)
    cols = torch.where(keep, cols, fb_col)
    values = torch.where(keep[:, None, None], values, fb_value)
    pool_leaf[blocks, :, cols] = values.to(pool_leaf.dtype)
    return pool_leaf


def paged_to_contiguous(leaf, table):
    """Gather a paged K/V leaf into per-slot contiguous rows.

    ``leaf``: (num_blocks, heads, block_size, head_dim) physical blocks;
    ``table``: (max_slots, blocks_per_slot) int block ids (out-of-range
    ids clamp to the last block). Returns a new (max_slots, heads,
    blocks_per_slot * block_size, head_dim) tensor."""
    slots, bps = table.shape
    num_blocks, heads, bs, head_dim = leaf.shape
    gathered = leaf[table.clamp(max=num_blocks - 1)]  # (slots, bps, heads, bs, hd)
    return gathered.permute(0, 2, 1, 3, 4).reshape(slots, heads, bps * bs, head_dim)


def slot_row_to_contiguous(leaf, row_table):
    """Gather ONE slot's blocks as a batch-1 contiguous cache row.

    ``row_table``: (blocks_per_slot,) int block ids for the slot.
    Returns (1, heads, blocks_per_slot * block_size, head_dim)."""
    num_blocks, heads, bs, head_dim = leaf.shape
    gathered = leaf[row_table.clamp(max=num_blocks - 1)]  # (bps, heads, bs, hd)
    return gathered.permute(1, 0, 2, 3).reshape(heads, -1, head_dim)[None]


def scatter_decode_columns(pool_leaf, contiguous, table, idx, active):
    """Write each slot's just-decoded column back into its physical block,
    in place.

    ``contiguous`` is the (max_slots, heads, L, head_dim) view AFTER the
    apply wrote column ``idx[s]`` for every slot s (``idx`` is the
    PRE-advance per-slot column vector). Inactive lanes, and lanes whose
    column is unallocated or past the row, write nothing — their computed
    column is garbage by contract."""
    num_blocks, _, bs, _ = pool_leaf.shape
    slots, bps = table.shape
    length = contiguous.shape[2]
    lanes = torch.arange(slots, device=idx.device)
    written = contiguous[lanes, :, idx.clamp(max=length - 1)]  # (slots, heads, hd)
    blk = table[lanes, (idx // bs).clamp(max=bps - 1)]
    # A column past the row (a frozen lane at its end) is out of range in
    # the reference's take_along_axis too, and its write drops.
    return _scatter_kept(pool_leaf, blk, idx % bs, written,
                         active & (blk < num_blocks) & (idx < length))


def scatter_prefill_columns(pool_leaf, row_table, start, chunk):
    """Write one prefill chunk's columns ``[start, start + C)`` of ONE
    slot into its physical blocks, in place.

    ``chunk``: (heads, C, head_dim) — the freshly-computed K or V
    columns. Columns landing in unallocated blocks (right-pad garbage
    past the slot's allocation) write nothing."""
    num_blocks, _, bs, _ = pool_leaf.shape
    cols = start + torch.arange(chunk.shape[1], device=row_table.device)
    target = row_table[(cols // bs).clamp(max=row_table.shape[0] - 1)]
    return _scatter_kept(pool_leaf, target, cols % bs, chunk.transpose(0, 1),
                         target < num_blocks)


def scatter_spec_columns(pool_leaf, contiguous, table, idx, count: int, active):
    """Write each slot's ``count`` freshly-computed columns ``[idx[s],
    idx[s] + count)`` back into its physical blocks, in place — the
    multi-column sibling of ``scatter_decode_columns`` for a speculative
    verify window.

    ``contiguous`` is the (max_slots, heads, L, head_dim) view AFTER a
    forward with seq == ``count`` wrote those columns (``idx`` is the
    PRE-advance per-slot column vector). Inactive lanes, and columns past
    the row's virtual capacity (or in an unallocated block), write
    nothing. Rejected-suffix columns are written too: they sit at or past
    every reader's causal frontier until a later accepted token
    overwrites them, so they are never attended. The pool keeps its
    address (a captured step reads it)."""
    num_blocks, heads, bs, head_dim = pool_leaf.shape
    slots, bps = table.shape
    length = contiguous.shape[2]
    cols = idx[:, None] + torch.arange(count, device=idx.device)[None, :]  # (slots, count)
    lanes = torch.arange(slots, device=idx.device)[:, None]
    # (slots, count, heads, head_dim): the two index tensors broadcast
    # first, the sliced heads axis after them.
    written = contiguous[lanes, :, cols.clamp(max=length - 1)]
    blk = table[lanes, (cols // bs).clamp(0, bps - 1)]
    keep = active[:, None] & (cols < bps * bs) & (blk < num_blocks)
    return _scatter_kept(pool_leaf, blk.reshape(-1), (cols % bs).reshape(-1),
                         written.reshape(slots * count, heads, head_dim),
                         keep.reshape(-1))


def flash_backward_reference(q, k, v, o, lse, do, causal: bool = True,
                             block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                             scale: Optional[float] = None):
    """Plain PyTorch version of the flash backward (K2 and K3), returning
    ``(dq, dk, dv)`` in the input dtypes.

    Follows the numerics of ``attention_pallas.py::_flash_dq_kernel`` and
    ``_flash_dkv_kernel``: ``delta = rowsum(dO * O)`` in float32; p is
    recomputed as ``exp(scale * q.k - lse)`` from the forward's lse and
    is 0 where the key is masked; ``ds = p * (dO.v - delta)``; ``dq =
    scale * sum ds k``, ``dv = sum p^T dO`` and ``dk = scale * sum ds^T q``
    accumulate in float32 over tiles in increasing order. Causal tiles
    wholly above the diagonal are skipped, as the kernels skip them. The
    scale is ``1 / sqrt(head_dim)`` unless ``scale`` is given.
    """
    s, d = q.shape[2], q.shape[3]
    if scale is None:
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


def kernel_layout(head_dim: int, dtype) -> tuple:
    """``(head_dim, dtype)`` at which the kernels compute inputs of
    ``head_dim`` and ``dtype``.

    The head_dim is the smallest of ``attention_cuda.HEAD_DIMS`` that
    holds it, and above the largest (256) the next multiple of 256, which
    the instances above 256 take in chunks of 256 columns: zero columns
    added to q, k and v change no score, add zero columns to o and the
    gradients, and the scale stays ``1 / sqrt(head_dim)`` of the
    caller's. The dtype is the caller's where the kernels are built for
    it, else float32 for float16 and float64: the Pallas kernels compute
    every tile in float32 and cast the results to the inputs' dtype, and
    so does ``blockwise_reference``. Raises where no kernel computes the
    input (a head_dim below 1, a dtype that is not floating point)."""
    if dtype in attention_cuda.DTYPES:
        kernel_dtype = dtype
    elif dtype in (torch.float16, torch.float64):
        kernel_dtype = torch.float32
    else:
        raise TypeError(f"no flash-attention kernel computes {dtype} inputs")
    if head_dim < 1:
        raise ValueError(f"no flash-attention kernel takes head_dim {head_dim}")
    fits = [d for d in attention_cuda.HEAD_DIMS if d >= head_dim]
    wide = attention_cuda.WIDE
    return (fits[0] if fits else -(-head_dim // wide) * wide), kernel_dtype


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start, as the kernels read
    it; a contiguous view that starts off alignment is cloned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _to_kernel(t, head_dim, dtype):
    """``t`` in the kernels' ``kernel_layout``: cast, padded with zero
    columns up to ``head_dim``, contiguous and aligned."""
    t = t.to(dtype)
    if t.shape[-1] < head_dim:
        t = F.pad(t, (0, head_dim - t.shape[-1]))
    return _aligned(t)


def _from_kernel(t, head_dim, dtype):
    """A kernel's output back in the caller's head_dim and dtype."""
    if t.shape[-1] > head_dim:
        t = t[..., :head_dim].contiguous()
    return t.to(dtype)


class _FlashAttentionCUDA(torch.autograd.Function):
    """The CUDA kernels under autograd: K1 forward, K2 and K3 backward,
    as the JAX package's ``custom_vjp`` pairs the Pallas kernels, at the
    head_dim and dtype of ``kernel_layout``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        caller = (q.shape[-1], q.dtype)
        layout = kernel_layout(*caller)
        # A (b, s, h, d) tensor viewed as (b, h, s, d), or a slice of one,
        # reaches here strided or off alignment.
        q, k, v = (_to_kernel(t, *layout) for t in (q, k, v))
        scale = 1.0 / math.sqrt(caller[0])
        o, lse = attention_cuda.flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.layout, ctx.caller = causal, scale, layout, caller
        ctx.mark_non_differentiable(lse)
        return _from_kernel(o, *caller), lse

    @staticmethod
    def backward(ctx, grad_o, grad_lse):
        q, k, v, o, lse = ctx.saved_tensors
        # The model's head merge hands the gradient back as a strided view.
        do = _to_kernel(grad_o, *ctx.layout)
        delta = (do.float() * o.float()).sum(-1)
        grads = _launch_bwd(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return (*(_from_kernel(g, *ctx.caller) for g in grads), None)


def _launch_bwd(q, k, v, do, lse, delta, causal, scale):
    """K2 then K3 on inputs in the kernels' layout: ``(dq, dk, dv)``."""
    dq = attention_cuda.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = attention_cuda.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


# The JAX package's ``pallas_min_seq`` outside head_dim 32-128: there it
# takes its XLA blockwise path below this length and Pallas at or above.
# The port's rule has no length: this is the length of the wide-head
# checks on the card, where both packages run kernels.
WIDE_HEAD_MIN_SEQ = 4096


def takes_kernels(head_dim: int, seq: int, device_type: str) -> bool:
    """The dispatch rule: whether an input of ``head_dim`` and sequence
    length ``seq`` on a device of ``device_type`` runs the CUDA kernels.

    Every CUDA input takes them, at every head_dim (``kernel_layout``) and
    every length: the port has no sequence-length threshold, where the
    JAX package runs its XLA blockwise path below ``WIDE_HEAD_MIN_SEQ``
    outside head_dim 32-128 (a deliberate difference: the kernels are
    the port's counterpart of Pallas at every shape). Inputs on any other
    device never take them. The rule reads the device only: a failed
    build or launch raises instead of falling back."""
    del head_dim, seq  # every CUDA input takes the kernels
    return device_type == "cuda"


def use_kernels(q, k, v) -> bool:
    """Whether ``flash_attention`` runs the CUDA kernels on q, k and v:
    ``takes_kernels`` of q's head_dim, length and device. Layout does not
    count: the launch makes the inputs contiguous, aligned and of the
    kernels' ``kernel_layout``. CUDA inputs must share one device and
    dtype."""
    if q.device.type == "cuda" and (not k.device == v.device == q.device
                                    or not k.dtype == v.dtype == q.dtype):
        raise ValueError(
            "flash_attention needs CUDA q, k, v on one device and of one dtype, "
            f"got {[(str(t.device), t.dtype) for t in (q, k, v)]}"
        )
    return takes_kernels(q.shape[-1], q.shape[2], q.device.type)


def _check_qkv(name, q, k, v):
    """Raise unless q, k and v have one (batch, heads, seq, head_dim)
    shape: the kernels assume equal query and key lengths, as the JAX
    package's do."""
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(
            f"{name} needs q, k, v of one (batch, heads, seq, head_dim) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def flash_attention(q, k, v, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    return_lse: bool = False):
    """Blockwise attention; ``(o, lse)`` with ``return_lse=True``.

    Inputs that ``takes_kernels`` sends to the kernels (every CUDA input)
    run them at their own tiling (``attention_cuda.kernel_tiles``),
    whatever ``block_q`` and ``block_k`` say: the tiling sets the order of
    the sums, not what they sum. Inputs on another device run
    ``blockwise_reference`` under autograd at the given tiling (default
    ``BLOCK_Q`` x ``BLOCK_K``), as the JAX package runs its XLA path off
    the TPU. q, k and v must have one shape: the kernel assumes equal
    query and key lengths, as the JAX package's does.
    """
    _check_qkv("flash_attention", q, k, v)
    if use_kernels(q, k, v):
        o, lse = _FlashAttentionCUDA.apply(q, k, v, causal)
    else:
        o, lse = blockwise_reference(q, k, v, causal, block_q or BLOCK_Q, block_k or BLOCK_K)
    return (o, lse) if return_lse else o


# -- one hop of ring attention -----------------------------------------------
#
# The JAX package's ring runs the Pallas kernels per hop outside their own
# custom VJP: ``pallas_flash_attention(..., return_lse=True)`` forward and
# ``pallas_flash_attention_bwd(q, k, v, o, lse, do)`` with the GLOBAL o and
# lse of the combined softmax, so each hop's p is its slice of the global
# softmax and the hops' gradients sum to the exact ones. These are the
# port's counterparts: K1, and K2 with K3, on the inputs ``takes_kernels``
# sends to them, through ``kernel_layout`` (the scale stays 1/sqrt of the
# caller's head_dim when the kernels compute on zero-padded columns), the
# plain versions elsewhere. Neither records autograd.


def flash_attention_fwd(q, k, v, causal: bool = True):
    """``(o, lse)`` of softmax attention of q over k and v (causal within
    this block, or full): K1 where ``takes_kernels`` sends the input,
    ``blockwise_reference`` elsewhere. o is in q's dtype, lse (batch,
    heads, seq) float32."""
    _check_qkv("flash_attention_fwd", q, k, v)
    with torch.no_grad():
        if not use_kernels(q, k, v):
            return blockwise_reference(q, k, v, causal)
        caller = (q.shape[-1], q.dtype)
        layout = kernel_layout(*caller)
        o, lse = attention_cuda.flash_fwd(*(_to_kernel(t, *layout) for t in (q, k, v)),
                                          causal, 1.0 / math.sqrt(caller[0]))
        return _from_kernel(o, *caller), lse


def flash_attention_bwd(q, k, v, o, lse, do, delta, causal: bool = True):
    """``(dq, dk, dv)`` of one block from the output ``o`` and ``lse`` of
    the WHOLE softmax this block is a slice of, and its gradient ``do``:
    K2 and K3 where ``takes_kernels`` sends the input,
    ``flash_backward_reference`` elsewhere.
    ``delta`` is rowsum(do * o) in float32 from that same o, computed once
    by the caller for all its blocks (the plain version recomputes it from
    o)."""
    _check_qkv("flash_attention_bwd", q, k, v)
    with torch.no_grad():
        if not use_kernels(q, k, v):
            return flash_backward_reference(q, k, v, o, lse, do, causal)
        caller = (q.shape[-1], q.dtype)
        layout = kernel_layout(*caller)
        q, k, v, do = (_to_kernel(t, *layout) for t in (q, k, v, do))
        grads = _launch_bwd(q, k, v, do, lse.float().contiguous(), delta.contiguous(),
                            causal, 1.0 / math.sqrt(caller[0]))
        return tuple(_from_kernel(g, *caller) for g in grads)
