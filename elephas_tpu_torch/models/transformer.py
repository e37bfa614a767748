"""Decoder-only transformer LM (counterpart of ``elephas_tpu/models/transformer.py``).

The full-sequence forward picks its attention by name:

- ``attention='dense'`` — plain softmax attention;
- ``attention='flash'`` — ``ops.attention.flash_attention``: the
  hand-written CUDA kernel on the GPU, its plain version on the CPU;
- ``attention='ring'`` — ``parallel.ring_attention``: K/V shards rotate
  around the bound mesh's ``'seq'`` axis;
- ``attention='ulysses'`` — ``parallel.ulysses``: all_to_all re-sharding
  from sequence to heads, then full-length flash attention;
- ``attention='auto'`` — resolved at call time: inside a bound mesh
  (``parallel.mesh.bind_mesh``, as ``seq_parallel`` binds it) ``'ulysses'``
  where the heads divide the seq-axis size, else ``'ring'``; ``'flash'``
  outside one.

``'ring'`` and ``'ulysses'`` run only inside a bound mesh, where the
tokens are this rank's sequence shard and the positional table is read
at global positions; outside one they raise. The parameters do not
depend on the attention, so one state dict serves every choice.

Numerics follow the flax model: LayerNorms compute in float32 with
epsilon 1e-6, GELU is the tanh approximation, a ``bfloat16`` model runs
its Dense layers in bf16 on float32 parameters and keeps the final
LayerNorm and ``lm_head`` in float32, and masked scores take
``finfo(float32).min`` (the scale is a float64 NumPy scalar in the JAX
code, which promotes bf16 scores to float32).

Sampling (``generate``) runs the KV-cache decode path: one batched
prefill forward over the (left-padded) prompt, then one single-token
forward per new token, with the cache held as explicit tensors
(``DecodeCache``) and updated in place. The serving engine drives the
same path with per-row cache columns, an ``active`` lane mask, a paged
block pool (``make_paged_decode_cache``) and position-keyed sampling
(``sample_tokens_at``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from elephas_tpu_torch.models import register_model
from elephas_tpu_torch.ops.attention import cache_attention_mask, flash_attention
from elephas_tpu_torch.parallel.collectives import gather_from_model
from elephas_tpu_torch.parallel.ring_attention import (
    ring_attention,
    require_seq_axis,
    seq_axis_size_or_none,
)
from elephas_tpu_torch.parallel.ulysses import ulysses_attention
from elephas_tpu_torch.utils.device import resolve_device

_LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch defaults to 1e-5)
_ATTENTIONS = ("dense", "flash", "ring", "ulysses", "auto")


def _dense(layer: nn.Linear, x, dtype):
    """A flax Dense with ``dtype``: inputs and float32 params cast to the
    compute dtype. A tensor-parallel layer (``parallel.tensor_parallel``)
    places its own collectives around the product."""
    parallel = getattr(layer, "parallel_dense", None)
    if parallel is not None:
        return parallel(x, dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _masked_softmax_attend(q, k, v, valid):
    """Scores in float32 (the JAX code's float64 scale promotes them),
    masked to ``finfo(float32).min``, softmax, then the weighted sum in
    float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q @ k.transpose(-1, -2)).float() * scale
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    weights = torch.softmax(scores, dim=-1)
    return weights @ v.float()


def dense_causal_attention(q, k, v):
    """Reference softmax attention. q/k/v: (batch, heads, seq, head_dim)."""
    seq = q.shape[2]
    mask = torch.ones((seq, seq), dtype=torch.bool, device=q.device).tril()
    return _masked_softmax_attend(q, k, v, mask)


@dataclass
class DecodeCache:
    """KV cache of the decode path: per layer (batch, heads, max_len,
    head_dim) keys and values in the model dtype, written in place.

    ``index`` is the cache column where the next block lands and, as in
    the JAX model (whose per-layer ``cache_index`` and module-level
    ``pos_index`` always advance together), the position counter: an int
    when every row writes the same column (``generate``), or a (batch,)
    tensor of per-row columns (the serving pool, where each slot decodes
    at its own depth)."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    index: Union[int, torch.Tensor] = 0


class SelfAttention(nn.Module):
    """Causal self-attention. Under tensor parallelism (``qkv``
    column-parallel over the heads) it runs on its ``local_heads`` heads,
    and ``out`` sums the heads' products over the model group."""

    def __init__(self, d_model, num_heads, dtype, attention, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.local_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dtype = dtype
        self.attention = attention
        self.qkv = nn.Linear(d_model, 3 * d_model, device=device)
        self.out = nn.Linear(d_model, d_model, device=device)

    def forward(self, x, kv=None, index=0, pad_offset=None):
        b, s, _ = x.shape
        h = self.local_heads
        # (3, batch, heads, seq, head_dim): the flax kernel's (d, 3, H, hd)
        # output order, so each of q, k, v comes out contiguous.
        qkv = _dense(self.qkv, x, self.dtype).view(b, s, 3, h, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        attention = self.attention
        if attention == "auto":
            # Resolved at call time from the bound mesh and the local heads,
            # as the JAX model resolves it at trace time from the bound
            # 'seq' axis.
            n = seq_axis_size_or_none()
            attention = "flash" if n is None else ("ulysses" if h % n == 0 else "ring")
        if kv is not None:
            out = self._decode_attend(q, k, v, kv, index, pad_offset)
        elif attention == "flash":
            out = flash_attention(q, k, v, causal=True)
        elif attention == "ring":
            out = ring_attention(q, k, v, causal=True)
        elif attention == "ulysses":
            out = ulysses_attention(q, k, v, causal=True)
        else:
            out = dense_causal_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, s, h * self.head_dim)
        if h != self.num_heads and not getattr(self.out, "sharded_input", False):
            out = gather_from_model(out, self.qkv.tp_mesh, -1)
        return _dense(self.out, out, self.dtype)

    def _decode_attend(self, q, k, v, kv, index, pad_offset):
        """KV-cache attention: write this block's k/v at ``index`` (in
        place), then each query attends every cached column up to its
        own, minus its row's left-pad columns. Queries at pad columns
        have no valid key; their output is zeroed so the pad columns'
        residual stream stays finite.

        A per-row write starts at ``index`` clamped to ``[0, max_len -
        seq]``, as the JAX model's ``dynamic_update_slice`` clamps it: a
        free serving slot whose frozen column sits at ``max_len`` writes
        its garbage into the last column instead of out of range."""
        cached_k, cached_v = kv
        b, _, s, _ = q.shape
        offsets = torch.arange(s, device=q.device)
        if isinstance(index, int):
            cached_k[:, :, index:index + s] = k.to(cached_k.dtype)
            cached_v[:, :, index:index + s] = v.to(cached_v.dtype)
            qcols = index + offsets
        else:
            qcols = index[:, None] + offsets[None, :]
            wcols = index.clamp(0, cached_k.shape[2] - s)[:, None] + offsets[None, :]
            rows = torch.arange(b, device=q.device)[:, None]
            cached_k.transpose(1, 2)[rows, wcols] = k.transpose(1, 2).to(cached_k.dtype)
            cached_v.transpose(1, 2)[rows, wcols] = v.transpose(1, 2).to(cached_v.dtype)
        valid = cache_attention_mask(cached_k.shape[2], s, index, pad_offset,
                                     device=q.device)
        out = _masked_softmax_attend(q, cached_k, cached_v, valid)
        if pad_offset is not None:
            qpad = qcols < pad_offset[:, None]  # (batch, seq)
            out = out.masked_fill(qpad[:, None, :, None], 0.0)
        return out


class Block(nn.Module):
    def __init__(self, d_model, num_heads, dtype, attention, mlp_ratio=4,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.ln1 = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.attn = SelfAttention(d_model, num_heads, dtype, attention, device=device)
        self.ln2 = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.fc1 = nn.Linear(d_model, d_model * mlp_ratio, device=device)
        self.fc2 = nn.Linear(d_model * mlp_ratio, d_model, device=device)

    def forward(self, x, kv=None, index=0, pad_offset=None):
        x = x + self.attn(self.ln1(x.float()), kv=kv, index=index,
                          pad_offset=pad_offset)
        h = F.gelu(_dense(self.fc1, self.ln2(x.float()), self.dtype),
                   approximate="tanh")
        return x + _dense(self.fc2, h, self.dtype)


class TransformerLM(nn.Module):
    def __init__(self, vocab_size=32000, d_model=256, num_heads=8, num_layers=4,
                 max_seq_len=2048, dtype=torch.float32, attention="dense",
                 device=None):
        super().__init__()
        if attention not in _ATTENTIONS:
            raise ValueError(
                f"unknown attention={attention!r}; expected one of "
                "'dense', 'flash', 'ring', 'ulysses', 'auto'"
            )
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.attention = attention
        self.local_heads = num_heads  # the heads this process holds (tensor parallelism)
        self.tok_embed = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_embed = nn.Parameter(torch.zeros(max_seq_len, d_model, device=device))
        self.blocks = nn.ModuleList(
            Block(d_model, num_heads, dtype, self.attention, device=device)
            for _ in range(num_layers)
        )
        self.ln_f = nn.LayerNorm(d_model, eps=_LN_EPS, device=device)
        self.lm_head = nn.Linear(d_model, vocab_size, device=device)

    @property
    def device(self) -> torch.device:
        return self.pos_embed.device

    def forward(self, tokens, train: bool = False,
                cache: Optional[DecodeCache] = None, pad_offset=None,
                active=None, local_logits: bool = False):
        """Next-token logits (batch, seq, vocab) in float32.

        ``train`` is the flax model's flag; the LM has no dropout or
        batch statistics, so it changes nothing. Gradients reach the
        float32 parameters through ``_dense``'s casts, so a bf16 model
        keeps float32 parameters and gradients, as the flax model does.

        Without ``cache``: the full causal forward. With ``cache``: the
        incremental decode path — the block's k/v are written into the
        cache at ``cache.index`` and ``cache.index`` advances by the
        block length. ``pad_offset`` (batch,) masks each row's leading
        left-pad columns and counts positions from the row's first real
        token; it is taken only on the decode path. ``active`` (batch,)
        bool — serving only — advances only the active rows' columns: free
        pool slots ride along in the fixed-shape decode batch, and their
        columns freeze instead of marching past ``max_len``. It needs
        per-row (tensor) cache columns.

        Under tensor parallelism with a vocab-sharded ``lm_head`` the
        logits are gathered over the model group, unless ``local_logits``
        asks for this rank's vocabulary columns (the vocab-parallel loss
        takes those)."""
        seq = tokens.shape[1]
        x = self.tok_embed(tokens.long())
        if cache is None:
            if pad_offset is not None or active is not None:
                raise ValueError(
                    "pad_offset / active (ragged left-padded serving batches) "
                    "are only supported on the decode path"
                )
            x = (x + self._positions(seq)).to(self.dtype)
            for block in self.blocks:
                x = block(x)
        else:
            index = cache.index
            if active is not None and not torch.is_tensor(index):
                raise ValueError(
                    "active masks require per-row (batch,) cache indices (the "
                    "serving pool layout); generate()'s shared index never "
                    "passes active"
                )
            x = (x + self._decode_positions(index, seq, pad_offset)).to(self.dtype)
            for block, ck, cv in zip(self.blocks, cache.keys, cache.values):
                x = block(x, kv=(ck, cv), index=index, pad_offset=pad_offset)
            cache.index = (index + seq if active is None
                           else torch.where(active, index + seq, index))
        x = self.ln_f(x.float())
        if hasattr(self.lm_head, "gather_output"):  # column-parallel
            return self.lm_head.parallel_dense(x, gather=not local_logits)
        return self.lm_head(x)

    def _positions(self, seq):
        """Positional embeddings of the full forward. Under sequence
        parallelism the tokens are this rank's shard, so the table is read
        from global position ``seq_rank * seq`` (clamped to the table, as
        the JAX model's ``dynamic_slice`` clamps it)."""
        seq_parallel = self.attention in ("ring", "ulysses") or (
            self.attention == "auto" and seq_axis_size_or_none() is not None)
        if not seq_parallel:
            return self.pos_embed[:seq]
        start = require_seq_axis(feature=f"attention='{self.attention}'") * seq
        start = min(start, self.max_seq_len - seq)
        return self.pos_embed[start:start + seq]

    def _decode_positions(self, index, seq, pad_offset):
        """Positional embeddings of the block at cache column ``index``.
        With ``pad_offset`` a row's position is its column minus its
        left-pad count; pad columns clip to position 0 (their embeddings
        are masked out of every real query's attention)."""
        if isinstance(index, int) and pad_offset is None:
            start = min(index, self.max_seq_len - seq)  # dynamic_slice clamps
            return self.pos_embed[start:start + seq]
        offsets = torch.arange(seq, device=self.device)
        cols = (index[:, None] if torch.is_tensor(index) else index) + offsets
        if pad_offset is not None:
            cols = cols - pad_offset[:, None]
        return self.pos_embed[cols.clamp(0, self.max_seq_len - 1)]


def make_decode_cache(module: TransformerLM, batch: int, total_len: int) -> DecodeCache:
    """Zeroed KV caches of ``total_len`` columns on the module's device
    (of the heads this process holds)."""
    shape = (batch, module.local_heads, total_len, module.d_model // module.num_heads)

    def zeros():
        return torch.zeros(shape, dtype=module.dtype, device=module.device)

    return DecodeCache(
        keys=[zeros() for _ in range(module.num_layers)],
        values=[zeros() for _ in range(module.num_layers)],
    )


def make_paged_decode_cache(module: TransformerLM, max_slots: int,
                            num_blocks: int, block_size: int) -> DecodeCache:
    """Zeroed PAGED decode cache: per layer, K and V as physical blocks
    ``(num_blocks, heads, block_size, head_dim)`` instead of one
    contiguous row per slot, and ``index`` a (max_slots,) int vector of
    per-slot columns. A host-side block table maps ``slot -> block ids``;
    slots share blocks by holding the same id."""
    shape = (num_blocks, module.local_heads, block_size,
             module.d_model // module.num_heads)

    def zeros():
        return torch.zeros(shape, dtype=module.dtype, device=module.device)

    return DecodeCache(
        keys=[zeros() for _ in range(module.num_layers)],
        values=[zeros() for _ in range(module.num_layers)],
        index=torch.zeros((max_slots,), dtype=torch.int64, device=module.device),
    )


def sample_tokens(logits, generator, greedy, top_k, temperature):
    """Greedy argmax, or a top-k-truncated categorical draw at
    ``temperature`` (Gumbel-max with exponential noise from
    ``generator``). logits: (batch, vocab) -> (batch,) int64."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, torch.finfo(logits.dtype).min)
    noise = torch.empty_like(logits, dtype=torch.float32).exponential_(
        generator=generator
    )
    return torch.argmax(logits / temperature - torch.log(noise), dim=-1)


_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c`` modulo 2**32 for int64 ``x`` in [0, 2**32), in 16-bit
    halves so no int64 product overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """A 32-bit integer hash (lowbias32: xorshift-multiply rounds) on
    int64 lanes holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sample_tokens_at(logits, seed: int, positions, greedy: bool, top_k: int,
                     temperature: float):
    """Position-keyed sampling: greedy argmax, or a top-k-truncated
    categorical draw whose random numbers depend only on ``(seed,
    positions[row], vocab id)``.

    The reference folds the position into a threefry key
    (``jax.random.fold_in``), which torch cannot reproduce; the port keeps
    the same invariant with its own counter-based draw. Each (row, vocab
    id) lane hashes ``(seed, position, id)`` with integer tensor ops into
    a uniform number, and the token is the Gumbel-max ``argmax(logits /
    temperature + gumbel)`` over the top-k. So the n-th token of a stream
    draws the same numbers whichever program samples it (chunked or
    one-shot prefill, paged or contiguous decode, pipelined or not), no
    ``torch.Generator`` state is consumed, the draw is the same on the
    CPU and the GPU up to float rounding, and it can be captured in a
    CUDA graph.

    ``logits``: (N, vocab); ``positions``: (N,) int tensor (the pad-free
    position of the token being sampled). Returns (N,) int64."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(sampling_scores(logits, seed, positions, top_k, temperature),
                        dim=-1)


def sampling_scores(logits, seed: int, positions, top_k: int, temperature: float):
    """The scores ``sample_tokens_at`` takes the argmax of when sampling:
    the top-k logits over ``temperature`` plus each lane's Gumbel noise
    (the rest at ``-inf``), in float32."""
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= kth, logits, torch.finfo(logits.dtype).min)
    vocab = torch.arange(logits.shape[-1], device=logits.device, dtype=torch.int64)
    key = _mix32(torch.full_like(positions, seed & _MASK32, dtype=torch.int64))
    key = _mix32(key ^ (positions.to(torch.int64) & _MASK32))
    bits = _mix32((key[:, None] + _mul32(vocab, 0x9E3779B9)[None, :]) & _MASK32)
    gumbel = -torch.log(-torch.log(_open_uniform(bits)))
    return logits.float() / temperature + gumbel


def _open_uniform(bits):
    """32-bit lanes to float32 uniforms strictly inside (0, 1), from their
    top 23 bits: k + 0.5 is exact in float32 for every k < 2**23, so the
    result lies in [2**-24, 1 - 2**-24]. (From 24 bits, 2**24 - 0.5 rounds
    to 2**24: a uniform of 1 gives an infinite Gumbel, and on a masked
    lane -inf + inf is a NaN, which argmax takes.)"""
    return ((bits >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))


def left_pad_prompts(prompts, pad_token: int = 0):
    """Left-pad a ragged batch of prompts to a (batch, max_len) array.

    Returns ``(padded, lengths)`` as int32 NumPy arrays; real tokens of
    row ``i`` occupy the LAST ``lengths[i]`` columns, so every row's
    final prompt token lands in the same column."""
    rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if any(len(r) < 1 for r in rows):
        raise ValueError("every prompt must have at least 1 token")
    lengths = np.array([len(r) for r in rows], np.int32)
    plen = int(lengths.max())
    padded = np.full((len(rows), plen), int(pad_token), np.int32)
    for i, r in enumerate(rows):
        padded[i, plen - len(r):] = r
    return padded, lengths


def _generate_loop(module, prompt, cache, generator, max_new, greedy, top_k,
                   temperature, pad_offset, stop_token):
    def sample(logits):
        return sample_tokens(logits, generator, greedy, top_k, temperature)

    # Prefill: one batched forward over the whole prompt fills every cache.
    tok = sample(module(prompt, cache=cache, pad_offset=pad_offset)[:, -1, :])
    done = tok == stop_token if stop_token is not None else None
    out = [tok]
    for _ in range(max_new - 1):
        nxt = sample(module(tok[:, None], cache=cache, pad_offset=pad_offset)[:, 0, :])
        if done is not None:
            # A finished row keeps emitting stop_token: its output freezes
            # while the rest of the batch decodes on.
            nxt = torch.where(done, stop_token, nxt)
            done = done | (nxt == stop_token)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def generate(
    compiled,
    prompt,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    seed: int = 0,
    params=None,
    prompt_lengths=None,
    stop_token: Optional[int] = None,
    pad_token: int = 0,
):
    """Autoregressive sampling from a ``TransformerLM`` on its device.

    ``prompt``: (batch, prompt_len) int tokens, or a ragged list of 1-D
    token sequences, left-padded here with ``pad_token`` (or a pre-padded
    2-D array plus ``prompt_lengths``). Ragged rows are masked through
    prefill and cache and their positions count from their first real
    token, so each row decodes as it would alone. ``stop_token``: a row
    that emits it keeps emitting it while the rest decode on. Greedy at
    ``temperature=0`` (default), else categorical from a
    ``torch.Generator`` seeded with ``seed``, truncated to the ``top_k``
    most likely tokens when ``top_k > 0``. ``params``: a ``state_dict``
    to sample with in place of the module's own parameters (the module is
    left untouched). Returns the (batch, prompt_len + max_new_tokens)
    int32 tokens, prompt included.
    """
    module = compiled.module
    if not isinstance(module, TransformerLM):
        raise TypeError(
            f"generate() samples TransformerLM models, got {type(module).__name__}"
        )
    if isinstance(prompt, (list, tuple)):
        if prompt_lengths is not None:
            raise ValueError(
                "pass prompt_lengths only with a pre-padded 2-D prompt array"
            )
        prompt, prompt_lengths = left_pad_prompts(prompt, pad_token)
    prompt = np.asarray(prompt, np.int64)
    if prompt.ndim != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be (batch, prompt_len>=1), got {prompt.shape}")
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if not 0 <= top_k <= module.vocab_size:
        raise ValueError(
            f"top_k must be in [0, vocab_size={module.vocab_size}], got {top_k}"
        )
    b, plen = prompt.shape
    device = module.device
    pad_offset = None
    if prompt_lengths is not None:
        lengths = np.asarray(prompt_lengths, np.int64).reshape(-1)
        if lengths.shape != (b,):
            raise ValueError(
                f"prompt_lengths must have shape ({b},), got {lengths.shape}"
            )
        if (lengths < 1).any() or (lengths > plen).any():
            raise ValueError(f"prompt_lengths must be in [1, {plen}], got {lengths}")
        # All-full-length batches keep the unmasked path, as in JAX.
        if (lengths < plen).any():
            pad_offset = torch.as_tensor(plen - lengths, device=device)
    if stop_token is not None and not 0 <= stop_token < module.vocab_size:
        raise ValueError(
            f"stop_token must be in [0, vocab_size={module.vocab_size}), "
            f"got {stop_token}"
        )
    total = plen + max_new_tokens
    if total > module.max_seq_len:
        raise ValueError(
            f"prompt_len {plen} + max_new_tokens {max_new_tokens} exceeds "
            f"max_seq_len {module.max_seq_len}"
        )
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def run(*args, **kwargs):
        if params is None:
            return module(*args, **kwargs)
        return torch.func.functional_call(module, dict(params), args, kwargs)

    with torch.no_grad():
        out = _generate_loop(
            run, torch.as_tensor(prompt, device=device),
            make_decode_cache(module, b, total), generator, max_new_tokens,
            float(temperature) <= 0.0, int(top_k), float(temperature),
            pad_offset, stop_token,
        )
    return out.cpu().numpy().astype(np.int32)


@register_model("transformer_lm")
def build_transformer_lm(
    vocab_size=32000,
    d_model=256,
    num_heads=8,
    num_layers=4,
    max_seq_len=2048,
    dtype="float32",
    attention="dense",
    device=None,
):
    return TransformerLM(
        vocab_size=vocab_size,
        d_model=d_model,
        num_heads=num_heads,
        num_layers=num_layers,
        max_seq_len=max_seq_len,
        dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype,
        attention=attention,
        device=resolve_device(device),
    )
