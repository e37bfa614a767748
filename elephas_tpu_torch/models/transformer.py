"""Decoder-only transformer LM (counterpart of ``elephas_tpu/models/transformer.py``).

The full-sequence forward picks its attention by name:

- ``attention='dense'`` — plain softmax attention;
- ``attention='flash'`` — ``ops.attention.flash_attention``: the
  hand-written CUDA kernel on the GPU, its plain version on the CPU;
- ``attention='auto'`` — ``'flash'``: there is no sequence-parallel group
  in the port yet, which is what would make ``'auto'`` pick otherwise;
- ``'ring'`` and ``'ulysses'`` are not ported yet and raise.

Numerics follow the flax model: LayerNorms compute in float32 with
epsilon 1e-6, GELU is the tanh approximation, a ``bfloat16`` model runs
its Dense layers in bf16 on float32 parameters and keeps the final
LayerNorm and ``lm_head`` in float32, and masked scores take
``finfo(float32).min`` (the scale is a float64 NumPy scalar in the JAX
code, which promotes bf16 scores to float32).

Sampling (``generate``) runs the KV-cache decode path: one batched
prefill forward over the (left-padded) prompt, then one single-token
forward per new token, with the cache held as explicit tensors
(``DecodeCache``) and updated in place.
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
from elephas_tpu_torch.utils.device import resolve_device

_LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch defaults to 1e-5)
_ATTENTIONS = ("dense", "flash", "ring", "ulysses", "auto")


def _dense(layer: nn.Linear, x, dtype):
    """A flax Dense with ``dtype``: inputs and float32 params cast to the
    compute dtype."""
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
    tensor of per-row columns."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    index: Union[int, torch.Tensor] = 0


class SelfAttention(nn.Module):
    def __init__(self, d_model, num_heads, dtype, attention, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.attention = attention
        self.qkv = nn.Linear(d_model, 3 * d_model, device=device)
        self.out = nn.Linear(d_model, d_model, device=device)

    def forward(self, x, kv=None, index=0, pad_offset=None):
        b, s, d = x.shape
        h = self.num_heads
        # (3, batch, heads, seq, head_dim): the flax kernel's (d, 3, H, hd)
        # output order, so each of q, k, v comes out contiguous.
        qkv = _dense(self.qkv, x, self.dtype).view(b, s, 3, h, d // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        if kv is not None:
            out = self._decode_attend(q, k, v, kv, index, pad_offset)
        elif self.attention == "flash":
            out = flash_attention(q, k, v, causal=True)
        else:
            out = dense_causal_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, s, d)
        return _dense(self.out, out, self.dtype)

    def _decode_attend(self, q, k, v, kv, index, pad_offset):
        """KV-cache attention: write this block's k/v at ``index`` (in
        place), then each query attends every cached column up to its
        own, minus its row's left-pad columns. Queries at pad columns
        have no valid key; their output is zeroed so the pad columns'
        residual stream stays finite."""
        cached_k, cached_v = kv
        b, _, s, _ = q.shape
        if isinstance(index, int):
            cached_k[:, :, index:index + s] = k.to(cached_k.dtype)
            cached_v[:, :, index:index + s] = v.to(cached_v.dtype)
            qcols = index + torch.arange(s, device=q.device)
        else:
            qcols = index[:, None] + torch.arange(s, device=q.device)[None, :]
            rows = torch.arange(b, device=q.device)[:, None]
            cached_k.transpose(1, 2)[rows, qcols] = k.transpose(1, 2).to(cached_k.dtype)
            cached_v.transpose(1, 2)[rows, qcols] = v.transpose(1, 2).to(cached_v.dtype)
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
        if attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={attention!r} (sequence parallelism) is not ported "
                "yet; it arrives with the LM-parallelism slice (ROADMAP.md, "
                "queue 1)"
            )
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        # 'auto' is flash outside a sequence-parallel group, the only case here.
        self.attention = "flash" if attention == "auto" else attention
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
                cache: Optional[DecodeCache] = None, pad_offset=None):
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
        token; it is taken only on the decode path."""
        seq = tokens.shape[1]
        x = self.tok_embed(tokens.long())
        if cache is None:
            if pad_offset is not None:
                raise ValueError(
                    "pad_offset (ragged left-padded batches) is only supported "
                    "on the decode path"
                )
            x = (x + self.pos_embed[:seq]).to(self.dtype)
            for block in self.blocks:
                x = block(x)
        else:
            index = cache.index
            x = (x + self._decode_positions(index, seq, pad_offset)).to(self.dtype)
            for block, ck, cv in zip(self.blocks, cache.keys, cache.values):
                x = block(x, kv=(ck, cv), index=index, pad_offset=pad_offset)
            cache.index = index + seq
        x = self.ln_f(x.float())
        return self.lm_head(x)

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
    """Zeroed KV caches of ``total_len`` columns on the module's device."""
    shape = (batch, module.num_heads, total_len, module.d_model // module.num_heads)

    def zeros():
        return torch.zeros(shape, dtype=module.dtype, device=module.device)

    return DecodeCache(
        keys=[zeros() for _ in range(module.num_layers)],
        values=[zeros() for _ in range(module.num_layers)],
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
    most likely tokens when ``top_k > 0``. Returns the (batch,
    prompt_len + max_new_tokens) int32 tokens, prompt included.
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
    with torch.no_grad():
        out = _generate_loop(
            module, torch.as_tensor(prompt, device=device),
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
