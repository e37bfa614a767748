"""Parity of the port's attention ops (``elephas_tpu_torch.ops``) with the
JAX package's, on the CPU.

The JAX side runs as its own tests run it here (``flash_attention``
reaches ``_blockwise_reference`` and its XLA VJP; the Pallas kernels need a
TPU); the port runs its plain versions, which is what a CPU tensor
selects. The CUDA kernels themselves are checked against the same plain
versions on the card by ``chip_smoke.py``.
"""

import math
import re
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.ops.attention import cache_attention_mask as jax_cache_mask
from elephas_tpu.ops.attention import flash_attention as jax_flash
from elephas_tpu.ops.attention import pallas_min_seq as jax_pallas_min_seq
from elephas_tpu_torch.ops import attention as ops
from elephas_tpu_torch.ops import attention_cuda


def _qkv(head_dim, seq, batch=2, heads=2):
    rng = np.random.default_rng(1000 * head_dim + seq)
    return [rng.standard_normal((batch, heads, seq, head_dim)).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def jax_out():
    """JAX flash_attention outputs, computed once per (causal, dim, seq)."""
    memo = {}

    def get(causal, head_dim, seq):
        key = (causal, head_dim, seq)
        if key not in memo:
            memo[key] = np.asarray(jax_flash(*_qkv(head_dim, seq), causal=causal))
        return memo[key]

    return get


@pytest.fixture(scope="module")
def jax_vjp():
    """JAX flash_attention gradients (q, k, v) for a seeded cotangent,
    computed once per (causal, dim, seq)."""
    import jax

    memo = {}

    def get(causal, head_dim, seq):
        key = (causal, head_dim, seq)
        if key not in memo:
            q, k, v = _qkv(head_dim, seq)
            out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal), q, k, v)
            memo[key] = [np.asarray(g) for g in vjp(_cotangent(q.shape))]
        return memo[key]

    return get


def _cotangent(shape):
    return np.random.default_rng(7).standard_normal(shape).astype(np.float32)


# (192, 128) and (192, 64): the bf16 K1's at head_dim 32/64 and 128;
# (192, 64), (128, 64) and (64, 32): the float32 K1's at head_dim 32, 64
# and 128.
@pytest.mark.parametrize("blocks", [(16, 32), (64, 64), (192, 128), (192, 64), (128, 64),
                                    (64, 32)])
@pytest.mark.parametrize("seq", [37, 100])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(jax_out, causal, head_dim, seq, blocks):
    q, k, v = (torch.from_numpy(a) for a in _qkv(head_dim, seq))
    out = ops.flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                              block_k=blocks[1])
    # Both sides compute in float32 and differ only in summation order.
    np.testing.assert_allclose(out.numpy(), jax_out(causal, head_dim, seq),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seq", [37, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_numpy_logsumexp(causal, seq):
    q, k, v = _qkv(32, seq)
    _, lse = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal, return_lse=True)
    scores = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                       k.astype(np.float64)) / np.sqrt(32)
    if causal:
        scores = np.where(np.tril(np.ones((seq, seq), bool)), scores, -np.inf)
    peak = scores.max(axis=-1, keepdims=True)
    want = (peak + np.log(np.exp(scores - peak).sum(axis=-1, keepdims=True)))[..., 0]
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_cache_attention_mask_equals_jax(per_row, pad):
    max_len, seq = 12, 3
    idx = np.array([4, 0, 7], np.int32) if per_row else 5
    pad_offset = np.array([2, 0, 3], np.int32) if pad else None
    want = np.asarray(jax_cache_mask(
        max_len, seq, jnp.asarray(idx),
        None if pad_offset is None else jnp.asarray(pad_offset)))
    got = ops.cache_attention_mask(
        max_len, seq, torch.as_tensor(idx) if per_row else idx,
        None if pad_offset is None else torch.as_tensor(pad_offset))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_unequal_lengths_raise():
    q = torch.zeros(1, 2, 8, 32)
    k = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError, match="one"):
        ops.flash_attention(q, k, k)


def test_cpu_flash_attention_gradients_match_jax():
    """The plain version is differentiable: its gradients equal the JAX
    package's custom VJP on the CPU."""
    import jax

    q, k, v = _qkv(32, 37)
    cot = _cotangent(q.shape)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jax_flash(a, b, c, causal=True) * cot),
        argnums=(0, 1, 2),
    )(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (ops.flash_attention(tq, tk, tv, causal=True) * torch.from_numpy(cot)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# (64, 64): the float32 K2's and K3's; (64, 192) and (64, 128): the bf16
# K3's at head_dim 32 and 64/128; (128, 128), (192, 64) and (128, 64): the
# bf16 K2's at head_dim 32, 64 and 128.
@pytest.mark.parametrize("blocks", [(16, 32), (64, 64), (64, 192), (64, 128), (128, 128),
                                    (192, 64), (128, 64)])
@pytest.mark.parametrize("seq", [37, 100])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_reference_matches_jax(jax_vjp, causal, head_dim, seq, blocks):
    """K2/K3's plain version, fed the forward's o and lse, equals the JAX
    package's VJP and torch autograd through the plain forward."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(head_dim, seq))
    do = torch.from_numpy(_cotangent(q.shape))
    o, lse = ops.blockwise_reference(q, k, v, causal, *blocks)
    got = ops.flash_backward_reference(q, k, v, o, lse, do, causal, *blocks)
    # Both sides compute in float32 and differ only in summation order.
    for g, want in zip(got, jax_vjp(causal, head_dim, seq)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5, rtol=1e-5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    autograd = torch.autograd.grad(
        ops.blockwise_reference(*leaves, causal, *blocks)[0], leaves, do)
    for g, want in zip(got, autograd):
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


def test_cuda_function_backward_wiring(monkeypatch):
    """The kernels' autograd Function: forward saves K1's o and lse; the
    backward passes dO contiguous and delta = rowsum(dO * O) in float32 to
    K2 and K3, once each, and returns their gradients in q, k, v's slots.
    The launches are replaced by stand-ins, since there is no card here."""
    calls = []
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(32, 8, batch=1))
    lse = torch.from_numpy(rng.standard_normal((1, 2, 8)).astype(np.float32))
    grads = [torch.full_like(q, float(i)) for i in (1, 2, 3)]

    def fake_fwd(q_, k_, v_, causal, scale):
        calls.append(("fwd", causal, scale))
        return q_ * 2.0, lse

    def fake_dq(q_, k_, v_, do, lse_, delta, causal, scale):
        calls.append(("dq", causal, do, lse_, delta, scale))
        return grads[0]

    def fake_dkv(q_, k_, v_, do, lse_, delta, causal, scale):
        calls.append(("dkv", causal, do, lse_, delta, scale))
        return grads[1], grads[2]

    monkeypatch.setattr(attention_cuda, "flash_fwd", fake_fwd)
    monkeypatch.setattr(attention_cuda, "flash_bwd_dq", fake_dq)
    monkeypatch.setattr(attention_cuda, "flash_bwd_dkv", fake_dkv)
    before = dict(attention_cuda.launches)
    o, out_lse = ops._FlashAttentionCUDA.apply(q, k, v, True)
    assert out_lse is lse and not out_lse.requires_grad
    # The model's head merge: the gradient reaches o as a strided view.
    merged = o.transpose(1, 2).reshape(1, 8, 64)
    cot = torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(np.float32))
    (merged * cot).sum().backward()
    want_do = cot.reshape(1, 8, 2, 32).transpose(1, 2)
    assert [c[0] for c in calls] == ["fwd", "dq", "dkv"]
    assert calls[0][1:] == (True, 1 / math.sqrt(32))
    for name, causal, do, lse_, delta, scale in calls[1:]:
        assert causal is True and do.is_contiguous() and lse_ is lse
        assert scale == 1 / math.sqrt(32)
        torch.testing.assert_close(do, want_do, rtol=0, atol=0)
        assert delta.dtype == torch.float32
        torch.testing.assert_close(delta, (want_do * (q.detach() * 2.0)).sum(-1))
    for leaf, want in zip((q, k, v), grads):
        assert torch.equal(leaf.grad, want)
    assert attention_cuda.launches == before


@pytest.mark.parametrize("name", ["flash_fwd", "flash_dq", "flash_dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_kernel_tiles(name, dtype, head_dim):
    """Each kernel's tiling: bf16 K1 takes 192 query rows (64 per consumer
    warpgroup) against 128 keys, 64 at head_dim 128; bf16 K2 128 query
    rows against 128 keys at head_dim 32, 192 against 64 at 64 and 128
    against 64 at 128; bf16 K3 64 query rows against 192 keys (64 per
    consumer warpgroup; 128 at head_dim 64 and 128); float32 K1 192, 128
    and 64 query rows against 64, 64 and 32 keys at head_dim 32, 64 and
    128; float32 K2 128, 128 and 64 query rows against 64, 32 and 16 keys;
    float32 K3 64, 32 and 16 query rows against 128, 64 and 64 keys."""
    if dtype == torch.bfloat16 and name == "flash_fwd":
        want = (192, 64 if head_dim == 128 else 128)
    elif dtype == torch.bfloat16 and name == "flash_dq":
        want = {32: (128, 128), 64: (192, 64), 128: (128, 64)}[head_dim]
    elif dtype == torch.bfloat16 and name == "flash_dkv":
        want = (64, 192 if head_dim == 32 else 128)
    elif dtype == torch.float32 and name == "flash_fwd":
        want = {32: (192, 64), 64: (128, 64), 128: (64, 32)}[head_dim]
    elif dtype == torch.float32 and name == "flash_dq":
        want = {32: (128, 64), 64: (128, 32), 128: (64, 16)}[head_dim]
    else:
        want = {32: (64, 128), 64: (32, 64), 128: (16, 64)}[head_dim]
    assert attention_cuda.kernel_tiles(name, dtype, head_dim) == want
    with pytest.raises(ValueError, match="no flash_dq kernel"):
        attention_cuda.kernel_tiles("flash_dq", dtype, 48)


def _tf32(x):
    """What the tensor cores read of a float32 operand: its low 13 bits
    cleared."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_products(a, b, split):
    """a @ b as the float32 kernels take it on tf32 tensor cores, accumulated
    in float32: with ``split``, a_lo b + a b_lo + a b (a_lo = a minus
    _tf32(a), itself read as tf32), else the one product a b."""
    terms = [(a, b)]
    if split:
        terms = [(a - _tf32(a), b), (a, b - _tf32(b)), (a, b)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for x, y in terms:
        # Products of two tf32 values are exact in float32.
        acc += _tf32(x) @ _tf32(y)
    return acc


@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_split_tf32_products_keep_f32_accuracy(head_dim):
    """The float32 kernels' arithmetic on one 64-row tile: K1's Q K^T and
    P V, and the backward's dS K (K2), P^T dO and dS^T Q (K3), each as three
    tf32 products, hold against float64 within 1e-5 of the larger of 1 and
    the result's max, as a float32 product does; one tf32 product does not.
    Inputs at the LM's magnitudes: unit-normal q, k, v and dO; P a row
    softmax of the scaled scores (entries in [0, 1]); dS = P (dO V^T -
    delta), delta = rowsum(dO * P V), as the softmax backward gives it."""
    rng = np.random.default_rng(head_dim)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((64, head_dim)).astype(np.float32))
                   for _ in range(4))
    scores = q.double() @ k.double().T
    p64 = torch.softmax(scores / math.sqrt(head_dim), dim=-1)
    delta = (do.double() * (p64 @ v.double())).sum(-1, keepdim=True)
    ds = (p64 * (do.double() @ v.double().T - delta)).float()
    p = p64.float()
    products = {"Q K^T": (q, k.T.contiguous()), "P V": (p, v), "dS K": (ds, k),
                "P^T dO": (p.T.contiguous(), do), "dS^T Q": (ds.T.contiguous(), q)}
    for what, (a, b) in products.items():
        want = a.double() @ b.double()
        tol = 1e-5 * max(1.0, want.abs().max().item())
        split = (_tf32_products(a, b, split=True).double() - want).abs().max().item()
        one = (_tf32_products(a, b, split=False).double() - want).abs().max().item()
        plain = ((a @ b).double() - want).abs().max().item()
        assert split <= tol and plain <= tol, (what, split, plain, tol)
        assert one > tol, (what, one, tol)


def _fragment_pos(r):
    """tf32.cuh's fragment_pos: within its group of 8, reduction index 2c
    goes to column c and 2c + 1 to column c + 4."""
    return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2)


def _transposed_copy(src):
    """What tf32.cuh's write_transposed writes for an (R, C) tile: C rows
    of R columns, source row r at column fragment_pos(r)."""
    rows, cols = src.shape
    copy = np.zeros((cols, rows))
    for r in range(rows):
        copy[:, _fragment_pos(r)] = src[r]
    return copy


def _fragment_operand(acc):
    """The tf32 A operand that one warp's 16 accumulator rows give, taken
    from registers as split_fragments passes them: a thread holds columns
    2t and 2t+1 of each group of 8 (d[4j + 2i + c] = row g + 8i, column
    8j + 2t + c) and passes (d[4j], d[4j+2], d[4j+1], d[4j+3]) as the
    fragment's (row g, column t), (g + 8, t), (g, t + 4), (g + 8, t + 4)."""
    cols = acc.shape[1]
    a = np.zeros_like(acc)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        d = np.zeros(cols // 2)
        for j in range(cols // 8):
            for i in range(2):
                for c in range(2):
                    d[4 * j + 2 * i + c] = acc[g + 8 * i, 8 * j + 2 * t + c]
        for kk in range(cols // 8):
            x = (d[4 * kk], d[4 * kk + 2], d[4 * kk + 1], d[4 * kk + 3])
            a[g, 8 * kk + t], a[g + 8, 8 * kk + t] = x[0], x[1]
            a[g, 8 * kk + t + 4], a[g + 8, 8 * kk + t + 4] = x[2], x[3]
    return a


@pytest.mark.parametrize("keys", [16, 32, 64])
def test_tf32_fragment_key_order(keys):
    """An accumulator's registers feed the tf32 A fragment as they are,
    because the B operand is a transposed copy with its reduction index in
    fragment_pos order: K1's P V (V^T, keys permuted), K2's dS K (K^T,
    keys permuted) and K3's P^T dO and dS^T Q (dO^T and Q^T, query rows
    permuted). ``keys`` is the reduction length: 16 to 64, as the tiles."""
    rng = np.random.default_rng(keys)
    for width in (8, 32):  # the product's N: head_dim columns
        acc = rng.standard_normal((16, keys))  # P, dS, P^T or dS^T
        src = rng.standard_normal((keys, width))  # V, K, dO or Q
        b = _transposed_copy(src).T  # B as the K-major copy gives it
        np.testing.assert_allclose(_fragment_operand(acc) @ b, acc @ src,
                                   rtol=1e-12, atol=1e-12)



def test_wide_f32_transposed_chunks_gather_fragment_order():
    """flash_bwd.cu's write_pair_transposed (float32 K2/K3 at head_dim 256)
    writes each row of the transposed copy as four 16-byte chunks, chunk p
    gathered from source rows 8(p/2) + p%2 + 2j (j < 4): that is the
    column order of fragment_pos, the copy _transposed_copy describes."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal((16, 128))  # 16 streamed rows, a warpgroup's columns
    copy = np.zeros((128, 16))
    for row in range(128):
        for p in range(4):
            for j in range(4):
                copy[row, 4 * p + j] = src[8 * (p // 2) + p % 2 + 2 * j, row]
    np.testing.assert_array_equal(copy, _transposed_copy(src))


def _tf32(x):
    """What the tensor cores read of float32 x: its low 13 bits cleared."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def test_wide_f32_paired_product_merges_to_the_split_product():
    """Float32 K2/K3 at head_dim 256: the stacked A (rows 16w + l the hi
    parts of source rows 8w + l, rows 16w + 8 + l their lo parts) against
    a paired tile (16 streamed rows, then their lo parts) in one m64n32
    product; a thread's merge of its accumulator (d[4j + 2i + c] is row
    16w + l/4 + 8i, column 8j + 2(l%4) + c) gives its source row's values
    at columns 8j + 2t + c, j < 2, to float32 accuracy."""
    rng = np.random.default_rng(1)
    fixed = rng.standard_normal((32, 256)).astype(np.float32)
    streamed = rng.standard_normal((16, 256)).astype(np.float32)
    hi = _tf32(fixed)
    stacked = np.zeros((64, 256), np.float32)
    for w in range(4):
        stacked[16 * w:16 * w + 8] = hi[8 * w:8 * w + 8]
        stacked[16 * w + 8:16 * w + 16] = fixed[8 * w:8 * w + 8] - hi[8 * w:8 * w + 8]
    pair = np.concatenate([streamed, streamed - _tf32(streamed)])
    acc = _tf32(stacked).astype(np.float64) @ _tf32(pair).astype(np.float64).T  # 64 x 32
    exact = fixed.astype(np.float64) @ streamed.astype(np.float64).T
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            d = np.zeros(16)
            for j in range(4):
                for i in range(2):
                    for c in range(2):
                        d[4 * j + 2 * i + c] = acc[16 * w + g + 8 * i, 8 * j + 2 * t + c]
            for j in range(2):
                for c in range(2):
                    m = (d[4 * j + c] + d[4 * j + 2 + c]) + (d[4 * j + 8 + c] + d[4 * j + 10 + c])
                    want = exact[8 * w + g, 8 * j + 2 * t + c]
                    assert abs(m - want) <= 2e-6 * np.abs(fixed[8 * w + g]) @ np.abs(
                        streamed[8 * j + 2 * t + c])


def _wide_fwd_dim():
    """flash_fwd.cu's wide_fwd_dim(w, gq), evaluated from its source."""
    source = (attention_cuda.CSRC / "flash_fwd.cu").read_text()
    body = re.search(r"int wide_fwd_dim\(int w, int gq\) \{\s*return ([^;]+);", source).group(1)
    return lambda w, gq: eval(body, {}, {"w": w, "gq": gq})  # noqa: S307 - the kernel's own expression


def _swizzled(row, col_bytes, row_bytes):
    """TileLayout::offset: byte column ``col_bytes`` of ``row`` in a column
    block of ``row_bytes``-byte rows, its 16-byte chunk XORed with address
    bits 7-9 (128-byte rows) or 7-8 (64-byte rows) of the row's start."""
    return row * row_bytes + (col_bytes ^ ((((row * row_bytes) >> 7) & (row_bytes // 16 - 1)) << 4))


def test_wide_fwd_v_rows_cover_a_slab_and_meet_no_bank_twice():
    """Float32 K1 at head_dim 256: warpgroup 1's thread (warp w, lane
    group gq) holds head_dim rows wide_fwd_dim(w, gq) and + 1 of each
    64-row slab of O^T, so the 32 (w, gq) pairs cover a slab once; its
    8-byte loads of V (keys t and t + 4 of a k8 step, t = lane % 4) from
    the swizzled TMA tile put each half warp on 32 distinct banks."""
    dim = _wide_fwd_dim()
    rows = sorted(dim(w, gq) + i for w in range(4) for gq in range(8) for i in range(2))
    assert rows == list(range(64))
    for s in range(4):
        for w in range(4):
            for kk in range(2):
                for h in range(2):
                    for half in range(2):
                        banks = []
                        for lane in range(16 * half, 16 * half + 16):
                            d, key = 64 * s + dim(w, lane // 4), 8 * kk + lane % 4 + 4 * h
                            addr = (d // 32) * 16 * 128 + _swizzled(key, (d % 32) * 4, 128)
                            assert addr % 8 == 0
                            banks += [(addr // 4) % 32, (addr // 4 + 1) % 32]
                        assert sorted(banks) == list(range(32)), (s, w, kk, h, half)


def test_wide_fwd_exchange_and_transposed_output_give_softmax_v():
    """Float32 K1 at head_dim 256 over three 16-key tiles, as its two
    warpgroups compute it, in numpy. Warpgroup 0 takes the tiles in
    pairs: the stacked Q against a stage of 64 rows per column block (the
    pair's 32 keys, then their lo parts; the second pair's second tile
    lies past the sequence, zeros as TMA fills them), merged per thread
    into the split S of each tile (to float32 accuracy), the online
    softmax of both tiles with that tile masked whole, and each real
    tile's P (hi rows 0-31, lo rows 32-63) with each row's correction
    written into the 64-byte-swizzled exchange. Warpgroup 1 reads that
    exchange as the B operand of O^T = V^T [P; P_lo]^T + V^T_lo P^T, its
    A fragments V^T, hi and lo, loaded from the 128-byte-swizzled V tile
    at wide_fwd_dim's rows, rescales its accumulator by the corrections
    each thread reads back (c8), and at the end adds hi and lo columns
    and divides by the row sums. Equals softmax(Q K^T / 16) V in float64
    to float32 accuracy."""
    rng = np.random.default_rng(21)
    dim = _wide_fwd_dim()
    tiles, scale_log2 = 3, np.float32(math.log2(math.e) / 16.0)
    seq = 16 * tiles
    q = rng.standard_normal((32, 256)).astype(np.float32)
    k = rng.standard_normal((seq, 256)).astype(np.float32)
    v = rng.standard_normal((seq, 256)).astype(np.float32)
    hi = _tf32(q)
    stacked = np.zeros((64, 256), np.float32)
    for w in range(4):
        stacked[16 * w:16 * w + 8] = hi[8 * w:8 * w + 8]
        stacked[16 * w + 8:16 * w + 16] = q[8 * w:8 * w + 8] - hi[8 * w:8 * w + 8]
    threads = [(w, lane // 4, lane % 4) for w in range(4) for lane in range(32)]

    def v_at(d, key):  # float index of V[key, d] in the tile as TMA stores it
        return ((d // 32) * 16 * 128 + _swizzled(key, (d % 32) * 4, 128)) // 4

    m = np.full(32, -np.inf, np.float32)
    l = np.zeros(32, np.float32)
    acc = np.zeros((4, 64, 64))  # per slab: fragment rows x [P; P_lo] rows
    for i in range((tiles + 1) // 2):
        kt = np.zeros((32, 256), np.float32)  # the pair's keys, zeros past the sequence
        kt[:min(32, seq - 32 * i)] = k[32 * i:32 * i + 32]
        stage = np.concatenate([kt, kt - _tf32(kt)])  # 64 rows: keys, then their lo parts
        x = _tf32(stacked).astype(np.float64) @ _tf32(stage).astype(np.float64).T  # 64 x 64
        s_pair = np.zeros((32, 32), np.float32)
        for w, g, t in threads:  # each thread's merge: y = x + 8h + 4jj + c in its registers
            for h in range(2):
                for jj in range(2):
                    for c in range(2):
                        key = 16 * h + 8 * jj + 2 * t + c
                        s_pair[8 * w + g, key] = ((x[16 * w + g, key] + x[16 * w + g + 8, key])
                                                  + (x[16 * w + g, 32 + key] + x[16 * w + g + 8, 32 + key]))
        exact = q.astype(np.float64) @ kt.astype(np.float64).T
        assert (np.abs(s_pair - exact) <= 2e-6 * np.abs(q) @ np.abs(kt).T).all()
        s_pair[:, np.arange(32 * i, 32 * i + 32) >= seq] = -np.inf
        for h in range(2):
            j = 2 * i + h
            s_tile = s_pair[:, 16 * h:16 * h + 16]
            m_new = np.maximum(m, s_tile.max(1) * scale_log2)
            shift = np.where(np.isfinite(m_new), m_new, 0).astype(np.float32)
            corr = np.where(np.isfinite(m), np.exp2(m - shift), 0).astype(np.float32)
            p = np.exp2(s_tile * scale_log2 - shift[:, None]).astype(np.float32)
            l = l * corr + p.sum(1)
            m = m_new
            if j >= tiles:
                assert (p == 0).all() and (corr == 1).all()
                continue
            xchg = np.zeros(64 * 16, np.float32)
            for w, g, t in threads:
                r = 8 * w + g
                for jj in range(2):
                    for c in range(2):
                        col = (8 * jj + 2 * t + c) * 4
                        xchg[_swizzled(r, col, 64) // 4] = p[r, col // 4]
                        xchg[_swizzled(r + 32, col, 64) // 4] = p[r, col // 4] - _tf32(p[r, col // 4])
            b = np.array([[xchg[_swizzled(n, 4 * key, 64) // 4] for key in range(16)]
                          for n in range(64)], np.float32)  # as the K-major descriptor reads it
            vt = v[16 * j:16 * j + 16]
            vtile = np.zeros(16 * 256, np.float32)
            for key in range(16):
                for d in range(256):
                    vtile[v_at(d, key)] = vt[key, d]
            for s in range(4):
                a = np.zeros((64, 16), np.float32)  # the A fragments of all threads
                for w, g, t in threads:
                    d = 64 * s + dim(w, g)
                    for key in (t, t + 4, 8 + t, 12 + t):  # each an 8-byte load: rows d, d + 1
                        a[16 * w + g, key] = vtile[v_at(d, key)]
                        a[16 * w + g + 8, key] = vtile[v_at(d, key) + 1]
                    if j > 0:  # O^T *= the corrections, as the thread reads them
                        c8 = [corr[8 * jj + 2 * t + c] for jj in range(4) for c in range(2)]
                        for e in range(32):
                            row, col = 16 * w + g + 8 * ((e // 2) % 2), 8 * (e // 4) + 2 * t + (e % 2)
                            acc[s][row, col] *= c8[2 * ((e // 4) % 4) + (e & 1)]
                a_hi = _tf32(a)
                acc[s] += a_hi.astype(np.float64) @ _tf32(b).astype(np.float64).T
                acc[s][:, :32] += (_tf32(a - a_hi).astype(np.float64)
                                   @ _tf32(b[:32]).astype(np.float64).T)
    out = np.zeros((32, 256))
    for s in range(4):
        for w, g, t in threads:
            for jj in range(4):
                for c in range(2):
                    qr = 8 * jj + 2 * t + c
                    for i in range(2):
                        row = 16 * w + g + 8 * i
                        out[qr, 64 * s + dim(w, g) + i] = (acc[s][row, qr] + acc[s][row, qr + 32]) / l[qr]
    scores = q.astype(np.float64) @ k.astype(np.float64).T / 16.0
    probs = np.exp(scores - scores.max(1, keepdims=True))
    want = (probs / probs.sum(1, keepdims=True)) @ v.astype(np.float64)
    np.testing.assert_allclose(out, want, rtol=0, atol=2e-6)


LOG2E = np.float32(math.log2(math.e))


def _acc_layout(cols):
    """(thread, register, row, column) of a wgmma m64nN f32 accumulator:
    thread ctid (warp w, lane l) of a warpgroup holds d[4j + 2i + c] at row
    16w + l/4 + 8i, column 8j + 2(l%4) + c."""
    for ctid in range(128):
        w, lane = divmod(ctid, 32)
        g, t = lane // 4, lane % 4
        for j in range(cols // 8):
            for i in range(2):
                for c in range(2):
                    yield ctid, 4 * j + 2 * i + c, 16 * w + g + 8 * i, 8 * j + 2 * t + c


def _plain_ds(q, k, v, do, lse, delta, q0, k0, seq, causal, scale):
    """The plain version's dS for one (query tile, key tile), as
    ``flash_backward_reference`` forms it, in float32: rows past ``seq``
    are left out (NaN)."""
    qf, kf, vf, dof = (torch.from_numpy(a) for a in (q, k, v, do))
    p = torch.exp(scale * (qf @ kf.T) - torch.from_numpy(lse)[:, None])
    if causal:
        q_pos = torch.arange(q0, q0 + 64)[:, None]
        k_pos = torch.arange(k0, k0 + 64)[None, :]
        p = p.masked_fill(k_pos > q_pos, 0.0)
    p = p.masked_fill(torch.arange(k0, k0 + 64)[None, :] >= seq, 0.0)
    ds = (p * (dof @ vf.T - torch.from_numpy(delta)[:, None])).numpy()
    ds[np.arange(q0, q0 + 64) >= seq] = np.nan
    return ds


def _tile_inputs(rng, q0, k0, seq):
    """A 64-row query tile and a 64-key tile of head_dim 256 as TMA gives
    them (rows past ``seq`` zero), with each query row's lse and delta
    (0 past ``seq``)."""
    q, k, v, do = (rng.standard_normal((64, 256)).astype(np.float32) for _ in range(4))
    q[np.arange(q0, q0 + 64) >= seq] = 0
    do[np.arange(q0, q0 + 64) >= seq] = 0
    k[np.arange(k0, k0 + 64) >= seq] = 0
    v[np.arange(k0, k0 + 64) >= seq] = 0
    lse = (rng.standard_normal(64) + 3.0).astype(np.float32)
    delta = rng.standard_normal(64).astype(np.float32)
    lse[np.arange(q0, q0 + 64) >= seq] = 0
    delta[np.arange(q0, q0 + 64) >= seq] = 0
    return q, k, v, do, lse, delta


# (q0, k0, seq, causal) of one tile: below the diagonal, on it, ragged.
_WIDE_BF16_TILES = {"interior": (128, 0, 4096, True), "causal_diagonal": (64, 64, 4096, True),
                    "ragged": (960, 960, 1000, False)}


@pytest.mark.parametrize("case", sorted(_WIDE_BF16_TILES))
def test_wide_bf16_k3_exchange_gives_the_plain_ds(case):
    """bf16 K3 at head_dim 256, one tile as its two warpgroups compute it
    in numpy (float32). Warpgroup 1 stores the tile's lse (base 2) and
    delta as its threads do (thread ctid < 64 row ctid's lse, the others
    row ctid - 64's delta); warpgroup 0 forms P^T = exp2(S^T c - lse) in
    its accumulator (rows keys, columns query rows), each column's lse read
    as a float2 at 8j + 2t, masked past ``seq`` and above the diagonal
    only where the tile's flag says so, and writes its quad j to float4
    j * 128 + ctid of the exchange; warpgroup 1's thread ctid reads it back
    at the same positions of its dP^T accumulator and forms dS^T = P^T
    (dP^T - delta). That is the plain version's dS, transposed, before any
    bf16 rounding, and 0 for query rows past ``seq`` (keys past it are
    never written)."""
    q0, k0, seq, causal = _WIDE_BF16_TILES[case]
    rng = np.random.default_rng(22)
    q, k, v, do, lse, delta = _tile_inputs(rng, q0, k0, seq)
    scale = np.float32(1 / 16)
    scale_log2 = np.float32(scale * LOG2E)
    st, dpt = k @ q.T, v @ do.T  # S^T and dP^T: keys x query rows, float32
    row_vals = np.zeros(128, np.float32)
    for ctid in range(128):
        r = q0 + ctid % 64
        row_vals[ctid] = 0 if r >= seq else (lse[ctid] * LOG2E if ctid < 64 else delta[ctid - 64])
    mask = (causal and q0 < k0 + 63) or q0 + 64 > seq
    xchg = np.zeros((8 * 128, 4), np.float32)
    for ctid, e, row, col in _acc_layout(64):
        p = np.exp2(np.float32(st[row, col] * scale_log2 - row_vals[col]))
        qi = q0 + col
        if mask and (qi >= seq or (causal and k0 + row > qi)):
            p = np.float32(0)
        xchg[(e // 4) * 128 + ctid, e % 4] = p
    dst = np.zeros((64, 64), np.float32)
    for ctid, e, row, col in _acc_layout(64):
        p = xchg[(e // 4) * 128 + ctid, e % 4]
        dst[row, col] = p * (dpt[row, col] - row_vals[64 + col])
    want = _plain_ds(q, k, v, do, lse, delta, q0, k0, seq, causal, scale)
    keys = np.arange(k0, k0 + 64) < seq
    live = ~np.isnan(want) & keys[None, :]
    np.testing.assert_allclose(dst.T[live], want[live], rtol=2e-5,
                               atol=2e-5 * np.abs(want[live]).max())
    assert (dst.T[np.isnan(want) & keys[None, :]] == 0).all()


@pytest.mark.parametrize("case", ["interior", "causal_diagonal"])
def test_wide_bf16_k2_ds_in_its_row_layout(case):
    """bf16 K2 at head_dim 256: a warpgroup's thread holds rows 16w + l/4
    and + 8 of its 64 and their lse (base 2) and delta, S and dP of a
    64-key tile in the accumulator layout, and forms dS = exp2(S c - lse)
    (dP - delta) with the mask arithmetic only on a flagged tile. Equals
    the plain version's dS for the tile in float32."""
    q0, k0, seq, causal = _WIDE_BF16_TILES[case]
    rng = np.random.default_rng(23)
    q, k, v, do, lse, delta = _tile_inputs(rng, q0, k0, seq)
    scale = np.float32(1 / 16)
    scale_log2 = np.float32(scale * LOG2E)
    s, dp = q @ k.T, do @ v.T
    mask = (causal and k0 + 63 > q0) or k0 + 64 > seq
    ds = np.zeros((64, 64), np.float32)
    for _, e, row, col in _acc_layout(64):
        p = np.exp2(np.float32(s[row, col] * scale_log2 - lse[row] * LOG2E))
        if mask and (k0 + col >= seq or (causal and k0 + col > q0 + row)):
            p = np.float32(0)
        ds[row, col] = p * (dp[row, col] - delta[row])
    want = _plain_ds(q, k, v, do, lse, delta, q0, k0, seq, causal, scale)
    np.testing.assert_allclose(ds, want, rtol=2e-5, atol=2e-5 * np.abs(want).max())


def _wide_bf16_k2_blocks(seq, causal):
    """bf16 K2 at head_dim 256: per block (128 query rows) and warpgroup
    (64 of them), the rows and the key tiles it computes, by the kernel's
    expressions (`tiles`, `mine`)."""
    for q0 in range(0, seq, 128):
        kv_end = min(seq, q0 + 128) if causal else seq
        tiles = -(-kv_end // 64)
        for g in range(2):
            r0 = q0 + 64 * g
            own_end = min(seq, r0 + 64) if causal else seq
            mine = -(-own_end // 64) if r0 < seq else 0
            assert mine <= tiles
            yield r0, mine


@pytest.mark.parametrize("seq, causal", [(4096, True), (1000, True), (1000, False), (37, True)])
def test_wide_bf16_tiles_cover_every_score_and_flag_every_mask(seq, causal):
    """bf16 K2 (128-row blocks, warpgroups of 64 rows, 64-key tiles) and K3
    (64-key blocks, 64-row query tiles from the block's first key, causal)
    at head_dim 256: every score a row < ``seq`` needs (key < ``seq``, key
    <= row when causal) lies in exactly one computed tile, and every
    computed tile that holds a score the mask must zero carries the mask
    flag (the kernels skip the mask arithmetic elsewhere)."""
    need = np.zeros((seq, seq), np.int8)
    for r0, mine in _wide_bf16_k2_blocks(seq, causal):
        rows = np.arange(r0, min(seq, r0 + 64))
        for j in range(mine):
            n0 = 64 * j
            keys = np.arange(n0, n0 + 64)
            flag = (causal and n0 + 63 > r0) or n0 + 64 > seq
            zeroed = (keys[None, :] >= seq) | (causal & (keys[None, :] > rows[:, None]))
            assert flag or not zeroed.any(), (r0, j)
            live = keys[keys < seq]
            need[np.ix_(rows, live)] += ~zeroed[:, : len(live)]
    want = np.tril(np.ones((seq, seq), np.int8)) if causal else np.ones((seq, seq), np.int8)
    np.testing.assert_array_equal(need, want)
    need[:] = 0
    for k0 in range(0, seq, 64):
        keys = np.arange(k0, min(seq, k0 + 64))
        q_begin = k0 if causal else 0
        for i in range(-(-(seq - q_begin) // 64)):
            q0 = q_begin + 64 * i
            rows = np.arange(q0, q0 + 64)
            flag = (causal and q0 < k0 + 63) or q0 + 64 > seq
            zeroed = (rows[None, :] >= seq) | (causal & (keys[:, None] > rows[None, :]))
            assert flag or not zeroed.any(), (k0, i)
            live = rows[rows < seq]
            need[np.ix_(live, keys)] += ~zeroed[:, : len(live)].T
    np.testing.assert_array_equal(need, want)


@pytest.mark.parametrize("kernel", ["flash_dq", "flash_dkv"])
def test_wide_bf16_outputs_write_each_position_once(kernel):
    """bf16 K2 at head_dim 256 writes a block's 128 x 256 dQ from its two
    warpgroups' m64n256 accumulators (warpgroup g rows 64g ..), K3 its 64
    x 256 dV (warpgroup 0) and dK (1): thread (warp w, lane l) writes row
    16w + l/4 + 8r, columns 8n + 2(l%4) and + 1 from acc[4n + 2r] and
    acc[4n + 2r + 1]. Each position once."""
    counts = {}
    for g in range(2):
        out = np.zeros((128 if kernel == "flash_dq" else 64, 256), np.int64)
        base = 64 * g if kernel == "flash_dq" else 0
        for ctid in range(128):
            w, lane = divmod(ctid, 32)
            t = lane % 4
            for r in range(2):
                row = base + 16 * w + lane // 4 + 8 * r
                for n in range(32):
                    out[row, 8 * n + 2 * t: 8 * n + 2 * t + 2] += 1
        counts[g] = out
    if kernel == "flash_dq":
        np.testing.assert_array_equal(counts[0] + counts[1], np.ones((128, 256), np.int64))
    else:
        for g in range(2):
            np.testing.assert_array_equal(counts[g], np.ones((64, 256), np.int64))


def test_wide_bf16_fragments_are_the_accumulator_in_a_layout():
    """The bf16 D = 256 kernels pack a 64 x 64 f32 accumulator (dS, P^T or
    dS^T) as the register A operand of the next product: fr[kk][r] holds
    d[8kk + 2r] and d[8kk + 2r + 1]. Read as wgmma's A layout (a[0] row
    l/4, columns 16kk + 2(l%4) and + 1; a[1] those columns of row + 8; a[2]
    and a[3] columns + 8), the fragments are the accumulator's matrix."""
    rng = np.random.default_rng(24)
    acc = rng.standard_normal((64, 64)).astype(np.float32)
    regs = np.zeros((128, 32), np.float32)
    for ctid, e, row, col in _acc_layout(64):
        regs[ctid, e] = acc[row, col]
    a = np.zeros((64, 64), np.float32)
    for ctid in range(128):
        w, lane = divmod(ctid, 32)
        g, t = lane // 4, lane % 4
        for kk in range(4):
            for r in range(4):
                row = 16 * w + g + 8 * (r & 1)
                col = 16 * kk + 8 * (r >> 1) + 2 * t
                a[row, col], a[row, col + 1] = regs[ctid, 8 * kk + 2 * r], regs[ctid, 8 * kk + 2 * r + 1]
    np.testing.assert_array_equal(a, acc)


def _wide_fwd_bf16_shape():
    """The constants of ``WideFwdBf16`` (bf16 K1 at head_dim 256) as its
    source declares them."""
    text = attention_cuda.SOURCES["flash_fwd"].read_text()
    body = re.search(r"struct WideFwdBf16 \{(.*?)\n\};", text, re.S).group(1)
    consts = {name: value for name, value in re.findall(
        r"static constexpr \w+ (k\w+) = (\w+);", body)}
    shape = {name: int(consts[name]) for name in ("kRows", "kN", "kKSlots", "kVSlots",
                                                  "kConsumerWarps")}
    shape["kSkipMasked"] = consts["kSkipMasked"] == "true"
    return shape


def _wide_fwd_bf16_mine(q0, seq, causal, tiles, shape):
    """Tiles each consumer warpgroup of a bf16 K1 block at head_dim 256
    computes, by the kernel's expression (`mine`)."""
    n = shape["kN"]
    return [-(-min(seq, q0 + 64 * g + 64) // n) if shape["kSkipMasked"] and causal else tiles
            for g in range(2)]


class _MBarrier:
    """An mbarrier: `count` arrivals and the transaction bytes it was told
    to expect complete a phase; a wait on parity P returns once the
    completed phases' count differs from P in parity."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phases = count, count, 0, 0

    def arrive(self, tx=0):
        assert self.pending > 0
        self.pending -= 1
        self.tx += tx
        self._settle()

    def land(self, nbytes):
        self.tx -= nbytes
        self._settle()

    def _settle(self):
        if self.pending == 0 and self.tx == 0:
            self.phases += 1
            self.pending = self.count

    def passes(self, parity):
        return self.phases % 2 != parity


def _run_wide_fwd_bf16_block(q0, seq, causal, shape, rng):
    """One block of bf16 K1 at head_dim 256 as its producer thread and its
    8 consumer warps run it, in an order drawn from ``rng``: each step runs
    one agent up to its next barrier operation, or lands one TMA load in
    flight (loads land in any order). Checks the schedule as it goes and
    returns the barriers at the end."""
    n, stages = shape["kN"], {"k": shape["kKSlots"], "v": shape["kVSlots"]}
    kv_end = min(seq, q0 + shape["kRows"]) if causal else seq
    tiles = -(-kv_end // n)
    mine = _wide_fwd_bf16_mine(q0, seq, causal, tiles, shape)
    full = {r: [_MBarrier(1) for _ in range(stages[r])] for r in stages}
    empty = {r: [_MBarrier(shape["kConsumerWarps"]) for _ in range(stages[r])] for r in stages}
    q_full = _MBarrier(1)
    slot_tile = {r: [None] * stages[r] for r in stages}  # the tile TMA writes or wrote there
    landed = {r: [False] * stages[r] for r in stages}
    read_done = {}  # (ring, tile) -> warps that finished reading it
    in_flight = []
    warps = [(g, w) for g in range(2) for w in range(4)]
    readers = {(r, j): {wp for wp in warps if j < mine[wp[0]]} for r in stages for j in range(tiles)}

    def wait(bar, parity, fills):  # the wait returns at exactly `fills` completed phases
        while not bar.passes(parity):
            yield
        assert bar.phases == fills, (bar.phases, fills)

    def producer():
        q_full.arrive(tx=1)
        in_flight.append((q_full, None, None))
        yield

        def load(r, j):
            s = j % stages[r]
            yield from wait(empty[r][s], ((j // stages[r]) & 1) ^ 1, j // stages[r])
            if j >= stages[r]:  # every reader of the slot's previous tile is done with it
                assert readers[(r, j - stages[r])] <= read_done.get((r, j - stages[r]), set())
            full[r][s].arrive(tx=1)
            slot_tile[r][s], landed[r][s] = j, False
            in_flight.append((full[r][s], r, s))
            yield

        yield from load("k", 0)
        for j in range(tiles):
            if j + 1 < tiles:
                yield from load("k", j + 1)
            yield from load("v", j)

    def consumer(g, w):
        def acquire(r, j):  # the full wait, then the slot holds tile j, landed
            s = j % stages[r]
            yield from wait(full[r][s], (j // stages[r]) & 1, j // stages[r] + 1)
            assert slot_tile[r][s] == j and landed[r][s]

        def done(r, j):  # the products reading it completed; released if filled again
            read_done.setdefault((r, j), set()).add((g, w))
            if j + stages[r] < tiles:
                empty[r][j % stages[r]].arrive()
            yield

        yield from wait(q_full, 0, 1)
        yield from acquire("k", 0)
        yield from done("k", 0)
        for j in range(1, mine[g]):
            yield from acquire("k", j)
            yield from acquire("v", j - 1)
            yield from done("k", j)  # wgmma_wait<1>: S_j
            yield from done("v", j - 1)  # wgmma_wait<0>: P_{j-1} V_{j-1}
        yield from acquire("v", mine[g] - 1)
        yield from done("v", mine[g] - 1)

    agents = [producer()] + [consumer(g, w) for g, w in warps]
    while agents or in_flight:
        pick = rng.integers(len(agents) + (1 if in_flight else 0))
        if pick == len(agents):
            bar, r, s = in_flight.pop(rng.integers(len(in_flight)))
            if r is not None:
                landed[r][s] = True
            bar.land(1)
            continue
        try:
            next(agents[pick])
        except StopIteration:
            agents.pop(pick)
    return [q_full] + [bar for r in stages for bar in full[r] + empty[r]], read_done, readers


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("seq", [37, 100, 1000, 4096])
def test_wide_bf16_fwd_rings_schedule(seq, causal):
    """bf16 K1 at head_dim 256 streams K and V through rings of their own
    (``WideFwdBf16``'s slot counts, read from the source): the producer
    loads Q, K_0, then K_{j+1} and V_j; a consumer warp releases K_j once
    S_j is done and V_{j-1} once P V is, and only a slot that is filled
    again. Over the distinct blocks of one head, in random orders of the
    producer, the 8 consumer warps and the loads' landing: no load writes a
    slot before every warp that reads its previous tile has released it;
    every wait returns at the fill (or release) count its parity names;
    the schedule ends with no load in flight, every warp's tiles read, and
    every barrier at a phase boundary with no bytes outstanding."""
    shape = _wide_fwd_bf16_shape()
    assert (shape["kRows"], shape["kN"]) == attention_cuda.kernel_tiles(
        "flash_fwd", torch.bfloat16, 256)
    assert shape["kConsumerWarps"] == 8
    rng = np.random.default_rng(seq + causal)
    blocks = {}
    for q0 in range(0, seq, shape["kRows"]):  # the distinct (tiles, mine) of the head
        kv_end = min(seq, q0 + shape["kRows"]) if causal else seq
        tiles = -(-kv_end // shape["kN"])
        blocks.setdefault((tiles, *_wide_fwd_bf16_mine(q0, seq, causal, tiles, shape)), q0)
    if seq == 4096:  # the longest blocks, and a few short ones, keep the test quick
        keys = sorted(blocks)
        blocks = {key: blocks[key] for key in keys[:3] + keys[-3:]}
    for q0 in blocks.values():
        for _ in range(2 if seq < 4096 else 1):
            bars, read_done, readers = _run_wide_fwd_bf16_block(q0, seq, causal, shape, rng)
            assert all(bar.pending == bar.count and bar.tx == 0 for bar in bars)
            assert all(read_done.get(key, set()) == warps for key, warps in readers.items())


@pytest.mark.parametrize("seq, causal", [(4096, True), (1000, True), (1000, False), (37, True),
                                         (100, True), (200, False)])
def test_wide_bf16_fwd_tiles_cover_every_score_and_flag_every_mask(seq, causal):
    """bf16 K1 at head_dim 256 (128-row blocks, consumer warpgroups of 64
    rows, 64-key tiles, the first warpgroup's wholly masked last tile
    skipped when causal): every score a row < ``seq`` needs lies in
    exactly one computed tile, every computed tile that holds a score the
    mask must zero carries the mask flag, and every skipped tile holds only
    scores the mask zeroes (so skipping it changes no sum)."""
    shape = _wide_fwd_bf16_shape()
    n, rows_a_block = shape["kN"], shape["kRows"]
    need = np.zeros((seq, seq), np.int8)
    skipped = 0
    for q0 in range(0, seq, rows_a_block):
        kv_end = min(seq, q0 + rows_a_block) if causal else seq
        tiles = -(-kv_end // n)
        for g, mine in enumerate(_wide_fwd_bf16_mine(q0, seq, causal, tiles, shape)):
            r0 = q0 + 64 * g
            rows = np.arange(r0, r0 + 64)
            for j in range(tiles):
                n0 = n * j
                keys = np.arange(n0, n0 + n)
                zeroed = (keys[None, :] >= seq) | (causal & (keys[None, :] > rows[:, None]))
                if j >= mine:
                    skipped += 1
                    assert zeroed.all(), (q0, g, j)
                    continue
                flag = (causal and n0 + n - 1 > r0) or n0 + n > seq
                assert flag or not zeroed.any(), (q0, g, j)
                live_rows, live_keys = rows < seq, keys < seq
                need[np.ix_(rows[live_rows], keys[live_keys])] += \
                    ~zeroed[np.ix_(live_rows, live_keys)]
    want = np.tril(np.ones((seq, seq), np.int8)) if causal else np.ones((seq, seq), np.int8)
    np.testing.assert_array_equal(need, want)
    # One tile a block skipped where the block reaches past its first 64 rows.
    assert skipped == (sum(1 for q0 in range(0, seq, rows_a_block) if seq > q0 + 64)
                       if causal else 0)


def test_headers_cover_every_include():
    """Every header in csrc/ and every header a source includes is hashed
    into the library's name."""
    headers = set(attention_cuda.HEADERS)
    assert set(attention_cuda.CSRC.glob("*.cuh")) <= headers
    for source in (*attention_cuda.SOURCES.values(), *attention_cuda.HEADERS):
        for name in re.findall(r'^#include "([^"]+)"', source.read_text(), re.M):
            assert attention_cuda.CSRC / name in headers, f"{source.name} includes {name}"


@pytest.mark.parametrize("header", ["common.cuh", "sm90.cuh", "tf32.cuh"])
def test_editing_a_header_renames_the_library(tmp_path, monkeypatch, header):
    """An edited header gives every library a new name, so no stale build
    is reused; nvcc is stubbed, since there is none here."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in (*attention_cuda.SOURCES.values(), *attention_cuda.HEADERS):
        (csrc / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(attention_cuda, "SOURCES",
                        {n: csrc / p.name for n, p in attention_cuda.SOURCES.items()})
    monkeypatch.setattr(attention_cuda, "HEADERS",
                        tuple(csrc / p.name for p in attention_cuda.HEADERS))
    monkeypatch.setattr(attention_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(attention_cuda, "_nvcc", lambda: "nvcc")

    def fake_nvcc(cmd, **kwargs):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(attention_cuda.subprocess, "run", fake_nvcc)
    before = {n: attention_cuda.build(n) for n in attention_cuda.SOURCES}
    assert all(p.exists() for p in before.values())
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: attention_cuda.build(n) for n in attention_cuda.SOURCES}
    for n in attention_cuda.SOURCES:
        assert after[n] != before[n] and after[n].exists()


def test_cuda_wrapper_rejects_cpu_tensors():
    q = torch.zeros(1, 2, 8, 32)
    rows = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.flash_bwd_dq(q, q, q, q, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.flash_bwd_dkv(q, q, q, q, rows, rows)


class _Inputs:
    """What ``use_kernels`` reads of a tensor, without a card."""

    def __init__(self, shape, dtype=torch.float32, device="cuda"):
        self.shape, self.dtype, self.device = torch.Size(shape), dtype, torch.device(device)


# (head_dim, dtype, the kernels' (head_dim, dtype) or the error raised).
@pytest.mark.parametrize("head_dim, dtype, want", [
    (32, torch.float32, (32, torch.float32)),
    (64, torch.bfloat16, (64, torch.bfloat16)),
    (128, torch.float32, (128, torch.float32)),
    (16, torch.float32, (32, torch.float32)),
    (1, torch.bfloat16, (32, torch.bfloat16)),
    (48, torch.bfloat16, (64, torch.bfloat16)),
    (80, torch.float32, (128, torch.float32)),
    (100, torch.float16, (128, torch.float32)),
    (32, torch.float16, (32, torch.float32)),
    (32, torch.float64, (32, torch.float32)),
    (129, torch.float32, (256, torch.float32)),
    (256, torch.bfloat16, (256, torch.bfloat16)),
    (257, torch.float32, (512, torch.float32)),
    (320, torch.bfloat16, (512, torch.bfloat16)),
    (513, torch.float16, (768, torch.float32)),
    (0, torch.float32, ValueError),
    (32, torch.int32, TypeError),
    (32, torch.complex64, TypeError),
])
def test_kernel_layout_rules(head_dim, dtype, want):
    """The head_dim and dtype at which the kernels compute an input: the
    smallest built head_dim that holds it (zero columns), above 256 the
    next multiple of 256 (the instances that take it in chunks of 256
    columns), the input's dtype where a kernel is built for it, float32
    for float16 and float64 (the Pallas kernels' tile dtype); an error
    where no kernel computes it."""
    if isinstance(want, type):
        with pytest.raises(want):
            ops.kernel_layout(head_dim, dtype)
    else:
        assert ops.kernel_layout(head_dim, dtype) == want


@pytest.mark.parametrize("shape, dtype", [
    ((2, 8, 128, 32), torch.float32),
    ((2, 8, 128, 16), torch.float32),
    ((2, 8, 128, 32), torch.float16),
    ((256, 256, 64, 32), torch.bfloat16),
    ((2, 8, 1, 32), torch.float32),
])
def test_use_kernels_takes_every_cuda_input(shape, dtype):
    """Every CUDA input whose head_dim a kernel instance holds runs the
    kernels, whatever its dtype, batch·heads or length (no sequence-length
    threshold), as every TPU input runs Pallas in the JAX package; no
    other device does."""
    assert ops.use_kernels(*[_Inputs(shape, dtype)] * 3)
    assert not ops.use_kernels(*[_Inputs(shape, dtype, device="cpu")] * 3)


@pytest.mark.parametrize("head_dim, device, want", [
    (16, "cuda", True),
    (32, "cuda", True),
    (64, "cuda", True),
    (128, "cuda", True),
    (129, "cuda", True),
    (256, "cuda", True),
    (257, "cuda", True),
    (512, "cuda", True),
    (768, "cuda", True),
    (64, "cpu", False),
    (256, "cpu", False),
])
@pytest.mark.parametrize("seq", [64, 4095])
def test_takes_kernels_is_decided_by_head_dim_and_device(head_dim, device, want, seq):
    """The dispatch rule below the JAX package's Pallas length for wide
    heads: a CUDA input takes the kernels at every head_dim (above 256 the
    instances that take it in chunks of 256 columns), where the JAX
    package runs its XLA path there; no other device does.
    ``use_kernels`` reads it."""
    assert ops.WIDE_HEAD_MIN_SEQ == 4096 == jax_pallas_min_seq(256) == jax_pallas_min_seq(257)
    assert ops.takes_kernels(head_dim, seq, device) is want
    for dtype in (torch.float32, torch.bfloat16):
        assert ops.use_kernels(*[_Inputs((2, 4, seq, head_dim), dtype, device)] * 3) is want
    assert attention_cuda.HEAD_DIMS[-1] == 256 == attention_cuda.WIDE


@pytest.mark.parametrize("head_dim", [257, 512])
def test_wide_heads_at_the_pallas_length_take_the_kernels_on_the_card(head_dim):
    """At and above the length where the JAX package runs Pallas at a
    wide head_dim, a CUDA input takes the kernels (their instances above
    256) as it does below it; the CPU runs the plain versions."""
    for seq in (4096, 8192):
        assert ops.takes_kernels(head_dim, seq, "cuda")
        assert ops.use_kernels(*[_Inputs((1, 2, seq, head_dim))] * 3)
        assert ops.takes_kernels(256, seq, "cuda") and ops.takes_kernels(129, seq, "cuda")
        assert not ops.takes_kernels(head_dim, seq, "cpu")
        assert not ops.use_kernels(*[_Inputs((1, 2, seq, head_dim), device="cpu")] * 3)


def test_head_dim_256_takes_the_plain_path_and_computes_as_the_reference(monkeypatch):
    """head_dim 256 on an input the rule sends to the plain path (a CPU
    input): ``flash_attention`` (and its gradients) and the hop helpers run
    ``blockwise_reference`` and ``flash_backward_reference`` — no kernel
    wrapper is called — and agree with the JAX package's
    ``flash_attention`` and its gradients, which compute every head_dim."""
    import jax

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(attention_cuda, name, refuse)
    q, k, v = _qkv(256, 70)
    cot = _cotangent(q.shape)
    want, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=True), q, k, v)
    want = np.asarray(want)
    want_grads = [np.asarray(g) for g in vjp(cot)]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, True)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
    do = torch.from_numpy(cot)
    out.backward(do)
    for leaf, ref in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=1e-5)
    o, lse = ops.flash_attention_fwd(tq.detach(), tk.detach(), tv.detach(), True)
    np.testing.assert_allclose(o.numpy(), want, atol=1e-5)
    grads = ops.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o, lse, do,
                                    (do * o).sum(-1), True)
    for got, ref in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_use_kernels_needs_one_cuda_device_and_dtype():
    q = _Inputs((2, 8, 64, 32))
    with pytest.raises(ValueError, match="one device"):
        ops.use_kernels(q, _Inputs((2, 8, 64, 32), device="cuda:1"), q)
    with pytest.raises(ValueError, match="one dtype"):
        ops.use_kernels(q, q, _Inputs((2, 8, 64, 32), torch.bfloat16))
    real = torch.zeros(2, 8, 64, 32)
    assert not ops.use_kernels(real, real, real.double())


@pytest.mark.parametrize("kernels", [True, False])
def test_flash_attention_routes_by_use_kernels(monkeypatch, kernels):
    """Where ``use_kernels`` says so, the kernels' autograd Function runs
    (stood in for here) at its own tiling, whatever block sizes the caller
    gives; elsewhere ``blockwise_reference`` at the caller's blocks, the
    JAX package's own path off the TPU."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 37))
    calls = []
    monkeypatch.setattr(ops, "use_kernels", lambda *a: kernels)
    monkeypatch.setattr(ops._FlashAttentionCUDA, "apply",
                        lambda *a: calls.append(a) or ops.blockwise_reference(*a[:4]))
    reference = ops.blockwise_reference

    def plain(*args):
        calls.append(("plain", args[4:]))
        return reference(*args)

    monkeypatch.setattr(ops, "blockwise_reference", plain)
    out = ops.flash_attention(q, k, v, causal=True, block_q=16, block_k=32)
    assert out.shape == q.shape
    if kernels:
        assert len(calls) == 2 and len(calls[0]) == 4 and calls[0][3] is True
        assert calls[1] == ("plain", ())
    else:
        assert calls == [("plain", (16, 32))]


def _plain_kernels(monkeypatch, seen):
    """Stand K1-K3 in by their plain versions at the scale they are given,
    recording the inputs' shapes, dtypes and layout."""

    def note(*tensors):
        seen.append([(tuple(t.shape), t.dtype, t.is_contiguous(), t.data_ptr() % 16)
                     for t in tensors])

    def fwd(q, k, v, causal, scale):
        note(q, k, v)
        return ops.blockwise_reference(q, k, v, causal, scale=scale)

    def dq(q, k, v, do, lse, delta, causal, scale):
        note(do)
        o = ops.blockwise_reference(q, k, v, causal, scale=scale)[0]
        return ops.flash_backward_reference(q, k, v, o, lse, do, causal, scale=scale)[0]

    def dkv(q, k, v, do, lse, delta, causal, scale):
        o = ops.blockwise_reference(q, k, v, causal, scale=scale)[0]
        return ops.flash_backward_reference(q, k, v, o, lse, do, causal, scale=scale)[1:]

    monkeypatch.setattr(attention_cuda, "flash_fwd", fwd)
    monkeypatch.setattr(attention_cuda, "flash_bwd_dq", dq)
    monkeypatch.setattr(attention_cuda, "flash_bwd_dkv", dkv)


# (head_dim, dtype, atol): inputs the kernels compute at another head_dim
# or dtype. float16 results are rounded once to float16 on both sides.
@pytest.mark.parametrize("head_dim, dtype, atol", [
    (16, torch.float32, 1e-5),
    (20, torch.float32, 1e-5),
    (80, torch.float32, 1e-5),
    (16, torch.bfloat16, 1e-2),
    (32, torch.float16, 2e-3),
    (16, torch.float64, 1e-5),
])
def test_kernel_function_pads_and_casts(monkeypatch, head_dim, dtype, atol):
    """``_FlashAttentionCUDA`` hands the kernels q, k, v and dO padded
    with zero columns to ``kernel_layout``'s head_dim and cast to its
    dtype, at the caller's scale, and returns o and the gradients in the
    caller's head_dim and dtype: the plain version's results on the
    caller's inputs. The kernels are stood in by their plain versions."""
    seen = []
    _plain_kernels(monkeypatch, seen)
    want_dim, want_dtype = ops.kernel_layout(head_dim, dtype)
    rng = np.random.default_rng(head_dim)
    arrays = [rng.standard_normal((1, 2, 45, head_dim)) for _ in range(4)]
    leaves = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays[:3]]
    do = torch.tensor(arrays[3], dtype=dtype)
    before = dict(attention_cuda.launches)
    o, lse = ops._FlashAttentionCUDA.apply(*leaves, True)
    got = torch.autograd.grad(o, leaves, do)
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    ref_o, ref_lse = ops.blockwise_reference(*plain, True)
    ref = torch.autograd.grad(ref_o, plain, do)
    assert seen == [[((1, 2, 45, want_dim), want_dtype, True, 0)] * 3,
                    [((1, 2, 45, want_dim), want_dtype, True, 0)]]
    assert o.shape == ref_o.shape and o.dtype == dtype
    torch.testing.assert_close(o, ref_o, rtol=0, atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-5)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0, atol=atol * max(1.0, r.abs().max().item()))
    assert attention_cuda.launches == before


def test_kernel_function_raises_where_no_kernel_computes(monkeypatch):
    """A head_dim below 1, or a dtype no kernel takes, raises on the way
    to the kernels: no plain version runs instead. (Every head_dim from 1
    up has a kernel: above 256 the instances that take multiples of 256.)"""
    _plain_kernels(monkeypatch, [])
    with pytest.raises(ValueError, match="head_dim 0"):
        ops._FlashAttentionCUDA.apply(*[torch.zeros(1, 1, 8, 0)] * 3, True)
    with pytest.raises(TypeError, match="int32"):
        ops._FlashAttentionCUDA.apply(*[torch.zeros(1, 1, 8, 32, dtype=torch.int32)] * 3,
                                      True)


def test_kernel_function_takes_strided_and_unaligned_inputs(monkeypatch):
    """The launch gets q, k and v contiguous and 16-byte aligned: a (b, s,
    h, d) tensor viewed as (b, h, s, d) is made contiguous, a contiguous
    view that starts off alignment is cloned, and gradients still reach
    the caller's tensors."""
    seen = []

    def fake_fwd(q, k, v, causal, scale):
        seen.append([(t.is_contiguous(), t.data_ptr() % 16) for t in (q, k, v)])
        return ops.blockwise_reference(q, k, v, causal)

    def fake_dq(q, k, v, do, lse, delta, causal, scale):
        seen.append([(do.is_contiguous(), do.data_ptr() % 16)])
        return torch.ones_like(q)

    monkeypatch.setattr(attention_cuda, "flash_fwd", fake_fwd)
    monkeypatch.setattr(attention_cuda, "flash_bwd_dq", fake_dq)
    monkeypatch.setattr(attention_cuda, "flash_bwd_dkv",
                        lambda q, k, v, *rest: (2 * torch.ones_like(k), 3 * torch.ones_like(v)))
    rng = np.random.default_rng(4)
    bshd = torch.tensor(rng.standard_normal((1, 8, 2, 32)), dtype=torch.float32,
                        requires_grad=True)
    flat = torch.tensor(rng.standard_normal(1 + 1 * 2 * 8 * 32), dtype=torch.float32,
                        requires_grad=True)
    q = bshd.transpose(1, 2)
    k = flat[1:].view(1, 2, 8, 32)
    assert not q.is_contiguous() and k.data_ptr() % 16 != 0
    v = torch.zeros(1, 2, 8, 32, requires_grad=True)
    o, _ = ops._FlashAttentionCUDA.apply(q, k, v, True)
    torch.testing.assert_close(o, ops.blockwise_reference(q, k, v, True)[0])
    o.transpose(1, 2).sum().backward()
    assert seen == [[(True, 0)] * 3, [(True, 0)]]
    assert torch.equal(bshd.grad, torch.ones_like(bshd))
    assert torch.equal(flat.grad[1:], torch.full((512,), 2.0)) and flat.grad[0] == 0
    assert torch.equal(v.grad, torch.full_like(v, 3.0))


def test_head_dim_16_lm_flash_matches_dense():
    """The registry LM with head_dim 16 (which the kernels compute at
    head_dim 32) trains under ``attention='flash'`` on the CPU through the
    plain path: logits and every gradient as the dense model's."""
    from elephas_tpu_torch.api import CompiledModel
    from elephas_tpu_torch.engine.step import make_loss_fn
    from elephas_tpu_torch.models import get_model

    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, 97, (2, 41)))
    results = {}
    for attention in ("flash", "dense"):
        model = CompiledModel(get_model("transformer_lm", device="cpu", vocab_size=97,
                                        d_model=32, num_heads=2, num_layers=2,
                                        max_seq_len=64, attention=attention),
                              loss="sparse_categorical_crossentropy", seed=1)
        loss, logits = make_loss_fn(model)(tokens[:, :-1], tokens[:, 1:])
        loss.backward()
        results[attention] = (logits.detach(), loss.item(),
                              {n: p.grad for n, p in model.module.named_parameters()})
    (lf, ll, gf), (ld, ldense, gd) = results["flash"], results["dense"]
    torch.testing.assert_close(lf, ld, rtol=0, atol=1e-5)
    assert abs(ll - ldense) <= 1e-6
    for name, g in gd.items():
        assert (gf[name] - g).abs().max() <= 1e-4 * g.abs().max().clamp_min(1e-30), name
