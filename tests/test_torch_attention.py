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

    def fake_fwd(q_, k_, v_, causal):
        calls.append(("fwd", causal))
        return q_ * 2.0, lse

    def fake_dq(q_, k_, v_, do, lse_, delta, causal):
        calls.append(("dq", causal, do, lse_, delta))
        return grads[0]

    def fake_dkv(q_, k_, v_, do, lse_, delta, causal):
        calls.append(("dkv", causal, do, lse_, delta))
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
    for name, causal, do, lse_, delta in calls[1:]:
        assert causal is True and do.is_contiguous() and lse_ is lse
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
