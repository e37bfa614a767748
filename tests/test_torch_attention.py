"""Parity of the port's attention ops (``elephas_tpu_torch.ops``) with the
JAX package's, on the CPU.

The JAX side runs as its own tests run it here (``flash_attention``
reaches ``_blockwise_reference`` and its XLA VJP; the Pallas kernels need a
TPU); the port runs its plain versions, which is what a CPU tensor
selects. The CUDA kernels themselves are checked against the same plain
versions on the card by ``chip_smoke.py``.
"""

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


# (64, 64): the float32 kernels' tiling; (192, 128) and (192, 64): the
# bf16 K1's at head_dim 32/64 and 128.
@pytest.mark.parametrize("blocks", [(16, 32), (64, 64), (192, 128), (192, 64)])
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


# (64, 192) and (64, 128): the bf16 K3's at head_dim 32 and 64/128.
@pytest.mark.parametrize("blocks", [(16, 32), (64, 64), (64, 192), (64, 128)])
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
    """Each kernel's tiling: 64 x 64 in float32 and for bf16 K2; bf16 K1
    takes 192 query rows (64 per consumer warpgroup) against 128 keys, 64
    at head_dim 128; bf16 K3 64 query rows against 192 keys (64 per
    consumer warpgroup; 128 at head_dim 64 and 128)."""
    want = (64, 64)
    if dtype == torch.bfloat16 and name == "flash_fwd":
        want = (192, 64 if head_dim == 128 else 128)
    elif dtype == torch.bfloat16 and name == "flash_dkv":
        want = (64, 192 if head_dim == 32 else 128)
    assert attention_cuda.kernel_tiles(name, dtype, head_dim) == want


def test_headers_cover_every_include():
    """Every header in csrc/ and every header a source includes is hashed
    into the library's name."""
    headers = set(attention_cuda.HEADERS)
    assert set(attention_cuda.CSRC.glob("*.cuh")) <= headers
    for source in (*attention_cuda.SOURCES.values(), *attention_cuda.HEADERS):
        for name in re.findall(r'^#include "([^"]+)"', source.read_text(), re.M):
            assert attention_cuda.CSRC / name in headers, f"{source.name} includes {name}"


@pytest.mark.parametrize("header", ["common.cuh", "sm90.cuh"])
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
