"""Parity of the port's attention ops (``elephas_tpu_torch.ops``) with the
JAX package's, on the CPU.

The JAX side runs as its own tests run it here (``flash_attention``
reaches ``_blockwise_reference``, the Pallas kernel needs a TPU); the port
runs its plain versions, which is what a CPU tensor selects. The CUDA
kernel itself is checked against the same plain version on the card by
``chip_smoke.py``.
"""

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


@pytest.mark.parametrize("blocks", [(16, 32), (64, 64)])
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
    cot = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jax_flash(a, b, c, causal=True) * cot),
        argnums=(0, 1, 2),
    )(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (ops.flash_attention(tq, tk, tv, causal=True) * torch.from_numpy(cot)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_cuda_function_backward_raises(monkeypatch):
    """The kernel's autograd Function has no backward yet (K2/K3): it
    raises rather than differentiating anything else. The launch is
    replaced by a stand-in, since there is no card here."""
    calls = []

    def fake_flash_fwd(q, k, v, causal):
        calls.append(causal)
        return q * 1.0, torch.zeros(q.shape[:3])

    monkeypatch.setattr(attention_cuda, "flash_fwd", fake_flash_fwd)
    before = attention_cuda.launches
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    o, lse = ops._FlashAttentionCUDA.apply(q, q.detach(), q.detach(), True)
    assert calls == [True]
    with pytest.raises(NotImplementedError, match="K2"):
        o.sum().backward()
    assert attention_cuda.launches == before


def test_cuda_wrapper_rejects_cpu_tensors():
    q = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        attention_cuda.flash_fwd(q, q, q)
