"""The head_dim-256 kernel instances of the port, and those above 256,
against the JAX package, on the CPU.

On the card, CUDA inputs of head_dim 129-256 run K1-K3's head_dim-256
instances (``ops.attention.takes_kernels``), padded with zero columns to
256 (``kernel_layout``), and wider ones the instances above 256, padded
to the next multiple of 256 and computed in chunks of 256 columns. Here
the same inputs, made from a NumPy seed, go through the JAX package's
``flash_attention`` (its ``_blockwise_reference`` and XLA VJP off the
TPU) and through the port's plain versions at each instance's tiling,
which is what ``chip_smoke.py`` holds the kernels against on the card;
then small LMs with heads of 256 and of 512 train on both sides from one
set of weights.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.engine import step as jax_step
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.ops.attention import flash_attention as jax_flash
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.engine import step as port_step
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.ops import attention as ops
from elephas_tpu_torch.ops import attention_cuda

SHAPE = (1, 2, 256)  # (batch, heads, seq) of the attention checks
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# (query rows, keys) of each head_dim-256 instance.
WIDE_TILES = {
    torch.bfloat16: {"flash_fwd": (128, 64), "flash_dq": (128, 64), "flash_dkv": (64, 64)},
    torch.float32: {"flash_fwd": (32, 16), "flash_dq": (32, 16), "flash_dkv": (16, 32)},
}
TILINGS = sorted({t for by_name in WIDE_TILES.values() for t in by_name.values()})


def _inputs(head_dim):
    """q, k, v and the output's cotangent, float32, from a NumPy seed."""
    rng = np.random.default_rng(head_dim)
    return [rng.standard_normal((*SHAPE, head_dim)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jax_wide():
    """The JAX package's output and VJP at (causal, head_dim), computed once."""
    memo = {}

    def get(causal, head_dim):
        if (causal, head_dim) not in memo:
            q, k, v, cot = _inputs(head_dim)
            out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal), q, k, v)
            memo[causal, head_dim] = (np.asarray(out), [np.asarray(g) for g in vjp(cot)])
        return memo[causal, head_dim]

    return get


def _padded(t, head_dim=256):
    return torch.nn.functional.pad(t, (0, head_dim - t.shape[-1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("head_dim", [129, 192, 255])
def test_kernel_layout_pads_wide_heads_to_256(head_dim, dtype):
    """head_dim 129-255 runs the head_dim-256 instances on zero columns,
    in the input's dtype where a kernel is built for it (float16 in
    float32, as below 128)."""
    want = dtype if dtype != torch.float16 else torch.float32
    assert ops.kernel_layout(head_dim, dtype) == (256, want)
    assert attention_cuda.HEAD_DIMS == (32, 64, 128, 256) and attention_cuda.WIDE == 256


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_tiles_at_head_dim_256(name, dtype):
    """Each head_dim-256 instance's tiling: bf16 K1 and K2 128 query rows
    (two warpgroups) against 64 keys, K3 64 query rows against 64 keys;
    float32 K1 and K2 32 query rows (a stacked tile) against 16 keys, K3
    16 query rows against 32 keys (stacked)."""
    assert attention_cuda.kernel_tiles(name, dtype, 256) == WIDE_TILES[dtype][name]


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("head_dim", [256, 192])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_at_the_wide_tilings_match_jax(jax_wide, causal, head_dim, tiling):
    """``blockwise_reference`` and ``flash_backward_reference`` at a
    head_dim-256 instance's tiling, on the inputs as the kernels take them
    (head_dim 192 padded with zero columns to 256, the scale 1/sqrt(192)),
    equal the JAX package's ``flash_attention`` and its VJP at 1e-5; the
    lse equals a float64 logsumexp of the scaled scores."""
    q, k, v, cot = (torch.from_numpy(a) for a in _inputs(head_dim))
    scale = 1.0 / math.sqrt(head_dim)
    padded = [_padded(t) for t in (q, k, v, cot)]
    o, lse = ops.blockwise_reference(*padded[:3], causal, *tiling, scale=scale)
    grads = ops.flash_backward_reference(*padded[:3], o, lse, padded[3], causal, *tiling,
                                         scale=scale)
    want_o, want_grads = jax_wide(causal, head_dim)
    assert torch.equal(o[..., head_dim:], torch.zeros_like(o[..., head_dim:]))
    np.testing.assert_allclose(o[..., :head_dim].numpy(), want_o, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, want_grads):
        assert torch.equal(got[..., head_dim:], torch.zeros_like(got[..., head_dim:]))
        np.testing.assert_allclose(got[..., :head_dim].numpy(), want, atol=1e-5, rtol=1e-5)
    scores = np.einsum("bhqd,bhkd->bhqk", q.double().numpy(), k.double().numpy()) * scale
    if causal:
        scores = np.where(np.tril(np.ones((SHAPE[2],) * 2, bool)), scores, -np.inf)
    peak = scores.max(axis=-1, keepdims=True)
    want_lse = (peak + np.log(np.exp(scores - peak).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)


def _stand_in_kernels(monkeypatch, seen):
    """K1-K3 stood in by their plain versions at the instance's tiling and
    the scale they are given; ``seen`` records each call's (name, shape,
    dtype, scale)."""

    def fwd(q, k, v, causal, scale):
        seen.append(("fwd", tuple(q.shape), q.dtype, scale))
        tiles = attention_cuda.kernel_tiles("flash_fwd", q.dtype, q.shape[-1])
        return ops.blockwise_reference(q, k, v, causal, *tiles, scale=scale)

    def bwd(name, index):
        def launch(q, k, v, do, lse, delta, causal, scale):
            seen.append((name, tuple(q.shape), q.dtype, scale))
            tiles = attention_cuda.kernel_tiles(name, q.dtype, q.shape[-1])
            o = ops.blockwise_reference(q, k, v, causal, scale=scale)[0]
            grads = ops.flash_backward_reference(q, k, v, o, lse, do, causal, *tiles,
                                                 scale=scale)
            return grads[index]
        return launch

    monkeypatch.setattr(attention_cuda, "flash_fwd", fwd)
    monkeypatch.setattr(attention_cuda, "flash_bwd_dq", bwd("flash_dq", 0))
    monkeypatch.setattr(attention_cuda, "flash_bwd_dkv", bwd("flash_dkv", slice(1, None)))


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_flash_attention_takes_head_dim_192_to_the_256_instances(monkeypatch, dtype, atol):
    """Where the rule sends a head_dim-192 input to the kernels, the
    autograd Function hands K1-K3 inputs padded to 256 at the caller's
    scale and returns o and the gradients at 192: the plain version's on
    the caller's inputs (the kernels stood in by their plain versions)."""
    seen = []
    _stand_in_kernels(monkeypatch, seen)
    monkeypatch.setattr(ops, "use_kernels", lambda *a: True)
    q, k, v, cot = (torch.from_numpy(a).to(dtype) for a in _inputs(192))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, True)
    got = torch.autograd.grad(out, leaves, cot)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_out = ops.blockwise_reference(*plain, True)[0]
    ref = torch.autograd.grad(ref_out, plain, cot)
    scale = 1.0 / math.sqrt(192)
    assert seen == [(n, (*SHAPE, 256), dtype, scale) for n in ("fwd", "flash_dq", "flash_dkv")]
    assert out.shape == (*SHAPE, 192) and out.dtype == dtype
    torch.testing.assert_close(out, ref_out, rtol=0, atol=atol)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == dtype
        torch.testing.assert_close(g, r, rtol=0, atol=atol * max(1.0, r.abs().max().item()))


def test_hop_helpers_take_head_dim_256_to_the_kernels(monkeypatch, jax_wide):
    """The ring's hop helpers route a head_dim-256 input to K1 and to K2
    with K3 where the rule sends it there, at the caller's scale; given
    the whole softmax's o and lse (one hop here), their gradients are the
    JAX package's VJP."""
    seen = []
    _stand_in_kernels(monkeypatch, seen)
    monkeypatch.setattr(ops, "use_kernels", lambda *a: True)
    q, k, v, cot = (torch.from_numpy(a) for a in _inputs(256))
    o, lse = ops.flash_attention_fwd(q, k, v, True)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, cot, (cot * o).sum(-1), True)
    want_o, want_grads = jax_wide(True, 256)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert [s[:3] for s in seen] == [(n, (*SHAPE, 256), torch.float32)
                                     for n in ("fwd", "flash_dq", "flash_dkv")]
    assert {s[3] for s in seen} == {1 / 16}


# A small LM whose heads are 256 wide: d_model 512 over 2 heads.
LM = dict(vocab_size=512, d_model=512, num_heads=2, num_layers=2, max_seq_len=64)
ADAM = {"name": "adam", "learning_rate": 1e-3}


@pytest.fixture(scope="module")
def wide_lm():
    """The JAX LM (``attention='flash'``, its blockwise path off the TPU)
    with its flax init, and a seeded batch of 4 x 64 tokens."""
    jm = JaxCompiledModel(jax_get_model("transformer_lm", attention="flash", **LM),
                          optimizer=ADAM, loss="sparse_categorical_crossentropy",
                          metrics=["acc"], input_shape=(16,), input_dtype=jnp.int32, seed=0)
    tokens = np.random.default_rng(19).integers(0, LM["vocab_size"], (4, 65)).astype(np.int32)
    return jm, jax.device_get(jm.params), tokens[:, :-1], tokens[:, 1:]


def _port(params):
    module = get_model("transformer_lm", attention="flash", device="cpu", **LM)
    return CompiledModel(module, from_flax_params(params, module), optimizer=ADAM,
                         loss="sparse_categorical_crossentropy", metrics=["acc"])


def test_head_dim_256_lm_logits_and_gradients_match_jax(wide_lm):
    """The JAX parameters carried across (``from_flax_params``): logits
    within 1e-5, the loss within 1e-5 relative and every gradient within
    1e-5 of the larger of 1 and its largest entry (the key third of each
    qkv bias left out: its exact gradient is 0, so both sides hold
    rounding noise)."""
    jm, params, x, y = wide_lm
    state = jax_step.init_train_state(jm)
    pm = _port(params)
    assert pm.module.d_model // pm.module.num_heads == 256
    want_logits = np.asarray(jm.apply_eval(params, state.batch_stats, jnp.asarray(x)))
    np.testing.assert_allclose(pm.apply_eval(torch.from_numpy(x)).detach().numpy(),
                               want_logits, atol=1e-5)
    loss_fn = jax_step.make_loss_fn(jm)
    want_loss, want_grads = jax.value_and_grad(lambda p: loss_fn(
        p, state.batch_stats, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))[0])(params)
    loss, _ = port_step.make_loss_fn(pm)(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = from_flax_params(jax.device_get(want_grads), pm.module)
    for name, p in pm.module.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            third = slice(len(got) // 3, 2 * len(got) // 3)
            got, ref = np.delete(got, third), np.delete(ref, third)
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max()), name


def test_head_dim_256_lm_adam_steps_match_jax(wide_lm):
    """Three Adam steps from the same weights and batch: each step's loss
    and accuracy within 1e-5 relative, as ``tests/test_torch_train.py``
    holds the LM. Then each parameter's change within 1e-3 of the JAX
    run's by norm, and its entries within 1e-5 but for at most 1e-4 of
    them: at this width a few entries' gradients are rounding noise
    (first gradients near 1e-8 against a median near 1e-3), where Adam
    steps by lr times the noise's sign, so those stay within 2 x 3 x lr,
    as the key third of each qkv bias does (its exact gradient is 0)."""
    jm, params, x, y = wide_lm
    jm = JaxCompiledModel(jm.module, params, optimizer=ADAM,
                          loss="sparse_categorical_crossentropy", metrics=["acc"],
                          input_shape=(16,), input_dtype=jnp.int32, seed=0)
    step = jax.jit(jax_step.make_train_step(jm))
    state = jax_step.init_train_state(jm)
    pm = _port(params)
    start = {n: v.clone() for n, v in pm.module.state_dict().items()}
    pstep, pstate = port_step.make_train_step(pm), port_step.init_train_state(pm)
    for _ in range(3):
        state, metrics = step(state, x, y)
        pstate, pmetrics = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
        for key in ("loss", "acc"):
            np.testing.assert_allclose(float(pmetrics[key]), float(metrics[key]), rtol=1e-5)
    want = from_flax_params(jax.device_get(state.params), pm.module)
    noise = 2 * 3 * ADAM["learning_rate"]
    for name, value in pm.module.state_dict().items():
        got, ref, init = value.numpy(), want[name].numpy(), start[name].numpy()
        if name.endswith("attn.qkv.bias"):
            third = slice(len(got) // 3, 2 * len(got) // 3)
            np.testing.assert_allclose(got[third], ref[third], atol=noise, err_msg=name)
            got, ref, init = (np.delete(a, third) for a in (got, ref, init))
        diff = np.abs(got - ref)
        assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref - init), name
        assert (diff > 1e-5).mean() <= 1e-4 and diff.max() <= noise, name


# -- above head_dim 256 -------------------------------------------------------

ABOVE_SHAPE = (1, 2, 128)  # (batch, heads, seq) of the checks above 256
# (query rows, keys) of every instance above 256, K1-K3 alike.
ABOVE_TILES = {torch.bfloat16: (64, 64), torch.float32: (32, 32)}


def _above_inputs(head_dim):
    """q, k, v and the output's cotangent at ``ABOVE_SHAPE``, float32."""
    rng = np.random.default_rng(1000 + head_dim)
    return [rng.standard_normal((*ABOVE_SHAPE, head_dim)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jax_above():
    """The JAX package's output and VJP at (causal, head_dim) above 256,
    computed once."""
    memo = {}

    def get(causal, head_dim):
        if (causal, head_dim) not in memo:
            q, k, v, cot = _above_inputs(head_dim)
            out, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal), q, k, v)
            memo[causal, head_dim] = (np.asarray(out), [np.asarray(g) for g in vjp(cot)])
        return memo[causal, head_dim]

    return get


@pytest.mark.parametrize("tiling", sorted(set(ABOVE_TILES.values())))
@pytest.mark.parametrize("head_dim", [512, 768, 320])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_at_the_tilings_above_256_match_jax(jax_above, causal, head_dim, tiling):
    """``blockwise_reference`` and ``flash_backward_reference`` at the
    tiling of an instance above 256 (bf16 64 x 64, float32 32 x 32), on
    the inputs as the kernels take them (head_dim 320 padded with zero
    columns to 512, the scale 1/sqrt(320)), equal the JAX package's
    ``flash_attention`` and its VJP at 1e-5; the padding stays zero."""
    q, k, v, cot = (torch.from_numpy(a) for a in _above_inputs(head_dim))
    kernel_dim = ops.kernel_layout(head_dim, torch.float32)[0]
    assert kernel_dim == {512: 512, 768: 768, 320: 512}[head_dim]
    assert attention_cuda.wide_chunks(kernel_dim) == kernel_dim // 256
    scale = 1.0 / math.sqrt(head_dim)
    padded = [_padded(t, kernel_dim) for t in (q, k, v, cot)]
    o, lse = ops.blockwise_reference(*padded[:3], causal, *tiling, scale=scale)
    grads = ops.flash_backward_reference(*padded[:3], o, lse, padded[3], causal, *tiling,
                                         scale=scale)
    want_o, want_grads = jax_above(causal, head_dim)
    assert torch.equal(o[..., head_dim:], torch.zeros_like(o[..., head_dim:]))
    np.testing.assert_allclose(o[..., :head_dim].numpy(), want_o, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, want_grads):
        assert torch.equal(got[..., head_dim:], torch.zeros_like(got[..., head_dim:]))
        np.testing.assert_allclose(got[..., :head_dim].numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [512, 768])
def test_kernel_tiles_above_256(name, dtype, head_dim):
    """Every instance above 256 tiles as one: bf16 64 fixed rows against
    64-row tiles, float32 32 (a stacked operand) against 32, K1-K3 alike,
    at every multiple of 256; 384 is no multiple of 256."""
    assert attention_cuda.kernel_tiles(name, dtype, head_dim) == ABOVE_TILES[dtype]
    with pytest.raises(ValueError, match=f"no {name} kernel"):
        attention_cuda.kernel_tiles(name, dtype, 384)


class _CudaLike:
    """What ``attention_cuda._check`` reads of a CUDA tensor, without a card."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.float32):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


@pytest.mark.parametrize("head_dim, takes", [(512, True), (768, True), (384, False),
                                             (100, False)])
def test_c_wrappers_take_multiples_of_256(head_dim, takes):
    """The wrappers' checks take head_dim 32, 64, 128, 256 and every
    multiple of 256 above it, and refuse 384 and 100 (padding to them is
    ``kernel_layout``'s work); K3, two blocks a chunk (dV and dK), refuses
    more chunks than the grid's z dimension holds where K1 and K2 still
    take them."""
    t = _CudaLike((1, 2, 64, head_dim))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if takes:
            attention_cuda._check(name, t, t, t)
        else:
            with pytest.raises(ValueError, match="multiple of 256"):
                attention_cuda._check(name, t, t, t)
    widest = _CudaLike((1, 1, 8, 256 * (attention_cuda.MAX_GRID_Z // 2 + 1)))
    attention_cuda._check("flash_fwd", widest, widest, widest)
    attention_cuda._check("flash_bwd_dq", widest, widest, widest)
    with pytest.raises(ValueError, match="z dimension"):
        attention_cuda._check("flash_bwd_dkv", widest, widest, widest)


# A small LM whose heads are 512 wide: d_model 512 in one head.
LM_512 = dict(vocab_size=512, d_model=512, num_heads=1, num_layers=2, max_seq_len=64)


@pytest.fixture(scope="module")
def wide_lm_512():
    """The JAX LM with heads of 512 (``attention='flash'``, its blockwise
    path off the TPU), its flax init, and a seeded batch of 4 x 64 tokens."""
    jm = JaxCompiledModel(jax_get_model("transformer_lm", attention="flash", **LM_512),
                          optimizer=ADAM, loss="sparse_categorical_crossentropy",
                          metrics=["acc"], input_shape=(16,), input_dtype=jnp.int32, seed=0)
    tokens = np.random.default_rng(25).integers(0, LM_512["vocab_size"], (4, 65)).astype(np.int32)
    return jm, jax.device_get(jm.params), tokens[:, :-1], tokens[:, 1:]


def _port_512(params):
    module = get_model("transformer_lm", attention="flash", device="cpu", **LM_512)
    return CompiledModel(module, from_flax_params(params, module), optimizer=ADAM,
                         loss="sparse_categorical_crossentropy", metrics=["acc"])


def test_head_dim_512_lm_logits_and_gradients_match_jax(wide_lm_512):
    """The JAX parameters carried across (``from_flax_params``): logits
    within 1e-5, the loss within 1e-5 relative and every gradient within
    1e-5 of the larger of 1 and its largest entry (the key third of each
    qkv bias left out: its exact gradient is 0)."""
    jm, params, x, y = wide_lm_512
    state = jax_step.init_train_state(jm)
    pm = _port_512(params)
    assert pm.module.d_model // pm.module.num_heads == 512
    assert ops.kernel_layout(512, torch.float32) == (512, torch.float32)
    want_logits = np.asarray(jm.apply_eval(params, state.batch_stats, jnp.asarray(x)))
    np.testing.assert_allclose(pm.apply_eval(torch.from_numpy(x)).detach().numpy(),
                               want_logits, atol=1e-5)
    loss_fn = jax_step.make_loss_fn(jm)
    want_loss, want_grads = jax.value_and_grad(lambda p: loss_fn(
        p, state.batch_stats, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))[0])(params)
    loss, _ = port_step.make_loss_fn(pm)(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = from_flax_params(jax.device_get(want_grads), pm.module)
    for name, p in pm.module.named_parameters():
        got, ref = p.grad.numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            third = slice(len(got) // 3, 2 * len(got) // 3)
            got, ref = np.delete(got, third), np.delete(ref, third)
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max()), name


def test_head_dim_512_lm_adam_steps_match_jax(wide_lm_512):
    """Three Adam steps from the same weights and batch: each step's loss
    and accuracy within 1e-5 relative (``tests/test_torch_train.py``'s LM
    limit), then each parameter's change within 1e-3 of the JAX run's by
    norm and its entries within 1e-5 but for at most 1e-4 of them, whose
    gradients are rounding noise that Adam steps by lr times its sign
    (within 2 x 3 x lr), as the key third of each qkv bias is."""
    jm, params, x, y = wide_lm_512
    jm = JaxCompiledModel(jm.module, params, optimizer=ADAM,
                          loss="sparse_categorical_crossentropy", metrics=["acc"],
                          input_shape=(16,), input_dtype=jnp.int32, seed=0)
    step = jax.jit(jax_step.make_train_step(jm))
    state = jax_step.init_train_state(jm)
    pm = _port_512(params)
    start = {n: v.clone() for n, v in pm.module.state_dict().items()}
    pstep, pstate = port_step.make_train_step(pm), port_step.init_train_state(pm)
    for _ in range(3):
        state, metrics = step(state, x, y)
        pstate, pmetrics = pstep(pstate, torch.from_numpy(x), torch.from_numpy(y))
        for key in ("loss", "acc"):
            np.testing.assert_allclose(float(pmetrics[key]), float(metrics[key]), rtol=1e-5)
    want = from_flax_params(jax.device_get(state.params), pm.module)
    noise = 2 * 3 * ADAM["learning_rate"]
    for name, value in pm.module.state_dict().items():
        got, ref, init = value.numpy(), want[name].numpy(), start[name].numpy()
        if name.endswith("attn.qkv.bias"):
            third = slice(len(got) // 3, 2 * len(got) // 3)
            np.testing.assert_allclose(got[third], ref[third], atol=noise, err_msg=name)
            got, ref, init = (np.delete(a, third) for a in (got, ref, init))
        diff = np.abs(got - ref)
        assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref - init), name
        assert (diff > 1e-5).mean() <= 1e-4 and diff.max() <= noise, name
