"""Parity of the port's Transformer LM (``elephas_tpu_torch``) with the JAX
package's on the CPU: weight bridge, full forward, greedy ``generate``,
sampling and the scoring losses. Small model, same weights on both sides
(flax init, converted by ``from_flax_params``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.engine.losses import LOSSES as JAX_LOSSES
from elephas_tpu.engine.losses import METRICS as JAX_METRICS
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.models.transformer import generate as jax_generate
from elephas_tpu.models.transformer import left_pad_prompts as jax_left_pad
from elephas_tpu_torch.api import CompiledModel
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.models.transformer import (
    generate,
    left_pad_prompts,
    make_decode_cache,
    sample_tokens,
)

VOCAB = 97
SMALL = dict(vocab_size=VOCAB, d_model=32, num_heads=4, num_layers=2, max_seq_len=64)
PROMPTS = [[5, 3, 9, 41, 7], [12, 60, 2], [8, 8, 1, 90, 33, 17, 4, 29, 51]]


def _jax_compiled(attention="dense", params=None, dtype="float32"):
    return JaxCompiledModel(
        jax_get_model("transformer_lm", attention=attention, dtype=dtype, **SMALL),
        params,
        loss="sparse_categorical_crossentropy",
        metrics=["acc"],
        input_shape=(16,),
        input_dtype=jnp.int32,
        seed=0,
    )


@pytest.fixture(scope="module")
def jax_model():
    return _jax_compiled()


@pytest.fixture(scope="module")
def flax_params(jax_model):
    return jax.device_get(jax_model.params)


def _port(flax_params, attention="dense"):
    module = get_model("transformer_lm", attention=attention, device="cpu", **SMALL)
    return CompiledModel(module, from_flax_params(flax_params, module),
                         loss="sparse_categorical_crossentropy", metrics=["acc"])


def test_from_flax_params_consumes_every_leaf(flax_params):
    module = get_model("transformer_lm", device="cpu", **SMALL)
    state = from_flax_params(flax_params, module)
    assert set(state) == set(module.state_dict())
    n_flax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(flax_params))
    assert sum(t.numel() for t in state.values()) == n_flax


def _without(tree, path):
    tree = {k: (_without(v, path[1:]) if k == path[0] and len(path) > 1 else v)
            for k, v in tree.items() if not (k == path[0] and len(path) == 1)}
    return tree


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_from_flax_params_rejects_mismatch(flax_params, fault):
    module = get_model("transformer_lm", device="cpu", **SMALL)
    if fault == "missing":
        params, error = _without(flax_params, ("Block_1", "Dense_0", "bias")), KeyError
    elif fault == "extra":
        params, error = {**flax_params, "Block_2": flax_params["Block_1"]}, KeyError
    else:
        params = {**flax_params, "pos_embed": np.zeros((32, 32), np.float32)}
        error = ValueError
    with pytest.raises(error):
        from_flax_params(params, module)


@pytest.mark.parametrize("seq", [40, 64])
@pytest.mark.parametrize("attention", ["dense", "flash", "auto"])
def test_forward_logits_match_jax(flax_params, attention, seq):
    jm = _jax_compiled(attention, flax_params)
    tokens = np.random.default_rng(seq).integers(0, VOCAB, (2, seq)).astype(np.int32)
    want = np.asarray(jm.apply_eval(flax_params, {}, tokens))
    got = _port(flax_params, attention).apply_eval(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_bf16_forward_tracks_jax(flax_params):
    """bf16 models: Dense layers in bf16 on float32 params, LayerNorms and
    the head in float32. The two frameworks round bf16 at other places, so
    the check is loose: logits within 0.05 of the JAX model's (their scale
    is about 1)."""
    jm = _jax_compiled("flash", flax_params, dtype="bfloat16")
    tokens = np.random.default_rng(3).integers(0, VOCAB, (2, 48)).astype(np.int32)
    want = np.asarray(jm.apply_eval(flax_params, {}, tokens))
    module = get_model("transformer_lm", dtype="bfloat16", attention="flash",
                       device="cpu", **SMALL)
    got = CompiledModel(module, from_flax_params(flax_params, module)).apply_eval(
        torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


@pytest.fixture(scope="module")
def jax_greedy(jax_model):
    return jax_generate(jax_model, PROMPTS, 12)


def test_generate_greedy_matches_jax(flax_params, jax_greedy):
    got = generate(_port(flax_params), PROMPTS, 12)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_greedy)


def test_generate_stop_token_matches_jax(jax_model, flax_params, jax_greedy):
    # The stop token is a token of row 0's stream taken at its first
    # occurrence after step 0, so the freeze starts mid-stream.
    new = jax_greedy[0, 9:]
    step = next(i for i in range(1, len(new)) if new[i] not in new[:i])
    stop = int(new[step])
    want = jax_generate(jax_model, PROMPTS, 12, stop_token=stop)
    got = generate(_port(flax_params), PROMPTS, 12, stop_token=stop)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 9 + step:] == stop).all()
    assert not (got[0, 9:9 + step] == stop).any()


def test_left_pad_prompts_matches_jax():
    got, got_len = left_pad_prompts(PROMPTS, pad_token=3)
    want, want_len = jax_left_pad(PROMPTS, pad_token=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    with pytest.raises(ValueError):
        left_pad_prompts([[1, 2], []])


def test_decode_cache_matches_full_forward(flax_params):
    """Prefill plus one-token steps reproduce the full forward's logits."""
    cm = _port(flax_params)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, VOCAB, (2, 20)).astype(np.int64))
    full = cm.apply_eval(tokens)
    cache = make_decode_cache(cm.module, 2, 20)
    with torch.no_grad():
        steps = [cm.module(tokens[:, :8], cache=cache)]
        steps += [cm.module(tokens[:, t:t + 1], cache=cache) for t in range(8, 20)]
    assert cache.index == 20
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), full.numpy(),
                               atol=1e-4)


def test_ragged_prefill_logits_match_jax(jax_model, flax_params):
    """The decode path's prefill over a left-padded batch, at every column
    (pad columns included: their queries see no key and are zeroed)."""
    import dataclasses

    from elephas_tpu.models.transformer import make_decode_cache as jax_cache

    padded, lengths = left_pad_prompts(PROMPTS)
    pad_offset = padded.shape[1] - lengths
    decode = dataclasses.replace(jax_model.module, decode=True, attention="dense")
    want, _ = decode.apply(
        {"params": flax_params, "cache": jax_cache(decode, len(PROMPTS), 16)},
        jnp.asarray(padded), mutable=["cache"], pad_offset=jnp.asarray(pad_offset))
    cm = _port(flax_params)
    with torch.no_grad():
        got = cm.module(torch.from_numpy(padded),
                        cache=make_decode_cache(cm.module, len(PROMPTS), 16),
                        pad_offset=torch.from_numpy(pad_offset).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_decode_per_row_index_matches_rows_alone(flax_params):
    """Per-row cache columns (the serving layout): two rows at different
    depths take one step together and match each row decoded alone."""
    cm = _port(flax_params)
    rows = [np.array([4, 9, 22, 7, 1], np.int64), np.array([30, 2, 11], np.int64)]
    nxt = torch.tensor([[13], [44]])
    alone = []
    for r, tok in zip(rows, nxt):
        cache = make_decode_cache(cm.module, 1, 8)
        with torch.no_grad():
            cm.module(torch.from_numpy(r)[None], cache=cache)
            alone.append(cm.module(tok[None], cache=cache)[0, 0])
    cache = make_decode_cache(cm.module, 2, 8)
    with torch.no_grad():
        for i, r in enumerate(rows):  # fill each row at its own depth
            one = make_decode_cache(cm.module, 1, 8)
            cm.module(torch.from_numpy(r)[None], cache=one)
            for dst, src in zip(cache.keys + cache.values, one.keys + one.values):
                dst[i] = src[0]
        cache.index = torch.tensor([len(r) for r in rows])
        together = cm.module(nxt, cache=cache)[:, 0]
    assert cache.index.tolist() == [6, 4]
    np.testing.assert_allclose(together.numpy(), torch.stack(alone).numpy(), atol=1e-5)


def test_sample_tokens_top_k_in_top_k_and_seeded():
    logits = torch.from_numpy(
        np.random.default_rng(9).standard_normal((4, VOCAB)).astype(np.float32))
    top = torch.topk(logits, 5, dim=-1).indices

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([sample_tokens(logits, g, False, 5, 0.8) for _ in range(50)])

    a, b = draw(11), draw(11)
    assert torch.equal(a, b)
    assert not torch.equal(a, draw(12))
    assert all(bool((top[r] == a[:, r, None]).any(dim=-1).all()) for r in range(4))
    assert torch.equal(sample_tokens(logits, None, True, 0, 1.0), logits.argmax(-1))


def test_generate_sampled_is_seeded(flax_params):
    cm = _port(flax_params)
    a = generate(cm, PROMPTS, 10, temperature=0.7, top_k=8, seed=4)
    b = generate(cm, PROMPTS, 10, temperature=0.7, top_k=8, seed=4)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < VOCAB)).all()


def test_apply_eval_losses_match_jax(jax_model, flax_params):
    tokens = np.random.default_rng(2).integers(0, VOCAB, (3, 33)).astype(np.int32)
    x, y = tokens[:, :-1], tokens[:, 1:]
    jlogits = jax_model.apply_eval(flax_params, {}, x)
    cm = _port(flax_params)
    logits = cm.apply_eval(torch.from_numpy(x))
    yt = torch.from_numpy(y)
    np.testing.assert_allclose(
        cm.loss_fn(logits, yt).mean().item(),
        float(JAX_LOSSES["sparse_categorical_crossentropy"](jlogits, y).mean()),
        atol=1e-5)
    np.testing.assert_allclose(
        cm.metric_fns[0](logits, yt).mean().item(),
        float(JAX_METRICS["acc"](jlogits, y).mean()), atol=1e-5)


def test_compiled_model_weights_and_counts(jax_model, flax_params):
    cm = _port(flax_params)
    assert cm.count_params() == jax_model.count_params()
    weights = cm.get_weights()
    other = CompiledModel(get_model("transformer_lm", device="cpu", **SMALL), seed=1)
    assert not torch.equal(other.get_weights()["lm_head.weight"], weights["lm_head.weight"])
    other.set_weights(weights)
    assert all(torch.equal(other.get_weights()[k], v) for k, v in weights.items())
    assert cm.model_config == {"name": "transformer_lm",
                               "kwargs": {"attention": "dense", "device": "cpu", **SMALL}}


def test_seeded_init_is_reproducible():
    a = CompiledModel(get_model("transformer_lm", device="cpu", **SMALL), seed=3)
    b = CompiledModel(get_model("transformer_lm", device="cpu", **SMALL), seed=3)
    assert all(torch.equal(v, b.get_weights()[k]) for k, v in a.get_weights().items())


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_sequence_parallel_attention_not_ported(attention):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("transformer_lm", attention=attention, device="cpu", **SMALL)
