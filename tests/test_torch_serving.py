"""The port's serving engine (``elephas_tpu_torch.serving``) against the
JAX package's (``elephas_tpu.serving``), on the same weights and the same
scripted traffic.

The reference tests' model (vocab 97, d_model 32, 4 heads, 2 layers,
max_seq_len 64, seed 0) is carried across with ``convert.from_flax_params``.
Greedy streams must be token-identical; where two differ, the JAX model's
top-2 logit gap at the first differing position must be below 1e-4 (a
near-tie that float rounding may break either way), or the test fails.
Sampled streams cannot match across packages (threefry against the
port's counter-based draw), so temperature is held within the port:
every pair of paths must give the same stream.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.models.transformer import generate as jax_generate
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving import QueueFull as JaxQueueFull
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.models.transformer import (
    DecodeCache,
    generate,
    make_decode_cache,
    make_paged_decode_cache,
    sample_tokens_at,
)
from elephas_tpu_torch.serving import (
    DonatedBufferError,
    InferenceEngine,
    QueueFull,
    ServingMetrics,
)
from elephas_tpu_torch.serving import engine as engine_mod

VOCAB, SEQ = 97, 64
NEAR_TIE = 1e-4


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _jax_compiled(seed=0):
    return JaxCompiledModel(
        jax_get_model("transformer_lm", vocab_size=VOCAB, d_model=32,
                      num_heads=4, num_layers=2, max_seq_len=SEQ),
        optimizer={"name": "adam", "learning_rate": 3e-3},
        loss="sparse_categorical_crossentropy", metrics=[],
        input_shape=(SEQ,), input_dtype=jnp.int32, seed=seed,
    )


def _port_module():
    return get_model("transformer_lm", device="cpu", vocab_size=VOCAB,
                     d_model=32, num_heads=4, num_layers=2, max_seq_len=SEQ)


@pytest.fixture(scope="module")
def models():
    """(JAX compiled model, port module, the JAX weights as a state_dict)."""
    jc = _jax_compiled()
    module = _port_module()
    sd = from_flax_params(jax.tree_util.tree_map(np.asarray, jc.params), module)
    module.load_state_dict(sd)
    return jc, module, sd


def _kw(**kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_len", 24)
    kw.setdefault("queue_depth", 8)
    return kw


def _run(engine, script):
    """Drive ``script`` — ``("submit", tag, prompt, kwargs)`` /
    ``("step", n)`` / ``("advance", dt)`` / ``("drain",)`` — and return
    the results by tag, plus the prompts by tag."""
    rids, prompts = {}, {}
    for op in script:
        if op[0] == "submit":
            _, tag, prompt, skw = op
            rids[tag] = engine.submit(prompt, **skw)
            prompts[tag] = prompt
        elif op[0] == "step":
            for _ in range(op[1]):
                engine.step()
        elif op[0] == "advance":
            engine.clock.advance(op[1])
        elif op[0] == "drain":
            engine.run_until_drained()
    results = {tag: engine.result(rid, timeout_s=120) for tag, rid in rids.items()}
    return results, prompts


def _both(models, script, fake_clock=False, **kw):
    """The same script through the JAX engine and the port's."""
    jc, module, _ = models
    out = []
    for make in (lambda k: JaxEngine(jc, **k), lambda k: InferenceEngine(module, **k)):
        k = _kw(**kw)
        if fake_clock:
            k["clock"] = FakeClock()
        engine = make(k)
        results, prompts = _run(engine, script)
        out.append((engine, results))
    (jeng, jres), (teng, tres) = out
    return jeng, jres, teng, tres, prompts


def _top2_gap(jc, context):
    logits = np.asarray(jc.module.apply({"params": jc.params},
                                        jnp.asarray([context], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _assert_streams_match(jc, prompts, jres, tres):
    """Equal statuses and tokens, except from a JAX near-tie on."""
    assert jres.keys() == tres.keys()
    for tag in jres:
        assert jres[tag].status == tres[tag].status, tag
        a, b = jres[tag].tokens, tres[tag].tokens
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        assert k is not None, f"{tag}: one stream is a prefix of the other: {a} {b}"
        gap = _top2_gap(jc, list(prompts[tag]) + a[:k])
        assert gap < NEAR_TIE, (
            f"request {tag!r} differs at token {k} ({a} vs {b}) with a JAX "
            f"top-2 gap of {gap}, not a near-tie")


# Mixed ragged prompts: more requests than slots (slot reuse after
# eviction), arrivals mid-decode, and two prompts sharing a 4-token
# prefix (prefix hits at kv_block_size 4).
SCRIPT = [
    ("submit", "a", [5, 3, 9], {"max_new_tokens": 10}),
    ("submit", "b", [1, 2, 3, 4, 5, 6, 7], {"max_new_tokens": 10}),
    ("submit", "c", [11, 12], {"max_new_tokens": 6}),
    ("submit", "d", [20, 21, 22, 23, 24], {"max_new_tokens": 8}),
    ("step", 3),
    ("submit", "e", [7, 8, 9, 10, 1, 2], {"max_new_tokens": 6}),
    ("step", 2),
    ("submit", "f", [7, 8, 9, 10, 3, 4, 5], {"max_new_tokens": 5}),
    ("drain",),
    ("submit", "g", [7, 8, 9, 10, 1, 2, 40, 41], {"max_new_tokens": 7}),
    ("drain",),
]

CONFIGS = {
    "paged": dict(),
    "contiguous": dict(paged=False),
    "block4": dict(kv_block_size=4),
    "block5": dict(kv_block_size=5),
    "chunk3": dict(kv_block_size=4, prefill_chunk=3),
    "chunk3_budget1": dict(kv_block_size=4, prefill_chunk=3, prefill_chunks_per_step=1),
    "chunk2_budget2": dict(kv_block_size=4, prefill_chunk=2, prefill_chunks_per_step=2),
    "chunk1_budget1": dict(kv_block_size=4, prefill_chunk=1, prefill_chunks_per_step=1),
    "sync": dict(pipeline=False),
    "sync_block4_chunk3": dict(pipeline=False, kv_block_size=4, prefill_chunk=3,
                               prefill_chunks_per_step=1),
    "contiguous_sync": dict(paged=False, pipeline=False),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_streams_match_jax_engine(models, name):
    jeng, jres, teng, tres, prompts = _both(models, SCRIPT, **CONFIGS[name])
    _assert_streams_match(models[0], prompts, jres, tres)
    jst, tst = jeng.stats(), teng.stats()
    assert tst["prefill_traces"] == tst["decode_traces"] == 1
    for key in ("completed", "tokens_out", "pool_admitted_total", "pool_free",
                "prefix_hits", "prefix_lookups", "prefix_tokens_saved",
                "kv_blocks_free", "kv_blocks_total"):
        assert tst.get(key) == jst.get(key), key
    if name in ("block4", "chunk3", "chunk3_budget1"):
        assert tst["prefix_hits"] >= 1
    if teng.paged:
        teng.pool.assert_block_invariants()


def test_deadline_eviction_in_queue_and_decode_matches_jax(models):
    """Fake-clock deadlines: one request evicted mid-decode, one expiring
    in the queue, in both packages: the same statuses and tokens."""
    script = [
        ("submit", "doomed", [5, 3, 9], {"max_new_tokens": 1000, "timeout_s": 5.0}),
        ("submit", "healthy", [7, 2], {"max_new_tokens": 4}),
        ("submit", "queued", [3, 4], {"max_new_tokens": 5, "timeout_s": 2.0}),
    ]
    for _ in range(7):
        script += [("advance", 1.0), ("step", 1)]
    script += [("drain",)]
    for pipeline in (True, False):
        _, jres, teng, tres, prompts = _both(models, script, fake_clock=True,
                                             max_slots=2, max_len=40,
                                             pipeline=pipeline)
        _assert_streams_match(models[0], prompts, jres, tres)
        assert tres["doomed"].status == "timeout"
        assert 0 < len(tres["doomed"].tokens) < 1000
        assert tres["queued"].status == "timeout" and tres["queued"].tokens == []
        assert teng.pool.free_count == teng.pool.max_slots


def test_deadline_eviction_mid_prefill_matches_jax(models):
    """A request parked mid-chunked-prefill (a one-chunk budget starves
    it) expires and returns its blocks, as in the reference."""
    script = [
        ("submit", "busy", [1, 2], {"max_new_tokens": 12}),
        ("step", 1),
        ("submit", "doomed", [3, 4, 5, 6, 7, 8], {"max_new_tokens": 5, "timeout_s": 1.0}),
        ("step", 1),
        ("advance", 3.0),
        ("drain",),
    ]
    jeng, jres, teng, tres, prompts = _both(
        models, script, fake_clock=True, max_slots=2, kv_block_size=4,
        prefill_chunk=1, prefill_chunks_per_step=1)
    _assert_streams_match(models[0], prompts, jres, tres)
    assert tres["doomed"].status == "timeout" and tres["doomed"].tokens == []
    assert tres["busy"].status == "completed"
    assert teng.pool.free_count == teng.pool.max_slots
    assert teng.pool.free_blocks == jeng.pool.free_blocks
    teng.pool.assert_block_invariants()


def test_queue_full_backpressure_matches_jax(models, monkeypatch):
    """Overload rejects with the reference's retry_after; draining
    reopens admission; submit_with_retry gives up after bounded
    backoff."""
    jc, module, _ = models
    hints = []
    for engine, full in ((JaxEngine(jc, **_kw(max_slots=1, queue_depth=2)), JaxQueueFull),
                         (InferenceEngine(module, **_kw(max_slots=1, queue_depth=2)),
                          QueueFull)):
        engine.submit([1, 2], max_new_tokens=2)
        engine.submit([3, 4], max_new_tokens=2)
        with pytest.raises(full) as exc:
            engine.submit([5, 6], max_new_tokens=2)
        hints.append((exc.value.retry_after, engine.stats()["rejected"]))
    assert hints[0] == hints[1] and hints[1][0] > 0
    monkeypatch.setattr(engine_mod, "_RETRY_DELAYS", (0.0, 0.0))
    with pytest.raises(QueueFull):
        engine.submit_with_retry([5, 6], max_new_tokens=2)  # nobody drains
    engine.run_until_drained()
    assert engine.submit([5, 6], max_new_tokens=2) >= 0
    engine.run_until_drained()


def _first_stop(stream):
    """A stop token and the stream up to its FIRST occurrence."""
    stop = stream[3]
    return stop, stream[:stream.index(stop) + 1]


@pytest.mark.parametrize("kw", [dict(), dict(paged=False), dict(pipeline=False),
                                dict(kv_block_size=4, prefill_chunk=3)],
                         ids=["paged", "contiguous", "sync", "chunked"])
def test_stop_token_completes_at_its_first_occurrence(models, kw):
    jc, module, _ = models
    free = InferenceEngine(module, **_kw(**kw))
    stream = free.result(free.submit([5, 3, 9], max_new_tokens=10)).tokens
    stop, expect = _first_stop(stream)
    for engine in (JaxEngine(jc, **_kw(stop_token=stop, **kw)),
                   InferenceEngine(module, **_kw(stop_token=stop, **kw))):
        res = engine.result(engine.submit([5, 3, 9], max_new_tokens=10))
        assert res.status == "completed"
        assert res.tokens == expect


def test_last_column_chunk_writes_where_the_reference_writes(models):
    """A chunk that starts at the last prompt column (prompt 8, chunk 7:
    chunks at columns 0 and 7) writes its 7 columns into the virtual row
    (``max_prompt_len - 1 + chunk``) exactly where the JAX engine writes:
    the whole block pool agrees after the prefill."""
    jc, module, _ = models
    kw = _kw(kv_block_size=4, prefill_chunk=7, max_slots=2, max_len=10)
    jeng, teng = JaxEngine(jc, **kw), InferenceEngine(module, **kw)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    for engine in (jeng, teng):
        assert engine.pool.virtual_len == 16
        engine.result(engine.submit(prompt, max_new_tokens=1))
    layers = [jeng.pool.cache[f"Block_{i}"]["SelfAttention_0"] for i in range(2)]
    for i in range(2):
        np.testing.assert_allclose(teng.pool.cache.keys[i].numpy(),
                                   np.asarray(layers[i]["cached_key"]), atol=1e-5)
        np.testing.assert_allclose(teng.pool.cache.values[i].numpy(),
                                   np.asarray(layers[i]["cached_value"]), atol=1e-5)
    assert teng.pool.cache.index.tolist() == np.asarray(jeng.pool.cache["pos_index"]).tolist()
    assert (teng.pool.table.rows == jeng.pool.table.rows).all()


def test_generate_params_matches_jax(models):
    """``generate(params=...)`` samples with the given state_dict and
    leaves the module's own weights alone."""
    jc, _, sd = models
    module = _port_module()  # seeded differently from the JAX weights
    before = {k: v.clone() for k, v in module.state_dict().items()}

    class Compiled:
        pass

    compiled = Compiled()
    compiled.module = module
    prompts = [[5, 3, 9], [1, 2, 3, 4]]
    ours = generate(compiled, prompts, 8, params=sd)
    ref = jax_generate(jc, prompts, 8)
    np.testing.assert_array_equal(ours, ref)
    assert all(torch.equal(v, module.state_dict()[k]) for k, v in before.items())


def test_active_mask_needs_per_row_columns(models):
    _, module, _ = models
    cache = make_decode_cache(module, 2, 8)
    with pytest.raises(ValueError, match="per-row"):
        module(torch.tensor([[1], [2]]), cache=cache,
               active=torch.tensor([True, False]))
    cache.index = torch.tensor([3, 5])
    with torch.no_grad():
        module(torch.tensor([[1], [2]]), cache=cache,
               active=torch.tensor([True, False]))
    assert cache.index.tolist() == [4, 5]  # the inactive row froze


def test_paged_decode_cache_layout(models):
    _, module, _ = models
    cache = make_paged_decode_cache(module, max_slots=3, num_blocks=10, block_size=4)
    assert [tuple(k.shape) for k in cache.keys] == [(10, 4, 4, 8)] * 2
    assert [tuple(v.shape) for v in cache.values] == [(10, 4, 4, 8)] * 2
    assert tuple(cache.index.shape) == (3,) and cache.index.dtype == torch.int64


# -- temperature: position-keyed sampling, within the port --------------------


def _sampled(models, **kw):
    _, module, _ = models
    engine = InferenceEngine(module, **_kw(temperature=0.8, top_k=5, seed=11, **kw))
    results, _ = _run(engine, SCRIPT)
    return {tag: r.tokens for tag, r in results.items()}


def test_sample_tokens_at_is_keyed_by_position():
    torch.manual_seed(0)
    logits = torch.randn(4, 50)
    logits[2] = logits[0]
    pos = torch.tensor([3, 9, 3, 12])
    a = sample_tokens_at(logits, 7, pos, False, 10, 0.8)
    # The same (seed, position) draws the same numbers in any batch.
    b = sample_tokens_at(logits[[2, 0]], 7, pos[[2, 0]], False, 10, 0.8)
    assert a[[2, 0]].tolist() == b.tolist()
    assert a[0] == a[2]  # same logits, same position
    draws = {tuple(sample_tokens_at(logits, s, pos, False, 10, 0.8).tolist())
             for s in range(8)}
    assert len(draws) > 1  # the seed matters
    top = torch.topk(logits, 10).indices
    for s in range(8):
        toks = sample_tokens_at(logits, s, pos, False, 10, 0.8)
        assert all(int(t) in top[i].tolist() for i, t in enumerate(toks))
    assert torch.equal(sample_tokens_at(logits, 0, pos, True, 0, 1.0),
                       logits.argmax(-1))


def test_sampling_uniforms_stay_inside_the_open_interval():
    """Every 32-bit lane, the extremes included, maps to a uniform
    strictly inside (0, 1), so every Gumbel is finite and a token outside
    the top-k never wins (a uniform of 1 made a masked lane NaN, which
    argmax took)."""
    from elephas_tpu_torch.models.transformer import _open_uniform, sampling_scores

    bits = torch.cat([torch.arange(0, 1 << 12), (1 << 32) - 1 - torch.arange(0, 1 << 12)])
    u = _open_uniform(bits)
    assert bool((u > 0).all() and (u < 1).all())
    assert torch.isfinite(-torch.log(-torch.log(u))).all()
    logits = torch.randn(64, 500)
    scores = sampling_scores(logits, 3, torch.arange(64), 10, 0.8)
    top = torch.topk(logits, 10).indices
    assert torch.isfinite(scores.gather(1, top)).all()
    assert int(torch.isfinite(scores).sum()) == 64 * 10
    assert not torch.isnan(scores).any()


@pytest.mark.parametrize("pair", [
    (dict(), dict(paged=False)),
    (dict(kv_block_size=4, prefill_chunk=3, prefill_chunks_per_step=1),
     dict(kv_block_size=4)),
    (dict(), dict(pipeline=False)),
    (dict(kv_block_size=4), dict(kv_block_size=4, prefix_cache=False)),
], ids=["paged_vs_contiguous", "chunked_vs_one_shot", "pipelined_vs_sync",
        "prefix_hit_vs_cold"])
def test_temperature_streams_identical_across_paths(models, pair):
    a, b = _sampled(models, **pair[0]), _sampled(models, **pair[1])
    assert a == b


def test_temperature_streams_sample_the_top_k(models):
    _, module, _ = models
    greedy = InferenceEngine(module, **_kw())
    results, prompts = _run(greedy, SCRIPT)
    sampled = _sampled(models)
    assert sampled != {t: r.tokens for t, r in results.items()}
    with torch.no_grad():
        for tag, tokens in sampled.items():
            ctx = torch.tensor([prompts[tag] + tokens])
            logits = module(ctx)[0, len(prompts[tag]) - 1:-1]
            top = torch.topk(logits, 5).indices
            assert all(t in top[i].tolist() for i, t in enumerate(tokens)), tag


# -- the port's own contracts --------------------------------------------------


def test_pool_tensors_keep_their_addresses(models):
    """No step copies the pool: every pool tensor, the block table and
    the parameters keep their storage across a whole run (the reference
    donates instead, so its donation-guard tests have no counterpart:
    ``test_decode_donation_kills_stale_cache_reference``,
    ``test_pool_guard_raises_donated_buffer_error``,
    ``test_engine_never_trips_donation_guard``)."""
    _, module, _ = models
    for kw in (dict(kv_block_size=4, prefill_chunk=3), dict(paged=False)):
        engine = InferenceEngine(module, **_kw(**kw))
        tensors = engine.pool.tensors() + list(engine.module.parameters())
        before = [t.data_ptr() for t in tensors]
        cache = engine.pool.cache
        _run(engine, SCRIPT)
        assert [t.data_ptr() for t in tensors] == before
        assert engine.pool.cache is cache
    assert issubclass(DonatedBufferError, RuntimeError)


def test_stats_keys_match_the_reference(models):
    jc, module, _ = models
    for kw in (dict(), dict(paged=False)):
        keys = []
        for engine in (JaxEngine(jc, **_kw(**kw)), InferenceEngine(module, **_kw(**kw))):
            engine.result(engine.submit([5, 3, 9], max_new_tokens=4))
            keys.append(set(engine.stats()))
        assert keys[0] == keys[1]


def test_install_weights_serves_the_new_weights(models):
    """Weights copied in place: the next streams are the new model's
    (against the JAX engine on those weights), nothing is rebuilt, and
    the parameters keep their addresses."""
    jc, module, sd = models
    jc2 = _jax_compiled(seed=1)
    sd2 = from_flax_params(jax.tree_util.tree_map(np.asarray, jc2.params), module)
    engine = InferenceEngine(module, params=sd, **_kw(kv_block_size=4))
    ptrs = [p.data_ptr() for p in engine.module.parameters()]
    first = engine.result(engine.submit([5, 3, 9], max_new_tokens=8)).tokens
    engine.install_weights(sd2, version=3)
    second = engine.result(engine.submit([5, 3, 9], max_new_tokens=8)).tokens
    ref = JaxEngine(jc2, **_kw(kv_block_size=4))
    assert second == ref.result(ref.submit([5, 3, 9], max_new_tokens=8)).tokens
    assert first != second
    assert [p.data_ptr() for p in engine.module.parameters()] == ptrs
    st = engine.stats()
    assert st["model_version"] == 3 and st["decode_traces"] == 1
    # The caller's module is untouched: the engine serves a copy.
    assert torch.equal(module.lm_head.weight, sd["lm_head.weight"])


PROMPTS = [[5, 3, 9], [7, 2, 8, 4, 1, 6], [11, 12], [1, 2, 3, 4]]


def _greedy(engine, prompts=PROMPTS, new=8):
    ids = [engine.submit(p, max_new_tokens=new) for p in prompts]
    return [engine.result(i, timeout_s=120).tokens for i in ids]


def test_engines_built_from_one_module_own_their_weights(models):
    """Two engines from one module, as the JAX fleet and rollout tests
    build every replica from one ``compiled``: ``install_weights`` on the
    first leaves the second's greedy streams and every parameter bitwise
    as they were (and the caller's module too), while the first serves
    the new weights."""
    jc, module, sd = models
    sd2 = from_flax_params(jax.tree_util.tree_map(np.asarray, _jax_compiled(seed=1).params),
                           module)
    first, second = InferenceEngine(module, **_kw()), InferenceEngine(module, **_kw())
    before = {k: v.clone() for k, v in second.params.items()}
    want = _greedy(second)
    old = _greedy(first)
    first.install_weights(sd2, version=1)
    assert _greedy(first) != old
    assert _greedy(second) == want
    assert all(torch.equal(v, before[k]) for k, v in second.params.items())
    assert all(torch.equal(v, sd[k]) for k, v in module.state_dict().items())
    ptrs = {p.data_ptr() for p in second.module.parameters()}
    assert not ptrs & {p.data_ptr() for p in first.module.parameters()}
    assert not ptrs & {p.data_ptr() for p in module.parameters()}


def test_a_self_draft_reads_its_own_engines_weights(models):
    """The copy comes before the draft binds: a self-draft's layer view
    shares the tensors of its own engine, not the caller's module's."""
    _, module, _ = models
    engine = InferenceEngine(module, speculative=True, gamma=2, draft_layers=1, **_kw())
    own = {p.data_ptr() for p in engine.module.parameters()}
    view = {p.data_ptr() for p in engine.spec.source.module.parameters()}
    assert view and view <= own
    assert not view & {p.data_ptr() for p in module.parameters()}


@pytest.mark.parametrize("speculative", [False, True])
def test_release_frees_a_halted_engines_storage(models, speculative):
    """``release`` frees the storage of a halted engine's pool, decode
    operands and weights (and a speculative decoder's buffers); results
    published before stay claimable, the caller's module is untouched, and
    an engine that still runs refuses."""
    _, module, sd = models
    kw = {"speculative": True, "gamma": 2, "draft_layers": 1} if speculative else {}
    engine = InferenceEngine(module, **_kw(**kw))
    rid = engine.submit([5, 3, 9], max_new_tokens=4)
    engine.run_until_drained()
    with pytest.raises(RuntimeError, match="halt"):
        engine.release()
    engine.halt()
    engine.release()
    engine.release()
    freed = [*engine.pool.tensors(), engine._inputs, engine._out, *engine.module.parameters()]
    if speculative:
        freed += [engine.spec._t0, engine.spec._drafts, engine.spec._out]
    assert all(t.untyped_storage().nbytes() == 0 for t in freed)
    assert engine.result(rid, timeout_s=0.0).status == "completed"
    assert all(torch.equal(v, sd[k]) for k, v in module.state_dict().items())


class _CountingSubscriber:
    def __init__(self):
        self.calls = 0

    def on_step(self, engine):
        self.calls += 1


def _count_boundaries(engine, path):
    """Boundary calls and scheduler steps of ``engine`` on one path: the
    serve loop's ``step()``, ``result()``'s inline steps, or
    ``handoff()``'s inline steps."""
    sub, steps = _CountingSubscriber(), [0]
    engine.subscriber = sub
    real = engine.scheduler.step

    def step():
        steps[0] += 1
        return real()

    engine.scheduler.step = step
    if path == "step":
        ids = [engine.submit(p, max_new_tokens=6) for p in PROMPTS]
        engine.run_until_drained()
        assert all(engine.result(i).status == "completed" for i in ids)
    elif path == "result":
        ids = [engine.submit(p, max_new_tokens=6) for p in PROMPTS]
        assert all(engine.result(i, timeout_s=120).status == "completed" for i in ids)
    else:
        ids = [engine.submit_prefill(p, max_new_tokens=6) for p in PROMPTS]
        assert all(isinstance(engine.handoff(i, timeout_s=120), dict) for i in ids)
    return sub.calls, steps[0]


@pytest.mark.parametrize("path", ["step", "result", "handoff"])
def test_step_boundary_calls_per_step_match_the_jax_engine(models, path):
    """The subscriber hook runs once after every scheduler step on each
    of the engine's three stepping paths, as many times as the JAX
    engine's on the same traffic."""
    jc, module, _ = models
    jax_calls, jax_steps = _count_boundaries(JaxEngine(jc, **_kw()), path)
    calls, steps = _count_boundaries(InferenceEngine(module, **_kw()), path)
    assert calls == steps > 0
    assert (calls, steps) == (jax_calls, jax_steps)


def test_serve_forever_thread(models):
    _, module, _ = models
    engine = InferenceEngine(module, **_kw())
    stop = threading.Event()
    thread = threading.Thread(target=engine.serve_forever, args=(stop,))
    thread.start()
    try:
        rids = [engine.submit(p, max_new_tokens=5) for p in ([5, 3, 9], [7, 2])]
        results = [engine.result(r, timeout_s=60) for r in rids]
    finally:
        stop.set()
        thread.join(timeout=30)
    assert all(r.status == "completed" and len(r.tokens) == 5 for r in results)


def test_cancel_and_halt(models):
    _, module, _ = models
    engine = InferenceEngine(module, **_kw(max_slots=1))
    busy = engine.submit([1, 2], max_new_tokens=3)
    queued = engine.submit([3, 4], max_new_tokens=3)
    engine.step()
    assert engine.cancel(queued)
    assert engine.result(queued).status == "preempted"
    assert not engine.cancel(busy)
    engine.halt()
    assert engine.step() == [] and engine.halted


def test_not_ported_yet_raises_naming_the_roadmap(models):
    """No part of the engine's surface raises naming the ROADMAP any more:
    ``shard_serving`` keeps a weight subscriber (its sharded installs:
    ``tests/test_torch_serving_tp.py``), the canary driver (item 7b)
    attaches and serves ``/canary``, speculative decode and the KV handoff
    (item 7a) answer as the reference does (``tests/test_torch_spec.py``,
    ``tests/test_torch_disagg.py``)."""
    from elephas_tpu_torch.obs import CanaryDriver
    from elephas_tpu_torch.parallel.mesh import Mesh

    _, module, _ = models
    engine = InferenceEngine(module, **_kw())
    driver = CanaryDriver(engine)
    assert engine.canary is driver and engine._canary_doc() == driver.snapshot()
    subscribed = InferenceEngine(module, **_kw())
    sub = subscribed.subscriber = object()
    assert subscribed.shard_serving(Mesh()) is subscribed  # a model axis of 1
    assert subscribed.subscriber is sub
    assert InferenceEngine(module, speculative=True, **_kw()).spec is not None
    for call, error in ((lambda: engine.submit_handoff(b""), ValueError),
                        (lambda: engine.pool.export_blocks(0), ValueError),
                        (lambda: engine.pool.import_blocks(0, [1], []), ValueError)):
        with pytest.raises(error):
            call()
    assert isinstance(engine.handoff(engine.submit_prefill([1, 2], max_new_tokens=2)), dict)
    # The ops endpoint is ported (item 7): it mounts, and unmounts twice.
    ops = engine.mount_ops()
    assert engine.mount_ops() is ops and ops.role == "serving"
    engine.unmount_ops()
    engine.unmount_ops()
    assert engine.ops is None


def test_metrics_summary_and_sink(models, tmp_path):
    """ServingMetrics through the port's JsonlSink: one request line per
    finish and one step line per iteration."""
    import json

    from elephas_tpu_torch.metrics.logging import JsonlSink

    _, module, _ = models
    path = tmp_path / "serve.jsonl"
    sink = JsonlSink(str(path))
    engine = InferenceEngine(module, sink=sink, **_kw())
    engine.result(engine.submit([5, 3, 9], max_new_tokens=4))
    engine.run_until_drained()
    sink.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    events = [line["event"] for line in lines]
    assert events.count("request") == 1 and "step" in events
    summary = engine.metrics.summary()
    assert summary["completed"] == 1 and summary["tokens_out"] == 4
    assert summary["ttft_s_p50"] is not None
    assert isinstance(engine.metrics, ServingMetrics)


def test_decode_cache_defaults_to_shared_column(models):
    _, module, _ = models
    cache = DecodeCache(keys=[], values=[])
    assert cache.index == 0
