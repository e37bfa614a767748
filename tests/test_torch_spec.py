"""Speculative decoding in the port (``elephas_tpu_torch.serving.spec``)
against plain decode and against the JAX package's.

The reference tests' model (vocab 97, d_model 32, 4 heads, 2 layers,
max_seq_len 64, seed 0) is carried across with ``convert.from_flax_params``.
Port against port: with ``speculative=True`` the engine serves every
request through one draft and one verify program and its streams equal
plain decode's, greedy and sampled, across chunked prefill, gamma, EOS,
deadline evictions, draft-pull failures and paged-pool churn — except at
a token where plain decode's top-2 gap is below 1e-4 (a near-tie that
rounding between a one-column and a gamma + 1 column forward may break
either way); each such tie is named in the assertion message. Port
against the JAX package: greedy speculative streams equal the JAX
engine's unless its top-2 gap is below 1e-4, and ``scatter_spec_columns``
equals the reference's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.ops import attention as jax_attention
from elephas_tpu.serving import DraftModelSource as JaxDraftModelSource
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from elephas_tpu_torch import obs
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.obs import FlightRecorder
from elephas_tpu_torch.ops import attention
from elephas_tpu_torch.serving import InferenceEngine, ServingMetrics
from elephas_tpu_torch.serving.spec import (
    DraftModelSource,
    SelfDraftSource,
    layer_view,
)

VOCAB, SEQ = 97, 64
NEAR_TIE = 1e-4

PROMPTS = [
    ([5, 3, 9], 10),
    ([7, 2, 8, 4, 1, 6], 12),
    ([11, 12], 8),
    ([1, 2, 3, 4], 10),
    ([42, 7, 7, 13, 2], 9),
    ([3], 11),
]


def _port_module():
    return get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=32,
                     num_heads=4, num_layers=2, max_seq_len=SEQ)


@pytest.fixture(scope="module")
def models():
    """(JAX compiled model, port module, the JAX weights as a state_dict)."""
    jc = JaxCompiledModel(
        jax_get_model("transformer_lm", vocab_size=VOCAB, d_model=32, num_heads=4,
                      num_layers=2, max_seq_len=SEQ),
        optimizer={"name": "adam", "learning_rate": 3e-3},
        loss="sparse_categorical_crossentropy", metrics=[],
        input_shape=(SEQ,), input_dtype=jnp.int32, seed=0,
    )
    module = _port_module()
    sd = from_flax_params(jax.tree_util.tree_map(np.asarray, jc.params), module)
    module.load_state_dict(sd)
    return jc, module, sd


@pytest.fixture()
def flight():
    previous = obs.default_flight_recorder()
    recorder = FlightRecorder(capacity=256)
    obs.set_default_flight_recorder(recorder)
    try:
        yield recorder
    finally:
        obs.set_default_flight_recorder(previous)


def _engine(module, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_len", 24)
    kw.setdefault("queue_depth", 8)
    return InferenceEngine(module, **kw)


def _serve(engine, prompts=PROMPTS, **submit_kw):
    rids = [engine.submit(p, max_new_tokens=n, **submit_kw) for p, n in prompts]
    return [engine.result(r, timeout_s=120) for r in rids]


def _tokens(results):
    return [r.tokens for r in results]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakePSClient:
    """Stands in for ``ShardedParameterClient``: hands out a state_dict
    (the same tensors every pull, as a version-gated client does when the
    version did not move) and counts pulls."""

    def __init__(self, params):
        self.params = params
        self.pulls = 0
        self.fail_next = 0

    def get_parameters(self):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise ConnectionError("draft pull failed (injected)")
        self.pulls += 1
        return self.params


def _top2_gap(module, context):
    with torch.no_grad():
        logits = module(torch.as_tensor([context]))[0, -1]
    top2 = torch.topk(logits, 2).values
    return float(top2[0] - top2[1])


def _assert_streams(module, prompts, want, got, what="plain decode"):
    """``got`` equals ``want`` stream by stream, except from a token where
    ``module``'s top-2 gap over the prompt and ``want``'s stream is below
    ``NEAR_TIE``; names every such tie."""
    assert len(want) == len(got)
    ties = []
    for (prompt, _), a, b in zip(prompts, want, got):
        if a == b:
            continue
        k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        assert k is not None, f"one stream is a prefix of the other: {a} {b}"
        gap = _top2_gap(module, list(prompt) + a[:k])
        assert gap < NEAR_TIE, (f"prompt {prompt}: differs from {what} at token {k} "
                                f"({a} vs {b}) with a top-2 gap of {gap}, not a near-tie")
        ties.append((prompt, k, gap))
    return ties


# -- token identity ------------------------------------------------------------


@pytest.mark.parametrize("pipeline", [True, False])
def test_greedy_identity_self_draft(models, pipeline):
    module = models[1]
    plain = _tokens(_serve(_engine(module, pipeline=pipeline)))
    eng = _engine(module, pipeline=pipeline, speculative=True, gamma=3, draft_layers=1)
    _assert_streams(module, PROMPTS, plain, _tokens(_serve(eng)))
    assert eng.stats()["spec_windows"] > 0


def test_temperature_identity_self_draft(models):
    """Sampled decode stays the plain stream: position-keyed sampling
    draws the same numbers for the same stream position whichever
    program samples it."""
    module = models[1]
    kw = dict(temperature=0.7, top_k=5, seed=3)
    plain = _tokens(_serve(_engine(module, **kw)))
    spec = _tokens(_serve(_engine(module, speculative=True, gamma=3, draft_layers=1, **kw)))
    assert spec == plain
    assert spec != _tokens(_serve(_engine(module)))


def test_greedy_identity_chunked_prefill(models):
    module = models[1]
    plain = _tokens(_serve(_engine(module)))
    spec = _tokens(_serve(_engine(module, speculative=True, gamma=2, draft_layers=1,
                                  prefill_chunk=3, prefill_chunks_per_step=1)))
    _assert_streams(module, PROMPTS, plain, spec)


@pytest.mark.parametrize("gamma", [1, 2, 5])
def test_gamma_sweep_identity(models, gamma):
    module = models[1]
    plain = _tokens(_serve(_engine(module)))
    spec = _tokens(_serve(_engine(module, speculative=True, gamma=gamma, draft_layers=1)))
    _assert_streams(module, PROMPTS, plain, spec, what=f"plain decode (gamma={gamma})")


def test_eos_freeze_mid_window(models):
    """A stop token landing inside a speculative window ends the stream
    where plain decode would: later window tokens are never emitted."""
    module = models[1]
    plain = _serve(_engine(module))
    stop = plain[1].tokens[4]
    base = _tokens(_serve(_engine(module, stop_token=stop)))
    spec = _tokens(_serve(_engine(module, speculative=True, gamma=4, draft_layers=1,
                                  stop_token=stop)))
    _assert_streams(module, PROMPTS, base, spec)
    for toks in spec:
        assert stop not in toks[:-1]  # frozen at its first occurrence
    assert any(toks[-1] == stop for toks in spec)


# -- accept-all / reject-all ---------------------------------------------------


def test_accept_all_same_model_draft(models):
    """The target itself as the draft model: every draft token matches, so
    the accepted share is 1 and windows emit up to gamma + 1 tokens — and
    the streams are still plain decode's."""
    _, module, sd = models
    plain = _tokens(_serve(_engine(module)))
    eng = _engine(module, speculative=True, gamma=3, prefix_cache=False,
                  draft_source=DraftModelSource(_port_module(), FakePSClient(sd)))
    results = _serve(eng)
    _assert_streams(module, PROMPTS, plain, _tokens(results))
    st = eng.stats()
    assert st["spec_accept_rate"] == 1.0
    assert st["spec_tokens_per_step"] > 1.3
    assert any(r.tokens_per_step and r.tokens_per_step > 1.3 for r in results)


def test_reject_all_zero_params_draft(models):
    """A draft of zeroed parameters (flat logits: argmax 0) is rejected
    almost always; throughput falls to plain decode's, the streams stay
    plain decode's."""
    _, module, sd = models
    plain = _tokens(_serve(_engine(module)))
    zeroed = {k: torch.zeros_like(v) for k, v in sd.items()}
    eng = _engine(module, speculative=True, gamma=3, prefix_cache=False,
                  draft_source=DraftModelSource(_port_module(), FakePSClient(zeroed)))
    _assert_streams(module, PROMPTS, plain, _tokens(_serve(eng)))
    st = eng.stats()
    assert st["spec_accept_rate"] <= 0.1
    assert st["spec_tokens_per_step"] >= 1.0


# -- the programs' builds ------------------------------------------------------


def test_compile_counters_pinned(models):
    """Mixed traffic builds one draft and one verify program, and the
    plain decode program never runs."""
    eng = _engine(models[1], speculative=True, gamma=3, draft_layers=1)
    _serve(eng)
    _serve(eng)  # a second wave: no new build
    st = eng.stats()
    assert st["draft_traces"] == st["verify_traces"] == st["prefill_traces"] == 1
    assert st["decode_traces"] == 0 and st["draft_prefill_traces"] == 0
    assert st["spec_fallbacks"] == 0 and st["spec_windows"] > 0
    assert st["spec_source"] == "self" and st["spec_gamma"] == 3


def test_compile_counters_model_source(models):
    _, module, sd = models
    eng = _engine(module, speculative=True, gamma=2, prefix_cache=False,
                  draft_source=DraftModelSource(_port_module(), FakePSClient(sd)))
    _serve(eng)
    _serve(eng)
    st = eng.stats()
    assert st["draft_traces"] == st["verify_traces"] == st["draft_prefill_traces"] == 1
    assert st["spec_source"] == "model"


# -- rollback and the block ledger ---------------------------------------------


def test_refcount_conservation_under_churn(models):
    """Seeded churn (ragged prompts, shared prefixes, slot reuse) over a
    speculative engine: rejected suffixes roll back on the device, and the
    block ledger still conserves."""
    module = models[1]
    rng = np.random.default_rng(7)
    eng = _engine(module, speculative=True, gamma=3, draft_layers=1, queue_depth=32)
    prompts = []
    for _ in range(16):
        plen = int(rng.integers(1, 8))
        if prompts and rng.random() < 0.4:
            base = prompts[int(rng.integers(0, len(prompts)))][0]
            p = (base + [int(t) for t in rng.integers(1, VOCAB, plen)])[:7]
        else:
            p = [int(t) for t in rng.integers(1, VOCAB, plen)]
        prompts.append((p, int(rng.integers(2, 14))))
    results = _serve(eng, prompts=prompts)
    assert all(r.status == "completed" for r in results)
    eng.pool.assert_block_invariants()
    assert eng.pool.active_count == 0
    plain = _tokens(_serve(_engine(module, queue_depth=32), prompts=prompts))
    _assert_streams(module, prompts, plain, _tokens(results))


def test_deadline_eviction_mid_speculation(models):
    """A deadline expiring while a window is in flight evicts the lane
    cleanly: partial tokens returned, its blocks released, survivors
    unperturbed."""
    module = models[1]
    clock = FakeClock()
    eng = _engine(module, speculative=True, gamma=3, draft_layers=1, clock=clock)
    doomed = eng.submit([7, 2, 8, 4, 1, 6], max_new_tokens=12, timeout_s=5.0)
    survivor = eng.submit([5, 3, 9], max_new_tokens=10)
    for _ in range(3):
        eng.step()
        clock.advance(1.0)
    clock.advance(10.0)
    res_d = eng.result(doomed, timeout_s=120)
    res_s = eng.result(survivor, timeout_s=120)
    assert res_d.status == "timeout" and res_s.status == "completed"
    quiet = _engine(module, speculative=True, gamma=3, draft_layers=1)
    assert res_s.tokens == quiet.result(quiet.submit([5, 3, 9], max_new_tokens=10),
                                        timeout_s=120).tokens
    eng.pool.assert_block_invariants()
    full = _engine(module, speculative=True, gamma=3, draft_layers=1)
    stream = full.result(full.submit([7, 2, 8, 4, 1, 6], max_new_tokens=12),
                         timeout_s=120).tokens
    assert 0 < len(res_d.tokens) < 12 and res_d.tokens == stream[:len(res_d.tokens)]


# -- draft weights: delivery, refresh, fallback --------------------------------


def test_version_gated_draft_refresh(models):
    """``refresh_every`` bounds pulls: a large window pulls once for the
    run; refresh_every=1 asks the client at every draft call."""
    _, module, sd = models
    lazy = FakePSClient(sd)
    eng = _engine(module, speculative=True, gamma=2, prefix_cache=False,
                  draft_source=DraftModelSource(_port_module(), lazy, refresh_every=10_000))
    _serve(eng)
    assert lazy.pulls == 1
    eager = FakePSClient(sd)
    eng2 = _engine(module, speculative=True, gamma=2, prefix_cache=False,
                   draft_source=DraftModelSource(_port_module(), eager, refresh_every=1))
    _serve(eng2)
    assert eager.pulls > 1
    assert eng.stats()["spec_accept_rate"] == 1.0
    source = DraftModelSource(_port_module(), FakePSClient(sd), subscribed=True)
    source.params()
    source.params()
    assert source.pulls == 1  # a subscribed source pulls once, then on refresh()
    source.refresh()
    assert source.pulls == 2
    with pytest.raises(ValueError, match="refresh_every"):
        DraftModelSource(_port_module(), FakePSClient(sd), refresh_every=0)


def test_model_draft_copies_a_changed_tree_in_place(models):
    """A pulled tree is copied INTO the draft module's tensors (their
    addresses are what a captured program reads), and only when the
    pulled tensors changed."""
    _, module, sd = models
    draft = _port_module()
    client = FakePSClient(sd)
    eng = _engine(module, speculative=True, gamma=2, prefix_cache=False,
                  draft_source=DraftModelSource(draft, client, refresh_every=1))
    addresses = {k: v.data_ptr() for k, v in draft.state_dict().items()}
    loads = []
    original = draft.load_state_dict
    draft.load_state_dict = lambda tree, **kw: loads.append(1) or original(tree, **kw)
    _serve(eng)
    assert client.pulls > 1 and len(loads) == 1
    client.params = {k: v.clone() for k, v in sd.items()}  # a new version
    _serve(eng, prompts=PROMPTS[:1])
    assert len(loads) == 2
    assert {k: v.data_ptr() for k, v in draft.state_dict().items()} == addresses
    assert all(torch.equal(v, sd[k]) for k, v in draft.state_dict().items())


def test_spec_fallback_on_pull_failure(models, flight):
    """Draft pulls failing mid-serve degrade those windows to plain decode
    (``spec_fallback``) — never an error, and the streams stay plain
    decode's."""
    _, module, sd = models
    plain = _tokens(_serve(_engine(module)))
    client = FakePSClient(sd)
    eng = _engine(module, speculative=True, gamma=2, prefix_cache=False,
                  draft_source=DraftModelSource(_port_module(), client, refresh_every=1))
    client.fail_next = 3  # the first pulls fail (the draft prefill's included)
    _assert_streams(module, PROMPTS, plain, _tokens(_serve(eng)))
    st = eng.stats()
    assert st["spec_fallbacks"] == 3
    assert st["decode_traces"] <= 1
    notes = flight.events(kind="spec_fallback")
    assert len(notes) == 3 and all("injected" in n.detail["error"] for n in notes)
    assert any(n.detail.get("where") == "prefill" for n in notes)


def test_self_draft_is_a_view_of_the_target(models):
    """The self-draft shares the target's tensors: the first K blocks, the
    embeddings, the final norm and lm_head, with no copy; a weight
    install on the engine reaches the draft."""
    _, module, sd = models
    # params= serves a copy of the module: the install below leaves the
    # shared one whole.
    eng = _engine(module, params=sd, speculative=True, gamma=2)  # draft_layers 2 // 2
    view = eng.spec.source.module
    assert eng.spec.source.layers == 1 and view.num_layers == 1 and len(view.blocks) == 1
    assert len(eng.module.blocks) == 2  # the target stays whole
    ptrs = {p.data_ptr() for p in eng.module.parameters()}
    assert all(p.data_ptr() in ptrs for p in view.parameters())
    assert view.blocks[0] is eng.module.blocks[0] and view.lm_head is eng.module.lm_head
    eng.install_weights({k: torch.zeros_like(v) for k, v in sd.items()})
    assert all(float(p.detach().abs().sum()) == 0.0 for p in view.parameters())
    # layer_view of a bare module: the same contract.
    target = _port_module()
    assert len(layer_view(target, 1).blocks) == 1 and len(target.blocks) == 2


# -- metrics and plumbing ------------------------------------------------------


def test_tokens_per_step_plain_is_one(models):
    for r in _serve(_engine(models[1])):
        if len(r.tokens) > 1:
            assert r.tokens_per_step == pytest.approx(1.0)


def test_spec_load_signals(models):
    _, module, sd = models
    eng = _engine(module, speculative=True, gamma=3, prefix_cache=False,
                  draft_source=DraftModelSource(_port_module(), FakePSClient(sd)))
    _serve(eng)
    signals = eng.load.snapshot()["signals"]
    assert signals["spec_accept_rate"] == 1.0
    assert signals["spec_tokens_per_step"] > 1.3
    plain = _engine(module)
    _serve(plain)
    assert "spec_accept_rate" not in plain.load.snapshot()["signals"]


def test_spec_metrics_match_the_reference():
    """``record_spec``, the two ratios and the summary keys as the JAX
    package's ``ServingMetrics`` gives them."""
    out = []
    for cls in (JaxServingMetrics, ServingMetrics):
        m = cls(clock=lambda: 0.0)
        assert m.spec_accept_rate is None and m.spec_tokens_per_step is None
        assert "spec_windows" not in m.summary()
        m.record_spec(windows=3, drafted=12, accepted=5, emitted=8)
        m.record_spec(windows=1, drafted=4, accepted=4, emitted=5)
        s = m.summary()
        out.append({k: s[k] for k in ("spec_windows", "spec_accept_rate",
                                      "spec_tokens_per_step")})
        m.reset()
        assert m.spec_windows == m.spec_drafted == m.spec_accepted == m.spec_emitted == 0
    assert out[0] == out[1] == {"spec_windows": 4, "spec_accept_rate": 9 / 16,
                                "spec_tokens_per_step": 13 / 4}


def test_spec_requires_paged_and_validates(models):
    _, module, sd = models
    with pytest.raises(ValueError, match="paged"):
        _engine(module, paged=False, speculative=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(module, speculative=True, draft_layers=1, draft_source=SelfDraftSource(1))
    with pytest.raises(ValueError, match="speculative"):
        _engine(module, draft_layers=1)
    with pytest.raises(ValueError, match="draft_layers"):
        _engine(module, speculative=True, draft_layers=2)  # == num_layers
    with pytest.raises(ValueError, match="prefix_cache"):
        _engine(module, speculative=True,
                draft_source=DraftModelSource(_port_module(), FakePSClient(sd)))
    with pytest.raises(ValueError, match="gamma"):
        _engine(module, speculative=True, gamma=0, draft_layers=1)
    small = get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=32,
                      num_heads=4, num_layers=1, max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        _engine(module, speculative=True, prefix_cache=False,
                draft_source=DraftModelSource(small, FakePSClient(sd)))
    # The pool's virtual row holds a verify window past the last column.
    eng = _engine(module, speculative=True, gamma=5, draft_layers=1)
    assert eng.pool.virtual_len >= 24 + 5


def test_stats_keys_match_the_reference(models):
    jc, module, _ = models
    kw = dict(max_slots=3, max_prompt_len=8, max_len=24, queue_depth=8,
              speculative=True, gamma=3, draft_layers=1)
    jeng, teng = JaxEngine(jc, **kw), InferenceEngine(module, **kw)
    for eng in (jeng, teng):
        eng.result(eng.submit([5, 3, 9], max_new_tokens=6), timeout_s=120)
    jst, tst = jeng.stats(), teng.stats()
    spec_keys = {"draft_traces", "verify_traces", "draft_prefill_traces", "spec_windows",
                 "spec_fallbacks", "spec_source", "spec_gamma", "spec_accept_rate",
                 "spec_tokens_per_step"}
    assert spec_keys <= set(jst) and spec_keys <= set(tst)
    for key in ("draft_traces", "verify_traces", "draft_prefill_traces", "spec_source",
                "spec_gamma", "spec_fallbacks"):
        assert tst[key] == jst[key], key


def test_sharded_speculation_refuses_a_model_draft_as_the_reference_does(models):
    """Under ``shard_serving`` the JAX engine refuses a model draft source
    (the draft model has no sharding rules) and takes a self-draft; so
    does the port, before it shards anything (the sharded self-draft's
    streams: ``tests/test_torch_serving_tp.py``)."""
    from elephas_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from elephas_tpu.serving import shard_serving as jax_shard_serving
    from elephas_tpu_torch.parallel.mesh import Mesh

    _, module, sd = models
    kw = dict(max_slots=2, max_prompt_len=8, max_len=24, speculative=True, gamma=2,
              prefix_cache=False)
    jc = JaxCompiledModel(  # a vocabulary that divides over the model axis
        jax_get_model("transformer_lm", vocab_size=64, d_model=32, num_heads=4,
                      num_layers=2, max_seq_len=SEQ),
        optimizer="adam", loss="sparse_categorical_crossentropy", metrics=[],
        input_shape=(SEQ,), input_dtype=jnp.int32, seed=0)
    jeng = JaxEngine(jc, draft_source=JaxDraftModelSource(jc.module, FakePSClient(jc.params)),
                     **kw)
    with pytest.raises(NotImplementedError, match="model draft source") as want:
        jax_shard_serving(jeng, jax_build_mesh(num_data=1, num_model=2))
    teng = InferenceEngine(module, draft_source=DraftModelSource(_port_module(),
                                                                 FakePSClient(sd)), **kw)
    with pytest.raises(NotImplementedError, match="model draft source") as got:
        teng.shard_serving(Mesh(model_size=2))
    assert "use a self-draft" in str(want.value) and "use a self-draft" in str(got.value)
    assert teng._tp is None and teng.mesh is None
    assert _engine(module, speculative=True, gamma=2, draft_layers=1).shard_serving(
        Mesh()).spec.source.kind == "self"


# -- against the JAX package ---------------------------------------------------


def _jax_top2_gap(jc, context):
    logits = np.asarray(jc.module.apply({"params": jc.params},
                                        jnp.asarray([context], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("source", ["self", "model"])
def test_greedy_speculative_streams_match_the_jax_engine(models, source):
    """The same weights, traffic and windows through the JAX engine's
    speculative decode and the port's: equal streams, unless the JAX
    model's top-2 gap at the first difference is below 1e-4."""
    jc, module, sd = models
    kw = dict(max_slots=3, max_prompt_len=8, max_len=24, queue_depth=8,
              speculative=True, gamma=3)
    if source == "self":
        jeng = JaxEngine(jc, draft_layers=1, **kw)
        teng = InferenceEngine(module, draft_layers=1, **kw)
    else:
        jeng = JaxEngine(jc, prefix_cache=False, **kw,
                         draft_source=JaxDraftModelSource(jc.module, FakePSClient(jc.params)))
        teng = InferenceEngine(module, prefix_cache=False, **kw,
                               draft_source=DraftModelSource(_port_module(), FakePSClient(sd)))
    want, got = _tokens(_serve(jeng)), _tokens(_serve(teng))
    for (prompt, _), a, b in zip(PROMPTS, want, got):
        if a == b:
            continue
        k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = _jax_top2_gap(jc, list(prompt) + a[:k])
        assert gap < NEAR_TIE, (f"prompt {prompt}: the port differs from the JAX engine at "
                                f"token {k} ({a} vs {b}), JAX top-2 gap {gap}")
    jst, tst = jeng.stats(), teng.stats()
    assert tst["spec_windows"] == jst["spec_windows"]
    assert tst["spec_accept_rate"] == pytest.approx(jst["spec_accept_rate"])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", range(4))
def test_scatter_spec_columns_equals_the_reference(seed):
    """Active and inactive lanes, unallocated blocks and windows running
    past the row's virtual capacity land as in the reference; the pool
    is written in place."""
    rng = np.random.default_rng(seed)
    nb, heads, bs, hd, slots, bps = 13, 2, 4, 3, 4, 3
    leaf = rng.standard_normal((nb, heads, bs, hd)).astype(np.float32)
    table = rng.permutation(nb + 1)[:slots * bps].reshape(slots, bps).astype(np.int64)
    table[1, 2] = table[2, 0] = nb  # the out-of-range id: those writes drop
    length = bps * bs
    contig = rng.standard_normal((slots, heads, length, hd)).astype(np.float32)
    for count in (1, 3, 5):
        idx = rng.integers(0, length, slots).astype(np.int64)
        idx[-1] = length - 2  # the window runs past the row
        for active in (rng.random(slots) < 0.6, np.zeros(slots, bool), np.ones(slots, bool)):
            ref = np.asarray(jax_attention.scatter_spec_columns(
                jnp.asarray(leaf), jnp.asarray(contig), jnp.asarray(table, jnp.int32),
                jnp.asarray(idx, jnp.int32), count, jnp.asarray(active)))
            pool = _t(leaf.copy())
            ours = attention.scatter_spec_columns(pool, _t(contig), _t(table), _t(idx),
                                                  count, _t(active))
            assert ours.data_ptr() == pool.data_ptr()
            np.testing.assert_array_equal(ours.numpy(), ref)
