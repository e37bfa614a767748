"""Disaggregated prefill/decode serving in the port: the KV-block handoff
(``parameter.wire.encode_kv_blocks``, ``serving.handoff``,
``PagedKVPool.export_blocks``/``import_blocks``, the engine's
``submit_prefill``/``handoff``/``submit_handoff``) against the JAX
package's.

The counterparts of ``tests/test_disagg.py``'s wire, pool and engine
tests, on the reference tests' small LM carried across with
``convert.from_flax_params``: the codec round trip and its refusal of
corrupt frames, frames byte-identical to the JAX package's for the same
meta and arrays, export → wire → import to the bit, tiered streams equal
to a single engine's (greedy and sampled), refcounts under handoff churn,
a corrupt frame refused without wedging a slot, the billing window and
cross-tier billing — and a handoff exported by either package imported
by the other, giving the same stream.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from elephas_tpu.api.compile import CompiledModel as JaxCompiledModel
from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.parameter import wire as jax_wire
from elephas_tpu.serving import InferenceEngine as JaxEngine
from elephas_tpu.serving import handoff as jax_handoff
from elephas_tpu_torch.convert import from_flax_params
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.obs.tenancy import CostLedger
from elephas_tpu_torch.parameter.wire import (
    WireFormatError,
    decode_kv_blocks,
    encode_kv_blocks,
)
from elephas_tpu_torch.serving import InferenceEngine
from elephas_tpu_torch.serving.handoff import decode_handoff, encode_handoff

VOCAB, SEQ = 97, 64
NEAR_TIE = 1e-4


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


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
    module = get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=32,
                       num_heads=4, num_layers=2, max_seq_len=SEQ)
    sd = from_flax_params(jax.tree_util.tree_map(np.asarray, jc.params), module)
    module.load_state_dict(sd)
    return jc, module, sd


def _kw(**kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_len", 24)
    kw.setdefault("queue_depth", 8)
    kw.setdefault("paged", True)
    kw.setdefault("kv_block_size", 4)
    return kw


def _engine(module, **kw):
    return InferenceEngine(module, **_kw(**kw))


def _disagg_serve(pre, dec, prompt, max_new_tokens=6, **kw):
    """One request through the two-engine handoff; the decode tier's result."""
    rid = pre.submit_prefill(prompt, max_new_tokens=max_new_tokens, **kw)
    data = pre.handoff(rid, timeout_s=60.0)
    assert isinstance(data, dict), data
    rid2 = dec.submit_handoff(encode_handoff(data).tobytes())
    return dec.result(rid2, timeout_s=60.0)


def _mono(engine, prompt, max_new_tokens=6, **kw):
    return engine.result(engine.submit(prompt, max_new_tokens=max_new_tokens, **kw),
                         timeout_s=60.0)


def _as_numpy(t):
    """A port leaf as the JAX package holds it (bf16 as ml_dtypes')."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# -- wire codec ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_kv_codec_roundtrip_bit_identical(dtype):
    """Every KV dtype the pool can hold crosses the wire to the bit."""
    gen = torch.Generator().manual_seed(3)
    arrays = [torch.randn((2, 4, 4, 8), generator=gen).to(dtype) for _ in range(2)]
    meta = {"req_id": 7, "first": 12, "tenant": None,
            "export": {"block_size": 4, "blocks": 2}}
    buf = encode_kv_blocks(meta, arrays).tobytes()
    meta2, arrays2 = decode_kv_blocks(buf)
    assert meta2 == meta and len(arrays2) == len(arrays)
    for a, b in zip(arrays, arrays2):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(b.view(torch.int16) if dtype != torch.float32 else b,
                           a.view(torch.int16) if dtype != torch.float32 else a)
    # A writable buffer decodes to views of it; a read-only one to copies.
    meta3, arrays3 = decode_kv_blocks(bytearray(buf))
    assert meta3 == meta and all(torch.equal(a, b) for a, b in zip(arrays2, arrays3))


def test_kv_codec_rejects_corruption():
    buf = bytearray(encode_kv_blocks({"k": 1}, [np.zeros((1, 2, 2, 2), np.float32)])
                    .tobytes())
    with pytest.raises(WireFormatError, match="magic"):
        decode_kv_blocks(b"XXXX" + bytes(buf[4:]))
    with pytest.raises(WireFormatError):
        decode_kv_blocks(bytes(buf[: len(buf) // 2]))  # truncated payload
    stomped = bytearray(buf)
    stomped[12] ^= 0xFF  # inside the JSON header
    with pytest.raises(WireFormatError):
        decode_kv_blocks(bytes(stomped))
    with pytest.raises(WireFormatError, match="JSON"):
        encode_kv_blocks({"k": object()}, [])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kv_frames_are_byte_identical_to_the_jax_package(dtype):
    """The same meta and arrays give the same bytes in both packages, and
    each package decodes the other's frame."""
    gen = torch.Generator().manual_seed(5)
    arrays = [torch.randn(shape, generator=gen).to(dtype)
              for shape in ((3, 4, 4, 8), (3, 4, 4, 8), (1, 2, 3, 5))]
    meta = {"req_id": 3, "prompt": [5, 3, 9], "first": 11, "submitted_at": 1.25,
            "deadline": None, "tenant": "t", "export": {"block_size": 4, "blocks": 3}}
    ours = encode_kv_blocks(meta, arrays).tobytes()
    theirs = jax_wire.encode_kv_blocks(meta, [_as_numpy(a) for a in arrays]).tobytes()
    assert ours == theirs
    jmeta, jarrays = jax_wire.decode_kv_blocks(ours)
    assert jmeta == meta
    assert all(b.tobytes() == _as_numpy(a).tobytes() for a, b in zip(arrays, jarrays))
    tmeta, tarrays = decode_kv_blocks(theirs)
    assert tmeta == meta and all(torch.equal(a, b) for a, b in zip(arrays, tarrays))


def test_handoff_frames_validate_their_keys():
    """``encode_handoff``/``decode_handoff`` refuse a dict or frame that
    lacks the resume state, as the JAX package's do, before anything
    binds."""
    data = {"req_id": 1, "prompt": [1, 2], "first": 3, "max_new_tokens": 4,
            "stop_token": None, "deadline": None, "submitted_at": 0.0, "tenant": None,
            "matched": 0, "export": {"block_size": 4, "blocks": 1, "leaves": ["a"],
                                     "arrays": [np.zeros((1, 2, 4, 2), np.float32)]}}
    frame = encode_handoff(data).tobytes()
    assert frame == jax_handoff.encode_handoff(data).tobytes()
    back = decode_handoff(frame)
    assert back["prompt"] == [1, 2] and back["export"]["leaves"] == ["a"]
    for drop in ("first", "tenant"):
        partial = {k: v for k, v in data.items() if k != drop}
        for encode in (encode_handoff, jax_handoff.encode_handoff):
            with pytest.raises(Exception, match="missing keys"):
                encode(partial)
    with pytest.raises(WireFormatError, match="export"):
        encode_handoff({k: v for k, v in data.items() if k != "export"})
    bad = encode_kv_blocks({k: v for k, v in data.items() if k != "export"} |
                           {"export": {"block_size": 4, "blocks": 1}},
                           data["export"]["arrays"]).tobytes()
    with pytest.raises(WireFormatError, match="missing keys"):
        decode_handoff(bad)
    empty = encode_kv_blocks({k: v for k, v in data.items() if k != "export"} |
                             {"prompt": [], "export": {"block_size": 4, "blocks": 1,
                                                       "leaves": ["a"]}},
                             data["export"]["arrays"]).tobytes()
    with pytest.raises(WireFormatError, match="non-empty"):
        decode_handoff(empty)


# -- pool: export -> wire -> import --------------------------------------------


def test_leaf_names_are_the_jax_pools(models):
    """``export_blocks`` names the K/V leaves as the JAX package's pool
    flattens them for the same model, in the same order (layers in sorted
    key order)."""
    jc, module, _ = models
    jeng, teng = JaxEngine(jc, **_kw()), _engine(module)
    assert teng.pool._kv_leaf_names()[0] == jeng.pool._kv_leaf_names()[0]
    deep = get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=32,
                     num_heads=4, num_layers=11, max_seq_len=SEQ)
    names = _engine(deep).pool._kv_leaf_names()[0]
    assert names[:4] == ["['Block_0']['SelfAttention_0']['cached_key']",
                         "['Block_0']['SelfAttention_0']['cached_value']",
                         "['Block_1']['SelfAttention_0']['cached_key']",
                         "['Block_1']['SelfAttention_0']['cached_value']"]
    assert names[4].startswith("['Block_10']")


def test_export_wire_import_bit_identical(models):
    """A prefill engine's exported blocks survive encode → decode to the
    bit, land in the decode pool to the bit, and the decode engine emits
    the single engine's stream."""
    module = models[1]
    prompt = [5, 3, 9, 2, 6, 1]
    want = _mono(_engine(module), prompt).tokens
    pre, dec = _engine(module), _engine(module)
    data = pre.handoff(pre.submit_prefill(prompt, max_new_tokens=6), timeout_s=60.0)
    frame = encode_handoff(data).tobytes()
    parked = decode_handoff(frame)
    for a, b in zip(data["export"]["arrays"], parked["export"]["arrays"]):
        assert torch.equal(a, b)
    rid = dec.submit_handoff(frame)
    slot = next(s for s, e in dec.scheduler._active.items() if e.request.req_id == rid)
    _, leaves = dec.pool._kv_leaf_names()
    ids = torch.as_tensor(dec.pool.table.rows[slot][:data["export"]["blocks"]])
    assert all(torch.equal(leaf[ids], a) for leaf, a in zip(leaves, data["export"]["arrays"]))
    assert int(dec.pool.cache.index[slot]) == len(prompt)
    got = dec.result(rid, timeout_s=60.0)
    assert got.status == "completed" and list(got.tokens) == list(want)


def test_disagg_token_identity_greedy_and_sampled(models):
    """Tiered output equals a single engine's, greedy and sampled:
    position-keyed sampling plus a transfer to the bit make the handoff
    invisible to the stream."""
    module = models[1]
    prompts = [[5, 3, 9], [1, 2, 3, 4, 5, 6, 7], [11, 12, 13, 14, 15]]
    for sample_kw in ({}, {"temperature": 0.8, "top_k": 12, "seed": 7}):
        mono, pre, dec = (_engine(module, **sample_kw) for _ in range(3))
        for prompt in prompts:
            want = _mono(mono, prompt).tokens
            got = _disagg_serve(pre, dec, prompt)
            assert got.status == "completed", sample_kw
            assert list(got.tokens) == list(want), sample_kw


def test_refcount_conservation_under_handoff_churn(models):
    """Seeded churn over the handoff — shared system prefixes (the incref
    import arm) mixed with cold prompts (the upload arm) — leaves both
    pools' refcounts conserved."""
    module = models[1]
    pre, dec = _engine(module), _engine(module)
    rng = np.random.default_rng(29)
    sys_prefix = [7, 3, 2, 9]  # one full block at kv_block_size 4
    hits = 0
    for _ in range(12):
        if rng.integers(2) == 0:
            prompt = sys_prefix + rng.integers(1, VOCAB, int(rng.integers(1, 5))).tolist()
        else:
            prompt = rng.integers(1, VOCAB, int(rng.integers(1, 9))).tolist()
        before = dec.pool.prefix.hits_total
        res = _disagg_serve(pre, dec, prompt, max_new_tokens=int(rng.integers(2, 7)))
        hits += dec.pool.prefix.hits_total - before
        assert res.status == "completed"
        pre.pool.assert_block_invariants()
        dec.pool.assert_block_invariants()
    assert pre.pool.active_count == 0 and dec.pool.active_count == 0
    assert hits > 0  # the import matched a resident prefix


def test_corrupt_frame_rejects_without_wedging_slot(models):
    """A corrupt frame is refused at ``submit_handoff`` and leaves the
    decode engine serviceable: invariants intact, the next valid handoff
    and a local request served."""
    module = models[1]
    pre, dec = _engine(module), _engine(module)
    prompt = [4, 8, 15, 16, 23, 42]
    frame = bytearray(encode_handoff(
        pre.handoff(pre.submit_prefill(prompt, max_new_tokens=5), timeout_s=60.0)).tobytes())
    frame[10] ^= 0xFF  # the JSON header
    free = (dec.pool.free_count, dec.pool.free_blocks)
    with pytest.raises(WireFormatError):
        dec.submit_handoff(bytes(frame))
    dec.pool.assert_block_invariants()
    assert dec.pool.active_count == 0 and (dec.pool.free_count, dec.pool.free_blocks) == free
    want = _mono(_engine(module), prompt, 5).tokens
    res = _disagg_serve(pre, dec, prompt, max_new_tokens=5)
    assert res.status == "completed" and list(res.tokens) == list(want)
    assert _mono(dec, prompt, 5).status == "completed"
    # A structurally wrong frame (another model's leaves) unwinds its slot.
    other = get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=32,
                      num_heads=4, num_layers=1, max_seq_len=SEQ)
    wide = _engine(other)
    bad = encode_handoff(wide.handoff(wide.submit_prefill(prompt, max_new_tokens=5),
                                      timeout_s=60.0)).tobytes()
    with pytest.raises(ValueError, match="leaf structure"):
        dec.submit_handoff(bad)
    dec.pool.assert_block_invariants()
    assert dec.pool.active_count == 0


def test_export_transfers_billing_window(models):
    """Block-seconds of one request split across tiers sum to what one
    pool would have billed: export closes the prefill side's window, the
    import's ``set_slot_owner`` opens the decode side's."""
    module = models[1]
    clock = FakeClock()

    def with_ledger(eng):
        ledger = CostLedger(clock=clock)
        eng.pool.attach_cost_ledger(ledger, clock=clock)
        return ledger

    pre, dec = _engine(module), _engine(module)
    led_pre, led_dec = with_ledger(pre), with_ledger(dec)
    slot = pre.pool.acquire()
    pre.pool.set_slot_owner(slot, "t0")
    pre.pool.ensure_cols(slot, 8)  # 2 blocks resident
    clock.advance(5.0)
    export = pre.pool.export_blocks(slot)  # bills 5 s x 2 blocks, closes
    clock.advance(7.0)
    pre.pool.release(slot)  # the window is closed: nothing more
    pre_s = led_pre.snapshot()["tenants"]["t0"]["kv_block_seconds"]
    assert pre_s == pytest.approx(10.0)
    slot2 = dec.pool.acquire()
    matched = dec.pool.import_blocks(slot2, [5, 3, 9, 2, 6, 1, 4, 8], export["arrays"],
                                     leaf_names=export["leaves"])
    assert matched == 0
    dec.pool.set_slot_owner(slot2, "t0")
    clock.advance(3.0)
    dec.pool.release(slot2)
    dec_s = led_dec.snapshot()["tenants"]["t0"]["kv_block_seconds"]
    assert dec_s == pytest.approx(6.0)
    assert pre_s + dec_s == pytest.approx(16.0)
    with pytest.raises(ValueError, match="free"):
        pre.pool.export_blocks(slot)
    with pytest.raises(ValueError, match="free"):
        dec.pool.import_blocks(slot2, [1], export["arrays"])


def test_cross_tier_billing_token_conservation(models):
    """Prefill tokens and the first token bill on the prefill engine, the
    rest on the decode engine: summed, the single engine's ledger."""
    module = models[1]
    prompt = [5, 3, 9, 2, 6]
    mono = _engine(module)
    _mono(mono, prompt, tenant="t")
    m = mono.costs.snapshot()["tenants"]["t"]
    pre, dec = _engine(module), _engine(module)
    assert _disagg_serve(pre, dec, prompt, tenant="t").status == "completed"
    p = pre.costs.snapshot()["tenants"]["t"]
    d = dec.costs.snapshot()["tenants"]["t"]
    for key in ("prefill_tokens", "decode_tokens", "submitted", "completed"):
        assert p[key] + d[key] == m[key], key


def test_prefill_only_needs_a_paged_engine(models):
    module = models[1]
    contiguous = InferenceEngine(module, **_kw(paged=False, kv_block_size=None))
    with pytest.raises(ValueError, match="paged"):
        contiguous.submit_prefill([1, 2])
    with pytest.raises(RuntimeError, match="paged"):
        contiguous.submit_handoff(b"")


# -- across packages -----------------------------------------------------------


def _jax_top2_gap(jc, context):
    logits = np.asarray(jc.module.apply({"params": jc.params},
                                        jnp.asarray([context], jnp.int32)))[0, -1]
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_a_handoff_crosses_packages(models, direction):
    """A frame exported by either package's prefill engine imports into
    the other's decode engine and gives the single JAX engine's stream
    (unless the JAX model's top-2 gap at the first difference is below
    1e-4)."""
    jc, module, _ = models
    prompts = [[5, 3, 9, 2, 6, 1], [7, 3, 2, 9, 4], [11, 12]]
    mono = JaxEngine(jc, **_kw())
    if direction == "jax_to_port":
        pre, dec = JaxEngine(jc, **_kw()), _engine(module)
        encode = jax_handoff.encode_handoff
    else:
        pre, dec = _engine(module), JaxEngine(jc, **_kw())
        encode = encode_handoff
    for prompt in prompts:
        want = _mono(mono, prompt).tokens
        data = pre.handoff(pre.submit_prefill(prompt, max_new_tokens=6), timeout_s=60.0)
        got = dec.result(dec.submit_handoff(encode(data).tobytes()), timeout_s=60.0)
        assert got.status == "completed"
        if list(got.tokens) != list(want):
            k = next(i for i, (x, y) in enumerate(zip(want, got.tokens)) if x != y)
            gap = _jax_top2_gap(jc, prompt + list(want[:k]))
            assert gap < NEAR_TIE, (f"{direction} {prompt}: differs at token {k} "
                                    f"({want} vs {got.tokens}), JAX top-2 gap {gap}")
    dec.pool.assert_block_invariants()
