"""The port's KV pools (``elephas_tpu_torch.serving.kv_pool``) and paged
helpers (``elephas_tpu_torch.ops.attention``) against the JAX package's.

The paged gather/scatter helpers must equal the reference's exactly on
seeded arrays, including the out-of-range block id ``num_blocks`` (XLA
clamps it in a gather and drops it in a scatter; the port clamps the ids
and turns dropped writes into copies of kept ones). The allocator is
host logic and must follow the reference's state step by step under
seeded churn.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elephas_tpu.models import get_model as jax_get_model
from elephas_tpu.ops import attention as jax_attention
from elephas_tpu.serving.kv_pool import PagedKVPool as JaxPagedKVPool
from elephas_tpu.serving.kv_pool import PrefixCache as JaxPrefixCache
from elephas_tpu_torch import obs
from elephas_tpu_torch.models import get_model
from elephas_tpu_torch.obs import FlightRecorder
from elephas_tpu_torch.ops import attention
from elephas_tpu_torch.serving import (
    BlockTable,
    KVCachePool,
    PagedKVPool,
    PrefixCache,
)

VOCAB, SEQ = 97, 64


@pytest.fixture(scope="module")
def module():
    return get_model("transformer_lm", device="cpu", vocab_size=VOCAB, d_model=32,
                     num_heads=4, num_layers=2, max_seq_len=SEQ)


@pytest.fixture(scope="module")
def jax_decode_module():
    m = jax_get_model("transformer_lm", vocab_size=VOCAB, d_model=32, num_heads=4,
                      num_layers=2, max_seq_len=SEQ)
    return dataclasses.replace(m, decode=True, attention="dense")


@pytest.fixture()
def flight():
    previous = obs.default_flight_recorder()
    recorder = FlightRecorder(capacity=256)
    obs.set_default_flight_recorder(recorder)
    try:
        yield recorder
    finally:
        obs.set_default_flight_recorder(previous)


def _pool(module, max_slots=3, max_len=24, **kw):
    kw.setdefault("block_size", 4)
    return PagedKVPool(module, max_slots, max_len, **kw)


# -- the paged helpers against the reference's ---------------------------------


def _seeded(seed, nb=7, heads=2, bs=4, hd=3, slots=4, bps=3):
    rng = np.random.default_rng(seed)
    leaf = rng.standard_normal((nb, heads, bs, hd)).astype(np.float32)
    # Ids in [0, nb], the out-of-range id ``nb`` included in every table.
    table = rng.integers(0, nb + 1, (slots, bps)).astype(np.int64)
    table[0, -1] = nb
    contig = rng.standard_normal((slots, heads, bps * bs, hd)).astype(np.float32)
    return rng, leaf, table, contig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", range(4))
def test_gathers_equal_the_reference(seed):
    _, leaf, table, _ = _seeded(seed)
    ref = np.asarray(jax_attention.paged_to_contiguous(jnp.asarray(leaf),
                                                       jnp.asarray(table, jnp.int32)))
    np.testing.assert_array_equal(attention.paged_to_contiguous(_t(leaf), _t(table)).numpy(),
                                  ref)
    for row in table:
        ref = np.asarray(jax_attention.slot_row_to_contiguous(
            jnp.asarray(leaf), jnp.asarray(row, jnp.int32)))
        np.testing.assert_array_equal(
            attention.slot_row_to_contiguous(_t(leaf), _t(row)).numpy(), ref)


@pytest.mark.parametrize("seed", range(4))
def test_decode_scatter_equals_the_reference(seed):
    """Active and inactive lanes, unallocated blocks, and a frozen
    column at the very end of the row (``idx == L``) all land as in the
    reference; nothing else in the pool moves."""
    rng, leaf, table, contig = _seeded(seed, nb=13)
    slots, bps = table.shape
    L = contig.shape[2]
    # Distinct blocks per lane so kept writes never collide, and the
    # out-of-range id 13 in two places.
    table[:] = rng.permutation(14)[:slots * bps].reshape(slots, bps)
    table[1, 2] = table[2, 0] = 13
    idx = rng.integers(0, L + 1, slots).astype(np.int64)
    idx[-1] = L
    for active in (rng.random(slots) < 0.6, np.zeros(slots, bool), np.ones(slots, bool)):
        ref = np.asarray(jax_attention.scatter_decode_columns(
            jnp.asarray(leaf), jnp.asarray(contig), jnp.asarray(table, jnp.int32),
            jnp.asarray(idx, jnp.int32), jnp.asarray(active)))
        ours = attention.scatter_decode_columns(
            _t(leaf.copy()), _t(contig), _t(table), _t(idx), _t(active)).numpy()
        np.testing.assert_array_equal(ours, ref)
    # Every lane inactive: the pool is left exactly as it was.
    ours = attention.scatter_decode_columns(_t(leaf.copy()), _t(contig), _t(table),
                                            _t(idx), _t(np.zeros(slots, bool)))
    np.testing.assert_array_equal(ours.numpy(), leaf)


@pytest.mark.parametrize("seed", range(4))
def test_prefill_scatter_equals_the_reference(seed):
    rng, leaf, table, _ = _seeded(seed)
    bps, bs = table.shape[1], leaf.shape[2]
    row = table[0]  # its last block is the out-of-range id: writes drop
    for width in (1, 3, 5):
        chunk = rng.standard_normal((leaf.shape[1], width, leaf.shape[3])).astype(np.float32)
        for start in range(0, bps * bs - width + 1, 2):
            ref = np.asarray(jax_attention.scatter_prefill_columns(
                jnp.asarray(leaf), jnp.asarray(row, jnp.int32), start,
                jnp.asarray(chunk)))
            ours = attention.scatter_prefill_columns(_t(leaf.copy()), _t(row), start,
                                                     _t(chunk)).numpy()
            np.testing.assert_array_equal(ours, ref)


def test_scatters_write_in_place():
    _, leaf, table, contig = _seeded(0)
    pool = _t(leaf.copy())
    out = attention.scatter_decode_columns(pool, _t(contig), _t(table),
                                           torch.zeros(4, dtype=torch.int64),
                                           torch.ones(4, dtype=torch.bool))
    assert out.data_ptr() == pool.data_ptr()


# -- the allocator against the reference's --------------------------------------


def _state(pool):
    return (pool._ref.tolist(), sorted(pool._free_blocks), pool.table.rows.tolist(),
            sorted(pool._free), sorted(pool.prefix._entries) if pool.prefix else None)


def test_seeded_churn_follows_the_reference(module, jax_decode_module):
    """Adversarial churn — admissions with shared prefixes, growth, forks,
    COW writes, chain-publishing releases — applied to both packages'
    pools: refcounts, free lists, block tables and prefix entries agree
    after every operation, and the invariant checker passes throughout."""
    rng = np.random.default_rng(0)
    ours = _pool(module, max_slots=4, max_len=16)
    ref = JaxPagedKVPool(jax_decode_module, 4, 16, block_size=4)
    live = {}
    vocab = list(range(50, 60))
    for _ in range(200):
        op = rng.choice(["admit", "grow", "fork", "release"])
        args = None
        if op == "admit" and ours.free_count > 0:
            args = [int(rng.choice(vocab)) for _ in range(int(rng.integers(1, 9)))]
        elif op == "grow" and live:
            slot = int(rng.choice(list(live)))
            args = (slot, int(rng.integers(0, 5)), [int(rng.choice(vocab)) for _ in range(8)])
        elif op in ("fork", "release") and live:
            args = int(rng.choice(list(live)))
        if args is None:
            continue
        errors = []
        for pool in (ours, ref):
            try:
                if op == "admit":
                    slot = pool.acquire()
                    pool.admit_prefix(slot, args)
                    if pool is ours:
                        live[slot] = list(args)
                    pool.ensure_cols(slot, len(args))
                elif op == "grow":
                    slot, extra, new = args
                    upto = min(len(live[slot]) + extra, pool.virtual_len)
                    pool.ensure_cols(slot, upto)
                    pool.ensure_writable(slot, upto - 1)
                    if pool is ref:
                        live[slot] += new[:upto - len(live[slot])]
                elif op == "fork" and pool.free_count > 0:
                    child = pool.fork_slot(args)
                    if pool is ref and child is not None:
                        live[child] = list(live[args])
                elif op == "release":
                    pool.release(args, tokens=live[args])
                    if pool is ref:
                        live.pop(args)
            except RuntimeError as e:
                assert "out of KV blocks" in str(e)
                errors.append(pool)
        assert len(errors) in (0, 2)
        assert _state(ours) == _state(ref)
        ours.assert_block_invariants()
    for slot in list(live):
        ours.release(slot, tokens=live.pop(slot))
    ours.assert_block_invariants()
    resident = {b for e in ours.prefix._entries.values() for b in e.blocks}
    assert ours.free_blocks + len(resident) == ours.num_blocks


def test_prefix_cache_follows_the_reference():
    ops = [("insert", (1, 2, 3, 4, 5, 6, 7, 8), [10, 11]),
           ("match", (1, 2, 3, 4, 5, 6, 7, 8, 9)),
           ("match", (1, 2, 3, 4, 5, 6, 7, 8)),
           ("match", (9, 9, 9, 9, 9)),
           ("insert", (1, 2, 3, 4, 20, 21, 22, 23), [10, 12]),
           ("match", (1, 2, 3, 4, 20, 21, 22, 23, 1))]
    refs = []
    for cache in (PrefixCache(block_size=4), JaxPrefixCache(block_size=4)):
        held = []
        out = [cache.insert(o[1], o[2], held.append) if o[0] == "insert"
               else cache.match(o[1]) for o in ops]
        out.append(cache.evict_lru(held.append).tokens)
        refs.append((out, held, cache.hits_total, cache.lookups_total,
                     cache.tokens_saved_total, cache.evictions_total, len(cache)))
    assert refs[0] == refs[1]


# -- the pools' own contracts -----------------------------------------------------


def test_block_acquire_release_refcount_invariants(module):
    pool = _pool(module)
    assert pool.free_blocks == pool.num_blocks
    slot = pool.acquire()
    pool.ensure_cols(slot, 10)  # 3 blocks at block_size=4
    assert pool.blocks_in_use == 3
    held = [int(b) for b in pool.table.rows[slot] if b >= 0]
    assert len(held) == 3 and all(pool._ref[b] == 1 for b in held)
    pool.assert_block_invariants()
    pool.release(slot)
    assert pool.free_blocks == pool.num_blocks
    pool.assert_block_invariants()


def test_invalidated_prefixes_and_older_slots_publish_nothing(module):
    """``invalidate_prefixes`` (every weight install) drops the resident
    entries with their references, and a slot acquired before it neither
    commits nor releases its blocks into the prefix cache; a slot
    acquired after it does."""
    pool = _pool(module)
    chain = (1, 2, 3, 4, 5, 6, 7, 8, 9)
    old = pool.acquire()
    pool.ensure_cols(old, len(chain))
    pool.commit_prefix(old, chain)
    assert len(pool.prefix) == 2
    assert pool.invalidate_prefixes() == 2 and len(pool.prefix) == 0
    pool.assert_block_invariants()
    pool.commit_prefix(old, chain)
    pool.release(old, tokens=chain)
    assert len(pool.prefix) == 0 and pool.free_blocks == pool.num_blocks
    new = pool.acquire()
    pool.ensure_cols(new, len(chain))
    pool.release(new, tokens=chain)
    assert len(pool.prefix) == 2
    assert pool.admit_prefix(pool.acquire(), chain) == 8
    pool.assert_block_invariants()


def test_double_releases_fail_loudly(module):
    pool = _pool(module)
    slot = pool.acquire()
    pool.ensure_cols(slot, 4)
    block = int(pool.table.rows[slot, 0])
    pool._decref(block)  # a corrupt row releasing early
    with pytest.raises(RuntimeError, match="double-released"):
        pool._decref(block)
    pool = _pool(module)
    slot = pool.acquire()
    pool.release(slot)
    with pytest.raises(ValueError, match="already free"):
        pool.release(slot)


def test_sizing_and_range_errors(module):
    pool = _pool(module, max_slots=2, num_blocks=6, prefix_cache=False)
    with pytest.raises(RuntimeError, match="no wholesale admit"):
        pool.admit(0, None, 0)
    a, b = pool.acquire(), pool.acquire()
    with pytest.raises(ValueError, match="columns"):
        pool.ensure_cols(a, pool.virtual_len + 1)
    pool.ensure_cols(a, pool.virtual_len)  # 6 blocks: takes everything
    with pytest.raises(RuntimeError, match="out of KV blocks"):
        pool.ensure_cols(b, 4)


def test_cow_fork_copies_the_block_and_isolates_writes(module):
    pool = _pool(module)
    parent = pool.acquire()
    pool.ensure_cols(parent, 8)
    pblock = int(pool.table.rows[parent, 0])
    for leaf in pool.cache.keys + pool.cache.values:
        leaf[pblock] = 7.5
    child = pool.fork_slot(parent)
    assert int(pool.table.rows[child, 0]) == pblock and pool._ref[pblock] == 2
    fresh = pool.ensure_writable(child, 0)
    assert fresh != pblock and pool._ref[pblock] == 1 and pool._ref[fresh] == 1
    for leaf in pool.cache.keys + pool.cache.values:
        assert torch.equal(leaf[fresh], leaf[pblock])
        leaf[fresh] = -3.0
        assert float(leaf[pblock].max()) == 7.5
    pool.assert_block_invariants()


def test_lru_eviction_under_pressure_notes_flight(module, flight):
    pool = _pool(module, max_slots=2, max_len=8)
    assert pool.num_blocks == 4
    for start in (0, 40):  # two resident 1-block chains
        slot = pool.acquire()
        pool.ensure_cols(slot, 4)
        pool.release(slot, tokens=list(range(start, start + 4)))
    pool.prefix.match(tuple(range(0, 4)) + (9,))  # freshen the first chain
    a, b = pool.acquire(), pool.acquire()
    pool.ensure_cols(a, pool.virtual_len)
    pool.ensure_cols(b, 4)  # a 3rd block only exists by evicting a prefix
    assert len(pool.prefix) == 1
    assert pool.prefix.match(tuple(range(0, 4)) + (9,))[0] == 4
    events = flight.events(kind="prefix_evict")
    assert len(events) == 1 and events[0].detail["blocks"] == 1
    pool.assert_block_invariants()


def test_block_table_reuploads_into_one_tensor():
    table = BlockTable(max_slots=2, blocks_per_slot=3, num_blocks=9,
                       device=torch.device("cpu"))
    dev = table.device()
    ptr = dev.data_ptr()
    assert dev.tolist() == [[9, 9, 9], [9, 9, 9]]
    table.set(1, 0, 4)
    table.set(0, 2, 7)
    assert table.device() is dev and dev.data_ptr() == ptr
    assert dev.tolist() == [[9, 9, 7], [4, 9, 9]]
    table.clear_row(0)
    assert table.device().tolist() == [[9, 9, 9], [4, 9, 9]]


def test_contiguous_pool_admits_in_place(module):
    from elephas_tpu_torch.models.transformer import make_decode_cache

    pool = KVCachePool(module, max_slots=3, max_len=12)
    ptrs = [t.data_ptr() for t in pool.tensors()]
    slot = pool.acquire()
    pre = make_decode_cache(module, 1, 12)
    for leaf in pre.keys + pre.values:
        leaf.fill_(2.0)
    pre.index = 5
    pool.admit(slot, pre, pad_offset=3)
    assert pool.cache.index[slot] == 5 and pool.pad[slot] == 3
    assert float(pool.cache.keys[0][slot].min()) == 2.0
    assert [t.data_ptr() for t in pool.tensors()] == ptrs
    assert pool.active_slots() == [slot] and pool.admitted_total == 1
    pool.release(slot)
    with pytest.raises(ValueError, match="already free"):
        pool.release(slot)


def test_paged_pool_layout_and_signals(module):
    pool = _pool(module, max_slots=3, max_len=24, block_size=5, virtual_len=30)
    assert pool.blocks_per_slot == 6 and pool.virtual_len == 30
    assert pool.num_blocks == 18
    assert tuple(pool.cache.keys[0].shape) == (18, 4, 5, 8)
    assert pool.device_table() is pool.table.buffer
    sig = pool.load_signals()
    assert sig == {"kv_blocks_free": 18, "kv_blocks_total": 18, "prefix_hit_rate": None}
    assert pool.prefix_stats()["prefix_lookups"] == 0
