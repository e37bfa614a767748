"""Slot-based KV-cache pools for continuous batching (counterpart of
``elephas_tpu/serving/kv_pool.py``).

``KVCachePool`` owns ONE decode cache of fixed shape — per layer,
keys/values of (max_slots, heads, max_len, head_dim), plus the per-slot
``index`` (max_slots,) column vector and the per-slot left-pad vector
``pad`` — so the decode step's operand shapes never change as sequences
come and go. Admission copies a finished prefill's batch-1 cache into a
free slot's row; eviction just returns the slot id to the free list,
since the next admission overwrites the row wholesale.

Per-slot state the model consumes each step:

- ``index`` — the column the slot's next token writes (advanced by the
  apply itself, per row, ONLY for rows the decode step's ``active``
  mask marks occupied: free slots' columns freeze so they cannot march
  past ``max_len`` between admissions);
- ``pad`` — the slot's left-pad column count (contiguous prompts are
  left-padded to the engine's fixed prefill width; the pad columns stay
  masked out of attention for the sequence's whole lifetime).

``PagedKVPool`` is the block/paged successor — the vLLM layout: fixed-
size physical KV blocks shared across slots through a reference-counted
``BlockTable``, a ``PrefixCache`` that admits already-resident prompt
prefixes by bumping refcounts instead of re-prefilling, LRU eviction of
unreferenced prefixes under allocation pressure, and copy-on-write at
any shared boundary a fork creates. The contiguous pool stays as the
oracle the paged path is tested token-identical against (and the
``paged=False`` engine mode).

Under tensor parallelism (``InferenceEngine.shard_serving``) each rank's
pool holds its ``heads / M`` heads of every K/V tensor, laid out as
``parallel.tensor_parallel.decode_cache_specs`` says (``shard_heads``);
the slot and block bookkeeping lives on rank 0, whose pool reports each
device write or read it makes outside the engine's programs (an
admission, a copy-on-write, a handoff's export or import) through
``mirror`` so the other ranks repeat it. A handoff's blocks cross with
all the heads (``gather_blocks``, ``write_blocks``): a frame from a
sharded pool is a frame from an unsharded pool of either package.

Donation: the reference donates the pool to every program that
rewrites it, and reading a donated (stale) tree raises
``DonatedBufferError``. Torch has no donation: the programs here write
the pool's tensors IN PLACE, every tensor keeps its address for the
pool's lifetime (which is also what lets the paged decode step be
captured once in a CUDA graph), and ``swap`` only rebinds.
``DonatedBufferError`` stays exported for callers written against the
reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from elephas_tpu_torch.parallel.collectives import all_gather, local_chunk
from elephas_tpu_torch.serving import host_sync


class DonatedBufferError(RuntimeError):
    """A pool cache reference was read after its buffers were donated.

    Kept for callers written against the reference: the port writes the
    pool in place, so nothing raises it."""


class KVCachePool:
    """Fixed-shape KV cache + slot bookkeeping for the serving engine.

    ``decode_module``: the port's ``TransformerLM``.
    ``max_slots``: decode batch width (concurrent sequences).
    ``max_len``: cache columns per slot — an admitted sequence may run
    to ``prefill_len + generated <= max_len``.

    The live cache is ``cache`` (a ``models.transformer.DecodeCache``
    whose ``index`` is the per-slot column vector); ``swap`` rebinds it
    after a program returns it (the same object: programs write in
    place).
    """

    def __init__(self, decode_module, max_slots: int, max_len: int):
        from elephas_tpu_torch.models.transformer import make_decode_cache

        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = decode_module.device
        self.cache = make_decode_cache(decode_module, max_slots, max_len)
        self.cache.index = torch.zeros((max_slots,), dtype=torch.int64,
                                       device=self.device)
        self.pad = torch.zeros((max_slots,), dtype=torch.int64,
                               device=self.device)
        self._free: List[int] = list(range(max_slots))
        self.admitted_total = 0  # lifetime admissions (slot reuse visible)
        self.mirror = None  # rank 0 of a sharded engine: (op, *ints, payload=) -> None
        self.model_group = None  # the group the heads split over (shard_heads)

    def shard_heads(self, mesh) -> None:
        """Keep this rank's heads of every K/V tensor (dim 1 split into
        ``mesh.size`` chunks, ``decode_cache_specs``' layout). Only on an
        empty pool: the tensors are new (a captured step must come after)."""
        self.model_group = mesh
        self.cache.keys = [local_chunk(k, mesh, 1).contiguous() for k in self.cache.keys]
        self.cache.values = [local_chunk(v, mesh, 1).contiguous() for v in self.cache.values]

    def swap(self, new_cache, new_pad=None) -> None:
        """Install the cache (and optionally pad) a program returned."""
        self.cache = new_cache
        if new_pad is not None:
            self.pad = new_pad

    def tensors(self) -> List[torch.Tensor]:
        """Every device tensor the pool holds (keys, values, the column
        and pad vectors, and a paged pool's block table): their addresses
        are constant for the pool's lifetime."""
        return [*self.cache.keys, *self.cache.values, self.cache.index,
                self.pad]

    # -- slot bookkeeping --------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.max_slots - len(self._free)

    def active_slots(self) -> List[int]:
        """Occupied slot ids, ascending (the decode step's active mask)."""
        free = set(self._free)
        return [s for s in range(self.max_slots) if s not in free]

    def acquire(self) -> Optional[int]:
        """Claim a free slot id, or None when the pool is saturated."""
        if not self._free:
            return None
        return self._free.pop()

    def admit(self, slot: int, prefill_cache, pad_offset: int) -> None:
        """Copy a finished batch-1 prefill into ``slot`` (in place) and
        record its left-pad count. The prefill cache's index carries the
        write position (= prefill length) into the slot's column."""
        if self.mirror is not None:
            self.mirror("admit", slot, pad_offset)
        with torch.no_grad():
            for pool_leaf, pre_leaf in zip(
                    self.cache.keys + self.cache.values,
                    prefill_cache.keys + prefill_cache.values):
                pool_leaf[slot].copy_(pre_leaf[0])
            self.cache.index[slot] = prefill_cache.index
            self.pad[slot] = pad_offset
        self.admitted_total += 1

    def release(self, slot: int) -> None:
        """Return ``slot`` to the free list. No device work: in THIS
        contiguous layout the slot exclusively owns its cache row, so
        the stale contents are simply overwritten by the next admit.
        (``PagedKVPool.release`` is the refcount-aware version.)
        Double-release raises."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.max_slots})")
        self._free.append(slot)


# -- paged layout ------------------------------------------------------------


class BlockTable:
    """Host-side ``slot -> physical block ids`` map with a device mirror.

    Rows are ``-1`` where unallocated. The device mirror substitutes the
    OUT-OF-RANGE id ``num_blocks`` for ``-1`` (gathers clamp it, scatters
    drop it: ``ops.attention``'s paged helpers), lives in ONE device
    tensor for the table's lifetime, and is re-uploaded into that tensor
    only when a row changed (the dirty flag) — a CUDA graph that reads it
    keeps reading the current table."""

    def __init__(self, max_slots: int, blocks_per_slot: int,
                 num_blocks: int, device: torch.device):
        self.num_blocks = num_blocks
        self.rows = np.full((max_slots, blocks_per_slot), -1, np.int64)
        self.buffer = torch.full((max_slots, blocks_per_slot), num_blocks,
                                 dtype=torch.int64, device=device)
        self._dirty = False

    def set(self, slot: int, index: int, block: int) -> None:
        self.rows[slot, index] = block
        self._dirty = True

    def clear_row(self, slot: int) -> None:
        self.rows[slot, :] = -1
        self._dirty = True

    def invalidate(self) -> None:
        self._dirty = True

    def device(self) -> torch.Tensor:
        if self._dirty:
            host = np.where(self.rows < 0, self.num_blocks, self.rows)
            host_sync.upload(host, self.buffer.device, out=self.buffer)
            self._dirty = False
        return self.buffer


class _PrefixEntry:
    __slots__ = ("tokens", "blocks", "recency")

    def __init__(self, tokens, blocks, recency):
        self.tokens = tokens
        self.blocks = blocks
        self.recency = recency


class PrefixCache:
    """Resident-prefix index: token chains → the physical blocks that
    already hold their K/V.

    Entries are keyed by the exact token tuple of a FULL-block prefix
    (tuple equality keeps collisions impossible, so a hit can never
    silently serve the wrong prefix). Every full-block prefix of an
    inserted chain gets its own entry — a new prompt can resume from ANY
    block boundary of an old conversation. Each entry holds one reference
    on each of its blocks (the pool's refcounts), so resident prefixes
    pin their blocks until evicted.

    Eviction is LRU over entries, triggered by the pool on allocation
    pressure; ``match`` is capped one token short of the prompt so at
    least one suffix token always prefills.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._entries: Dict[Tuple[int, ...], _PrefixEntry] = {}
        self._tick = 0
        self.hits_total = 0
        self.lookups_total = 0
        self.tokens_saved_total = 0
        self.evictions_total = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> Optional[float]:
        if not self.lookups_total:
            return None
        return self.hits_total / self.lookups_total

    def match(self, prompt: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest resident full-block prefix STRICTLY shorter than the
        prompt; returns ``(matched_token_count, block_ids)`` (0, [] on a
        miss). Bumps recency and the hit counters."""
        self.lookups_total += 1
        bs = self.block_size
        prompt = tuple(prompt)
        for k in range((len(prompt) - 1) // bs, 0, -1):
            entry = self._entries.get(prompt[:k * bs])
            if entry is not None:
                self._tick += 1
                entry.recency = self._tick
                self.hits_total += 1
                self.tokens_saved_total += k * bs
                return k * bs, list(entry.blocks)
        return 0, []

    def insert(self, chain: Sequence[int], blocks: Sequence[int],
               incref) -> int:
        """Register every full-block prefix of ``chain`` (``blocks[i]``
        holds tokens ``[i*bs, (i+1)*bs)``), taking one reference per
        entry per block via ``incref``. Token chains already resident
        keep their existing entry. Returns the number of entries added."""
        bs = self.block_size
        chain = tuple(chain)
        added = 0
        for k in range(1, min(len(chain) // bs, len(blocks)) + 1):
            key = chain[:k * bs]
            if key in self._entries:
                continue
            held = tuple(blocks[:k])
            for b in held:
                incref(b)
            self._tick += 1
            self._entries[key] = _PrefixEntry(key, held, self._tick)
            added += 1
        return added

    def clear(self, decref) -> int:
        """Drop every entry, releasing its block references through
        ``decref`` (no eviction is counted). Returns the entries dropped."""
        entries, self._entries = self._entries, {}
        for entry in entries.values():
            for b in entry.blocks:
                decref(b)
        return len(entries)

    def evict_lru(self, decref) -> Optional[_PrefixEntry]:
        """Drop the least-recently-used entry, releasing its block
        references through ``decref``. Returns it (None when empty)."""
        if not self._entries:
            return None
        key = min(self._entries, key=lambda k: self._entries[k].recency)
        entry = self._entries.pop(key)
        for b in entry.blocks:
            decref(b)
        self.evictions_total += 1
        return entry


class PagedKVPool(KVCachePool):
    """Block/paged KV pool: fixed-size physical blocks shared across
    slots through a ``BlockTable``, reference-counted, with a
    ``PrefixCache`` so prompts whose prefix is already resident admit by
    bumping refcounts instead of re-prefilling.

    Layout: every K/V tensor is ``(num_blocks, heads, block_size,
    head_dim)``; a slot's logical cache row is the concatenation of its
    table row's blocks — a VIRTUAL length ``blocks_per_slot * block_size
    >= max_len`` (ceil, so ``block_size`` need not divide ``max_len``).
    The engine's decode and chunk-prefill programs gather through the
    table, run the same dense cache-attention forward as the contiguous
    pool (token identity by construction), and scatter back exactly the
    columns they wrote (``ops.attention`` paged helpers).

    Invariants the allocator maintains (and tests pin):

    - a block is in the free list iff its refcount is 0;
    - a slot's row references each of its blocks exactly once, a prefix
      cache entry once per entry containing it;
    - ``release`` decrefs, never abandons — double-releasing a block
      raises ``RuntimeError`` loudly;
    - allocation under pressure evicts prefix entries LRU-first (flight
      kind ``prefix_evict``), and with the default ``num_blocks =
      max_slots * blocks_per_slot`` sizing can never dead-end.

    Writes never touch a shared block in normal serving: prefix matches
    cover full blocks only and prefill resumes at the block-aligned
    boundary. ``ensure_writable`` is the copy-on-write safety net for
    explicit ``fork_slot`` aliases.
    """

    def __init__(self, decode_module, max_slots: int, max_len: int,
                 block_size: int, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 virtual_len: Optional[int] = None):
        from elephas_tpu_torch.models.transformer import make_paged_decode_cache

        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.max_slots = max_slots
        self.max_len = max_len
        self.block_size = block_size
        self.device = decode_module.device
        # Virtual row length: enough blocks for max_len columns AND for
        # the widest prefill-chunk write window (a chunk starting at the
        # last prompt column must slice/scatter without clamping).
        need = max(max_len, virtual_len or 0)
        self.blocks_per_slot = -(-need // block_size)
        self.virtual_len = self.blocks_per_slot * block_size
        self.num_blocks = (
            num_blocks if num_blocks is not None
            else max_slots * self.blocks_per_slot
        )
        if self.num_blocks < self.blocks_per_slot:
            raise ValueError(
                f"num_blocks ({self.num_blocks}) cannot back even one "
                f"slot ({self.blocks_per_slot} blocks per slot)"
            )
        self.cache = make_paged_decode_cache(
            decode_module, max_slots, self.num_blocks, block_size
        )
        # Paged prompts are never left-padded (shared prefixes must land
        # at identical cache columns in every slot); the zero pad vector
        # keeps the decode signature identical to the contiguous pool.
        self.pad = torch.zeros((max_slots,), dtype=torch.int64,
                               device=self.device)
        self._free: List[int] = list(range(max_slots))
        self.admitted_total = 0
        self.table = BlockTable(max_slots, self.blocks_per_slot,
                                self.num_blocks, self.device)
        self._ref = np.zeros((self.num_blocks,), np.int64)
        self._free_blocks: List[int] = list(range(self.num_blocks))
        self.prefix = PrefixCache(block_size) if prefix_cache else None
        # The served weights' epoch (``invalidate_prefixes``) and the one
        # each slot was acquired in: a slot whose K/V older weights wrote
        # never publishes them to the prefix cache.
        self._epoch = 0
        self._slot_epoch: Dict[int, int] = {}
        # Lazy process-registry mirror (the fleet aggregator federates
        # these from /metrics scrapes).
        self._mirror = None
        self._pushed_hits = 0
        self._pushed_lookups = 0
        # Per-tenant cost attribution (obs/tenancy.py): the scheduler
        # names each slot's owning tenant before binding any blocks, and
        # the pool integrates block-seconds (elapsed seconds x resident
        # block count) into the attached CostLedger at every block-count
        # change and at release.
        self._costs = None
        self._cost_clock = None
        self._owner: Dict[int, Optional[str]] = {}
        self._billed_at: Dict[int, float] = {}
        self.mirror = None
        self.model_group = None

    def tensors(self) -> List[torch.Tensor]:
        return super().tensors() + [self.table.buffer]

    def acquire(self) -> Optional[int]:
        slot = super().acquire()
        if slot is not None:
            self._slot_epoch[slot] = self._epoch
        return slot

    def invalidate_prefixes(self) -> int:
        """Forget every resident prefix: the served weights changed
        (``InferenceEngine.install_weights``), and the K/V the old ones
        wrote would otherwise admit new requests by refcount. The entries'
        block references are released, and a slot acquired before now
        publishes nothing to the prefix cache (``commit_prefix``,
        ``release``): its blocks hold the old weights' K/V. The JAX
        package keeps its prefixes across a swap (ROADMAP, deliberate
        differences). Returns the entries dropped."""
        self._epoch += 1
        return self.prefix.clear(self._decref) if self.prefix is not None else 0

    def _publishes(self, slot: int) -> bool:
        return self.prefix is not None and self._slot_epoch.get(slot) == self._epoch

    # -- block accounting ----------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free_blocks)

    def _incref(self, block: int) -> None:
        self._ref[block] += 1

    def _decref(self, block: int) -> None:
        if self._ref[block] <= 0:
            raise RuntimeError(
                f"KV block {block} double-released: refcount is already 0 "
                "(a slot row or prefix entry decref'd a block it did not "
                "hold — allocator bookkeeping is corrupt)"
            )
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free_blocks.append(block)

    def _alloc_block(self) -> int:
        """Claim a free block (refcount 1). Under pressure, evict
        least-recently-used prefix-cache entries until one frees — with
        default sizing this always terminates before the cache empties."""
        from elephas_tpu_torch import obs

        while not self._free_blocks:
            entry = (self.prefix.evict_lru(self._decref)
                     if self.prefix is not None else None)
            if entry is None:
                raise RuntimeError(
                    f"out of KV blocks ({self.num_blocks} total, "
                    f"{self.max_slots} slots x {self.blocks_per_slot} "
                    "blocks/slot needed worst-case) and no evictable "
                    "prefix entries — num_blocks is undersized"
                )
            obs.default_flight_recorder().note(
                "prefix_evict", "info", blocks=len(entry.blocks),
                tokens=len(entry.tokens),
                resident=len(self.prefix),
            )
        block = self._free_blocks.pop()
        self._incref(block)
        return block

    # -- per-tenant occupancy billing ----------------------------------------

    def attach_cost_ledger(self, ledger, clock=None) -> None:
        """Wire a ``CostLedger`` so slot block occupancy bills to each
        slot's owning tenant as KV block-seconds. ``clock`` defaults to
        the ledger's own clock."""
        self._costs = ledger
        self._cost_clock = clock if clock is not None else ledger.clock

    def set_slot_owner(self, slot: int, tenant: Optional[str]) -> None:
        """Name the tenant billed for ``slot``'s block occupancy from
        this instant on (called BEFORE ``admit_prefix`` so prefix-bound
        blocks bill from their first resident moment)."""
        self._owner[slot] = tenant
        if self._cost_clock is not None:
            self._billed_at[slot] = self._cost_clock()

    def _bill_slot(self, slot: int, *, cow: bool = False) -> None:
        """Integrate ``slot``'s occupancy since its last bill into the
        attached ledger: elapsed seconds x blocks currently resident.
        ``cow=True`` additionally counts a copy-on-write block copy."""
        if self._costs is None:
            return
        last = self._billed_at.get(slot)
        if last is None:
            return  # slot never owned: nothing to attribute
        now = self._cost_clock()
        blocks = int((self.table.rows[slot] >= 0).sum())  # host-ok: numpy table
        seconds = (now - last) * blocks
        self._billed_at[slot] = now
        if seconds > 0.0 or cow:
            self._costs.record_block_seconds(
                self._owner.get(slot), seconds, cow=cow)

    def assert_block_invariants(self) -> None:
        """Free-list/refcount conservation — every block is either free
        (refcount 0) or accounted for by exactly its refcount many
        holders (slot rows + prefix entries). NOT on the hot path."""
        free = set(self._free_blocks)
        assert len(free) == len(self._free_blocks), "free list has dupes"
        holders = np.zeros((self.num_blocks,), np.int64)
        for row in self.table.rows:
            for b in row:
                if b >= 0:
                    holders[b] += 1
        if self.prefix is not None:
            for entry in self.prefix._entries.values():
                for b in entry.blocks:
                    holders[b] += 1
        for b in range(self.num_blocks):
            assert (b in free) == (self._ref[b] == 0), (
                f"block {b}: ref={self._ref[b]} vs free={b in free}")
            assert self._ref[b] == holders[b], (
                f"block {b}: ref={self._ref[b]} != holders={holders[b]}")

    # -- slot lifecycle ------------------------------------------------------

    def admit(self, slot, prefill_cache, pad_offset) -> None:
        raise RuntimeError(
            "PagedKVPool has no wholesale admit: prefill writes through "
            "the block table (the engine's chunked-prefill program), "
            "then the scheduler activates the slot"
        )

    def admit_prefix(self, slot: int, prompt: Sequence[int]) -> int:
        """Bind the longest resident prefix of ``prompt`` to ``slot``
        (bump refcounts, no device work, no prefill compute). Returns
        the matched token count — prefill resumes at that column."""
        if self.prefix is None:
            return 0
        self._bill_slot(slot)  # close the zero-block window pre-bind
        matched, blocks = self.prefix.match(prompt)
        for i, b in enumerate(blocks):
            self._incref(b)
            self.table.set(slot, i, b)
        self._mirror_push()
        return matched

    def commit_prefix(self, slot: int, prompt: Sequence[int]) -> None:
        """Publish ``slot``'s freshly-prefilled prompt to the prefix
        cache (full blocks only) so requests arriving DURING this
        conversation can share it — not just after release."""
        if not self._publishes(slot):
            return
        row = self.table.rows[slot]
        nfull = len(prompt) // self.block_size
        blocks = [int(row[i]) for i in range(nfull)]  # host-ok: numpy table
        assert all(b >= 0 for b in blocks), (
            f"slot {slot}: prompt columns not fully backed at commit")
        self.prefix.insert(tuple(prompt)[:nfull * self.block_size],
                           blocks, self._incref)
        self._mirror_push()

    def ensure_cols(self, slot: int, upto: int) -> None:
        """Back columns ``[0, upto)`` of ``slot`` with physical blocks
        (prefix-shared blocks already in the row count as backed)."""
        if upto > self.virtual_len:
            raise ValueError(
                f"slot {slot} needs column {upto - 1} but rows are "
                f"{self.virtual_len} columns"
            )
        self._bill_slot(slot)  # per-decode-step occupancy integration
        row = self.table.rows[slot]
        for i in range(-(-upto // self.block_size)):
            if row[i] < 0:
                self.table.set(slot, i, self._alloc_block())
        self._mirror_push()

    def ensure_decode_col(self, slot: int, col: int) -> None:
        """Back (and exclusively own) the single column the next decode
        step writes for ``slot``."""
        self.ensure_cols(slot, col + 1)
        self.ensure_writable(slot, col)

    def ensure_writable(self, slot: int, col: int) -> int:
        """Copy-on-write guard: make the block backing ``col``
        exclusively owned by ``slot`` before a write. Normal serving
        never triggers the copy; ``fork_slot`` aliases do. Returns the
        (possibly fresh) physical block id."""
        i = col // self.block_size
        block = int(self.table.rows[slot, i])  # host-ok: numpy table
        if block < 0:
            raise ValueError(f"slot {slot} column {col} is unallocated")
        if self._ref[block] == 1:
            return block
        self._bill_slot(slot, cow=True)
        fresh = self._alloc_block()
        if self.mirror is not None:
            self.mirror("copy_block", block, fresh)
        with torch.no_grad():
            for leaf in self.cache.keys + self.cache.values:
                leaf[fresh].copy_(leaf[block])
        self.table.set(slot, i, fresh)
        self._decref(block)
        self._mirror_push()
        return fresh

    def fork_slot(self, parent: int) -> Optional[int]:
        """Alias a fresh slot over ``parent``'s blocks (refcounts bumped,
        zero device copies) — both slots read the same physical K/V until
        one writes, at which point ``ensure_writable`` copies just the
        written block. Returns the child slot id, or None when the pool
        is out of slots."""
        if parent in self._free:
            raise ValueError(f"slot {parent} is free; nothing to fork")
        child = self.acquire()
        if child is None:
            return None
        self._slot_epoch[child] = self._slot_epoch.get(parent)
        for i, b in enumerate(self.table.rows[parent]):
            if b >= 0:
                self._incref(int(b))  # host-ok: numpy table
                self.table.set(child, i, int(b))  # host-ok: numpy table
        if parent in self._owner:
            self.set_slot_owner(child, self._owner[parent])
        return child

    def release(self, slot: int,
                tokens: Optional[Sequence[int]] = None) -> None:
        """Refcount-aware release: ``slot`` returns to the free list and
        DROPS one reference on each of its blocks — shared blocks
        survive for their other holders. ``tokens`` — the slot's full
        token chain, prompt + generated — lets the prefix cache adopt
        the full-block prefixes before the references drop. Double-
        releasing the slot raises ``ValueError``; a corrupt row that
        decrefs a free block raises ``RuntimeError``."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        if not 0 <= slot < self.max_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.max_slots})")
        self._bill_slot(slot)  # closing bill: occupancy up to release
        self._owner.pop(slot, None)
        self._billed_at.pop(slot, None)
        row = self.table.rows[slot]
        if tokens is not None and self._publishes(slot):
            backed = int((row >= 0).sum())  # host-ok: numpy table
            nfull = min(len(tokens) // self.block_size, backed)
            if nfull > 0:
                self.prefix.insert(
                    tuple(tokens)[:nfull * self.block_size],
                    [int(row[i]) for i in range(nfull)],  # host-ok: numpy table
                    self._incref,
                )
        for b in row:
            if b >= 0:
                self._decref(int(b))  # host-ok: numpy table
        self.table.clear_row(slot)
        self._free.append(slot)
        self._mirror_push()

    # -- cross-tier KV handoff -----------------------------------------------
    #
    # The disaggregated-serving transfer unit: a prefill engine exports one
    # slot's filled blocks to the host (``export_blocks``), the wire codec
    # frames them (``parameter.wire.encode_kv_blocks``), and the decode
    # engine rebinds them into its own pool (``import_blocks``) — refcounts
    # are TRANSFERRED, not copied: the exporter's references drop with its
    # normal ``release``, the importer derives fresh references locally
    # (slot row + prefix-chain entries), and the billing window moves with
    # the blocks (closed at export, reopened by the importer's
    # ``set_slot_owner``) so cross-tier block-seconds never double-bill.

    def _kv_leaf_names(self) -> Tuple[List[str], List[torch.Tensor]]:
        """(names, tensors) of every K/V tensor, named and ordered as the
        JAX package's paged cache flattens for the same model
        (``jax.tree_util.keystr`` of each rank-4 leaf: layers in sorted
        key order, ``Block_10`` before ``Block_2``), so a frame exported by
        either package imports into the other."""
        layers = sorted(range(len(self.cache.keys)), key=lambda i: f"Block_{i}")
        names, leaves = [], []
        for i in layers:
            for name, leaf in (("cached_key", self.cache.keys[i]),
                               ("cached_value", self.cache.values[i])):
                names.append(f"['Block_{i}']['SelfAttention_0']['{name}']")
                leaves.append(leaf)
        return names, leaves

    def gather_blocks(self, ids: torch.Tensor) -> torch.Tensor:
        """Every K/V tensor at block ``ids`` (a device tensor), stacked in
        ``_kv_leaf_names`` order: ``(leaves, blocks, heads, block_size,
        head_dim)`` with all the heads. On a sharded pool each rank selects
        its heads and they are gathered over the model group in rank order
        (every rank calls it: rank 0 from ``export_blocks``, the others on
        its ``"export"`` message)."""
        _, leaves = self._kv_leaf_names()
        with torch.no_grad():
            local = torch.stack([leaf.index_select(0, ids) for leaf in leaves])
        if self.model_group is None:
            return local
        return all_gather(local, self.model_group, dim=2)

    def write_blocks(self, ids: torch.Tensor, payload: Optional[torch.Tensor] = None) -> None:
        """Write ``payload`` (``(leaves, blocks, heads, block_size,
        head_dim)`` in ``_kv_leaf_names`` order, with all the heads) into
        block ``ids`` of every K/V tensor, in place. On a sharded pool rank
        0 (from ``import_blocks``) broadcasts it over the model group, the
        other ranks take it on its ``"import"`` message (passing None), and
        each rank keeps its heads."""
        _, leaves = self._kv_leaf_names()
        group = self.model_group
        if group is not None:
            if payload is None:
                like = leaves[0]
                payload = torch.empty(
                    (len(leaves), ids.numel(), like.shape[1] * group.size, *like.shape[2:]),
                    dtype=like.dtype, device=self.device)
            dist.broadcast(payload, src=dist.get_global_rank(group.group, 0), group=group.group)
            payload = local_chunk(payload, group, 2)
        with torch.no_grad():
            for leaf, blocks in zip(leaves, payload.unbind(0)):
                leaf.index_copy_(0, ids, blocks)

    def export_blocks(self, slot: int) -> Dict:
        """Copy ``slot``'s resident blocks to the host for a cross-tier
        handoff.

        Returns ``{"block_size", "blocks", "leaves", "arrays"}`` —
        ``arrays[i]`` is the ``(blocks, heads, block_size, head_dim)`` CPU
        tensor of leaf ``leaves[i]`` at the slot's block ids, in row
        order (one device gather and one copy to the host for all of
        them), with every head of the model on a sharded pool too
        (``gather_blocks``). Also CLOSES the slot's block-seconds billing window:
        occupancy up to this instant bills the owning tenant here, the
        later local ``release`` bills nothing, and the decode engine's
        ``set_slot_owner`` opens the next window, so summed cross-tier
        block-seconds equal a single engine's."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is free; nothing to export")
        row = self.table.rows[slot]
        n = int((row >= 0).sum())  # host-ok: numpy table
        if n == 0:
            raise ValueError(f"slot {slot} has no resident blocks")
        self._bill_slot(slot)
        self._owner.pop(slot, None)
        self._billed_at.pop(slot, None)
        names, _ = self._kv_leaf_names()
        blocks = np.asarray(row[:n], np.int64)  # host-ok: numpy table
        if self.mirror is not None:
            self.mirror("export", n, payload=blocks)
        host = host_sync.fetch_tensor(host_sync.stage(
            self.gather_blocks(host_sync.upload(blocks, self.device))))
        return {
            "block_size": self.block_size,
            "blocks": n,
            "leaves": names,
            "arrays": list(host.unbind(0)),
        }

    def import_blocks(self, slot: int, tokens: Sequence[int], arrays,
                      leaf_names: Optional[Sequence[str]] = None) -> int:
        """Rebind an exported block set to ``slot`` of THIS pool.

        ``tokens`` is the chain the blocks hold (the prompt: exactly the
        columns with K/V written). ``arrays`` are CPU tensors or NumPy
        arrays in ``_kv_leaf_names`` order. The local prefix cache is
        consulted first: matched full-block prefixes admit by incref (a
        shared system prompt costs no upload past its first import), only
        the remaining blocks allocate and upload — into the pool's own
        tensors, in place — and the full-block chain is inserted into this
        pool's ``PrefixCache``. Returns the matched token count. The
        caller owns slot acquisition and ``set_slot_owner`` (which opens
        the billing window the exporter closed). Raises ``ValueError`` on
        any structural mismatch, before anything binds. A sharded pool
        takes a frame with every head of the model, as an unsharded one
        does: rank 0 matches and allocates, then each rank writes its
        heads of the uploaded blocks (``write_blocks``); matched prefix
        blocks are resident on every rank already."""
        bs = self.block_size
        if slot in self._free:
            raise ValueError(f"slot {slot} is free; acquire it first")
        names, leaves = self._kv_leaf_names()
        if leaf_names is not None and list(leaf_names) != names:
            raise ValueError(
                f"handoff leaf structure mismatch: got {list(leaf_names)}, "
                f"this pool has {names}"
            )
        if len(arrays) != len(names):
            raise ValueError(
                f"handoff carries {len(arrays)} leaves, pool has {len(names)}"
            )
        try:
            arrays = [a if isinstance(a, torch.Tensor)
                      else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        except TypeError as exc:
            raise ValueError(f"handoff leaf has no tensor dtype: {exc}") from exc
        n_blocks = int(arrays[0].shape[0]) if arrays else 0  # host-ok: host array
        split = 1 if self.model_group is None else self.model_group.size
        for name, leaf, arr in zip(names, leaves, arrays):
            want = (n_blocks, leaf.shape[1] * split) + tuple(leaf.shape[2:])
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"handoff leaf {name} shape {tuple(arr.shape)} != {want}"
                )
            if arr.dtype != leaf.dtype:
                raise ValueError(
                    f"handoff leaf {name} dtype {arr.dtype} != {leaf.dtype}"
                )
        if not tokens or n_blocks != -(-len(tokens) // bs):
            raise ValueError(
                f"handoff block count {n_blocks} does not back "
                f"{len(tokens)} tokens at block size {bs}"
            )
        if n_blocks > self.blocks_per_slot:
            raise ValueError(
                f"handoff needs {n_blocks} blocks/slot, rows have "
                f"{self.blocks_per_slot}"
            )
        self._bill_slot(slot)  # close the zero-block window pre-bind
        matched, mblocks = (
            self.prefix.match(tokens) if self.prefix is not None else (0, [])
        )
        for i, b in enumerate(mblocks):
            self._incref(b)
            self.table.set(slot, i, b)
        start = matched // bs
        fresh = []
        try:
            for i in range(start, n_blocks):
                b = self._alloc_block()
                self.table.set(slot, i, b)
                fresh.append(b)
        except RuntimeError:
            # Out of blocks mid-import: unwind every reference this
            # import took so the slot releases clean.
            for i in range(start + len(fresh)):
                self._decref(int(self.table.rows[slot][i]))  # host-ok: numpy table
            self.table.clear_row(slot)
            raise
        # matched < len(tokens) (a match is strictly shorter), so at least
        # one block always uploads.
        ids = np.asarray(fresh, np.int64)  # host-ok: host list
        if self.mirror is not None:
            self.mirror("import", len(fresh), payload=ids)
        self.write_blocks(host_sync.upload(ids, self.device), host_sync.upload(
            torch.stack([a[start:].contiguous() for a in arrays]), self.device))
        with torch.no_grad():
            self.cache.index[slot] = len(tokens)
        self.commit_prefix(slot, tokens)
        self._mirror_push()
        return matched

    # -- program operands ----------------------------------------------------

    def device_table(self) -> torch.Tensor:
        """The (max_slots, blocks_per_slot) device block table the
        gather/scatter programs read (unallocated = the out-of-range id
        ``num_blocks``), brought up to date with the host rows. Always
        the same tensor."""
        return self.table.device()

    # -- saturation-plane signals --------------------------------------------

    def load_signals(self) -> dict:
        """Block-granular KV pressure for the load tracker."""
        return {
            "kv_blocks_free": len(self._free_blocks),
            "kv_blocks_total": self.num_blocks,
            "prefix_hit_rate": (
                self.prefix.hit_rate if self.prefix is not None else None
            ),
        }

    def prefix_stats(self) -> dict:
        if self.prefix is None:
            return {"prefix_hits": 0, "prefix_lookups": 0,
                    "prefix_hit_rate": None, "prefix_tokens_saved": 0,
                    "prefix_evictions": 0, "prefix_resident": 0}
        return {
            "prefix_hits": self.prefix.hits_total,
            "prefix_lookups": self.prefix.lookups_total,
            "prefix_hit_rate": self.prefix.hit_rate,
            "prefix_tokens_saved": self.prefix.tokens_saved_total,
            "prefix_evictions": self.prefix.evictions_total,
            "prefix_resident": len(self.prefix),
        }

    def _mirror_push(self) -> None:
        mirror = self._mirror
        if mirror is None:
            try:
                from elephas_tpu_torch import obs

                reg = obs.default_registry()
                mirror = (
                    reg.gauge("serving_kv_blocks_free",
                              help="unreferenced KV blocks in the paged "
                                   "pool"),
                    reg.counter("serving_prefix_cache_hit_total",
                                help="prompt admissions that reused a "
                                     "resident prefix"),
                    reg.counter("serving_prefix_cache_lookup_total",
                                help="prompt admissions that consulted "
                                     "the prefix cache"),
                    reg.gauge("serving_prefix_cache_hit_rate",
                              help="lifetime prefix-cache hit rate"),
                )
            except Exception:
                mirror = False
            self._mirror = mirror
        if not mirror:
            return
        gauge_free, hit_counter, lookup_counter, rate_gauge = mirror
        gauge_free.set(len(self._free_blocks))
        if self.prefix is not None:
            hit_counter.inc(self.prefix.hits_total - self._pushed_hits)
            lookup_counter.inc(
                self.prefix.lookups_total - self._pushed_lookups
            )
            self._pushed_hits = self.prefix.hits_total
            self._pushed_lookups = self.prefix.lookups_total
            rate = self.prefix.hit_rate
            if rate is not None:
                rate_gauge.set(rate)
