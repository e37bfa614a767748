"""Speculative decoding: draft-and-verify serving decode, token-identical
by construction (counterpart of ``elephas_tpu/serving/spec.py``).

The decode hot path pays one dense target forward per emitted token. A
``SpeculativeDecoder`` instead drafts ``gamma`` tokens per slot with a
cheap ``DraftSource`` and verifies the whole window in ONE batched
target forward (seq = gamma + 1 through the same paged pool), emitting
between 1 and gamma + 1 tokens per window.

**Identity discipline.** Acceptance is EXACT-MATCH, not the
probabilistic Leviathan/Chen rule: the verify forward samples the
target's own token at every window position (greedy argmax, or the
position-keyed draw of ``models.transformer.sample_tokens_at``), a draft
token is accepted iff it EQUALS the target's sample at that position,
and the emitted tokens are always the target's samples ``tgt[:a+1]``
(``a`` = length of the matching prefix). The emitted stream is
therefore the plain decode's stream for greedy AND temperature-matched
sampling — the draft only decides how many target samples one forward
yields, never what they are. (On the card a forward over gamma + 1
columns may round differently from gamma + 1 one-column forwards, so a
near-tie of the target's scores can break the other way; that is the
only difference from plain decode.)

**Cache story.** No new layout: the verify forward gathers the paged
pool contiguous exactly like plain decode, writes all gamma + 1 columns
back through ``ops.attention.scatter_spec_columns``, and ROLLS BACK
rejected suffixes on the device by resetting the pool's one column
vector (``DecodeCache.index``, where the reference keeps per-layer
``cache_index`` and ``pos_index`` leaves) to ``idx0 + a + 1`` on active
lanes — the rejected columns' K/V stay in place as garbage at or past
the causal frontier, overwritten before any query can attend them. Block
backing and copy-on-write stay on the host in the scheduler.

Two ``DraftSource`` flavors:

- ``SelfDraftSource(layers)`` — a K-layer VIEW of the target: its first
  K blocks, its embeddings, final norm and ``lm_head``, sharing the
  target's tensors (no copy: an in-place weight load reaches the draft
  too). It reads the target's own paged pool (its first K layers,
  gathered contiguous) and writes nothing back: verify rewrites every
  layer's columns.
- ``DraftModelSource(module, client)`` — a separate small
  ``TransformerLM`` whose state_dict is pulled from a client's
  ``get_parameters()`` (e.g. a ``ShardedParameterClient``). It keeps its
  own contiguous decode cache, filled by a draft-prefill program riding
  every prefill chunk, and requires ``prefix_cache=False`` (a
  prefix-matched admission fills the target pool by refcount, which
  would leave the draft cache cold).

A failed draft pull degrades to ONE plain decode step for that dispatch
(``spec_fallback`` flight kind, ``spec_fallbacks`` counted) instead of
erroring — the reference's own semantics; identity is unaffected because
the plain path samples the same position keys.

Programs: exactly ONE draft program and ONE verify program (plus one
draft-prefill program for model sources). On the card each is a
``torch.cuda.CUDAGraph`` captured once beside the engine's decode step,
reading only tensors whose addresses never change — the pool, the block
table, the engine's static decode inputs, the parameters (a model
source's pulled tree is copied INTO the draft module's tensors, and only
when it changed) and the decoder's own static buffers. On the CPU the
same functions run eagerly, and so they do on an engine sharded by
``shard_serving``, whose forwards carry the model group's collectives
(gloo's, where ranks share a card, cannot be captured). ``draft_traces``,
``verify_traces`` and ``draft_prefill_traces`` count the builds.

Sharded (a self-draft only: the engine refuses a model draft there, as
the JAX package does): rank 0 sends each window's operands to the other
ranks (``"spec"``), which run the same draft and verify programs on their
heads and shards (``follow_window``). The draft's and the target's logits
are gathered over the model group, so every rank drafts, accepts and
rolls back alike.
"""

from __future__ import annotations

import copy
from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn

from elephas_tpu_torch import obs
from elephas_tpu_torch.models.transformer import DecodeCache, make_decode_cache
from elephas_tpu_torch.ops.attention import paged_to_contiguous, scatter_spec_columns
from elephas_tpu_torch.serving import host_sync

__all__ = [
    "DraftSource",
    "SelfDraftSource",
    "DraftModelSource",
    "SpeculativeDecoder",
]


def layer_view(target, layers: int):
    """A ``TransformerLM`` that runs the first ``layers`` blocks of
    ``target`` and shares every tensor with it: embeddings, those blocks,
    the final norm and ``lm_head``."""
    view = copy.copy(target)
    # copy.copy shares the module's registries; give the view its own so
    # replacing its blocks leaves the target whole.
    view._modules = dict(target._modules)
    view._parameters = dict(target._parameters)
    view._buffers = dict(target._buffers)
    view.blocks = nn.ModuleList(list(target.blocks)[:layers])
    view.num_layers = layers
    return view


class DraftSource:
    """Where draft tokens come from. ``bind(engine)`` is called once by
    the ``SpeculativeDecoder``; ``params()`` is called at every dispatch
    and may raise — the decoder degrades to plain decode for that step
    (``spec_fallback``)."""

    kind = "abstract"

    def bind(self, engine) -> None:
        raise NotImplementedError

    def params(self):
        raise NotImplementedError


class SelfDraftSource(DraftSource):
    """Shallow-stack self-draft: the target's first ``layers`` blocks,
    same embeddings, the target's own final norm + lm_head on top (a
    ``layer_view``). Zero extra weights and zero extra cache."""

    kind = "self"

    def __init__(self, layers: int):
        self.layers = int(layers)  # host-ok: constructor arg
        self.module = None
        self._engine = None

    def bind(self, engine) -> None:
        """Build the view of ``engine.module``; ``shard_serving`` binds
        again once the module is sharded, so the view's own attributes
        (its head count, its tensor-parallel layout) are the shards'."""
        target = engine.module
        if not 1 <= self.layers < target.num_layers:
            raise ValueError(
                f"draft_layers ({self.layers}) must be in "
                f"[1, num_layers={target.num_layers})"
            )
        self.module = layer_view(target, self.layers)
        self._engine = engine

    def params(self):
        """The served weights: the view reads them in place."""
        return self._engine.params


class DraftModelSource(DraftSource):
    """A separate small draft model, its state_dict delivered by a
    parameter-server client: ``client.get_parameters()`` is version-gated
    at the wire layer (an unchanged pull costs a not-modified frame per
    shard and returns the cached tree), and ``refresh_every`` bounds how
    many speculation windows reuse one pulled tree before re-asking. A
    pull failure raises out of ``params()`` — the decoder's fallback path
    turns it into one plain decode step, never an error.

    ``subscribed=True`` hands the pull cadence to a weight subscriber:
    ``params()`` never polls (beyond one cold-start pull) and the
    subscriber calls ``refresh()`` between decode windows."""

    kind = "model"

    def __init__(self, module, client, refresh_every: int = 1,
                 subscribed: bool = False):
        if refresh_every < 1:
            raise ValueError(
                f"refresh_every must be >= 1, got {refresh_every}"
            )
        self._raw_module = module
        self.client = client
        self.refresh_every = int(refresh_every)  # host-ok: constructor arg
        self.subscribed = bool(subscribed)
        self.module = None
        self._engine = None
        self._cached = None
        self._windows = 0
        self.pulls = 0

    def bind(self, engine) -> None:
        target = engine.module
        module = self._raw_module
        if module.vocab_size != target.vocab_size:
            raise ValueError(
                f"draft model vocab_size ({module.vocab_size}) must match "
                f"the target's ({target.vocab_size})"
            )
        if module.max_seq_len < engine.pool.virtual_len:
            raise ValueError(
                f"draft model max_seq_len ({module.max_seq_len}) must "
                f"cover the pool's virtual row "
                f"({engine.pool.virtual_len} columns)"
            )
        if module.device != target.device:
            raise ValueError(
                f"the draft model lives on {module.device}, the engine serves on "
                f"{target.device}"
            )
        # The port's decode forward always attends densely: the module
        # serves as it is.
        self.module = module
        self._engine = engine

    def params(self):
        if self.subscribed:
            self._windows += 1
            if self._cached is None:
                self._cached = self.client.get_parameters()
                self.pulls += 1
            return self._cached
        take = (self._cached is None
                or self._windows % self.refresh_every == 0)
        self._windows += 1
        if take:
            self._cached = self.client.get_parameters()
            self.pulls += 1
        return self._cached

    def refresh(self) -> None:
        """Re-pull the draft tree NOW (a weight subscriber's hook, at a
        decode-step boundary, never mid-verify). A pull failure
        propagates to the caller."""
        self._cached = self.client.get_parameters()
        self.pulls += 1


class SpeculativeDecoder:
    """Drafts ``gamma`` tokens per slot, verifies them in one batched
    target forward over the paged pool, and hands the scheduler a
    ``(last, emitted, accepted)`` triple of staged values per window:

    - ``last``     — (max_slots,) the target sample at each lane's
                     accepted frontier; chains as the next window's
                     device ``prev_tokens`` (lookahead preserved),
    - ``emitted``  — (max_slots, gamma + 1) the target's samples; the
                     harvest appends ``emitted[s, :accepted[s] + 1]``,
    - ``accepted`` — (max_slots,) matching-prefix lengths in [0, gamma].

    The three are views of ONE staged (max_slots, gamma + 3) buffer, so a
    window costs one copy to the host. ``dispatch`` returns None when the
    draft source cannot produce params (``spec_fallback`` flight note
    recorded) — the scheduler falls back to one plain decode step.
    """

    def __init__(self, engine, source: DraftSource, gamma: int = 4):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.engine = engine
        self.source = source
        self.gamma = int(gamma)  # host-ok: constructor arg
        source.bind(engine)
        self.draft_traces = 0
        self.verify_traces = 0
        self.draft_prefill_traces = 0
        self.windows = 0
        self.fallbacks = 0
        pool, dev = engine.pool, engine.device
        slots, width = pool.max_slots, self.gamma + 1
        self._t0 = torch.zeros((slots,), dtype=torch.int64, device=dev)
        self._drafts = torch.zeros((slots, self.gamma), dtype=torch.int64, device=dev)
        # Columns [0, W) the target's samples, W the accepted count, W + 1
        # the frontier sample (the next window's input).
        self._out = torch.zeros((slots, width + 2), dtype=torch.int64, device=dev)
        self._draft_step = self._verify_step = self._draft_prefill_step = None
        self._graphs = []
        self._installed = None  # the leaves of the draft tree last copied in
        self._draft_cache = None
        if source.kind == "model":
            self._draft_cache = make_decode_cache(source.module, slots, pool.virtual_len)
            self._draft_index = torch.zeros((slots,), dtype=torch.int64, device=dev)
            # slot, start, valid, then the (right-padded) chunk's tokens.
            self._prefill_inputs = torch.zeros((3 + engine.prefill_chunk,),
                                               dtype=torch.int64, device=dev)

    def release(self) -> List[torch.Tensor]:
        """Drop the captured programs and return the decoder's own device
        tensors, whose storage ``InferenceEngine.release`` frees (a model
        source's module is the caller's and stays)."""
        self._draft_step = self._verify_step = self._draft_prefill_step = None
        self._graphs = []
        own = [self._t0, self._drafts, self._out]
        if self._draft_cache is not None:
            own += [*self._draft_cache.keys, *self._draft_cache.values,
                    self._draft_index, self._prefill_inputs]
        return own

    # -- the programs' bodies ------------------------------------------------

    def _draft_steps(self, module, cache, t0, idx0, active, pad, steps: int) -> None:
        """``steps`` autoregressive draft steps; the token drafted at
        window offset j is sampled at pad-free stream position ``idx0 -
        pad + 1 + j``, the key plain decode would use for that position.
        The first ``gamma`` land in ``_drafts``. A model source runs one
        step more (``write_tail``): it feeds the final draft back so its
        K/V lands in the persistent draft cache (sample discarded) —
        after an accept-all window the next window's frontier sits past
        that column, which would otherwise be attended as garbage and
        sink the accept rate (never identity)."""
        eng = self.engine
        tok = t0
        for j in range(steps):
            logits = module(tok[:, None], cache=cache, pad_offset=pad, active=active)
            tok = eng._sample(logits[:, -1], idx0 - pad + 1 + j)
            if j < self.gamma:
                self._drafts[:, j].copy_(tok)

    def _draft_body(self) -> None:
        """Draft ``gamma`` tokens for every lane from the engine's static
        decode inputs. Self-draft: the first K layers' paged K/V gathered
        contiguous (the pool is untouched). Model draft: the source's own
        contiguous cache, its column vector reset at entry to the target
        pool's pre-window frontier — the target's index IS the truth, and
        the draft cache's rejected-suffix columns are garbage at or past
        it, overwritten before anything attends them."""
        eng = self.engine
        pool = eng.pool
        tokens, active = eng._decode_operands()
        idx0 = pool.cache.index
        self._t0.copy_(tokens)
        if self.source.kind == "self":
            table = pool.table.buffer
            k = self.source.layers
            cache = DecodeCache(
                [paged_to_contiguous(leaf, table) for leaf in pool.cache.keys[:k]],
                [paged_to_contiguous(leaf, table) for leaf in pool.cache.values[:k]],
                index=idx0.clone())
            self._draft_steps(self.source.module, cache, tokens, idx0, active,
                              pool.pad, self.gamma)
            return
        self._draft_index.copy_(idx0)
        cache = DecodeCache(self._draft_cache.keys, self._draft_cache.values,
                            index=self._draft_index)
        self._draft_steps(self.source.module, cache, tokens, idx0, active, pool.pad,
                          self.gamma + 1)

    def _verify_body(self) -> None:
        """ONE batched target forward over the whole window: the
        unchanged decode forward with seq = gamma + 1 (causal within the
        window from ``cache_attention_mask``), the target's token sampled
        at every position with the position-keyed sampler, the longest
        matching draft prefix accepted, all gamma + 1 columns scattered
        back, and the column vector rolled to ``idx0 + accepted + 1`` on
        active lanes."""
        eng = self.engine
        pool = eng.pool
        _, active = eng._decode_operands()
        width = self.gamma + 1
        idx0 = pool.cache.index
        table = pool.table.buffer
        keys = [paged_to_contiguous(leaf, table) for leaf in pool.cache.keys]
        values = [paged_to_contiguous(leaf, table) for leaf in pool.cache.values]
        tokens_in = torch.cat([self._t0[:, None], self._drafts], dim=1)
        logits = eng.module(tokens_in, cache=DecodeCache(keys, values, index=idx0),
                            pad_offset=pool.pad, active=active)
        slots = tokens_in.shape[0]
        positions = ((idx0 - pool.pad + 1)[:, None]
                     + torch.arange(width, device=idx0.device)[None, :])
        tgt = eng._sample(logits.reshape(slots * width, -1),
                          positions.reshape(-1)).reshape(slots, width)
        match = (self._drafts == tgt[:, :-1]).to(torch.int64)
        accepted = torch.cumprod(match, dim=1).sum(dim=1)
        last = tgt.gather(1, accepted[:, None])[:, 0]
        frontier = torch.where(active, idx0 + accepted + 1, idx0)
        for pool_leaf, contiguous in zip(pool.cache.keys + pool.cache.values,
                                         keys + values):
            scatter_spec_columns(pool_leaf, contiguous, table, idx0, width, active)
        idx0.copy_(frontier)
        self._out[:, :width].copy_(tgt)
        self._out[:, width].copy_(accepted)
        self._out[:, width + 1].copy_(last)

    def _draft_prefill_body(self) -> None:
        """One prompt chunk through the DRAFT model (model sources only),
        mirroring the engine's paged chunk prefill: the slot's row of the
        draft cache gathered, the dense cache-attention forward at column
        ``start``, the row written back whole, and the slot's column set
        to ``start + valid``. Every operand is a tensor of the static
        input buffer, so one program covers every slot and chunk."""
        ins = self._prefill_inputs
        slot, start, valid = ins[0:1], ins[1:2], ins[2:3]
        dc = self._draft_cache
        keys = [leaf.index_select(0, slot) for leaf in dc.keys]
        values = [leaf.index_select(0, slot) for leaf in dc.values]
        self.source.module(ins[3:][None], cache=DecodeCache(keys, values, index=start.clone()))
        for leaf, row in zip(dc.keys + dc.values, keys + values):
            leaf.index_copy_(0, slot, row)
        self._draft_index.index_copy_(0, slot, start + valid)

    # -- building the programs -----------------------------------------------

    def _build(self, body, program: str):
        """Build one program: counted in ``<program>_traces``, a CUDA graph
        on the card (``engine.capture_step``), the eager body elsewhere and
        on a sharded engine."""
        counter = f"{program}_traces"
        setattr(self, counter, getattr(self, counter) + 1)
        obs.note_retrace(f"serving_{program}", count=getattr(self, counter))
        if self.engine.device.type != "cuda" or self.engine._tp is not None:
            def eager():
                with torch.no_grad():
                    body()
            return eager
        from elephas_tpu_torch.serving.engine import capture_step

        graph = capture_step(body, self.engine.device)
        self._graphs.append(graph)
        return graph.replay

    def _build_window(self) -> None:
        """Build the draft and verify programs at the first window. Both
        warm up before their capture: the draft on the window's real
        inputs (it writes only the decoder's buffers and, for a model
        source, draft-cache columns at or past the frontier — running it
        again writes the same values), the verify with every lane marked
        inactive (it then writes nothing and advances no column); the
        real inputs are put back after."""
        eng = self.engine
        self._draft_step = self._build(self._draft_body, "draft")
        saved = eng._inputs.clone()
        eng._inputs.zero_()
        self._verify_step = self._build(self._verify_body, "verify")
        eng._inputs.copy_(saved)

    # -- scheduler-facing closures -------------------------------------------

    def _install(self, tree) -> None:
        """Copy a model source's pulled state_dict INTO the draft module's
        tensors (their addresses are what the captured programs read),
        and only when the pulled tree changed: a version-gated pull that
        found nothing new hands back the same tensors."""
        leaves = list(tree.values())
        last = self._installed
        if last is not None and len(last) == len(leaves) and all(
                a is b for a, b in zip(last, leaves)):
            return
        with torch.no_grad():
            self.source.module.load_state_dict(tree)
        self._installed = leaves

    def _params(self, where: Optional[str] = None) -> bool:
        """Ask the source for its params; a model source's new tree is
        installed. False (a ``spec_fallback`` noted and counted) when the
        source raised."""
        try:
            tree = self.source.params()
        except Exception as err:
            self.fallbacks += 1
            fields = {"where": where} if where else {}
            obs.default_flight_recorder().note(
                "spec_fallback", "warn", source=self.source.kind,
                error=repr(err), **fields,
            )
            return False
        if self.source.kind == "model":
            self._install(tree)
        return True

    def dispatch(self, cache, prev_tokens, override_vals, override_mask,
                 active_mask, pad):
        """One speculation window (draft + verify, both launched without
        waiting). Returns ``(last, emitted, accepted)`` staged values, or
        None when the draft source failed to produce params — the caller
        runs one plain decode step instead."""
        eng = self.engine
        if not self._params():
            return None
        eng._load_inputs(prev_tokens, override_vals, override_mask, active_mask)
        eng.pool.device_table()
        if eng._tp_leader:
            eng._send("spec")
        if self._draft_step is None:
            self._build_window()
        t0c = eng.clock()
        self._draft_step()
        t1c = eng.clock()
        eng.tracer.record("spec/draft", t0c, t1c, gamma=self.gamma)
        self._verify_step()
        t2c = eng.clock()
        eng.tracer.record("spec/verify", t1c, t2c, gamma=self.gamma)
        self.windows += 1
        out = host_sync.stage(self._out)
        width = self.gamma + 1

        def part(cols):
            return host_sync.Staged(out.device[:, cols], out.host[:, cols], out.event)

        return part(width + 1), part(slice(0, width)), part(width)

    def follow_window(self) -> None:
        """A follower rank of a sharded engine: rank 0's window, whose
        operands ``follow()`` has put in the engine's static inputs, on
        this rank's shards."""
        if self._draft_step is None:
            self._build_window()
        self._draft_step()
        self._verify_step()
        self.windows += 1

    def prefill_chunk(self, tokens, slot: int, start: int, valid: int) -> None:
        """Model sources: land one prompt chunk in the draft cache (rides
        the scheduler's target prefill chunk). A params failure leaves the
        draft cache cold for this chunk — acceptance drops, identity
        doesn't."""
        if self.source.kind != "model":
            return
        if not self._params(where="prefill"):
            return
        host = np.concatenate([np.asarray([slot, start, valid], np.int64),  # host-ok: host ints
                               np.asarray(tokens, np.int64).reshape(-1)])  # host-ok: host chunk
        host_sync.upload(host, self.engine.device, out=self._prefill_inputs)
        if self._draft_prefill_step is None:
            # Warmed up on this chunk itself: running it again writes the
            # same columns and the same column vector entry.
            self._draft_prefill_step = self._build(self._draft_prefill_body,
                                                   "draft_prefill")
        self._draft_prefill_step()

    def stats(self) -> dict:
        return {
            "draft_traces": self.draft_traces,
            "verify_traces": self.verify_traces,
            "draft_prefill_traces": self.draft_prefill_traces,
            "spec_windows": self.windows,
            "spec_fallbacks": self.fallbacks,
            "spec_source": self.source.kind,
            "spec_gamma": self.gamma,
        }
