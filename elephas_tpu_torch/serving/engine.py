"""InferenceEngine — the serving frontend over the continuous-batching
scheduler (counterpart of ``elephas_tpu/serving/engine.py``).

Binds the port's ``TransformerLM`` to TWO programs that together serve
arbitrary request traffic:

- ``prefill``: on the default paged pool, one prompt CHUNK for one slot
  through the block table (gather the slot's blocks, run the dense
  cache-attention forward, scatter the chunk's columns back); on the
  contiguous pool (``paged=False``), a batch-1 prefill at the fixed
  ``max_prompt_len`` width (prompts left-padded into it). It emits the
  token sampled after the prompt.
- ``decode``: one token for every pool slot per call, fixed
  ``(max_slots,)`` shapes, per-slot cache columns. Freshly admitted
  lanes are spliced in with a ``where`` override INSIDE the program;
  free lanes are masked so their columns freeze.

The reference compiles each program once with XLA (``stats()``
``prefill_traces == decode_traces == 1``). Here the paged decode step is
captured ONCE into a ``torch.cuda.CUDAGraph`` and replayed every step:
``decode_traces`` counts the captures (on the CPU, where there are no
graphs, the same function runs eagerly and ``decode_traces`` counts its
one build), and ``prefill_traces`` counts the one build of the prefill
program, which runs eagerly everywhere. The contiguous pool, the oracle,
runs its decode eagerly too. The captured step reads only tensors whose
addresses never change: the pool (written in place), the block table
(re-uploaded into the same tensor), the parameters (``install_weights``
copies into them) and a static input buffer that each step fills with
one upload (previous tokens, overrides, active mask). A capture that
fails raises; there is no eager fallback.

Like the reference, the engine runs no attention kernel of its own: the
decode path is dense cache attention (the reference switches its module
to ``attention="dense"``; the port's decode forward always attends
densely), so no flash kernel launches while serving.

Speculative decode (``speculative=True``, ``serving.spec``) adds a draft
program and a verify program, each captured once into a CUDA graph on
the card beside the decode step (run eagerly on a sharded engine, as its
decode step is). Disaggregated serving runs a request's
prefill on one engine (``submit_prefill``, then ``handoff``) and its
decode on another (``submit_handoff``), the KV blocks crossing in one
``serving.handoff`` frame.

Admission, eviction, slot reuse and backpressure all happen HOST-side
between calls. The only blocking device→host reads go through
``serving.host_sync``.

Tensor-parallel serving (``shard_serving``, one process per device over
a mesh whose model axis is the whole world): every rank holds its shard
of the parameters (``parallel.tensor_parallel``) and its heads of the KV
pool. Rank 0 runs the front end and the scheduler; before each program
it broadcasts one int64 message to the model group holding the
program's operands and the pool's column, pad and block-table tensors,
and the other ranks, in ``follow()``, run the same program on their
shards until ``close()``. Logits are gathered over the model group
before sampling, so every rank samples the same token. The decode step
runs eagerly there: its collectives are gloo's where ranks share a card,
and a gloo collective cannot be captured in a CUDA graph. A sharded
engine speculates with a self-draft (a model draft is refused, as in the
JAX package: the draft model has no sharding rules), hands its KV blocks
off with every head of the model in the frame, and takes a weight
subscriber, whose installs rank 0 broadcasts at a step boundary.

Usage::

    engine = InferenceEngine(compiled, max_slots=4, max_prompt_len=16,
                             max_len=64, stop_token=eos)
    rid = engine.submit([5, 3, 9], max_new_tokens=20)
    result = engine.result(rid)          # drives steps inline, or waits
    ...                                  # on a serve_forever thread

``submit`` applies admission control (bounded queue) and raises
``QueueFull`` with a ``retry_after`` hint; ``submit_with_retry`` wraps
it in bounded backoff.
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from elephas_tpu_torch import obs
from elephas_tpu_torch.models.transformer import (
    DecodeCache,
    make_decode_cache,
    sample_tokens_at,
)
from elephas_tpu_torch.ops.attention import (
    paged_to_contiguous,
    scatter_decode_columns,
    scatter_prefill_columns,
    slot_row_to_contiguous,
)
from elephas_tpu_torch.serving import host_sync
from elephas_tpu_torch.serving.handoff import decode_handoff
from elephas_tpu_torch.serving.kv_pool import KVCachePool, PagedKVPool
from elephas_tpu_torch.serving.metrics import ServingMetrics
from elephas_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    GenerationResult,
    QueueFull,
    Request,
    RequestQueue,
)

# Bounded backoff for submit_with_retry: a handful of increasing delays,
# then the error propagates.
_RETRY_DELAYS = (0.1, 0.2, 0.4, 0.8, 1.3)

# The sharded engine's messages: a header of _HEAD ints (the op, then its
# ints), a payload of ints (the prompt tokens, or a handoff's block ids),
# the decode inputs, the pool's column and pad vectors and, paged, its
# block table. "install" is followed by one broadcast of each whole
# state_dict tensor, "import" by one of the blocks' K/V, and "export" by
# one all_gather of them.
_HEAD = 6
_OPS = {"stop": 0, "chunk_prefill": 1, "prefill": 2, "decode": 3, "admit": 4,
        "copy_block": 5, "install": 6, "spec": 7, "export": 8, "import": 9}
_EAGER_WHY = ("the tensor-parallel decode step (and a speculative engine's draft and verify "
              "programs) run eagerly: their model-group collectives are gloo's where ranks "
              "share a card, and gloo cannot be captured in a CUDA graph")


class InferenceEngine:
    """Online inference over the port's ``TransformerLM`` decode path.

    Parameters
    ----------
    compiled: ``CompiledModel`` or a bare ``TransformerLM``. The engine
        serves on the module's device: ``cuda`` unless the model was
        built with ``device="cpu"``.
    params: optional ``state_dict`` to serve instead of the module's own
        weights (e.g. ``convert.from_flax_params``).

    Each engine serves weights of its own, as each JAX engine binds its
    own ``params``: the constructor always copies the module (and loads
    ``params`` into the copy), before any program is built, so the
    captured decode graph holds the copy's addresses and a self-draft's
    layer view shares the copy's tensors. ``install_weights`` on one
    engine therefore never reaches another engine built from the same
    model, nor the caller's model.
    max_slots, max_prompt_len, max_len, stop_token, queue_depth,
    pad_token, temperature, top_k, seed, pipeline, paged,
    kv_block_size, kv_blocks, prefix_cache, prefill_chunk,
    prefill_chunks_per_step, sink, clock, tracer: as in the reference.
        Sampling (``temperature > 0``) is position-keyed
        (``models.transformer.sample_tokens_at``): the n-th token of a
        stream draws the same random numbers on every path.
    speculative: draft-and-verify decode (paged only; default False).
        Each dispatch drafts ``gamma`` tokens per slot with a cheap draft
        source and verifies the whole window in ONE batched target
        forward — between 1 and ``gamma + 1`` tokens emitted per step,
        the plain decode's tokens by construction (``serving.spec``).
    gamma: draft window length per speculation step (default 4).
    draft_layers: shallow-stack SELF-draft — the target's first K layers
        draft with zero extra weights (default ``num_layers // 2`` when
        ``speculative`` and no ``draft_source`` given).
    draft_source: an explicit ``serving.spec.DraftSource`` (e.g.
        ``DraftModelSource`` pulling a small draft model from a
        parameter-server client). Mutually exclusive with
        ``draft_layers``; model sources require ``prefix_cache=False``
        (a refcount-admitted prefix would leave the draft cache cold).
    """

    def __init__(
        self,
        compiled,
        params=None,
        *,
        max_slots: int = 8,
        max_prompt_len: int = 32,
        max_len: int = 128,
        stop_token: Optional[int] = None,
        queue_depth: int = 16,
        pad_token: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        pipeline: bool = True,
        paged: bool = True,
        kv_block_size: Optional[int] = None,
        kv_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        prefill_chunk: Optional[int] = None,
        prefill_chunks_per_step: Optional[int] = None,
        speculative: bool = False,
        gamma: int = 4,
        draft_layers: Optional[int] = None,
        draft_source=None,
        sink=None,
        clock=time.monotonic,
        tracer=None,
    ):
        module = copy.deepcopy(getattr(compiled, "module", compiled))
        if params is not None:
            module.load_state_dict(params)
        if max_prompt_len >= max_len:
            raise ValueError(
                f"max_prompt_len ({max_prompt_len}) must leave room to "
                f"generate within max_len ({max_len})"
            )
        if getattr(module, "max_seq_len", max_len) < max_len:
            raise ValueError(
                f"max_len ({max_len}) exceeds module.max_seq_len "
                f"({module.max_seq_len})"
            )
        self.module = module
        self.device = module.device
        self.max_prompt_len = max_prompt_len
        self.stop_token = stop_token
        self.temperature = temperature
        self.top_k = top_k
        self.seed = seed
        self.clock = clock
        self._greedy = temperature == 0.0

        self.tracer = tracer if tracer is not None else obs.default_tracer()
        self.paged = paged
        if (draft_layers is not None or draft_source is not None) \
                and not speculative:
            raise ValueError(
                "draft_layers/draft_source require speculative=True"
            )
        if speculative:
            if not paged:
                raise ValueError("speculative decode requires paged=True")
            if draft_layers is not None and draft_source is not None:
                raise ValueError(
                    "draft_layers and draft_source are mutually exclusive"
                )
        if paged:
            chunk = (prefill_chunk if prefill_chunk is not None
                     else max_prompt_len)
            if not 1 <= chunk <= max_prompt_len:
                raise ValueError(
                    f"prefill_chunk ({chunk}) must be in "
                    f"[1, max_prompt_len={max_prompt_len}]"
                )
            self.prefill_chunk = chunk
            # A chunk may start as late as the last prompt column; its
            # slice/scatter window must fit the virtual row without
            # clamping. A speculative verify window writes up to gamma
            # columns past the last decode column the same way (the
            # decode forward would clamp its write columns otherwise).
            virtual_len = max_prompt_len - 1 + chunk
            if speculative:
                virtual_len = max(virtual_len, max_len + gamma)
            self.pool = PagedKVPool(
                module, max_slots, max_len,
                block_size=(kv_block_size if kv_block_size is not None
                            else max_prompt_len),
                num_blocks=kv_blocks,
                prefix_cache=prefix_cache,
                virtual_len=virtual_len,
            )
        else:
            if (kv_block_size is not None or kv_blocks is not None
                    or prefill_chunk is not None
                    or prefill_chunks_per_step is not None):
                raise ValueError(
                    "kv_block_size/kv_blocks/prefill_chunk/"
                    "prefill_chunks_per_step require paged=True"
                )
            self.prefill_chunk = None
            self.pool = KVCachePool(module, max_slots, max_len)
        # The decode step's static operands (see _load_inputs).
        self._inputs = torch.zeros((4, max_slots), dtype=torch.int64,
                                   device=self.device)
        self.spec = None
        if speculative:
            from elephas_tpu_torch.serving.spec import (
                SelfDraftSource,
                SpeculativeDecoder,
            )

            if draft_source is None:
                layers = (draft_layers if draft_layers is not None
                          else max(1, module.num_layers // 2))
                draft_source = SelfDraftSource(layers)
            if draft_source.kind == "model" and prefix_cache:
                raise ValueError(
                    "a model draft source requires prefix_cache=False: a "
                    "prefix-matched admission fills the target pool by "
                    "refcount and would leave the draft cache cold"
                )
            self.spec = SpeculativeDecoder(self, draft_source, gamma=gamma)
        self.queue = RequestQueue(max_depth=queue_depth)
        self.metrics = ServingMetrics(sink=sink, clock=clock)
        # Saturation + goodput plane, both on the engine's clock.
        self.load = obs.LoadTracker(clock=clock)
        self.slo = obs.GoodputLedger(clock=clock)
        # Per-tenant cost attribution (queue seconds, prefill/decode
        # tokens, statuses; the paged pool integrates block-seconds).
        self.costs = obs.CostLedger(clock=clock)
        if paged:
            self.pool.attach_cost_ledger(self.costs, clock)
        self.scheduler = ContinuousBatchingScheduler(
            self.pool,
            self.queue,
            self._prefill,
            self._decode,
            max_prompt_len=max_prompt_len,
            pad_token=pad_token,
            metrics=self.metrics,
            clock=clock,
            pipeline=pipeline,
            tracer=self.tracer,
            load=self.load,
            costs=self.costs,
            chunk_prefill_fn=self._chunk_prefill if paged else None,
            prefill_chunk=self.prefill_chunk,
            prefill_chunks_per_step=prefill_chunks_per_step,
            spec_decode_fn=(self.spec.dispatch if self.spec is not None
                            else None),
            gamma=gamma if speculative else None,
        )

        # ``_out`` takes the decode step's sampled tokens.
        self._out = torch.zeros((max_slots,), dtype=torch.int64,
                                device=self.device)
        self._decode_step = None  # the built step: graph replay or eager
        self._prefill_traces = 0
        self._decode_traces = 0
        self._tp = None  # the model group once sharded (shard_serving)
        self._tp_leader = False
        self._tp_closed = False
        self.mesh = None

        self._req_ids = itertools.count()
        self._results: Dict[int, GenerationResult] = {}
        self._cond = threading.Condition()
        self._step_lock = threading.Lock()
        self._halted = False  # see halt(): a dead engine never steps again
        # Canary exclusion: req_ids submitted with canary=True (guarded
        # by _cond) publish normally but never reach the goodput ledger.
        self._canary_ids: set = set()
        self.canary = None  # CanaryDriver, attached on demand
        # Live model delivery (rollout/): the PS version the served
        # weights carry (None: the construction-time weights) and the
        # WeightSubscriber whose on_step hook runs at every step boundary
        # under _step_lock.
        self.model_version: Optional[int] = None
        self._subscriber = None
        self.ops = None  # OpsServer, mounted on demand (mount_ops)
        self.store = None  # TelemetryStore, mounted with ops (store_dir=)
        self._alert_engine = None
        self._ops_history = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The served weights, as the module's (live) ``state_dict``."""
        return self.module.state_dict()

    @property
    def subscriber(self):
        """The ``rollout.WeightSubscriber`` called at every step boundary
        (None: no live delivery)."""
        return self._subscriber

    @subscriber.setter
    def subscriber(self, sub) -> None:
        self._subscriber = sub

    # -- the two programs --------------------------------------------------

    def _sample(self, logits, positions):
        return sample_tokens_at(logits, self.seed, positions, self._greedy,
                                self.top_k, self.temperature)

    def _note_prefill_build(self) -> None:
        # One build per engine: the counter measures rebuilds, and the
        # obs hook makes a surprise one a visible counter + trace marker.
        if self._prefill_traces == 0:
            self._prefill_traces += 1
            obs.note_retrace("serving_prefill", count=self._prefill_traces)

    def _prefill(self, prompt, pad_offset: int):
        """Contiguous-pool prefill: batch-1 at the fixed prompt width,
        left-padded by ``pad_offset`` columns."""
        if self.paged:
            raise RuntimeError(
                "paged engines prefill through _chunk_prefill (the "
                "scheduler's chunked path), not the contiguous program"
            )
        if self._tp_leader:
            self._send("prefill", (pad_offset, prompt.shape[1]), prompt)
        first, cache = self._prefill_body(host_sync.upload(prompt, self.device), pad_offset)
        return host_sync.stage(first), cache

    def _prefill_body(self, tokens, pad_offset: int):
        self._note_prefill_build()
        with torch.no_grad():
            cache = make_decode_cache(self.module, 1, self.pool.max_len)
            pad = torch.full((1,), pad_offset, dtype=torch.int64,
                             device=self.device)
            logits = self.module(tokens, cache=cache, pad_offset=pad)
            # Position-keyed sampling: the token after a plen-token
            # prompt sits at pad-free stream position plen.
            first = self._sample(logits[:, -1], torch.full(
                (1,), tokens.shape[1] - pad_offset, dtype=torch.int64,
                device=self.device))
        return first, cache

    def _chunk_prefill(self, tokens, slot: int, start: int, valid: int):
        """One prompt CHUNK for one slot, through the paged pool: gather
        the slot's blocks contiguous, run the same dense cache-attention
        forward the contiguous prefill uses, scatter exactly the chunk's
        columns back, and advance the slot's column to ``start +
        valid``. ``tokens`` is (1, chunk) with the final chunk
        RIGHT-padded; padded columns compute garbage K/V that lands
        at-or-past the slot's column, stays causally invisible, and is
        overwritten by later decode steps. Returns the staged token
        sampled at the chunk's last valid position."""
        if self._tp_leader:
            self._send("chunk_prefill", (slot, start, valid, tokens.shape[1]), tokens)
        first = host_sync.stage(self._chunk_prefill_body(
            host_sync.upload(tokens, self.device), slot, start, valid))
        if self.spec is not None:
            # Model draft sources mirror every prompt chunk into their
            # own cache (a no-op for a self-draft, which reads the pool).
            self.spec.prefill_chunk(tokens, slot, start, valid)
        return first

    def _chunk_prefill_body(self, tokens, slot: int, start: int, valid: int):
        self._note_prefill_build()
        pool = self.pool
        width = tokens.shape[1]
        with torch.no_grad():
            row = pool.device_table()[slot]
            keys = [slot_row_to_contiguous(k, row) for k in pool.cache.keys]
            values = [slot_row_to_contiguous(v, row) for v in pool.cache.values]
            cache = DecodeCache(keys, values, index=torch.full(
                (1,), start, dtype=torch.int64, device=self.device))
            logits = self.module(tokens, cache=cache)
            # Paged rows are never left-padded, so the sampled token's
            # pad-free position is the prefilled depth start + valid.
            first = self._sample(logits[:, valid - 1], torch.full(
                (1,), start + valid, dtype=torch.int64, device=self.device))
            # The reference slices the written columns with a clamped
            # dynamic_slice; the virtual row makes the clamp a no-op.
            col0 = min(start, keys[0].shape[2] - width)
            for pool_leaf, row_leaf in zip(pool.cache.keys + pool.cache.values,
                                           keys + values):
                scatter_prefill_columns(pool_leaf, row, start,
                                        row_leaf[0][:, col0:col0 + width])
            # This slot advances to its true prefilled depth (NOT start +
            # chunk: the right-pad tail is garbage).
            pool.cache.index[slot] = start + valid
        return first

    def _decode_operands(self):
        ins = self._inputs
        tokens = torch.where(ins[2].bool(), ins[1], ins[0])
        return tokens, ins[3].bool()

    def _contiguous_decode_body(self) -> None:
        """One decode step over every slot of the contiguous pool,
        written in place."""
        tokens, active = self._decode_operands()
        pool = self.pool
        idx = pool.cache.index
        cache = DecodeCache(pool.cache.keys, pool.cache.values, index=idx)
        logits = self.module(tokens[:, None], cache=cache,
                             pad_offset=pool.pad, active=active)
        # The token sampled this step sits at pad-free position
        # idx - pad + 1.
        self._out.copy_(self._sample(logits[:, -1], idx - pool.pad + 1))
        idx.copy_(cache.index)

    def _paged_decode_body(self) -> None:
        """One decode step over every slot of the paged pool: gather all
        slots' blocks contiguous, run the unchanged decode forward,
        scatter back only the column each active lane wrote. Gathered
        garbage from unallocated blocks sits past every lane's column and
        never survives the causal mask. Reads the block table's tensor
        as it stands: ``_decode`` brings it up to date first."""
        tokens, active = self._decode_operands()
        pool = self.pool
        table = pool.table.buffer
        idx = pool.cache.index  # PRE-advance write column per lane
        keys = [paged_to_contiguous(k, table) for k in pool.cache.keys]
        values = [paged_to_contiguous(v, table) for v in pool.cache.values]
        cache = DecodeCache(keys, values, index=idx)
        logits = self.module(tokens[:, None], cache=cache,
                             pad_offset=pool.pad, active=active)
        self._out.copy_(self._sample(logits[:, -1], idx - pool.pad + 1))
        for pool_leaf, contiguous in zip(pool.cache.keys + pool.cache.values,
                                         keys + values):
            scatter_decode_columns(pool_leaf, contiguous, table, idx, active)
        idx.copy_(cache.index)

    def _decode_body(self) -> None:
        with torch.no_grad():
            if self.paged:
                self._paged_decode_body()
            else:
                self._contiguous_decode_body()

    def _build_decode(self) -> None:
        """Build the decode step once. The paged step on CUDA is captured
        into a CUDA graph (``capture_step``) while the static inputs mark
        every lane inactive — so the warm-up writes nothing and advances
        no column (a speculative engine's inputs may hold its last
        window's lanes: they are cleared first; ``_decode`` uploads this
        step's after the build). A capture that fails raises."""
        self._decode_traces += 1
        obs.note_retrace("serving_decode", count=self._decode_traces)
        if not (self.paged and self.device.type == "cuda") or self._tp is not None:
            self._decode_step = self._decode_body
            return
        self._inputs.zero_()
        self._graph = capture_step(self._decode_body, self.device)
        self._decode_step = self._graph.replay

    def _load_inputs(self, prev_tokens, override_vals, override_mask,
                     active_mask) -> None:
        """Fill the static input buffer the decode and speculative steps
        read: rows are the previous tokens, the override values, the
        override mask and the active mask, in one upload. A staged
        ``prev_tokens`` (the previous step's device tokens) chains
        straight in, never read by the host first."""
        chained = isinstance(prev_tokens, host_sync.Staged)
        host = np.stack([
            np.zeros_like(override_vals) if chained else prev_tokens,
            override_vals, override_mask, active_mask,
        ]).astype(np.int64)
        host_sync.upload(host, self.device, out=self._inputs)
        if chained:
            self._inputs[0].copy_(prev_tokens.device)

    def _decode(self, cache, prev_tokens, override_vals, override_mask,
                active_mask, pad):
        """Scheduler-facing decode: upload this step's operands into the
        static buffer, bring the block table up to date, run the built
        step, and stage its tokens for the host."""
        if self._decode_step is None:
            if self.paged:
                self.pool.device_table()
            self._build_decode()
        self._load_inputs(prev_tokens, override_vals, override_mask, active_mask)
        if self.paged:
            self.pool.device_table()
        if self._tp_leader:
            self._send("decode")
        self._decode_step()
        return host_sync.stage(self._out), self.pool.cache

    # -- tensor-parallel serving -------------------------------------------

    def shard_serving(self, mesh, rules=None):
        """Make the engine tensor-parallel over ``mesh``'s ``'model'``
        axis: the module sharded by ``rules`` (default ``LM_RULES``;
        ``parallel.tensor_parallel``), every K/V tensor of the pool holding
        this rank's heads. Every rank of the mesh builds the same engine
        and calls this; then rank 0 serves (``submit``/``result``, ...)
        while the others run ``follow()``, until rank 0's ``close()``.

        The mesh's model axis must span the world (data 1, seq 1): the
        JAX package's data-axis copies of a serving program compute the
        same thing again, and one process per device has nothing to give
        them, so that layout is refused. A warm engine is refused (its
        programs are built), and so are heads that do not divide over the
        model axis. A self-draft speculative engine and a weight
        subscriber are kept (the draft's layer view is bound again to the
        sharded module); a model draft source is refused, as the JAX
        package refuses it. Returns ``self``."""
        from elephas_tpu_torch.parallel.mesh import MODEL_AXIS, world
        from elephas_tpu_torch.parallel.tensor_parallel import shard_module

        if self.spec is not None and self.spec.source.kind != "self":
            raise NotImplementedError(
                "tensor-parallel serving with a model draft source is not supported (the "
                "draft model has no sharding rules); use a self-draft")
        if self._prefill_traces or self._decode_traces or self.pool.admitted_total:
            raise RuntimeError(
                "shard_serving must run before the first request: the engine's programs "
                "are already built (and the paged decode step captured)")
        tp = mesh.model_size
        heads = self.module.num_heads
        if heads % tp != 0:
            raise ValueError(f"num_heads ({heads}) must divide evenly over the "
                             f"'{MODEL_AXIS}' mesh axis ({tp}) to shard the KV pool")
        if mesh.size != 1 or mesh.seq_size != 1:
            raise ValueError(
                f"shard_serving takes a mesh of data 1 x seq 1 x model M; this one has data "
                f"{mesh.size} x seq {mesh.seq_size}: with one process per device, data-axis "
                "copies of a serving program would compute the same tokens again")
        if tp != world()[0]:
            raise ValueError(f"shard_serving's model axis ({tp}) must span the world "
                             f"({world()[0]} processes): rank 0 serves and every other "
                             "rank follows")
        self.mesh = mesh
        if tp == 1:
            return self
        shard_module(self.module, mesh, rules)  # the engine's own copy (see __init__)
        self._tp = mesh.over(MODEL_AXIS)
        self.pool.shard_heads(self._tp)
        self._tp_leader = self._tp.rank == 0
        if self.spec is not None:
            self.spec.source.bind(self)  # the view copies the sharded module's attributes
        if self._tp_leader:
            self.pool.mirror = self._mirror
        table = self.pool.table.buffer.numel() if self.paged else 0
        # The payload holds a prompt chunk or a handoff's block ids.
        self._payload = max(self.max_prompt_len,
                            self.pool.blocks_per_slot if self.paged else 0)
        self._msg_len = (_HEAD + self._payload + self._inputs.numel()
                         + 2 * self.pool.max_slots + table)
        self._tp_messages = {op: 0 for op in _OPS}
        return self

    def _mirror(self, op: str, *ints, payload=None) -> None:
        self._send(op, ints, payload)

    def _send(self, op: str, ints=(), payload=None) -> None:
        """Rank 0: broadcast one message to the model group."""
        head = np.zeros((_HEAD + self._payload,), np.int64)
        head[0] = _OPS[op]
        head[1:1 + len(ints)] = ints
        if payload is not None:
            flat = np.asarray(payload, np.int64).reshape(-1)  # host-ok: host ints
            head[_HEAD:_HEAD + flat.size] = flat
        pool = self.pool
        parts = [host_sync.upload(head, self.device), self._inputs.reshape(-1),
                 pool.cache.index, pool.pad]
        if self.paged:
            parts.append(pool.device_table().reshape(-1))
        dist.broadcast(torch.cat(parts), src=dist.get_global_rank(self._tp.group, 0),
                       group=self._tp.group)
        self._tp_messages[op] += 1

    def follow(self) -> None:
        """Run the programs rank 0 of a sharded engine sends, on this
        rank's shards, until rank 0 closes the engine. Every rank but 0
        calls it after ``shard_serving``."""
        if self._tp is None or self._tp_leader:
            raise RuntimeError("follow() runs on the ranks other than 0 of an engine "
                               "sharded by shard_serving")
        pool, slots = self.pool, self.pool.max_slots
        src = dist.get_global_rank(self._tp.group, 0)
        names = {code: op for op, code in _OPS.items()}
        pending = None
        while True:
            msg = torch.empty((self._msg_len,), dtype=torch.int64, device=self.device)
            dist.broadcast(msg, src=src, group=self._tp.group)
            head = host_sync.fetch_ints(host_sync.stage(msg[:_HEAD]))
            op, ints = head[0], head[1:]
            self._tp_messages[names[op]] += 1
            if op == _OPS["stop"]:
                self._tp_closed = True
                return
            at = _HEAD + self._payload
            tokens = msg[_HEAD:at]
            inputs = msg[at:at + self._inputs.numel()]
            at += self._inputs.numel()
            with torch.no_grad():
                pool.cache.index.copy_(msg[at:at + slots])
                pool.pad.copy_(msg[at + slots:at + 2 * slots])
                if self.paged:
                    pool.table.buffer.copy_(msg[at + 2 * slots:].view_as(pool.table.buffer))
                if op == _OPS["chunk_prefill"]:
                    slot, start, valid, width = ints[:4]
                    self._chunk_prefill_body(tokens[:width].view(1, width), slot, start, valid)
                elif op == _OPS["prefill"]:
                    pad_offset, width = ints[:2]
                    pending = self._prefill_body(tokens[:width].view(1, width), pad_offset)[1]
                elif op == _OPS["admit"]:
                    pool.admit(ints[0], pending, ints[1])
                elif op == _OPS["copy_block"]:
                    for leaf in pool.cache.keys + pool.cache.values:
                        leaf[ints[1]].copy_(leaf[ints[0]])
                elif op == _OPS["decode"]:
                    self._inputs.copy_(inputs.view_as(self._inputs))
                    self._decode_body()
                elif op == _OPS["install"]:
                    self._install_shards(None, ints[1] if ints[0] else None)
                elif op == _OPS["spec"]:
                    self._inputs.copy_(inputs.view_as(self._inputs))
                    self.spec.follow_window()
                elif op == _OPS["export"]:
                    pool.gather_blocks(tokens[:ints[0]])
                elif op == _OPS["import"]:
                    pool.write_blocks(tokens[:ints[0]])

    def close(self) -> None:
        """Release the follower ranks of a sharded engine (rank 0; once).
        A no-op on an engine that is not sharded."""
        if self._tp_leader and not self._tp_closed:
            self._tp_closed = True
            self._send("stop")

    # -- frontend ----------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 32,
        stop_token: Optional[int] = "default",
        timeout_s: Optional[float] = None,
        canary: bool = False,
        tenant: Optional[str] = None,
        prefill_only: bool = False,
    ) -> int:
        """Enqueue a request; returns its id. Raises ``QueueFull`` (with
        ``.retry_after``) when admission control rejects it.

        ``prefill_only=True`` (paged engines only) runs this engine as a
        PREFILL TIER member for the request: the prompt prefills into
        paged blocks as usual, but instead of joining the decode batch
        the filled blocks export as a KV handoff — claim it with
        ``handoff()`` and ship it to a decode engine's
        ``submit_handoff``.

        ``canary=True`` tags the request as a blackbox probe: its result
        publishes but is excluded from the goodput ledger. ``tenant``
        names the account billed in the engine's ``CostLedger``."""
        prompt = [int(t) for t in prompt]  # host-ok: caller-supplied ints
        if not 1 <= len(prompt) <= self.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt)} outside [1, "
                f"{self.max_prompt_len}]"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prefill_only and not self.paged:
            raise ValueError("prefill_only requires paged=True (the KV "
                             "handoff ships paged blocks)")
        now = self.clock()
        req = Request(
            req_id=next(self._req_ids),
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            stop_token=self.stop_token if stop_token == "default" else stop_token,
            timeout_s=timeout_s,
            submitted_at=now,
            deadline=None if timeout_s is None else now + timeout_s,
            tenant=tenant,
            ctx=obs.current_context() or obs.new_context(),
            prefill_only=prefill_only,
        )
        if canary:
            with self._cond:
                self._canary_ids.add(req.req_id)
        try:
            self.queue.submit(req)
        except QueueFull as err:
            if canary:
                with self._cond:
                    self._canary_ids.discard(req.req_id)
            self.metrics.record_reject()
            self.costs.record_reject(tenant)
            obs.default_flight_recorder().note(
                "backpressure_reject", "warn", req_id=req.req_id,
                queue_depth=len(self.queue), retry_after_s=err.retry_after,
            )
            raise
        self.metrics.record_submit()
        self.costs.record_submit(tenant)
        self.tracer.instant(
            "submit", at=now, track=f"req:{req.req_id}",
            req_id=req.req_id, prompt_tokens=len(prompt),
            tenant=tenant or obs.DEFAULT_TENANT,
        )
        return req.req_id

    def submit_with_retry(self, prompt, **kwargs) -> int:
        """``submit`` retrying a ``QueueFull`` rejection over bounded
        increasing delays (honoring ``retry_after`` when it asks for
        longer), then letting the rejection propagate."""
        for delay in (*_RETRY_DELAYS, None):
            try:
                return self.submit(prompt, **kwargs)
            except QueueFull as err:
                if delay is None:
                    raise
                time.sleep(max(delay, err.retry_after))
        raise AssertionError("unreachable")

    # -- disaggregated serving (prefill tier ↔ decode tier) ------------------

    def submit_prefill(self, prompt: Sequence[int], **kwargs) -> int:
        """Prefill-tier submit: identical admission to ``submit``, but
        the request terminates at the prompt — claim its exported KV
        blocks with ``handoff()`` and ship them to a decode replica."""
        return self.submit(prompt, prefill_only=True, **kwargs)

    def handoff(self, req_id: int, timeout_s: Optional[float] = None):
        """Block until ``req_id``'s prefill finishes and claim its
        exported KV handoff (the dict ``serving.handoff.encode_handoff``
        frames). Drives the scheduler inline when no serve thread is
        mid-step, exactly like ``result()``. Returns the handoff dict —
        or the ``GenerationResult`` when the request terminated on this
        engine instead (deadline eviction mid-prefill); callers
        type-check."""
        deadline = None if timeout_s is None else self.clock() + timeout_s
        while True:
            data = self.scheduler.pop_handoff(req_id)
            if data is not None:
                return data
            with self._cond:
                if req_id in self._results:
                    return self._results.pop(req_id)
            if not self._halted and self._step_lock.acquire(blocking=False):
                try:
                    finished = [] if self._halted else self.scheduler.step()
                    if not self._halted:
                        self._on_step_boundary()
                finally:
                    self._step_lock.release()
                self._publish(finished)
                continue
            with self._cond:
                self._cond.wait(timeout=0.01)
            if deadline is not None and self.clock() >= deadline:
                raise TimeoutError(
                    f"handoff {req_id} not ready in {timeout_s}s")

    def submit_handoff(self, frame, canary: bool = False) -> int:
        """Decode-tier admission of a packed ``KVHandoff`` frame: decode
        it (``WireFormatError`` on any corruption — nothing binds until
        the frame validates), import the blocks into this engine's pool,
        and join the decode batch at the prompt frontier. Returns the
        LOCAL request id (``result()`` claims it). Raises ``QueueFull``
        when no slot is free — the router tries another decode replica
        or falls back to a local re-prefill.

        Cost accounting: no ``record_submit`` here — the prefill engine
        already billed the submit, the prompt, and the first token;
        this engine bills decode tokens from token two and block-seconds
        from the import instant (the window the exporter closed)."""
        if not self.paged:
            raise RuntimeError("KV handoff import requires paged=True")
        data = decode_handoff(frame)
        prompt = [int(t) for t in data["prompt"]]  # host-ok: wire metadata
        if not 1 <= len(prompt) <= self.max_prompt_len:
            raise ValueError(
                f"handoff prompt length {len(prompt)} outside [1, "
                f"{self.max_prompt_len}]"
            )
        req = Request(
            req_id=next(self._req_ids),
            prompt=prompt,
            max_new_tokens=int(data["max_new_tokens"]),  # host-ok: wire metadata
            stop_token=data["stop_token"],
            timeout_s=None,
            submitted_at=float(data["submitted_at"]),  # host-ok: wire metadata
            deadline=data["deadline"],
            tenant=data["tenant"],
            ctx=obs.current_context() or obs.new_context(),
        )
        if canary:
            with self._cond:
                self._canary_ids.add(req.req_id)
        export = data["export"]
        try:
            with self._step_lock:
                _, finished = self.scheduler.admit_import(
                    req, int(data["first"]), prompt,  # host-ok: wire metadata
                    export["arrays"], leaf_names=export.get("leaves"),
                )
        except Exception:
            if canary:
                with self._cond:
                    self._canary_ids.discard(req.req_id)
            raise
        self._publish(finished)
        return req.req_id

    def cancel(self, req_id: int) -> bool:
        """QoS preemption: yank ``req_id`` from the queue if it has not
        been admitted yet, publishing a ``"preempted"`` terminal result.
        Returns False once the request holds a slot."""
        with self._step_lock:
            result = self.scheduler.cancel_queued(req_id)
        if result is None:
            return False
        # Keeps submitted == completed + timed_out + rejected.
        self.metrics.record_reject()
        self._publish([result])
        return True

    def _publish(self, finished: List[GenerationResult]) -> None:
        """Make finished results claimable and account goodput — canary
        probes publish but are never evaluated into the SLO ledger."""
        if not finished:
            return
        with self._cond:
            real = [r for r in finished
                    if r.req_id not in self._canary_ids
                    and r.status != "preempted"]
            for r in finished:
                self._results[r.req_id] = r
                self._canary_ids.discard(r.req_id)
            self._cond.notify_all()
        for r in real:
            self.slo.record(r)
            self.costs.record_goodput(r)

    def halt(self) -> None:
        """Simulate process death: after any in-flight step completes,
        the scheduler never advances again; published results stay
        claimable."""
        self._halted = True
        with self._cond:
            self._cond.notify_all()

    @property
    def halted(self) -> bool:
        return self._halted

    def release(self) -> None:
        """Give a halted engine's device memory back, as a dead process's
        returns to the card: the captured programs are dropped and the
        storage of the pool, the decode operands and the served weights
        (a speculative decoder's buffers and draft cache too) is freed in
        place, after any step in flight (on the CPU a storage that a
        NumPy array shares cannot be resized and is left to the garbage
        collector). Published results stay claimable: they live on the
        host. The JAX package needs no counterpart (a killed engine there
        is a process that exits); the fleet's ``Replica`` calls it when a
        boot dies, so restarts on the card do not grow its allocation.
        Idempotent."""
        if not self._halted:
            raise RuntimeError("release() frees a halted engine's memory; halt() it first")
        with self._step_lock:
            host_sync.settle(self.device)
            self._graph = self._decode_step = None
            tensors = [*self.pool.tensors(), self._inputs, self._out,
                       *self.module.parameters(), *self.module.buffers()]
            if self.spec is not None:
                tensors += self.spec.release()
            for t in tensors:
                storage = t.untyped_storage()
                if storage.resizable():  # not a CPU storage a NumPy array shares
                    storage.resize_(0)

    def step(self) -> List[GenerationResult]:
        """One scheduler iteration; publishes finished results."""
        if self._halted:
            return []
        with self._step_lock:
            if self._halted:
                return []
            finished = self.scheduler.step()
            self._on_step_boundary()
        self._publish(finished)
        return finished

    def _on_step_boundary(self) -> None:
        """The subscription plane's swap point. Runs under ``_step_lock``
        after every scheduler step (one speculative window is one step,
        so no window spans it). On the card a pipelined step may have
        launched the next decode graph already: ``install_weights``
        copies on the same stream after that replay, so the step in
        flight computes with the old weights and the next one with the
        new, as the JAX engine's dispatched program keeps the params it
        was called with."""
        sub = self._subscriber
        if sub is not None:
            sub.on_step(self)

    def install_weights(self, tree, version: Optional[int] = None) -> None:
        """Swap the served weights in place: ``tree`` (a ``state_dict``)
        is copied INTO the module's parameters, whose addresses the
        captured decode step holds — so the next step computes with the
        new weights and nothing is rebuilt. ``model_version`` takes
        ``version``. The paged pool's resident prefixes are forgotten:
        their K/V are the old weights' (requests in flight keep theirs,
        as in the JAX engine, and do not publish them).

        This is the call for a caller that owns the engine and does not
        hold ``_step_lock``; the rollout plane's subscriber hook, which
        runs under it, calls :meth:`install_weights_held`. On an engine
        sharded by ``shard_serving`` rank 0 installs: it takes
        ``_step_lock`` so that no decode message goes out between the
        weights' broadcasts, sends every whole tensor of ``tree`` to the
        followers, and each rank keeps its shard."""
        if self._tp is None:
            self.install_weights_held(tree, version)
            return
        with self._step_lock:  # no decode message between the weights' broadcasts
            self.install_weights_held(tree, version)

    def install_weights_held(self, tree, version: Optional[int] = None) -> None:
        """:meth:`install_weights`'s body, for a caller that holds
        ``_step_lock`` (the step-boundary hook) or owns an unsharded
        engine. It never takes the lock, so the hook cannot re-enter it."""
        if self._tp is None:
            with torch.no_grad():
                self.module.load_state_dict(tree)
            self._forget_prefixes()
            if version is not None:
                self.model_version = int(version)  # host-ok: PS version, plain int
            return
        if not self._tp_leader:
            raise RuntimeError("install_weights runs on rank 0 of a sharded engine; the "
                               "other ranks take the weights from it in follow()")
        shapes = self._full_shapes()
        if tree.keys() != shapes.keys():
            raise KeyError(f"install_weights needs the module's keys: missing "
                           f"{sorted(shapes.keys() - tree.keys())}, unexpected "
                           f"{sorted(tree.keys() - shapes.keys())}")
        wrong = {k: tuple(tree[k].shape) for k, (shape, _) in shapes.items()
                 if tuple(tree[k].shape) != shape}
        if wrong:
            raise ValueError(f"install_weights takes the whole tensors: {wrong} differ from "
                             f"{ {k: shapes[k][0] for k in wrong} }")
        self._send("install", (version is not None, version or 0))
        self._install_shards(tree, version)
        self._forget_prefixes()

    def _forget_prefixes(self) -> None:
        """After a weight install no request admits by refcount onto K/V
        the old weights wrote (``PagedKVPool.invalidate_prefixes``)."""
        if self.paged:
            self.pool.invalidate_prefixes()

    def _full_shapes(self) -> Dict[str, tuple]:
        """(whole shape, dtype) of each ``state_dict`` tensor of a sharded
        module."""
        layout = self.module._tensor_parallel.layout
        out = {}
        for key, local in self.module.state_dict().items():
            shape = list(local.shape)
            if key in layout:
                shape[layout[key].dim] *= self._tp.size
            out[key] = (tuple(shape), local.dtype)
        return out

    def _install_shards(self, tree, version) -> None:
        """Every rank of a sharded engine: each whole tensor of ``tree``
        broadcast from rank 0 (the followers pass None), then this rank's
        shards of them installed."""
        src = dist.get_global_rank(self._tp.group, 0)
        full = {}
        for key, (shape, dtype) in self._full_shapes().items():
            if tree is None:
                full[key] = torch.empty(shape, dtype=dtype, device=self.device)
            else:
                full[key] = tree[key].to(self.device, dtype).contiguous()
            dist.broadcast(full[key], src=src, group=self._tp.group)
        with torch.no_grad():
            self.module.load_state_dict(self.module._tensor_parallel.local_state(full))
        if version is not None:
            self.model_version = int(version)  # host-ok: PS version, plain int

    def result(
        self, req_id: int, timeout_s: Optional[float] = None
    ) -> GenerationResult:
        """Block until ``req_id`` finishes. Without a serving thread this
        drives the scheduler inline; alongside ``serve_forever`` it just
        waits."""
        deadline = None if timeout_s is None else self.clock() + timeout_s
        while True:
            with self._cond:
                if req_id in self._results:
                    return self._results.pop(req_id)
            if not self._halted and self._step_lock.acquire(blocking=False):
                # No server thread mid-step: advance the world ourselves.
                try:
                    finished = [] if self._halted else self.scheduler.step()
                    if not self._halted:
                        self._on_step_boundary()
                finally:
                    self._step_lock.release()
                self._publish(finished)
                continue
            with self._cond:
                if req_id in self._results:
                    return self._results.pop(req_id)
                self._cond.wait(timeout=0.01)
            if deadline is not None and self.clock() >= deadline:
                raise TimeoutError(f"request {req_id} not done in {timeout_s}s")

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        """Step until no queued or active work remains."""
        for _ in range(max_steps):
            if not self.scheduler.has_work:
                return
            self.step()
        raise RuntimeError(f"not drained after {max_steps} steps")

    def serve_forever(
        self,
        stop_event: Optional[threading.Event] = None,
        idle_sleep_s: float = 0.001,
    ) -> None:
        """Serve until ``stop_event`` is set (forever if None). Run in a
        thread; ``submit``/``result`` are safe from other threads."""
        while stop_event is None or not stop_event.is_set():
            if self.scheduler.has_work:
                self.step()
            else:
                time.sleep(idle_sleep_s)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        out = {
            **self.metrics.summary(),
            "model_version": self.model_version,
            "prefill_traces": self._prefill_traces,
            "decode_traces": self._decode_traces,
            "pool_admitted_total": self.pool.admitted_total,
            "pool_active": self.pool.active_count,
            "pool_free": self.pool.free_count,
        }
        if self.paged:
            out["kv_blocks_free"] = self.pool.free_blocks
            out["kv_blocks_total"] = self.pool.num_blocks
            out.update(self.pool.prefix_stats())
        if self.spec is not None:
            out.update(self.spec.stats())
        if len(self.costs.tenants()) > 0:
            out["tenancy"] = self.costs.snapshot()
        if self._tp is not None:
            out["tensor_parallel"] = {"model": self._tp.size, "decode_graph": False,
                                      "why": _EAGER_WHY, "messages": dict(self._tp_messages)}
            if self.spec is not None:
                out["tensor_parallel"]["spec_graphs"] = False
        return out

    def attach_canary(self, driver) -> None:
        """Register the blackbox probe driver serving ``/canary``."""
        self.canary = driver

    def _canary_doc(self) -> dict:
        if self.canary is not None:
            return self.canary.snapshot()
        return {"surface": None, "probes": 0, "failures": 0,
                "failure_ratio": None, "last": None}

    def _tenants_doc(self) -> dict:
        """``/tenants``: evaluate the per-tenant alert rules (burn,
        noisy-neighbor KV share) against the ledger's synthetic metric
        view, then snapshot — rows, totals, kv_share, alerts."""
        self.costs.evaluate_alerts(self.clock())
        return self.costs.snapshot()

    def mount_ops(self, port: int = 0, host: Optional[str] = None,
                  store_dir: Optional[str] = None):
        """Mount a live introspection endpoint (``obs.opsd``) for this
        engine: ``/metrics``, ``/healthz`` (+ queue/pool summary),
        ``/trace``, ``/vars``, ``/flight``, ``/alerts`` (stock SLO rule
        pack — its serving ITL rule reads the registry mirror
        ``ServingMetrics`` feeds), plus the saturation/goodput plane:
        ``/load`` (EWMA load score), ``/slo`` (windowed goodput +
        burn), ``/canary`` (the blackbox probe document of an attached
        ``CanaryDriver``), ``/tenants``
        (per-tenant cost ledger + burn/KV-share alerts), ``/profile``
        (``torch.profiler`` capture and the card's memory). Loopback-bound
        by default; port 0 picks a free one (read ``engine.ops.port``).
        Idempotent.

        ``store_dir`` additionally mounts the durable telemetry journal
        (``obs.store``): flight notes, alert transitions, sampler ticks,
        and completed spans persist there for cross-process post-mortem
        reconstruction (``/incidents`` serves its meta).
        """
        if self.ops is not None:
            return self.ops
        if self._alert_engine is None:
            self._alert_engine = obs.AlertEngine()
        self._ops_history = obs.HistorySampler(extra_fn=obs.record_device_memory).start()
        self.store = None
        if store_dir is not None:
            self.store = obs.TelemetryStore(store_dir, role="serving",
                                            flight=obs.default_flight_recorder())
            obs.default_flight_recorder().attach_store(self.store)
            self._alert_engine.attach_store(self.store)
            self._ops_history.attach_store(self.store)
            if getattr(self.tracer, "enabled", False):
                self.tracer.attach_store(self.store)
        self.ops = obs.OpsServer(
            port=port, host=host, tracer=self.tracer,
            role="serving",
            alerts_fn=self._alert_engine.scrape,
            history=self._ops_history,
            vars_fn=lambda: {
                "role": "serving",
                "max_slots": self.pool.max_slots,
                "max_prompt_len": self.max_prompt_len,
            },
            health_fn=lambda: {
                "queue_depth": len(self.queue),
                "pool_active": self.pool.active_count,
                "pool_free": self.pool.free_count,
            },
            load_fn=self.load.snapshot,
            slo_fn=self.slo.snapshot,
            canary_fn=self._canary_doc,
            tenants_fn=self._tenants_doc,
            incidents_fn=self.store.doc if self.store is not None else None,
        ).start()
        return self.ops

    def unmount_ops(self, reason: str = "close") -> None:
        """Tear the endpoint, the sampler and the journal down.
        Idempotent."""
        if self.ops is not None:
            self.ops.stop()
            self.ops = None
        if self._ops_history is not None:
            self._ops_history.stop()
            self._ops_history = None
        store, self.store = self.store, None
        if store is not None:
            obs.default_flight_recorder().detach_store(store)
            if self._alert_engine is not None:
                self._alert_engine.detach_store(store)
            if hasattr(self.tracer, "detach_store"):
                self.tracer.detach_store(store)
            store.close(reason=reason)


# Captures run one at a time in a process (torch.cuda.graph captures on
# one shared stream), each warmed up on its device's one side stream.
_CAPTURE_LOCK = threading.Lock()
_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_step(body, device) -> "torch.cuda.CUDAGraph":
    """Capture ``body`` (a step that reads and writes only tensors whose
    addresses never change) into a CUDA graph: warmed up twice on a side
    stream (cuBLAS and the caching allocator settle before capture), then
    captured, under ``no_grad``. The caller makes the warm-up harmless
    (inactive lanes, or a step that can run again). A capture that fails
    raises.

    The capture's error mode is ``thread_local``: a replica of a fleet
    builds its decode graph on its serve thread while a peer engine on
    the same card steps on its own, syncing the host and allocating, and
    the default ``global`` mode refuses such calls from every thread of
    the process while a capture is open. The side stream is one per
    device, so the warm-up's cuBLAS workspace is not allocated anew for
    every engine a fleet boots."""
    with _CAPTURE_LOCK, torch.no_grad():
        device = torch.device(device)
        side = _WARMUP_STREAMS.get(device)
        if side is None:
            side = _WARMUP_STREAMS[device] = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(2):
                body()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body()
    return graph


def shard_serving(engine: InferenceEngine, mesh, rules=None) -> InferenceEngine:
    """Module-level alias for ``InferenceEngine.shard_serving``."""
    return engine.shard_serving(mesh, rules=rules)
