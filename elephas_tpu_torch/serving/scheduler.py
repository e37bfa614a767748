"""Continuous-batching scheduler: iteration-level request scheduling
over a fixed-shape KV-cache pool, with a one-step-lookahead pipelined
decode hot path (counterpart of ``elephas_tpu/serving/scheduler.py``).

The scheduling unit is one DECODE ITERATION, not one request (Orca-style
continuous batching). In the default PIPELINED mode each ``step()``:

1. dispatches decode step N+1 *first*, chaining the device token vector
   decode N produced straight back in as the next input — the host
   never reads it before dispatch, so the device starts the next
   iteration immediately,
2. only then fetches step N's tokens (active lanes only, through the
   one sanctioned sync point in ``serving.host_sync``) and does all the
   host bookkeeping — stop-token checks, budget exhaustion, deadline
   eviction, admission prefills, metrics — OVERLAPPED with step N+1's
   device compute,
3. admits queued requests while free slots last; an admitted request's
   prefill-produced first token reaches the device as a per-lane
   OVERRIDE on the next dispatch (a ``where`` folded into the one
   decode program, not a new program).

Pipelining semantics: token streams are IDENTICAL to the unpipelined
path (``pipeline=False``). The only observable differences are (a) a
finished request's completion is detected one step after its final
token is computed — one wasted lane-iteration — and (b) an admission
joins the decode batch one step later. Deadline-evicted requests return
exactly the same partial token list in both modes, because eviction
runs AFTER the previous step's harvest.

Backpressure lives at the queue: a bounded ``RequestQueue`` whose
``submit`` raises ``QueueFull`` carrying a ``retry_after`` hint —
the same reject-then-backoff contract the parameter-server client
implements on its side with ``_RETRY_DELAYS``.

The scheduler is deliberately device-agnostic: it drives two injected
callables (``prefill_fn``, ``decode_fn``) and a ``KVCachePool``, hands
them host (NumPy) arrays and ints, and reads device values back only
through ``serving.host_sync``; tests can clock it with fakes and the
engine owns the programs and their uploads.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from elephas_tpu_torch import obs
from elephas_tpu_torch.serving import host_sync
from elephas_tpu_torch.utils import locksan

class QueueFull(RuntimeError):
    """Admission control rejected a submit; retry after ``retry_after``s."""

    def __init__(self, depth: int, limit: int, retry_after: float):
        super().__init__(
            f"request queue full ({depth}/{limit}); retry after "
            f"{retry_after:.2f}s"
        )
        self.retry_after = retry_after


@dataclass
class Request:
    """One generation request as it moves queue → slot → result."""

    req_id: int
    prompt: List[int]
    max_new_tokens: int
    stop_token: Optional[int] = None
    timeout_s: Optional[float] = None
    submitted_at: float = 0.0
    deadline: Optional[float] = None  # absolute, from submitted_at
    # Cost attribution: who pays for this request's tokens, queue
    # seconds, and KV block-seconds. None bills the "default" tenant.
    # The tag rides the request object end to end — through the
    # scheduler, spec harvests, and the router's requeue-on-death.
    tenant: Optional[str] = None
    # The trace context rooted at submit: finish-side observability
    # (request spans, the ITL histogram's exemplar latch) re-activates
    # it so /metrics joins to this request's span tree.
    ctx: Any = None
    # Disaggregated serving: a prefill-tier request stops at the
    # prompt — instead of joining the decode batch, its filled blocks
    # export as a KV handoff (``pop_handoff``) for a decode replica.
    prefill_only: bool = False


@dataclass
class GenerationResult:
    """Terminal state of a request. ``tokens`` excludes the prompt and,
    for ``status="timeout"``, holds whatever was generated before
    eviction (possibly empty)."""

    req_id: int
    tokens: List[int]
    status: str  # "completed" | "timeout"
    prompt_tokens: int
    ttft_s: Optional[float] = None
    itl_s_avg: Optional[float] = None
    tokens_per_sec: Optional[float] = None
    # Decode tokens per decode step: exactly 1.0 on the plain path,
    # up to gamma + 1 under speculative decode (multi-token harvests
    # would otherwise silently under-report ITL). The prefill-produced
    # first token is excluded — it cost no decode step.
    tokens_per_step: Optional[float] = None
    # The tenant billed for this request (attribution survives into the
    # result so the engine's publish path can drive per-tenant goodput).
    tenant: Optional[str] = None


class RequestQueue:
    """Thread-safe bounded FIFO with reject-with-retry-after overflow.

    ``retry_hint_s`` scales the hint by how oversubscribed the queue is:
    a caller hitting a barely-full queue backs off less than one hitting
    a deeply backed-up server.
    """

    def __init__(self, max_depth: int = 64, retry_hint_s: float = 0.1):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self.retry_hint_s = retry_hint_s
        self._items: List[Request] = []
        self._lock = locksan.make_lock("RequestQueue._lock")

    def submit(self, request: Request) -> None:
        with self._lock:
            if len(self._items) >= self.max_depth:
                raise QueueFull(
                    len(self._items), self.max_depth,
                    self.retry_hint_s * max(1, len(self._items) // 2),
                )
            self._items.append(request)

    def pop(self) -> Optional[Request]:
        with self._lock:
            return self._items.pop(0) if self._items else None

    def remove(self, req_id: int) -> Optional[Request]:
        """Pull a still-queued request out by id (QoS preemption: a
        queued victim can be yanked and requeued elsewhere — once popped
        into a slot it is no longer preemptible here). None if absent."""
        with self._lock:
            for i, req in enumerate(self._items):
                if req.req_id == req_id:
                    return self._items.pop(i)
        return None

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


@dataclass
class _Active:
    """Bookkeeping for a request occupying a pool slot."""

    request: Request
    slot: int
    tokens: List[int]                    # generated so far (incl. first)
    token_times: List[float]             # wall time per token, for ITL
    budget: int                          # tokens still allowed (cache cap)
    admitted_at: float = 0.0             # decode-batch join time (spans)
    next_col: int = 0                    # paged: column the next decode writes
    steps: int = 0                       # decode steps harvested (ITL unit)


@dataclass
class _Prefilling:
    """A slot mid-chunked-prefill (paged pools only): the prompt's
    columns land chunk-by-chunk, interleaved with decode steps when a
    per-step chunk budget is set. Holds only the device token from the
    LATEST chunk — it is read (one fetch) at finalize, never between
    chunks."""

    request: Request
    slot: int
    matched: int                         # prefix-cache tokens reused
    next_col: int                        # next prompt column to prefill
    t_pop: float
    t_pre0: Optional[float] = None
    first_dev: Any = None


@dataclass
class _Inflight:
    """A dispatched-but-unread decode step (the lookahead window)."""

    tokens: Any                          # staged (max_slots,) token vector
    lanes: List[Tuple[int, _Active]]     # entries occupying lanes at dispatch
    dispatched_at: float = 0.0
    # Speculative windows: ragged per-lane harvest state. ``tokens``
    # stays the (max_slots,) NEXT-input vector (the accepted frontier's
    # target sample) so lookahead chaining is mode-blind.
    spec: bool = False
    spec_emitted: Any = None             # staged (max_slots, gamma + 1)
    spec_accepted: Any = None            # staged (max_slots,)


class ContinuousBatchingScheduler:
    """Drives prefill/decode interleaving over a ``KVCachePool``.

    ``prefill_fn(prompt, pad_offset) -> (first_token, prefill_cache)``
        batch-1 prefill at the fixed prompt width; ``prompt`` is the
        left-padded (1, max_prompt_len) host token array, ``pad_offset``
        the pad-column count. ``first_token`` is a staged device value
        (``host_sync.stage``).
    ``decode_fn(cache, prev_tokens, override_vals, override_mask,
    active_mask, pad) -> (next_tokens, new_cache)``
        one decode step over all ``pool.max_slots`` rows.
        ``prev_tokens`` is the (max_slots,) vector of each lane's
        previous token — on the pipelined path the DEVICE OUTPUT of the
        previous call, chained without a host read. ``override_vals`` /
        ``override_mask`` splice freshly-admitted lanes' first tokens in
        (host (max_slots,) arrays); ``active_mask`` marks occupied lanes
        whose cache columns may advance. ``next_tokens`` is staged
        (``host_sync.stage``); ``new_cache`` is the pool's cache, written
        in place (the scheduler swaps it into the pool).
    ``chunk_prefill_fn(tokens, slot, start, valid) -> first_token``
        paged pools only: one prompt CHUNK for one slot through the
        block table. ``tokens`` is the (1, prefill_chunk) right-padded
        host chunk, ``start`` the slot column it begins at, ``valid`` its
        real token count; the returned staged device value is the token
        sampled at the chunk's last valid position (read only for the
        final chunk). When set, the scheduler runs the paged admission
        path: prefix-cache match at admission, chunked prefill
        (``prefill_chunks_per_step`` bounds chunks dispatched per step;
        None runs every pending chunk at admission), block backing per
        decode column, and chain-publishing release.
    ``spec_decode_fn(cache, prev_tokens, override_vals, override_mask,
    active_mask, pad) -> (last, emitted, accepted) | None``
        speculative decode (paged + chunked prefill only): ONE
        draft-and-verify window over all lanes. ``last`` chains as the
        next dispatch's ``prev_tokens`` exactly like ``decode_fn``'s
        output; ``emitted`` is the (max_slots, gamma + 1) matrix of
        target samples and ``accepted`` the per-lane matching-prefix
        lengths — the harvest appends ``emitted[s, :accepted[s] + 1]``
        per lane (ragged, device-rolled-back past that). A None return
        means the draft source failed for this window (flight-recorded
        as ``spec_fallback``) and the scheduler runs one plain
        ``decode_fn`` step instead — token-identical either way.
    """

    def __init__(
        self,
        pool,
        queue: RequestQueue,
        prefill_fn: Callable,
        decode_fn: Callable,
        max_prompt_len: int,
        pad_token: int = 0,
        metrics=None,
        clock=time.monotonic,
        pipeline: bool = True,
        tracer=None,
        load=None,
        chunk_prefill_fn: Optional[Callable] = None,
        prefill_chunk: Optional[int] = None,
        prefill_chunks_per_step: Optional[int] = None,
        spec_decode_fn: Optional[Callable] = None,
        gamma: Optional[int] = None,
        costs=None,
    ):
        self.pool = pool
        self.queue = queue
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.chunk_prefill_fn = chunk_prefill_fn
        self.paged = chunk_prefill_fn is not None
        self.prefill_chunk = (
            prefill_chunk if prefill_chunk is not None else max_prompt_len
        )
        self.prefill_chunks_per_step = prefill_chunks_per_step
        self.spec_decode_fn = spec_decode_fn
        self.gamma = gamma
        if spec_decode_fn is not None and not self.paged:
            raise ValueError("spec_decode_fn requires the paged path "
                             "(chunk_prefill_fn)")
        self.max_prompt_len = max_prompt_len
        self.pad_token = pad_token
        self.metrics = metrics
        self.clock = clock
        self.pipeline = pipeline
        # Per-tenant cost attribution (obs.tenancy.CostLedger, engine-
        # owned): every token emission, queue residency, and terminal
        # status bills the request's tenant tag here. None disables
        # attribution without branching cost elsewhere.
        self.costs = costs
        # Saturation plane (obs.LoadTracker, engine-owned): fed once per
        # step with the queue/slot/KV signals already in hand here, so
        # the /load route and a future admission router see a score
        # computed on this scheduler's own clock.
        self.load = load
        # Span recording: retroactive `record()` calls with THIS clock's
        # timestamps — the tracer must share the clock domain (the
        # engine passes its own). A disabled tracer makes every call a
        # cheap early return, so recording can stay in the hot path.
        self.tracer = tracer if tracer is not None else obs.default_tracer()
        self._active: Dict[int, _Active] = {}  # slot -> _Active
        self._prefilling: Dict[int, _Prefilling] = {}  # paged mid-prefill
        # req_id -> exported handoff (prefill-only requests park their
        # finished prompt here for the engine's ``pop_handoff``).
        self._handoffs: Dict[int, Dict] = {}
        self._results: List[GenerationResult] = []
        self._inflight: Optional[_Inflight] = None
        # slot -> first token to splice into the NEXT dispatch (set by
        # admissions that happened after the current inflight dispatch).
        self._overrides: Dict[int, int] = {}

    # -- introspection -----------------------------------------------------

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def has_work(self) -> bool:
        return (
            bool(self._active)
            or bool(self._prefilling)
            or len(self.queue) > 0
            or self._inflight is not None
        )

    # -- lifecycle ---------------------------------------------------------

    def _finish(self, entry: _Active, status: str) -> GenerationResult:
        if self.paged:
            # Publish the slot's token chain to the prefix cache before
            # the block references drop: exactly the columns with K/V
            # deterministically on device — ``next_col`` counts
            # dispatched writes, including the pipelined in-flight step
            # (device-ordered before any later sharer's gather).
            chain = (list(entry.request.prompt)
                     + list(entry.tokens))[:entry.next_col]
            self.pool.release(entry.slot, tokens=chain)
        else:
            self.pool.release(entry.slot)
        del self._active[entry.slot]
        self._overrides.pop(entry.slot, None)
        req = entry.request
        times = entry.token_times
        ttft = times[0] - req.submitted_at if times else None
        gaps = [b - a for a, b in zip(times, times[1:])]
        itl = sum(gaps) / len(gaps) if gaps else None
        span = times[-1] - req.submitted_at if times else None
        result = GenerationResult(
            req_id=req.req_id,
            tokens=list(entry.tokens),
            status=status,
            prompt_tokens=len(req.prompt),
            ttft_s=ttft,
            itl_s_avg=itl,
            tokens_per_sec=(
                len(entry.tokens) / span if span and span > 0 else None
            ),
            # First token excluded: prefill produced it, no decode step.
            tokens_per_step=(
                (len(entry.tokens) - 1) / entry.steps
                if entry.steps > 0 else None
            ),
            tenant=req.tenant,
        )
        # Finish-side observability runs under the request's own trace
        # context: the spans below and the ITL histogram's exemplar
        # latch (ServingMetrics → serving_itl_seconds) both tag this
        # request's trace id, which is what joins a /metrics bucket to
        # its span tree.
        with obs.activate(req.ctx):
            if self.tracer.enabled:
                now = self.clock()
                track = f"req:{req.req_id}"
                if times and times[-1] > entry.admitted_at:
                    self.tracer.record(
                        "decode", entry.admitted_at, times[-1], track=track,
                        req_id=req.req_id, tokens=len(entry.tokens),
                    )
                self.tracer.instant(
                    "finish", at=now, track=track, req_id=req.req_id,
                    status=status,
                )
                self.tracer.record(
                    "request", req.submitted_at, now, track=track,
                    req_id=req.req_id, status=status,
                    tokens=len(entry.tokens),
                    tenant=req.tenant or "default",
                )
            self._results.append(result)
            if self.metrics is not None:
                self.metrics.record_finish(
                    result, queue_depth=len(self.queue),
                    active=len(self._active),
                )
        if self.costs is not None:
            self.costs.record_status(req.tenant, status)
        return result

    def _evict_expired(self) -> None:
        now = self.clock()
        for slot in [
            s for s, e in self._active.items()
            if e.request.deadline is not None and now >= e.request.deadline
        ]:
            entry = self._active[slot]
            obs.default_flight_recorder().note(
                "deadline_eviction", "warn", req_id=entry.request.req_id,
                where="decode", tokens=len(entry.tokens),
            )
            self._finish(entry, "timeout")
        for slot in [
            s for s, pf in self._prefilling.items()
            if pf.request.deadline is not None and now >= pf.request.deadline
        ]:
            pf = self._prefilling.pop(slot)
            req = pf.request
            obs.default_flight_recorder().note(
                "deadline_eviction", "warn", req_id=req.req_id,
                where="prefill", tokens=0,
            )
            # Drop the slot's half-written blocks (no chain to publish —
            # the prompt never finished landing). The evicted tenant is
            # still billed for its block occupancy up to this instant
            # (the pool integrates on release) and for the eviction.
            self.pool.release(slot)
            result = GenerationResult(
                req_id=req.req_id, tokens=[], status="timeout",
                prompt_tokens=len(req.prompt), tenant=req.tenant,
            )
            if self.tracer.enabled:
                track = f"req:{req.req_id}"
                self.tracer.record(
                    "queue", req.submitted_at, pf.t_pop, track=track,
                    req_id=req.req_id,
                )
                self.tracer.record(
                    "request", req.submitted_at, now, track=track,
                    req_id=req.req_id, status="timeout", tokens=0,
                    tenant=req.tenant or "default",
                )
            self._results.append(result)
            if self.metrics is not None:
                self.metrics.record_finish(
                    result, queue_depth=len(self.queue),
                    active=len(self._active),
                )
            if self.costs is not None:
                self.costs.record_status(req.tenant, "timeout")

    def _expire_queued(self, req: Request, t_pop: float) -> None:
        """Account a request that expired while still queued — don't
        burn a prefill on it."""
        track = f"req:{req.req_id}"
        obs.default_flight_recorder().note(
            "deadline_eviction", "warn", req_id=req.req_id,
            where="queue", tokens=0,
        )
        self.tracer.record(
            "queue", req.submitted_at, t_pop, track=track,
            req_id=req.req_id,
        )
        self.tracer.record(
            "request", req.submitted_at, t_pop, track=track,
            req_id=req.req_id, status="timeout", tokens=0,
            tenant=req.tenant or "default",
        )
        self._results.append(GenerationResult(
            req_id=req.req_id, tokens=[], status="timeout",
            prompt_tokens=len(req.prompt), tenant=req.tenant,
        ))
        if self.metrics is not None:
            self.metrics.record_finish(
                self._results[-1], queue_depth=len(self.queue),
                active=len(self._active),
            )
        if self.costs is not None:
            # The tenant pays for its queue residency even when the
            # request dies there — queue seconds are a shared-resource
            # cost whether or not a prefill ever ran.
            self.costs.record_queue(req.tenant, t_pop - req.submitted_at)
            self.costs.record_status(req.tenant, "timeout")

    def _admit_from_queue(self) -> None:
        if self.paged:
            self._admit_paged()
            return
        while self.pool.free_count > 0:
            req = self.queue.pop()
            if req is None:
                return
            t_pop = self.clock()
            track = f"req:{req.req_id}"
            if req.deadline is not None and t_pop >= req.deadline:
                self._expire_queued(req, t_pop)
                continue
            plen = len(req.prompt)
            pad = self.max_prompt_len - plen
            padded = np.asarray(  # host-ok: host prompt list
                [[self.pad_token] * pad + list(req.prompt)], np.int64
            )
            t_pre0 = self.clock()
            first_dev, prefill_cache = self.prefill_fn(padded, pad)
            # The admission-path sync: on the pipelined path this overlaps
            # the in-flight decode step dispatched before bookkeeping.
            first = host_sync.fetch_scalar(first_dev)
            t_pre1 = self.clock()
            slot = self.pool.acquire()
            assert slot is not None  # guarded by free_count above
            self.pool.admit(slot, prefill_cache, pad)
            # Cache capacity bounds generation: prompt + generated tokens
            # all live in max_len columns (pad columns included).
            budget = min(
                req.max_new_tokens, self.pool.max_len - self.max_prompt_len
            )
            entry = _Active(
                request=req, slot=slot, tokens=[first],
                token_times=[self.clock()], budget=budget,
            )
            entry.admitted_at = self.clock()
            self._active[slot] = entry
            if self.costs is not None:
                # Queue residency ends here; the prompt's prefill and
                # its first emitted token bill now (the contiguous pool
                # has no prefix cache — nothing is ever discounted).
                self.costs.record_queue(req.tenant,
                                        t_pop - req.submitted_at)
                self.costs.record_prefill(req.tenant, plen)
                self.costs.record_decode(req.tenant, 1)
            if self.tracer.enabled:
                self.tracer.record(
                    "queue", req.submitted_at, t_pop, track=track,
                    req_id=req.req_id,
                )
                self.tracer.record(
                    "prefill", t_pre0, t_pre1, track=track,
                    req_id=req.req_id, prompt_tokens=plen,
                )
                self.tracer.record(
                    "admit", t_pop, entry.admitted_at, track=track,
                    req_id=req.req_id, slot=slot,
                )
            if first == req.stop_token or len(entry.tokens) >= budget:
                self._finish(entry, "completed")
            else:
                self._overrides[slot] = first

    # -- paged admission: prefix match + chunked prefill ---------------------

    def _admit_paged(self) -> None:
        """Paged admission: claim a slot, bind the longest resident
        prompt prefix (refcount bumps, zero prefill compute), and park
        the request mid-prefill — ``_advance_prefills`` lands the
        remaining columns chunk by chunk."""
        while self.pool.free_count > 0:
            req = self.queue.pop()
            if req is None:
                return
            t_pop = self.clock()
            if req.deadline is not None and t_pop >= req.deadline:
                self._expire_queued(req, t_pop)
                continue
            slot = self.pool.acquire()
            assert slot is not None  # guarded by free_count above
            # Declare the slot's owner BEFORE the first block binds so
            # every block-second — including the prefix-bound ones —
            # bills this tenant from the first instant.
            if self.costs is not None and \
                    hasattr(self.pool, "set_slot_owner"):
                self.pool.set_slot_owner(slot, req.tenant)
            matched = self.pool.admit_prefix(slot, req.prompt)
            if self.costs is not None:
                self.costs.record_queue(req.tenant,
                                        t_pop - req.submitted_at)
            self._prefilling[slot] = _Prefilling(
                request=req, slot=slot, matched=matched,
                next_col=matched, t_pop=t_pop,
            )

    def _run_chunk(self, pf: _Prefilling) -> None:
        """Dispatch ONE prefill chunk for a parked request: back its
        columns with blocks, launch the compiled chunk (non-blocking),
        and finalize the slot into the decode batch when the prompt's
        last column has landed."""
        req = pf.request
        plen = len(req.prompt)
        start = pf.next_col
        valid = min(self.prefill_chunk, plen - start)
        if pf.t_pre0 is None:
            pf.t_pre0 = self.clock()
        self.pool.ensure_cols(pf.slot, start + valid)
        chunk = list(req.prompt[start:start + valid])
        chunk += [self.pad_token] * (self.prefill_chunk - valid)
        tokens = np.asarray([chunk], np.int64)  # host-ok: host prompt list
        pf.first_dev = self.chunk_prefill_fn(tokens, pf.slot, start, valid)
        pf.next_col = start + valid
        if pf.next_col >= plen:
            self._finalize_prefill(pf)

    def _finalize_prefill(self, pf: _Prefilling) -> None:
        """Every prompt column is on device: fetch the first generated
        token (the ONE prefill-path sync, same as the contiguous
        admission), publish the prompt to the prefix cache, and join the
        decode batch."""
        req = pf.request
        first = host_sync.fetch_scalar(pf.first_dev)
        t_pre1 = self.clock()
        del self._prefilling[pf.slot]
        self.pool.commit_prefix(pf.slot, req.prompt)
        self.pool.admitted_total += 1
        if req.prefill_only:
            self._finalize_handoff(pf, first, t_pre1)
            return
        # Same budget as the contiguous pool (capacity from the FIXED
        # prompt width, not this prompt's length) — oracle parity.
        budget = min(
            req.max_new_tokens, self.pool.max_len - self.max_prompt_len
        )
        entry = _Active(
            request=req, slot=pf.slot, tokens=[first],
            token_times=[self.clock()], budget=budget,
            next_col=len(req.prompt),
        )
        entry.admitted_at = self.clock()
        self._active[pf.slot] = entry
        if self.costs is not None:
            # The whole prompt is on device: bill its prefill (with the
            # prefix-cache discount visible) and the first emitted token.
            self.costs.record_prefill(req.tenant, len(req.prompt),
                                      cached=pf.matched)
            self.costs.record_decode(req.tenant, 1)
        if self.tracer.enabled:
            track = f"req:{req.req_id}"
            self.tracer.record(
                "queue", req.submitted_at, pf.t_pop, track=track,
                req_id=req.req_id,
            )
            self.tracer.record(
                "prefill", pf.t_pre0, t_pre1, track=track,
                req_id=req.req_id, prompt_tokens=len(req.prompt),
                cached_tokens=pf.matched,
            )
            self.tracer.record(
                "admit", pf.t_pop, entry.admitted_at, track=track,
                req_id=req.req_id, slot=pf.slot,
            )
        if first == req.stop_token or len(entry.tokens) >= budget:
            self._finish(entry, "completed")
        else:
            self._overrides[pf.slot] = first

    def _finalize_handoff(self, pf: _Prefilling, first: int,
                          t_pre1: float) -> None:
        """Prefill-tier terminal: the whole prompt is on device, so
        instead of joining the decode batch the slot's blocks export as
        a KV handoff and the slot releases (its chain stays published in
        THIS pool's prefix cache, so sibling prompts on the prefill tier
        keep hitting). ``export_blocks`` closes the block-seconds
        billing window; the importing pool's owner declaration opens the
        next one. The prefill side bills the prompt (prefix discount
        visible) and the prefill-sampled first token — the decode side
        bills from token two, so cross-tier token sums equal the
        monolithic run's."""
        req = pf.request
        export = self.pool.export_blocks(pf.slot)
        chain = list(req.prompt)
        self.pool.release(pf.slot, tokens=chain)
        self._handoffs[req.req_id] = {
            "req_id": req.req_id,
            "prompt": chain,
            "first": first,
            "max_new_tokens": req.max_new_tokens,
            "stop_token": req.stop_token,
            "deadline": req.deadline,
            "submitted_at": req.submitted_at,
            "tenant": req.tenant,
            "matched": pf.matched,
            "export": export,
        }
        if self.costs is not None:
            self.costs.record_prefill(req.tenant, len(req.prompt),
                                      cached=pf.matched)
            self.costs.record_decode(req.tenant, 1)
        if self.tracer.enabled:
            track = f"req:{req.req_id}"
            self.tracer.record(
                "queue", req.submitted_at, pf.t_pop, track=track,
                req_id=req.req_id,
            )
            self.tracer.record(
                "prefill", pf.t_pre0, t_pre1, track=track,
                req_id=req.req_id, prompt_tokens=len(req.prompt),
                cached_tokens=pf.matched,
            )
            self.tracer.instant(
                "handoff_export", at=self.clock(), track=track,
                req_id=req.req_id, blocks=export["blocks"],
            )

    def pop_handoff(self, req_id: int) -> Optional[Dict]:
        """Claim a parked handoff (None until its prefill finishes)."""
        return self._handoffs.pop(req_id, None)

    def admit_import(self, request: Request, first: int,
                     chain: List[int], arrays,
                     leaf_names=None) -> Tuple[int, List[GenerationResult]]:
        """Decode-tier admission of an imported handoff: bind the
        shipped blocks to a fresh slot and join the decode batch exactly
        where the prefill side left off (``next_col`` at the prompt
        frontier, the prefill-sampled first token riding in as the next
        dispatch's override — token-identical to the monolithic path by
        construction). Returns ``(slot, finished)`` — ``finished`` is
        non-empty only when the first token already terminated the
        request (stop token / budget of 1), and the caller publishes it
        (``step``'s result slicing never returns admissions made between
        steps). Raises ``QueueFull`` when no slot is free (the router
        retries another decode replica or falls back to a local
        re-prefill); any import error unwinds the slot completely."""
        before = len(self._results)
        slot = self.pool.acquire()
        if slot is None:
            raise QueueFull(self.pool.max_slots, self.pool.max_slots,
                            self.queue.retry_hint_s)
        if self.costs is not None and hasattr(self.pool, "set_slot_owner"):
            self.pool.set_slot_owner(slot, request.tenant)
        try:
            self.pool.import_blocks(slot, chain, arrays,
                                    leaf_names=leaf_names)
        except Exception:
            self.pool.release(slot)
            raise
        self.pool.admitted_total += 1
        budget = min(
            request.max_new_tokens, self.pool.max_len - self.max_prompt_len
        )
        entry = _Active(
            request=request, slot=slot, tokens=[first],
            token_times=[self.clock()], budget=budget,
            next_col=len(chain),
        )
        entry.admitted_at = self.clock()
        self._active[slot] = entry
        if self.tracer.enabled:
            track = f"req:{request.req_id}"
            self.tracer.instant(
                "handoff_import", at=entry.admitted_at, track=track,
                req_id=request.req_id, tokens=len(chain),
            )
            self.tracer.record(
                "admit", entry.token_times[0], entry.admitted_at,
                track=track, req_id=request.req_id, slot=slot,
            )
        if first == request.stop_token or len(entry.tokens) >= budget:
            self._finish(entry, "completed")
        else:
            self._overrides[slot] = first
        return slot, self._results[before:]

    def cancel_queued(self, req_id: int) -> Optional[GenerationResult]:
        """QoS preemption hook: pull ``req_id`` out of the queue if it
        has not been admitted yet and mint a ``"preempted"`` terminal
        result for it (the router requeues it under fair-share). Returns
        the result — the CALLER publishes it (``step``'s result slicing
        never returns cancellations made between steps) — or None when
        the request already left the queue: admitted work is never
        clawed back."""
        req = self.queue.remove(req_id)
        if req is None:
            return None
        result = GenerationResult(
            req_id=req.req_id, tokens=[], status="preempted",
            prompt_tokens=len(req.prompt), tenant=req.tenant,
        )
        self._results.append(result)
        if self.costs is not None:
            self.costs.record_queue(req.tenant,
                                    self.clock() - req.submitted_at)
            self.costs.record_status(req.tenant, "preempted")
        return result

    def _advance_prefills(self) -> None:
        """Run parked prefills forward, FIFO by admission order. With no
        per-step budget every pending chunk runs now (admission costs
        the same step it always did); with ``prefill_chunks_per_step``
        set, at most that many chunks dispatch — long prompts spread
        over several steps so in-flight decodes keep their ITL."""
        if not self._prefilling:
            return
        budget = self.prefill_chunks_per_step
        pending = list(self._prefilling.values())
        ran = 0
        for pf in pending:
            while pf.slot in self._prefilling and \
                    self._prefilling[pf.slot] is pf:
                if budget is not None and ran >= budget:
                    return
                self._run_chunk(pf)
                ran += 1

    # -- the decode hot path -----------------------------------------------

    def _dispatch(self, prev_tokens) -> _Inflight:
        """Launch one decode iteration (non-blocking) and swap the
        pool's cache. ``prev_tokens`` is the previous step's staged
        output or a host-built vector when no step is in flight."""
        t0 = self.clock()
        S = self.pool.max_slots
        override_vals = np.full((S,), self.pad_token, np.int64)
        override_mask = np.zeros((S,), bool)
        for slot, tok in self._overrides.items():
            override_vals[slot] = tok
            override_mask[slot] = True
        self._overrides.clear()
        active_mask = np.zeros((S,), bool)
        lanes = sorted(self._active.items())
        for slot, _ in lanes:
            active_mask[slot] = True
        if self.spec_decode_fn is not None:
            # Conservatively back TWO windows of columns per lane before
            # the engine snapshots the device block table: window N
            # writes [next_col, next_col + gamma], and the pipelined
            # window N+1 dispatches before N's harvest, so its writes
            # land no further than next_col + 2*gamma + 1. next_col
            # itself advances at HARVEST (by accepted + 1) on this path
            # — it must keep counting columns whose K/V write is
            # device-ordered, and a speculative write past the accepted
            # frontier is not one.
            for slot, entry in lanes:
                upto = min(entry.next_col + 2 * (self.gamma + 1),
                           self.pool.virtual_len)
                for col in range(entry.next_col, upto):
                    self.pool.ensure_decode_col(slot, col)
            out = self.spec_decode_fn(
                self.pool.cache, prev_tokens, override_vals,
                override_mask, active_mask, self.pool.pad,
            )
            if out is not None:
                last, emitted, accepted = out
                dispatched_at = self.clock()
                self.tracer.record(
                    "dispatch", t0, dispatched_at, lanes=len(lanes),
                    spec=True,
                )
                return _Inflight(
                    tokens=last, lanes=lanes, dispatched_at=dispatched_at,
                    spec=True, spec_emitted=emitted, spec_accepted=accepted,
                )
            # Draft source failed (spec_fallback flight-recorded by the
            # decoder): degrade to ONE plain decode step — the blocks
            # backed above stay owned, and the plain path's
            # advance-at-dispatch accounting below takes over for it.
        if self.paged:
            # Back (and exclusively own) the column each lane writes
            # this step BEFORE the engine closure snapshots the device
            # block table.
            for slot, entry in lanes:
                self.pool.ensure_decode_col(slot, entry.next_col)
                entry.next_col += 1
        nxt, new_cache = self.decode_fn(
            self.pool.cache, prev_tokens, override_vals, override_mask,
            active_mask, self.pool.pad,
        )
        self.pool.swap(new_cache)
        dispatched_at = self.clock()
        self.tracer.record(
            "dispatch", t0, dispatched_at, lanes=len(lanes),
        )
        return _Inflight(tokens=nxt, lanes=lanes,
                         dispatched_at=dispatched_at)

    def _host_prev_tokens(self):
        """Previous-token vector built host-side — the cold-start path
        (nothing in flight to chain from). Admission overrides are
        already reflected in each entry's ``tokens[-1]``."""
        prev = np.full((self.pool.max_slots,), self.pad_token, np.int64)
        for slot, entry in self._active.items():
            prev[slot] = entry.tokens[-1]
        self._overrides.clear()
        return prev

    def _harvest(self, inflight: _Inflight) -> int:
        """Read a dispatched step's tokens back (active lanes only) and
        run the host bookkeeping: append, stop/budget checks, finishes.
        Lanes whose entry finished or was evicted AFTER dispatch are
        skipped — their computed token is the one wasted lane-iteration
        pipelining costs on stop detection."""
        if inflight.spec:
            return self._harvest_spec(inflight)
        live = [
            (slot, entry) for slot, entry in inflight.lanes
            if self._active.get(slot) is entry
        ]
        if not live:
            return 0
        fetched = host_sync.fetch_lanes(
            inflight.tokens, [slot for slot, _ in live]
        )
        now = self.clock()
        if self.metrics is not None:
            self.metrics.record_overlap(now - inflight.dispatched_at)
        # One span per decode ITERATION (dispatch → tokens on host) —
        # exactly the dispatch_to_fetch overlap window, not per-token.
        self.tracer.record(
            "decode_step", inflight.dispatched_at, now, lanes=len(live),
        )
        emitted = 0
        # Attribution batched per tenant: one ledger call per tenant per
        # step, not per token (lanes are few; the lock is not).
        tenant_tokens: Optional[Dict[Optional[str], int]] = (
            {} if self.costs is not None else None
        )
        for (slot, entry), (_, tok) in zip(live, fetched):
            entry.tokens.append(tok)
            entry.token_times.append(now)
            entry.steps += 1
            emitted += 1
            if tenant_tokens is not None:
                t = entry.request.tenant
                tenant_tokens[t] = tenant_tokens.get(t, 0) + 1
            if tok == entry.request.stop_token or \
                    len(entry.tokens) >= entry.budget:
                self._finish(entry, "completed")
            else:
                # The lane's next input rides the device chain; a stale
                # override from a previous occupancy must not clobber it.
                self._overrides.pop(slot, None)
        if tenant_tokens:
            for t, n in tenant_tokens.items():
                self.costs.record_decode(t, n)
        return emitted

    def _harvest_spec(self, inflight: _Inflight) -> int:
        """Ragged speculative harvest: lane ``s`` gained
        ``accepted[s] + 1`` tokens this window — the target's own
        samples, truncated host-side at stop token / budget exactly
        where the plain path would have stopped.

        ``next_col`` advances by ``accepted + 1`` (the device frontier's
        advance): every column below the new frontier has its K/V write
        device-ordered, and the frontier token itself — like plain
        decode's newest token — is K/V-unwritten until the next window
        consumes it. ``_finish``'s chain slice therefore publishes
        exactly the deterministically-written columns; on a truncated
        window the Python slice clamps to the shorter token list, whose
        last token was a draft INPUT this window (K/V written)."""
        live = [
            (slot, entry) for slot, entry in inflight.lanes
            if self._active.get(slot) is entry
        ]
        if not live:
            return 0
        em = host_sync.fetch_ints(inflight.spec_emitted)    # (S, gamma+1)
        ac = host_sync.fetch_ints(inflight.spec_accepted)   # (S,)
        now = self.clock()
        if self.metrics is not None:
            self.metrics.record_overlap(now - inflight.dispatched_at)
        self.tracer.record(
            "decode_step", inflight.dispatched_at, now, lanes=len(live),
            spec=True,
        )
        emitted = 0
        accepted_sum = 0
        for slot, entry in live:
            a = ac[slot]
            accepted_sum += a
            entry.steps += 1
            entry.next_col += a + 1
            finished = False
            lane_emitted = 0
            for off in range(a + 1):
                tok = em[slot][off]
                entry.tokens.append(tok)
                entry.token_times.append(now)
                emitted += 1
                lane_emitted += 1
                if tok == entry.request.stop_token or \
                        len(entry.tokens) >= entry.budget:
                    self._finish(entry, "completed")
                    finished = True
                    break
            if self.costs is not None:
                # Per-lane attribution: the lane's tenant pays for its
                # gamma draft proposals, its accepted prefix, and the
                # tokens that actually reached its stream (post stop/
                # budget truncation) — summing to the aggregate
                # record_spec below by construction.
                self.costs.record_spec(
                    entry.request.tenant, drafted=self.gamma,
                    accepted=a, emitted=lane_emitted,
                )
                self.costs.record_decode(entry.request.tenant,
                                         lane_emitted)
            if not finished:
                # Next input rides the device chain (the frontier
                # sample); drop any stale override for this slot.
                self._overrides.pop(slot, None)
        if self.metrics is not None:
            self.metrics.record_spec(
                windows=len(live),
                drafted=self.gamma * len(live),
                accepted=accepted_sum,
                emitted=emitted,
            )
        return emitted

    def _step_pipelined(self) -> int:
        """Dispatch N+1, then do ALL host work overlapped with it."""
        prev = self._inflight
        self._inflight = None
        if self._active:
            self._inflight = self._dispatch(
                prev.tokens if prev is not None else self._host_prev_tokens()
            )
        emitted = self._harvest(prev) if prev is not None else 0
        # Host bookkeeping below overlaps the just-dispatched step.
        self._evict_expired()
        self._admit_from_queue()
        self._advance_prefills()
        if self._inflight is None and self._active:
            # Cold start: the pool was empty at the top of the step and
            # admissions just filled it — dispatch now rather than
            # wasting a whole iteration before the first decode.
            self._inflight = self._dispatch(self._host_prev_tokens())
        return emitted

    def _step_sync(self) -> int:
        """The unpipelined reference path: evict, admit, decode, read —
        the device idles during every host phase. Kept as the oracle the
        pipelined path is tested token-identical against."""
        self._evict_expired()
        self._admit_from_queue()
        self._advance_prefills()
        if not self._active:
            return 0
        inflight = self._dispatch(self._host_prev_tokens())
        return self._harvest(inflight)

    def step(self) -> List[GenerationResult]:
        """One scheduler iteration; returns requests finished during it."""
        t0 = self.clock()
        before = len(self._results)
        emitted = (
            self._step_pipelined() if self.pipeline else self._step_sync()
        )
        t1 = self.clock()
        self.tracer.record(
            "sched_step", t0, t1, tokens=emitted, active=len(self._active),
        )
        if self.metrics is not None:
            self.metrics.record_step(
                queue_depth=len(self.queue), active=len(self._active),
                tokens=emitted, step_seconds=t1 - t0,
            )
        if self.load is not None:
            # Paged pools report BLOCK-granular KV pressure (free blocks
            # beat free slots once blocks are shared across slots).
            kv = (self.pool.load_signals()
                  if hasattr(self.pool, "load_signals") else {})
            kv_free_frac = (
                kv["kv_blocks_free"] / max(1, kv["kv_blocks_total"])
                if kv else self.pool.free_count / self.pool.max_slots
            )
            self.load.observe(
                queue_depth=len(self.queue),
                queue_limit=self.queue.max_depth,
                active=len(self._active),
                max_slots=self.pool.max_slots,
                kv_free_frac=kv_free_frac,
                admitted_total=(self.metrics.requests_submitted
                                if self.metrics else 0),
                rejected_total=(self.metrics.requests_rejected
                                if self.metrics else 0),
                tokens_total=(self.metrics.tokens_out
                              if self.metrics else 0),
                now=t1,
                kv_blocks_free=kv.get("kv_blocks_free"),
                kv_blocks_total=kv.get("kv_blocks_total"),
                prefix_hit_rate=kv.get("prefix_hit_rate"),
                spec_accept_rate=(
                    self.metrics.spec_accept_rate
                    if self.metrics is not None
                    and self.spec_decode_fn is not None else None
                ),
                spec_tokens_per_step=(
                    self.metrics.spec_tokens_per_step
                    if self.metrics is not None
                    and self.spec_decode_fn is not None else None
                ),
            )
        return self._results[before:]

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        """Step until queue and pool are empty (tests / batch draining)."""
        for _ in range(max_steps):
            if not self.has_work:
                return
            self.step()
        raise RuntimeError(f"not drained after {max_steps} steps")

    def drain_results(self) -> List[GenerationResult]:
        out, self._results = self._results, []
        return out
