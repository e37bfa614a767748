"""Serving observability: TTFT, inter-token latency, queue depth,
tokens/sec (counterpart of ``elephas_tpu/serving/metrics.py``) — emitted
through the port's ``metrics.logging.JsonlSink``
(one JSON object per line, the same artifact format every committed
benchmark in this repo uses) and aggregated in-memory for tests and the
engine's ``stats()``.

Two record streams share the sink, tagged by ``event``:

- ``event="request"`` — one line per FINISHED request: status, prompt /
  generated token counts, ``ttft_s`` (submit → first token),
  ``itl_s_avg`` (mean gap between consecutive tokens), decode
  tokens/sec for that request.
- ``event="step"``   — one line per scheduler iteration (sampled every
  ``step_log_every``): queue depth, active slots, tokens emitted this
  step, step wall seconds, and ``dispatch_to_fetch_s`` — the
  device-overlap gauge: wall seconds between a decode step's dispatch
  and the harvest of its tokens. On the pipelined path all host
  bookkeeping for the previous step happens inside this window, so the
  gauge reads ≈ one full step of hidden host work; on the unpipelined
  path it collapses to the bare device-compute+transfer time.

Metrics must degrade, not kill the serve loop — the sink already
stringifies anything JSON can't carry; here a missing sink simply means
in-memory aggregation only.
"""

from __future__ import annotations

import time
from typing import Optional

from elephas_tpu_torch.obs import Histogram

# The three latency families summary() reports percentiles for. Raw
# sample lists are kept alongside (tests and notebooks read them); the
# histograms are what the percentile estimates come from, so the same
# numbers keep working if the lists are ever dropped for long runs.
_LATENCY_KEYS = ("ttft_s", "itl_s", "dispatch_to_fetch_s")


class ServingMetrics:
    """Aggregator + JSONL emitter for the serving engine."""

    def __init__(self, sink=None, step_log_every: int = 1,
                 clock=time.monotonic):
        self.sink = sink
        self.step_log_every = max(1, int(step_log_every))  # host-ok: arg
        self.clock = clock
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_timed_out = 0
        self.requests_rejected = 0
        self.tokens_out = 0
        self.steps = 0
        self.max_concurrent = 0
        self.ttft_s: list = []
        self.itl_s: list = []
        self.dispatch_to_fetch_s: list = []
        self.histograms = {k: Histogram(k) for k in _LATENCY_KEYS}
        self._last_overlap: Optional[float] = None
        self._t0: Optional[float] = None
        # Speculative decode aggregates (zero unless the engine runs
        # with speculative=True): lane-windows harvested, draft tokens
        # proposed/accepted, tokens emitted by speculative harvests.
        self.spec_windows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0
        # Lazy process-registry mirror of the ITL distribution: the SLO
        # alert pack's serving rule reads ``serving_itl_seconds_p99``
        # from registry snapshots, which the private per-engine
        # histograms above never reach. Bound on first finish; False
        # latches "registry unavailable" so a broken import can't tax
        # every request.
        self._registry_itl = None

    def reset(self) -> None:
        """Zero every in-memory aggregate (the sink, if any, keeps its
        already-written lines). Benchmarks warm the compile caches with
        a throwaway request, then reset so the timed run's numbers
        measure serving, not the programs' first build."""
        self.requests_submitted = 0
        self.requests_completed = 0
        self.requests_timed_out = 0
        self.requests_rejected = 0
        self.tokens_out = 0
        self.steps = 0
        self.max_concurrent = 0
        self.ttft_s = []
        self.itl_s = []
        self.dispatch_to_fetch_s = []
        self.histograms = {k: Histogram(k) for k in _LATENCY_KEYS}
        self._last_overlap = None
        self._t0 = None
        self.spec_windows = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_emitted = 0

    # -- request lifecycle -------------------------------------------------

    def record_submit(self) -> None:
        if self._t0 is None:
            self._t0 = self.clock()
        self.requests_submitted += 1

    def record_reject(self) -> None:
        self.requests_rejected += 1

    def record_finish(self, result, queue_depth: int, active: int) -> None:
        if result.status == "timeout":
            self.requests_timed_out += 1
        else:
            self.requests_completed += 1
        self.tokens_out += len(result.tokens)
        if result.ttft_s is not None:
            self.ttft_s.append(result.ttft_s)
            self.histograms["ttft_s"].observe(result.ttft_s)
        if result.itl_s_avg is not None:
            self.itl_s.append(result.itl_s_avg)
            self.histograms["itl_s"].observe(result.itl_s_avg)
            hist = self._registry_itl
            if hist is None:
                try:
                    from elephas_tpu_torch import obs
                    # exemplars=True: each observe latches the request's
                    # active trace id on its bucket, so a p99 spike in
                    # the exposition joins to the exact span tree in
                    # trace_report (the record runs inside the request
                    # span the scheduler opened).
                    hist = obs.default_registry().histogram(
                        "serving_itl_seconds",
                        help="per-request mean inter-token latency",
                        exemplars=True,
                    )
                except Exception:
                    hist = False
                self._registry_itl = hist
            if hist:
                hist.observe(result.itl_s_avg)
        if self.sink is not None:
            self.sink.log(
                self.steps,
                event="request",
                req_id=result.req_id,
                status=result.status,
                prompt_tokens=result.prompt_tokens,
                new_tokens=len(result.tokens),
                ttft_s=result.ttft_s,
                itl_s_avg=result.itl_s_avg,
                tokens_per_sec=result.tokens_per_sec,
                tokens_per_step=result.tokens_per_step,
                queue_depth=queue_depth,
                active_slots=active,
            )

    # -- speculative decode ------------------------------------------------

    def record_spec(self, *, windows: int, drafted: int, accepted: int,
                    emitted: int) -> None:
        """One speculative harvest: ``windows`` lane-windows read back,
        ``drafted`` draft tokens proposed (gamma per lane), ``accepted``
        of them matching the target, ``emitted`` tokens appended to
        streams (accepted + bonus, minus stop/budget truncation)."""
        self.spec_windows += windows
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    @property
    def spec_accept_rate(self) -> Optional[float]:
        if self.spec_drafted == 0:
            return None
        return self.spec_accepted / self.spec_drafted

    @property
    def spec_tokens_per_step(self) -> Optional[float]:
        if self.spec_windows == 0:
            return None
        return self.spec_emitted / self.spec_windows

    # -- scheduler cadence -------------------------------------------------

    def record_overlap(self, seconds: float) -> None:
        """Dispatch→fetch wall time for one decode step (the window the
        pipelined scheduler hides host bookkeeping in)."""
        self.dispatch_to_fetch_s.append(seconds)
        self.histograms["dispatch_to_fetch_s"].observe(seconds)
        self._last_overlap = seconds

    def record_step(self, queue_depth: int, active: int, tokens: int,
                    step_seconds: float) -> None:
        self.steps += 1
        self.max_concurrent = max(self.max_concurrent, active)
        overlap, self._last_overlap = self._last_overlap, None
        if self.sink is not None and self.steps % self.step_log_every == 0:
            self.sink.log(
                self.steps,
                event="step",
                queue_depth=queue_depth,
                active_slots=active,
                step_tokens=tokens,
                step_seconds=step_seconds,
                dispatch_to_fetch_s=overlap,
                tokens_per_sec=tokens / max(step_seconds, 1e-9),
            )

    # -- aggregates --------------------------------------------------------

    def summary(self) -> dict:
        elapsed = None if self._t0 is None else self.clock() - self._t0
        mean = lambda xs: (sum(xs) / len(xs)) if xs else None  # noqa: E731
        out = {
            "submitted": self.requests_submitted,
            "completed": self.requests_completed,
            "timed_out": self.requests_timed_out,
            "rejected": self.requests_rejected,
            "tokens_out": self.tokens_out,
            "steps": self.steps,
            "max_concurrent": self.max_concurrent,
            "ttft_s_avg": mean(self.ttft_s),
            "itl_s_avg": mean(self.itl_s),
            "dispatch_to_fetch_s_avg": mean(self.dispatch_to_fetch_s),
            "elapsed_s": elapsed,
            "tokens_per_sec": (
                self.tokens_out / elapsed if elapsed else None
            ),
        }
        if self.spec_windows:
            out["spec_windows"] = self.spec_windows
            out["spec_accept_rate"] = self.spec_accept_rate
            out["spec_tokens_per_step"] = self.spec_tokens_per_step
        # Tail latencies (bucketed estimates, obs.Histogram): averages
        # hide exactly the stall spikes serving SLOs are written against.
        for key, hist in self.histograms.items():
            for pkey, v in hist.percentiles().items():
                out[f"{key}_{pkey}"] = v
        return out
