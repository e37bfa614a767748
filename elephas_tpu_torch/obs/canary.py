"""Blackbox canaries: synthetic probes through the real data paths
(counterpart of ``elephas_tpu/obs/canary.py``).

Whitebox metrics can look healthy while users see nothing — a wedged
accept loop keeps exporting beautiful histograms. The canary answers
the only question that matters from the outside: *does a request
actually make it through, and how long does it take?*

- ``CanaryDriver`` — injects tagged low-cost probe requests (one-token
  prompt, two decode steps by default) through the engine's *real*
  submit path. The engine routes the finished probe back to the driver
  and — critically — never lets it reach the goodput ledger: real-
  traffic SLO accounting is identical with canaries on or off (pinned
  by test). Each probe is measured as an end-to-end blackbox SLI
  (submit-to-result wall time, TTFT) on the engine's injected clock,
  mirrored into ``serving_canary_probe_total`` /
  ``serving_canary_fail_total`` counters, and failures emit the
  ``canary_fail`` flight kind. The opsd ``/canary`` route serves
  ``snapshot()``.
- ``PSCanary`` — the parameter-server analogue: a zero-delta probe
  tree (built from the ``ShardPlan``'s dtype/shape rows, so it is
  plan-exact by construction and perturbs nothing) pushed and pulled
  through one wire sub-client *per shard*, yielding a write-read
  round-trip time for each shard independently — a dead primary shows
  up as that shard's probe failing while its peers stay green. When
  handed the in-process ``ShardGroup`` it also reads each standby's
  ``WalStreamer.lag()``, so a standby's lag shows beside its shard.

The port's zero-delta tree is built from the plan's rows as tensors
(``torch.zeros`` of each row's dtype, bfloat16 included), which every
wire codec of the port frames as the JAX package frames its arrays.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

DEFAULT_PROBE_PROMPT = (1,)
DEFAULT_PROBE_TOKENS = 2
DEFAULT_PROBE_TIMEOUT_S = 30.0
MAX_KEPT_RESULTS = 256


def _flight():
    from elephas_tpu_torch import obs
    return obs.default_flight_recorder()


class _ProbeCounters:
    """Lazy default-registry counter pair, latched off on bind failure.

    Metric names arrive as full literals from the two call sites (the
    naming lint judges literals where they are written, and canary
    counters ride the ``serving_`` / ``ps_`` history-sampling prefixes).
    """

    def __init__(self, probe_name: str, fail_name: str):
        self._probe_name = probe_name
        self._fail_name = fail_name
        self._probe = None
        self._fail = None

    def bump(self, ok: bool) -> None:
        if self._probe is None:
            try:
                from elephas_tpu_torch import obs
                reg = obs.default_registry()
                self._probe = reg.counter(
                    self._probe_name, help="blackbox canary probes attempted")
                self._fail = reg.counter(
                    self._fail_name, help="blackbox canary probes that failed")
            except Exception:
                self._probe = False
                self._fail = False
        if self._probe:
            self._probe.inc()
            if not ok:
                self._fail.inc()


class CanaryDriver:
    """End-to-end serving probe through the real submit path."""

    def __init__(self, engine, *, prompt: Sequence[int] = DEFAULT_PROBE_PROMPT,
                 max_new_tokens: int = DEFAULT_PROBE_TOKENS,
                 timeout_s: float = DEFAULT_PROBE_TIMEOUT_S,
                 clock: Optional[Callable[[], float]] = None):
        self.engine = engine
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.timeout_s = float(timeout_s)
        self.clock = clock if clock is not None else engine.clock
        self._lock = threading.Lock()
        self._results: List[Dict[str, object]] = []
        self.probes = 0
        self.failures = 0
        self._counters = _ProbeCounters(
            "serving_canary_probe_total", "serving_canary_fail_total")
        # The engine serves /canary from the attached driver.
        engine.attach_canary(self)

    def probe(self, timeout_s: Optional[float] = None) -> Dict[str, object]:
        """One blackbox round trip: submit → result, measured outside."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        t0 = self.clock()
        rec: Dict[str, object] = {
            "t": t0, "ok": False, "e2e_s": None, "ttft_s": None,
            "status": None, "error": None,
        }
        try:
            rid = self.engine.submit(
                self.prompt, max_new_tokens=self.max_new_tokens,
                timeout_s=timeout_s, canary=True,
            )
            res = self.engine.result(rid, timeout_s=timeout_s)
            rec["status"] = res.status
            rec["ttft_s"] = res.ttft_s
            rec["e2e_s"] = self.clock() - t0
            rec["ok"] = res.status == "completed"
        except Exception as exc:
            rec["error"] = f"{type(exc).__name__}: {exc}"
            rec["e2e_s"] = self.clock() - t0
        with self._lock:
            self.probes += 1
            if not rec["ok"]:
                self.failures += 1
            self._results.append(rec)
            del self._results[:-MAX_KEPT_RESULTS]
        self._counters.bump(bool(rec["ok"]))
        if not rec["ok"]:
            _flight().note(
                "canary_fail", "error", surface="serving",
                status=rec["status"], error=rec["error"],
            )
        return rec

    def snapshot(self) -> Dict[str, object]:
        """The opsd ``/canary`` document."""
        with self._lock:
            results = list(self._results)
            probes, failures = self.probes, self.failures
        e2e = [r["e2e_s"] for r in results if r["e2e_s"] is not None]
        return {
            "surface": "serving",
            "probes": probes,
            "failures": failures,
            "failure_ratio": (failures / probes) if probes else None,
            "e2e_s_avg": (sum(e2e) / len(e2e)) if e2e else None,
            "e2e_s_max": max(e2e) if e2e else None,
            "last": results[-1] if results else None,
        }


class PSCanary:
    """Per-shard write-read probe through ``ShardedParameterClient``."""

    def __init__(self, client, *, group=None,
                 clock: Callable[[], float] = time.monotonic):
        self.client = client
        self.plan = client.plan
        self.group = group
        self.clock = clock
        self._lock = threading.Lock()
        self.probes = 0
        self.failures = 0
        self._last: Optional[Dict[str, object]] = None
        self._counters = _ProbeCounters(
            "ps_canary_probe_total", "ps_canary_fail_total")
        # One zero-delta flat tree per shard, plan-exact by construction:
        # the server applies it additively, so state is unperturbed while
        # the full decode/apply/encode path still runs.
        self._zero: Dict[int, Dict[str, torch.Tensor]] = {}
        for i, (path, row) in enumerate(zip(self.plan.paths, self.plan.rows)):
            dtype, shape = row[0], row[1]
            shard = self.plan.shard_of[i]
            self._zero.setdefault(shard, {})[path] = torch.zeros(
                tuple(shape), dtype=getattr(torch, dtype))

    def _probe_shard(self, shard: int) -> Dict[str, object]:
        rec: Dict[str, object] = {"shard": shard, "ok": False,
                                  "rtt_s": None, "error": None}
        t0 = self.clock()
        try:
            sub = self.client.shard_client(shard)
            sub.update_parameters(self._zero[shard])
            sub.get_parameters()
            rec["rtt_s"] = self.clock() - t0
            rec["ok"] = True
        except Exception as exc:
            rec["rtt_s"] = self.clock() - t0
            rec["error"] = f"{type(exc).__name__}: {exc}"
        return rec

    def probe(self) -> Dict[str, object]:
        """Write-read round trip against every shard, plus standby lag
        when the in-process group is visible."""
        t0 = self.clock()
        shards = [self._probe_shard(s) for s in range(self.plan.k)]
        ok = all(s["ok"] for s in shards)
        doc: Dict[str, object] = {
            "t": t0, "ok": ok, "shards": shards,
            "rtt_s_max": max((s["rtt_s"] for s in shards
                              if s["rtt_s"] is not None), default=None),
            "standby_lag": self._standby_lag(),
        }
        with self._lock:
            self.probes += 1
            if not ok:
                self.failures += 1
            self._last = doc
        self._counters.bump(ok)
        if not ok:
            failed = [s["shard"] for s in shards if not s["ok"]]
            _flight().note(
                "canary_fail", "error", surface="ps", shards=failed,
                error=next(s["error"] for s in shards if not s["ok"]),
            )
        return doc

    def _standby_lag(self) -> Optional[List[Dict[str, object]]]:
        if self.group is None:
            return None
        out = []
        for i in range(self.plan.k):
            streamer = self.group.streamer_of(i)
            if streamer is not None:
                try:
                    out.append({"shard": i, "lag": streamer.lag()})
                except Exception:
                    out.append({"shard": i, "lag": None})
        return out

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "surface": "ps",
                "probes": self.probes,
                "failures": self.failures,
                "failure_ratio": (self.failures / self.probes)
                if self.probes else None,
                "last": self._last,
            }
