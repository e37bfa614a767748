"""Trial spec + state machine for the elastic ASHA tuner (counterpart of
``elephas_tpu/tune/trial.py``, a copy: the digests are string-equal to the
JAX package's for the same trial).

A trial is one sampled configuration working its way up the rung
ladder. The spec is immutable (config, seed, the flattened sampler
``values`` the TPE observers key on) and pinned by a **replay-stable
digest**: the SHA-256 of the canonical-JSON ``(trial_id, seed, config)``
triple. Two runs of the same seeded search mint identical digests for
identical trials, which is what the chaos gate compares — a digest that
mixed in wall time or worker identity would never replay.

The state machine is deliberately small and *monotone*:

    pending -> running -> paused -> promoted (-> running at rung+1)
                               \\-> pruned
                running -> completed            (top rung reached, or
                                                 delta-norm plateau)

``paused`` is async ASHA's waiting room: the trial finished its rung
and was not (yet) in the promotable quantile. It may be promoted later
as more results land, or swept to ``pruned`` at finalize — ASHA's early
stopping is exactly "never scheduled again", not a hard kill. Every
transition is guarded (a zombie worker re-reporting a finished rung is
a no-op), so duplicate completions from re-leased units cannot corrupt
the table.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["STATUSES", "TERMINAL", "TrialSpec", "TrialState",
           "canonical_digest"]

#: The closed status vocabulary, in lifecycle order.
STATUSES = ("pending", "running", "paused", "promoted", "pruned",
            "completed")

#: Statuses a trial never leaves.
TERMINAL = ("pruned", "completed")


def _canon(obj: Any) -> Any:
    """Canonicalize config values for digesting: numpy scalars to
    Python scalars, tuples to lists — whatever survives a JSON
    round-trip identically on every host."""
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items(),
                                                     key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except Exception:
            pass
    if isinstance(obj, float):
        # repr round-trips doubles exactly; json uses repr already.
        return obj
    return obj


def canonical_digest(payload: Any, n: int = 12) -> str:
    """SHA-256 over canonical JSON, truncated to ``n`` hex chars."""
    blob = json.dumps(_canon(payload), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:n]


class TrialSpec:
    """Immutable identity of one trial: sampled config + seed + digest.

    ``values`` is the sampler's flattened ``{path: value}`` draw (kept
    so adaptive samplers can ``observe`` the final loss against the
    exact draw), ``config`` the substituted user-facing sample.
    """

    __slots__ = ("trial_id", "config", "values", "seed", "digest")

    def __init__(self, trial_id: int, config: Dict, seed: int,
                 values: Optional[Dict] = None):
        self.trial_id = int(trial_id)
        self.config = config
        self.values = values
        self.seed = int(seed)
        self.digest = canonical_digest(
            {"trial": self.trial_id, "seed": self.seed, "config": config})

    def __repr__(self):
        return (f"TrialSpec(id={self.trial_id}, seed={self.seed}, "
                f"digest={self.digest!r})")


class TrialState:
    """One trial's mutable scheduler-side record.

    NOT thread-safe on its own — the scheduler serializes every
    transition under its lock. ``rung_loss``/``rung_delta_norm`` are
    first-write-wins per rung (zombie fencing), ``owners`` the lease
    history (who ran each rung — re-leases append, so a kill shows as
    two owners for one rung), ``resumed`` how many times the trial was
    picked back up from a vault checkpoint after its owner died.
    """

    __slots__ = ("spec", "status", "rung", "rung_loss", "rung_delta_norm",
                 "owners", "resumed", "started_at", "last_progress_at")

    def __init__(self, spec: TrialSpec):
        self.spec = spec
        self.status = "pending"
        self.rung = 0                     # the rung currently being run/next
        self.rung_loss: Dict[int, float] = {}
        self.rung_delta_norm: Dict[int, float] = {}
        self.owners: List[Tuple[int, str]] = []   # (rung, worker_id)
        self.resumed = 0
        self.started_at: Optional[float] = None
        self.last_progress_at: Optional[float] = None

    # -- guarded transitions (caller holds the scheduler lock) ----------

    def start(self, rung: int, worker_id: str, now: float) -> None:
        if self.status in TERMINAL:
            return
        self.status = "running"
        self.rung = int(rung)
        self.owners.append((int(rung), str(worker_id)))
        if self.started_at is None:
            self.started_at = now
        self.last_progress_at = now

    def record_rung(self, rung: int, loss: float,
                    delta_norm: Optional[float], now: float) -> bool:
        """First-write-wins rung result; returns False for duplicates
        (a zombie's late re-report of a rung a survivor already
        delivered)."""
        rung = int(rung)
        if rung in self.rung_loss:
            return False
        self.rung_loss[rung] = float(loss)
        if delta_norm is not None:
            self.rung_delta_norm[rung] = float(delta_norm)
        self.last_progress_at = now
        return True

    @property
    def best_loss(self) -> Optional[float]:
        return min(self.rung_loss.values()) if self.rung_loss else None

    @property
    def top_rung(self) -> int:
        """Highest rung with a recorded result (-1 before any)."""
        return max(self.rung_loss) if self.rung_loss else -1

    def to_doc(self) -> Dict[str, Any]:
        """JSON-safe card for the ``/trials`` route / fleet board."""
        return {
            "trial": self.spec.trial_id,
            "digest": self.spec.digest,
            "status": self.status,
            "rung": self.rung,
            "loss": self.rung_loss.get(self.top_rung),
            "top_rung": self.top_rung,
            "resumed": self.resumed,
            "owners": [list(o) for o in self.owners],
        }

    def __repr__(self):
        return (f"TrialState(id={self.spec.trial_id}, {self.status}, "
                f"rung={self.rung}, losses={self.rung_loss})")
