"""The fleet roster: named replica slots with explicit lifecycles
(counterpart of ``elephas_tpu/serving/fleet/replica_set.py``).

A ``ReplicaSet`` owns N ``Replica`` slots and nothing else — no
dispatch policy, no signals interpretation; that's the router's job.
What it does own is *identity*: replica ids are assigned once
(``r0``, ``r1``, ...) and dead replicas stay in the roster, because
death is a state the fleet plane narrates (the aggregator's
alive → stale → dead → alive arcs need the slot to persist across the
outage), not an eviction. A restart is the same slot coming back with
the next boot number; a scale-up is a genuinely new slot.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Callable, Dict, List, Optional

from elephas_tpu_torch.serving.fleet.replica import DEAD, SERVING, Replica

__all__ = ["ReplicaSet"]


class ReplicaSet:
    """Spawn / drain / kill / restart replicas by id.

    ``engine_factory`` is shared by every slot — each spawn builds a
    fresh engine, so replicas never share queues or ledgers. They may
    share the model inside the factory's closure: each engine serves a
    copy of its weights (``InferenceEngine`` copies at construction), so
    a weight rollout to one replica never reaches another.
    """

    def __init__(self, engine_factory: Callable[[], Any], *,
                 initial: int = 1,
                 tiers: Optional[Dict[str, int]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 mount_ops: bool = False,
                 store_root: Optional[str] = None):
        if tiers is None:
            if initial < 1:
                raise ValueError(f"initial must be >= 1, got {initial}")
        elif not tiers or any(n < 1 for n in tiers.values()):
            raise ValueError(f"tiers must map tier -> count >= 1, "
                             f"got {tiers}")
        self.engine_factory = engine_factory
        self.clock = clock
        self.mount_ops = mount_ops
        # One durable telemetry slot dir per replica id under this root
        # (requires mount_ops — the store mounts with the ops endpoint).
        self.store_root = store_root
        self._seq = itertools.count()
        self.replicas: Dict[str, Replica] = {}
        # A disaggregated roster spawns per-tier slots instead of
        # ``initial`` monoliths, e.g. tiers={"prefill": 1, "decode": 2}.
        if tiers is None:
            for _ in range(initial):
                self.spawn()
        else:
            for tier, count in tiers.items():
                for _ in range(count):
                    self.spawn(tier=tier)

    def spawn(self, tier: str = "mono") -> Replica:
        """Add a new slot to the roster and boot it."""
        rid = f"r{next(self._seq)}"
        store_dir = (os.path.join(self.store_root, rid, "telemetry")
                     if self.store_root else None)
        rep = Replica(rid, self.engine_factory, clock=self.clock,
                      mount_ops=self.mount_ops, store_dir=store_dir,
                      tier=tier)
        rep.spawn()
        self.replicas[rid] = rep
        return rep

    def get(self, replica_id: str) -> Replica:
        return self.replicas[replica_id]

    def __len__(self) -> int:
        return len(self.replicas)

    def serving(self, tier: Optional[str] = None) -> List[Replica]:
        """Replicas currently accepting new work, in id order —
        optionally only those of one tier."""
        return [r for r in self.replicas.values()
                if r.state == SERVING
                and (tier is None or r.tier == tier)]

    def drain(self, replica_id: str, *, reason: str = "operator") -> None:
        self.replicas[replica_id].drain(reason=reason)

    def kill(self, replica_id: str) -> Replica:
        rep = self.replicas[replica_id]
        rep.kill()
        return rep

    def restart(self, replica_id: str, *,
                reason: str = "operator") -> Replica:
        return self.replicas[replica_id].restart(reason=reason)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-replica signal cards, keyed by replica id."""
        return {rid: rep.signals() for rid, rep in self.replicas.items()}

    def close(self) -> None:
        """Teardown for benches/tests: hard-stop every live replica."""
        for rep in self.replicas.values():
            if rep.state != DEAD:
                rep.kill()
