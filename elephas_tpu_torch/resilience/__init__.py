"""Resilience layer (counterpart of ``elephas_tpu/resilience``).

- ``liveness`` — the server-side ``FailureDetector`` every parameter
  server builds, and the trainer-side ``MembershipView``;
- ``faults``   — ``FaultPlan``/``FaultInjector``: seeded, step-indexed
  drops, delays and duplicates of wire frames (``utils.sockets``'s
  injector hook) and kills or stalls of worker threads, so chaos replays;
- ``elastic``  — ``UnitLedger`` + ``ElasticWorkerPool``: dead workers'
  units re-queued to survivors, late joiners admitted, accounting exact
  under any interleaving. The elastic tuner (``tune/``) and
  ``AsyncTrainer(elastic=True)`` run on it;
- ``wal``      — ``SnapshotWAL``/``WalWriter``: write-ahead
  version-tagged snapshots of the ``ParameterBuffer`` in the packed wire
  format; a restarted PS warm-restarts from the last durable version.

Entry point for training: ``AsyncTrainer(..., elastic=True,
fault_plan=..., ps_wal_dir=...)`` (``engine.async_engine``).
"""

from elephas_tpu_torch.resilience.elastic import (  # noqa: F401
    ElasticWorkerPool,
    UnitLedger,
)
from elephas_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    InjectedWorkerDeath,
    install,
)
from elephas_tpu_torch.resilience.liveness import (  # noqa: F401
    ALIVE,
    DEAD,
    SUSPECT,
    FailureDetector,
    MembershipView,
)
from elephas_tpu_torch.resilience.wal import SnapshotWAL, WalWriter  # noqa: F401
