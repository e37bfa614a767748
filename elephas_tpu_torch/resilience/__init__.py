"""Resilience layer (counterpart of ``elephas_tpu/resilience``).

- ``liveness`` — the server-side ``FailureDetector`` every parameter
  server builds, and the trainer-side ``MembershipView``;
- ``faults``   — ``FaultPlan``/``FaultInjector``: seeded, step-indexed
  drops, delays and duplicates of wire frames (``utils.sockets``'s
  injector hook) and kills or stalls of worker threads, so chaos replays;
- ``elastic``  — ``UnitLedger`` + ``ElasticWorkerPool``: dead workers'
  units re-queued to survivors, late joiners admitted, accounting exact
  under any interleaving. The elastic tuner (``tune/``) runs on it.

Not ported yet (ROADMAP.md queue 1, item 4): the snapshot WAL
(``wal.py``) and ``AsyncTrainer``'s elastic wiring (``elastic=True``,
``fault_plan``, ``batches_per_unit``).
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
