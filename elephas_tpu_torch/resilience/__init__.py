"""Resilience layer (counterpart of ``elephas_tpu/resilience``).

Ported: ``liveness.FailureDetector``, which every parameter server
builds. The elastic pool, fault plans, the snapshot WAL and the
trainer-side ``MembershipView`` arrive with ROADMAP.md queue 1, item 4.
"""

from elephas_tpu_torch.resilience.liveness import (  # noqa: F401
    ALIVE,
    DEAD,
    SUSPECT,
    FailureDetector,
)
