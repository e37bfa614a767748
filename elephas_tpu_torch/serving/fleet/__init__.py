"""Replicated serving fleet: N ``InferenceEngine`` replicas behind a
signal-driven router that *actuates* (counterpart of
``elephas_tpu/serving/fleet``).

Load scores, goodput burn, latched alerts, blackbox canaries and fleet
federation each observe one engine; this package is where those signals
steer traffic:

- ``Replica``       — one engine plus the process-like trimmings the
                      fleet needs: a serve thread, a lifecycle
                      (serving → draining → dead), an optional ops
                      endpoint the ``FleetAggregator`` polls, a
                      blackbox ``CanaryDriver``, and a per-replica
                      latched burn-alert view (``serving.fleet.replica``),
- ``ReplicaSet``    — the roster: spawn / drain / kill / restart by id,
                      each boot numbered so a restart is visibly the
                      same slot coming back different
                      (``serving.fleet.replica_set``),
- ``Router``        — the client-facing submit/result surface (the
                      scheduler/engine seam from the serving PR, one
                      level up: router fronts engines the way the
                      scheduler fronts slots). Dispatch is ranked by
                      per-replica ``serving_load_score``, queue
                      pressure, and goodput burn; session-affinity
                      keeps follow-up turns on the replica holding the
                      KV state (explicit ``affinity_miss_total`` when
                      it can't); ``tick()`` sheds latched-burn
                      replicas, drain-and-restarts canary-flagged
                      ones, requeues in-flight work off dead replicas,
                      and actuates the autoscaler
                      (``serving.fleet.router``),
- ``FleetAutoscaler`` — replica-count decisions from the multi-window
                      burn rate: hysteresis dead band, consecutive-
                      observation streaks, cooldown, every decision a
                      ``fleet_scale`` flight event and a
                      ``fleet_scale_events_total{direction=}`` tick
                      (``serving.fleet.autoscaler``).

Proof obligations carried by ``tests/test_torch_fleet_*.py`` and
``chip_smoke.py``'s fleet phase: a
single-replica routed fleet is token-identical to a bare engine; a
replica killed mid-traffic costs a bounded (canary-observed) blackbox
outage and a bounded real-goodput dip while every in-flight request
completes via requeue; the autoscaler's decision sequence under a
seeded burst replays exactly.
"""

from elephas_tpu_torch.serving.fleet.autoscaler import FleetAutoscaler  # noqa: F401
from elephas_tpu_torch.serving.fleet.qos import (  # noqa: F401
    AdmissionThrottled,
    QoSPolicy,
    TokenBucket,
)
from elephas_tpu_torch.serving.fleet.replica import (  # noqa: F401
    DEAD,
    DRAINING,
    LIFECYCLES,
    TIERS,
    Replica,
    ReplicaDead,
    SERVING,
)
from elephas_tpu_torch.serving.fleet.replica_set import ReplicaSet  # noqa: F401
from elephas_tpu_torch.serving.fleet.router import (  # noqa: F401
    FleetUnavailable,
    Router,
)
