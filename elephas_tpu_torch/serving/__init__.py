"""Online inference over the KV-cache decode path (counterpart of
``elephas_tpu/serving``).

- ``KVCachePool``      — a fixed-shape slot pool of per-layer KV caches
                         (``serving.kv_pool``), the oracle layout;
- ``PagedKVPool``      — its block/paged successor (the default):
                         reference-counted fixed-size KV blocks behind a
                         ``BlockTable``, a ``PrefixCache`` that admits
                         resident prompt prefixes by refcount instead of
                         re-prefilling, LRU prefix eviction under
                         pressure, copy-on-write at shared boundaries;
- ``ContinuousBatchingScheduler`` — bounded request queue, chunked
                         prefill/decode interleaving, deadline eviction,
                         backpressure, one-step-lookahead pipelining
                         (``serving.scheduler``);
- ``InferenceEngine``  — the frontend: ``submit()`` / ``result()`` /
                         ``serve_forever()``; on the GPU its paged decode
                         step is one captured CUDA graph
                         (``serving.engine``); ``shard_serving`` makes it
                         tensor-parallel over a model axis (rank 0
                         serves, the other ranks ``follow()``);
- ``ServingMetrics``   — TTFT / inter-token latency / queue depth /
                         tokens-per-sec / dispatch→fetch overlap through
                         ``metrics.logging.JsonlSink``
                         (``serving.metrics``);
- ``SpeculativeDecoder`` — draft-and-verify decode over the paged pool:
                         a ``DraftSource`` (shallow-stack self-draft or a
                         ``DraftModelSource`` pulled from a parameter
                         client) proposes gamma tokens, one target forward
                         verifies them, the plain stream by construction
                         (``serving.spec``); ``InferenceEngine(...,
                         speculative=True)`` drives it;
- ``serving.handoff``  — the KV-block handoff frame of disaggregated
                         serving (``submit_prefill``/``handoff`` on a
                         prefill engine, ``submit_handoff`` on a decode
                         engine);
- ``fleet``            — the replicated layer above the engine: a
                         ``ReplicaSet`` of N engine replicas with
                         process-like lifecycles behind a signal-driven
                         session-affinity ``Router`` that sheds, requeues,
                         drain-and-restarts canary-flagged replicas,
                         routes prefill and decode tiers and actuates a
                         burn-driven ``FleetAutoscaler``
                         (``serving.fleet``);
- ``host_sync``        — the ONE sanctioned device→host sync point.
"""

from elephas_tpu_torch.serving import host_sync  # noqa: F401
from elephas_tpu_torch.serving.kv_pool import (  # noqa: F401
    BlockTable,
    DonatedBufferError,
    KVCachePool,
    PagedKVPool,
    PrefixCache,
)
from elephas_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    GenerationResult,
    QueueFull,
    Request,
    RequestQueue,
)
from elephas_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine,
    shard_serving,
)
from elephas_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from elephas_tpu_torch.serving.spec import (  # noqa: F401
    DraftModelSource,
    DraftSource,
    SelfDraftSource,
    SpeculativeDecoder,
)
from elephas_tpu_torch.serving.fleet import (  # noqa: F401
    FleetAutoscaler,
    FleetUnavailable,
    Replica,
    ReplicaDead,
    ReplicaSet,
    Router,
)
