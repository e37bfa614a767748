"""Parameter exchange layer (counterpart of ``elephas_tpu/parameter``;
reference L2 — SURVEY.md §1).

Reference: ``elephas/parameter/{base,server,client}.py`` — a Flask HTTP or
raw-socket parameter server on the Spark driver, pickled weight lists over
the network, 2 network hops per worker per ``frequency`` unit.

The canonical store is a ``ParameterBuffer`` on the card (updates are
out-of-place subtracts there). Transports are pluggable on top:

- ``local``  — in-process buffer handle: a pull hands out device tensors,
- ``http``   — stdlib ThreadingHTTPServer speaking the reference's
  GET /parameters, POST /update protocol,
- ``socket`` — length-prefixed frames with the reference's
  ``'g'``/``'u'`` message kinds.

Wire payloads default to the packed zero-copy codec (``wire.py``),
byte-identical with the JAX package's, with magic-byte negotiation back
to pickle for legacy peers.

``group.py`` scales the wire transports horizontally: a deterministic
``ShardPlan`` partitions the tree across K servers, a
``ShardedParameterClient`` scatters and gathers concurrently, and a
WAL-streamed warm standby per shard turns a failover into a promotion
(``ShardGroup``).
"""

from elephas_tpu_torch.parameter import wire  # noqa: F401
from elephas_tpu_torch.parameter.base import (  # noqa: F401
    BaseParameterClient,
    BaseParameterServer,
)
from elephas_tpu_torch.parameter.buffer import ParameterBuffer  # noqa: F401
from elephas_tpu_torch.parameter.client import (  # noqa: F401
    HttpClient,
    LocalClient,
    ParameterServerUnavailable,
    SocketClient,
    StaleDeltaRejected,
    VersionUnavailable,
    make_client,
)
from elephas_tpu_torch.parameter.group import (  # noqa: F401
    FencedPrimaryError,
    GroupDirectory,
    ShardedParameterClient,
    ShardGroup,
    ShardGroupError,
    ShardMapMismatch,
    ShardPlan,
    WalStreamer,
)
from elephas_tpu_torch.parameter.server import (  # noqa: F401
    AdmissionPolicy,
    HttpServer,
    LocalServer,
    SocketServer,
    make_server,
)
