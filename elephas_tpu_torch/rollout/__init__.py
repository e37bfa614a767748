"""Live model delivery: PS-subscribed serving weights with goodput-gated
canary promotion (counterpart of ``elephas_tpu/rollout``).

Three layers close the training→serving loop:

- ``WeightSubscriber`` (``subscriber.py``) — per-engine delivery: pulls
  TARGET weights version-gated from a ``ShardedParameterClient`` at
  decode-step boundaries (the engine's ``_on_step_boundary`` hook runs
  it under the step lock, so a swap can never land mid-speculative-
  verify), carries the PS version as ``engine.model_version``, and
  degrades to serving the current weights on any pull failure — weight
  delivery is never a liveness dependency.
- ``RolloutController`` (``controller.py``) — fleet policy: new PS
  versions reach ONE canary replica first (in-place swap, no restart),
  the goodput/burn ledgers judge canary-vs-fleet over a bake window,
  and the verdict either ripples the pin tier-aware through the rest of
  the fleet (prefill before decode) or rolls the canary back to the
  pinned prior version. Every transition is an event in a replay-stable
  digest and a flight note on the incident timeline.
- The version-pinning plane lives with the PS itself
  (``parameter.client.get_parameters_pinned`` /
  ``ShardedParameterClient.pull(version=)``, served from the live
  buffer or the WAL history) so rollback and A/B reads never race
  ongoing training pushes.
"""

from elephas_tpu_torch.rollout.controller import RolloutController, goodput_judge
from elephas_tpu_torch.rollout.subscriber import WeightSubscriber

__all__ = [
    "RolloutController",
    "WeightSubscriber",
    "goodput_judge",
]
