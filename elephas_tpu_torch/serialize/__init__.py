"""Model serialization (counterpart of ``elephas_tpu/serialize/``;
reference: ``elephas/utils/serialization.py``). The Keras bridge
(``keras_bridge.py``) is not ported (ROADMAP.md, queue 1, item 3)."""

from elephas_tpu_torch.serialize.serialization import (  # noqa: F401
    dict_to_model,
    model_to_dict,
)
