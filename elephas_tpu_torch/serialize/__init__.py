"""Model serialization (counterpart of ``elephas_tpu/serialize/``;
reference: ``elephas/utils/serialization.py``), and the Keras-3 bridge
(``keras_bridge.py``, torch backend), imported on use: it imports keras."""

from elephas_tpu_torch.serialize.serialization import (  # noqa: F401
    dict_to_model,
    model_to_dict,
)
