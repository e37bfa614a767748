"""MLP classifier (counterpart of ``elephas_tpu/models/mlp.py``).

A Dense stack with ReLU and optional dropout, logits out (the losses
take logits). The first layer infers its input width at the first call,
as flax's ``nn.Dense`` does (``nn.LazyLinear``); ``CompiledModel``'s
``input_shape`` or a ``state_dict`` fixes it. Dropout draws from torch's
generator, so a model with ``dropout_rate > 0`` trains like the JAX one
only in distribution.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from elephas_tpu_torch.models import register_model
from elephas_tpu_torch.utils.device import resolve_device


class MLP(nn.Module):
    def __init__(self, features: Sequence[int] = (128, 128), num_classes=10,
                 dropout_rate=0.0, device=None):
        super().__init__()
        widths = list(features)
        self.hidden = nn.ModuleList(
            nn.LazyLinear(w, device=device) if i == 0
            else nn.Linear(widths[i - 1], w, device=device)
            for i, w in enumerate(widths)
        )
        self.out = (nn.Linear(widths[-1], num_classes, device=device) if widths
                    else nn.LazyLinear(num_classes, device=device))
        self.dropout_rate = dropout_rate

    def forward(self, x, train: bool = False):
        x = x.reshape(x.shape[0], -1).float()
        for layer in self.hidden:
            x = F.relu(layer(x))
            if self.dropout_rate > 0:
                x = F.dropout(x, self.dropout_rate, training=self.training)
        return self.out(x)


@register_model("mlp")
def build_mlp(features=(128, 128), num_classes=10, dropout_rate=0.0, device=None):
    return MLP(features=tuple(features), num_classes=num_classes, dropout_rate=dropout_rate,
               device=resolve_device(device))
