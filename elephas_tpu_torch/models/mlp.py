"""MLP classifier (counterpart of ``elephas_tpu/models/mlp.py``).

A Dense stack with ReLU and optional dropout, logits out (the losses
take logits). The first layer infers its input width at the first call,
as flax's ``nn.Dense`` does (``nn.LazyLinear``); ``CompiledModel``'s
``input_shape`` or a ``state_dict`` fixes it. Dropout draws from torch's
generators, not JAX's keys, so a model with ``dropout_rate > 0`` trains
like the JAX one only in distribution; ``dropout_generator`` (the async
trainer gives each worker its own) draws the masks where it is set.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from elephas_tpu_torch.models import register_model
from elephas_tpu_torch.utils.device import resolve_device


def dropout(x, rate: float, training: bool, generator=None):
    """Inverted dropout; masks from ``generator`` where one is given
    (``F.dropout`` takes none), else from torch's default generator."""
    if rate <= 0 or not training:
        return x
    if generator is None:
        return F.dropout(x, rate, training=True)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep / (1.0 - rate)


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
        self.dropout_generator = None

    def forward(self, x, train: bool = False):
        x = x.reshape(x.shape[0], -1).float()
        for layer in self.hidden:
            x = dropout(F.relu(layer(x)), self.dropout_rate, self.training,
                        self.dropout_generator)
        return self.out(x)


@register_model("mlp")
def build_mlp(features=(128, 128), num_classes=10, dropout_rate=0.0, device=None):
    return MLP(features=tuple(features), num_classes=num_classes, dropout_rate=dropout_rate,
               device=resolve_device(device))
