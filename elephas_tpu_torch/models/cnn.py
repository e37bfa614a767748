"""Small convnet (counterpart of ``elephas_tpu/models/cnn.py``; BASELINE
config 2: the MNIST CNN trained by Downpour SGD in asynchronous mode).

Conv-pool stages (3x3 convs with bias, ``padding="SAME"``, ReLU, 2x2 max
pool), then a ReLU dense layer and the logits. Images come in NHWC, as in
the JAX package; the convs run on the NCHW view of that memory
(``torch.channels_last``). The flatten before the dense layer takes the
feature map in (H, W, C) order, as flax flattens NHWC, so the dense
kernel's rows are the flax kernel's rows (``convert.py`` only transposes
it). The first conv and the first dense layer infer their input widths
at the first call, as flax's do.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from elephas_tpu_torch.models import register_model
from elephas_tpu_torch.models.mlp import dropout
from elephas_tpu_torch.utils.device import resolve_device


class SimpleCNN(nn.Module):
    """Conv-pool stack + dense head; NHWC inputs; logits out.
    ``dropout_generator`` (a ``torch.Generator`` on the module's device,
    or None for torch's default one) draws the dropout masks."""

    def __init__(self, channels: Sequence[int] = (32, 64), dense_width=128, num_classes=10,
                 dropout_rate=0.0, device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.LazyConv2d(ch, 3, padding=1, device=device) if i == 0
            else nn.Conv2d(channels[i - 1], ch, 3, padding=1, device=device)
            for i, ch in enumerate(channels)
        )
        self.dense = nn.LazyLinear(dense_width, device=device)
        self.out = nn.Linear(dense_width, num_classes, device=device)
        self.dropout_rate = dropout_rate
        self.dropout_generator = None

    def forward(self, x, train: bool = False):
        x = x.float().permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        for conv in self.convs:
            x = F.max_pool2d(F.relu(conv(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (H, W, C) order
        x = F.relu(self.dense(x))
        x = dropout(x, self.dropout_rate, self.training, self.dropout_generator)
        return self.out(x)


@register_model("cnn")
def build_cnn(channels=(32, 64), dense_width=128, num_classes=10, dropout_rate=0.0,
              device=None):
    return SimpleCNN(channels=tuple(channels), dense_width=dense_width,
                     num_classes=num_classes, dropout_rate=dropout_rate,
                     device=resolve_device(device))
