"""MLP classifiers (counterpart of ``elephas_tpu/models/mlp.py``):
``MLP`` (``mlp``) and the width-bucketed ``MaskedMLP`` (``mlp_masked``)
the hyperparameter search trains.

A Dense stack with ReLU and optional dropout, logits out (the losses
take logits). The first layer infers its input width at the first call,
as flax's ``nn.Dense`` does (``nn.LazyLinear``); ``CompiledModel``'s
``input_shape`` or a ``state_dict`` fixes it. Dropout draws from torch's
generators, not JAX's keys, so a model with ``dropout_rate > 0`` trains
like the JAX one only in distribution; ``dropout_generator`` (the async
trainer gives each worker its own) draws the masks where it is set.

Under tensor parallelism (``parallel.tensor_parallel``, a user's rule
table) the sharded layers place their own collectives, and a hidden
layer's activations are this rank's units between a column-parallel
layer and a row-parallel one: its mask is sharded with them.
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


def lecun_normal_(weight: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: a normal truncated at two standard
    deviations, rescaled so that its variance is ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


class MaskedMLP(MLP):
    """Width-bucketed MLP (counterpart of the JAX package's ``MaskedMLP``):
    layers are built at the ``features`` (bucket) widths, and only the
    first ``active[i]`` units of hidden layer ``i`` are live.

    Each hidden layer's 0/1 mask is a buffer, ``mask_{i}`` (flax's
    ``batch_stats/mask_{i}``): it is no parameter, so no optimizer sees
    it, and the trainers carry it as they carry BatchNorm statistics
    (synchronous averaging of equal masks, asynchronous deltas of zero
    leave it exact). ``relu(x) * mask`` zeroes the padded units forward,
    so they take no gradient and stay at their init: the network is the
    ``active``-width one at the bucket's cost. Keeping the width out of
    the shapes is what lets one captured step serve every width of a
    bucket (the JAX package shares one XLA executable across them).

    Init matches flax's in distribution: a layer fed by a masked layer
    draws ``lecun_normal`` at the live fan-in (``live_fan_in``), i.e. the
    bucket fan-in scaled by ``sqrt(bucket / active)``, with a zero bias.
    The first layer is lazy; ``CompiledModel``'s seeded init draws it at
    its true fan-in and reads ``live_fan_in`` for the others.
    """

    def __init__(self, features: Sequence[int] = (128,), active=None, num_classes=10,
                 dropout_rate=0.0, device=None):
        features = tuple(int(w) for w in features)
        active = features if active is None else tuple(int(w) for w in active)
        if len(active) != len(features):
            raise ValueError(f"active widths {active} must match bucket layout "
                             f"{features} layer-for-layer")
        for i, (bucket, live) in enumerate(zip(features, active)):
            if not 0 < live <= bucket:
                raise ValueError(f"layer {i}: active width {live} outside (0, {bucket}]")
        super().__init__(features, num_classes, dropout_rate, device)
        self.features, self.active = features, active
        for i, (bucket, live) in enumerate(zip(features, active)):
            self.register_buffer(f"mask_{i}",
                                 (torch.arange(bucket, device=device) < live).float())
        fed = [*list(self.hidden)[1:], self.out] if features else []
        for layer, live in zip(fed, active):
            layer.live_fan_in = live
            lecun_normal_(layer.weight, live)
        for layer in [*self.hidden, self.out]:
            if not isinstance(layer, nn.LazyLinear):
                nn.init.zeros_(layer.bias)

    def forward(self, x, train: bool = False):
        x = x.reshape(x.shape[0], -1).float()
        for i, layer in enumerate(self.hidden):
            x = F.relu(layer(x)) * self.get_buffer(f"mask_{i}")
            x = dropout(x, self.dropout_rate, self.training, self.dropout_generator)
        return self.out(x)


@register_model("mlp_masked")
def build_masked_mlp(features=(128,), active=None, num_classes=10, dropout_rate=0.0,
                     device=None):
    return MaskedMLP(features=tuple(features),
                     active=tuple(active) if active is not None else None,
                     num_classes=num_classes, dropout_rate=dropout_rate,
                     device=resolve_device(device))
