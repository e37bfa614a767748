"""ResNet-18 (counterpart of ``elephas_tpu/models/resnet.py``).

The public layout is the JAX package's and Keras': images come in NHWC,
``(N, H, W, C)``. The module views them as NCHW, which leaves them in
``torch.channels_last`` memory, and every conv, norm and add keeps that
format, as cuDNN runs it fastest.

Numerics follow the flax model:

- ``padding="SAME"`` pads each side as flax does: total padding
  ``max((ceil(n / s) - 1)·s + k - n, 0)``, the smaller half before. On an
  even input a 3x3 stride-2 conv pads (0, 1), not torch's (1, 1); a 1x1
  stride-2 shortcut pads nothing.
- BatchNorm: flax's ``momentum=0.9`` is torch's 0.1, epsilon 1e-5. The
  batch statistics are taken in float32 and the running variance keeps
  the *biased* batch variance, as flax's does (torch's keeps the
  unbiased one), so the running-stat update is this module's own.
- ``dtype="bfloat16"`` runs the convs in bf16 on float32 parameters; the
  norms normalise in float32 and output ``norm_dtype``; the mean pool and
  the head run in float32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from elephas_tpu_torch.models import register_model
from elephas_tpu_torch.utils.device import resolve_device

_MOMENTUM = 0.9  # flax's: running = 0.9 * running + 0.1 * batch
_EPS = 1e-5


def same_padding(size: int, kernel: int, stride: int):
    """Flax/XLA ``padding="SAME"`` of one spatial axis: ``(before, after)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _to_dtype(name):
    return getattr(torch, name) if isinstance(name, str) else name


class Conv(nn.Module):
    """A bias-free flax ``nn.Conv`` computing in ``dtype`` on float32
    weights, with ``padding="SAME"`` or explicit ``((top, bottom), (left,
    right))`` padding. The first conv of a model infers its input
    channels, as flax does (``nn.LazyConv2d``)."""

    def __init__(self, out_channels, kernel, stride=1, padding="SAME", dtype=torch.float32,
                 in_channels=None, device=None):
        super().__init__()
        if in_channels is None:
            self.conv = nn.LazyConv2d(out_channels, kernel, stride, bias=False, device=device)
        else:
            self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride, bias=False,
                                  device=device)
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype

    def forward(self, x):
        if self.padding == "SAME":
            (top, bottom), (left, right) = (same_padding(n, self.kernel, self.stride)
                                            for n in x.shape[2:])
        else:
            (top, bottom), (left, right) = self.padding
        pad, stride = 0, self.stride
        if self.kernel == 1 and stride > 1 and x.device.type == "cpu":
            # A 1x1 conv of stride s reads every s-th pixel: taking them
            # first gives the same products and keeps PyTorch's CPU build
            # off its strided 1x1 backward, which corrupts memory at some
            # channels_last shapes. On the card the conv strides itself.
            x, stride = x[:, :, ::stride, ::stride], 1
        if (top, left) == (bottom, right):
            pad = (top, left)  # symmetric: the conv pads without a copy
        else:
            x = F.pad(x, (left, right, top, bottom))
        if nn.parameter.is_lazy(self.conv.weight):
            self.conv.initialize_parameters(x)
        weight = self.conv.weight.to(self.dtype, memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), weight, None, stride, pad)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` (momentum 0.9, epsilon 1e-5) over NCHW.

    Training normalises with the batch statistics in float32 and moves
    the running statistics by 0.1 of the batch mean and *biased*
    variance; evaluation normalises with the running statistics. The
    output is in ``norm_dtype``. The state_dict is ``BatchNorm2d``'s."""

    def __init__(self, channels, norm_dtype=torch.float32, device=None):
        super().__init__(channels, eps=_EPS, momentum=1 - _MOMENTUM, device=device)
        self.norm_dtype = norm_dtype

    def forward(self, x):
        # Normalise in float32 at least; cuDNN takes bf16 x with float32
        # weight and statistics and computes in float32.
        x = x.to(torch.promote_types(x.dtype, self.norm_dtype))
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps).to(self.norm_dtype)
        # momentum 1 makes torch's update hand back the batch mean and the
        # unbiased batch variance; flax's update takes the biased one.
        mean, var = torch.zeros_like(self.running_mean), torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(_MOMENTUM).add_(mean, alpha=1 - _MOMENTUM)
            self.running_var.mul_(_MOMENTUM).add_(var, alpha=(1 - _MOMENTUM) * (n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y.to(self.norm_dtype)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels, channels, strides=1, dtype=torch.float32,
                 norm_dtype=torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv(channels, 3, strides, dtype=dtype, in_channels=in_channels,
                          device=device)
        self.norm1 = BatchNorm(channels, norm_dtype, device=device)
        self.conv2 = Conv(channels, 3, dtype=dtype, in_channels=channels, device=device)
        self.norm2 = BatchNorm(channels, norm_dtype, device=device)
        # flax adds the projection where the residual's shape differs.
        self.shortcut = self.shortcut_norm = None
        if strides != 1 or in_channels != channels:
            self.shortcut = Conv(channels, 1, strides, dtype=dtype, in_channels=in_channels,
                                 device=device)
            self.shortcut_norm = BatchNorm(channels, norm_dtype, device=device)

    def forward(self, x):
        residual = x
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.shortcut is not None:
            residual = self.shortcut_norm(self.shortcut(residual))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet over NHWC images; logits (N, num_classes) in float32.

    The CIFAR stem is one 3x3 conv; ``imagenet_stem=True`` takes a 7x7
    stride-2 conv padded 3 on each side, then a 3x3 stride-2 max pool
    with SAME padding."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2), num_classes=10, width=64,
                 dtype=torch.float32, norm_dtype=torch.float32, imagenet_stem=False,
                 device=None):
        super().__init__()
        self.dtype, self.imagenet_stem = dtype, imagenet_stem
        if imagenet_stem:
            self.stem = Conv(width, 7, 2, padding=((3, 3), (3, 3)), dtype=dtype, device=device)
        else:
            self.stem = Conv(width, 3, dtype=dtype, device=device)
        self.stem_norm = BatchNorm(width, norm_dtype, device=device)
        blocks, channels = [], width
        for stage, num_blocks in enumerate(stage_sizes):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(ResidualBlock(channels, width * 2**stage, strides, dtype,
                                            norm_dtype, device=device))
                channels = width * 2**stage
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(channels, num_classes, device=device)

    def forward(self, x, train: bool = False):
        """``x``: (N, H, W, C) images. ``train`` is the flax flag; the
        norms follow ``self.training`` (``CompiledModel`` sets both)."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        x = F.relu(self.stem_norm(self.stem(x.to(self.dtype))))
        if self.imagenet_stem:
            (top, bottom), (left, right) = (same_padding(n, 3, 2) for n in x.shape[2:])
            x = F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-math.inf), 3, 2)
        for block in self.blocks:
            x = block(x)
        # The pool and the head in the head's float32 (float64 in a model
        # made double for a reference run).
        return self.head(x.to(self.head.weight.dtype).mean(dim=(2, 3)))


def ResNet18(num_classes: int = 10, width: int = 64, dtype=torch.float32,  # noqa: N802
             norm_dtype=None, imagenet_stem=False, device=None):
    return ResNet(
        stage_sizes=(2, 2, 2, 2),
        num_classes=num_classes,
        width=width,
        dtype=dtype,
        norm_dtype=dtype if norm_dtype is None else norm_dtype,
        imagenet_stem=imagenet_stem,
        device=device,
    )


@register_model("resnet18")
def build_resnet18(num_classes=10, width=64, dtype="float32", norm_dtype=None,
                   imagenet_stem=False, device=None):
    return ResNet18(
        num_classes=num_classes,
        width=width,
        dtype=_to_dtype(dtype),
        norm_dtype=None if norm_dtype is None else _to_dtype(norm_dtype),
        imagenet_stem=imagenet_stem,
        device=resolve_device(device),
    )
