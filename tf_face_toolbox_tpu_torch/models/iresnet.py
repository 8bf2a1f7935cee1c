"""iResNet backbones: the BasicBlock + PReLU family of InsightFace's
arcface_torch, which most published face checkpoints use.

Counterpart of ``tf_face_toolbox_tpu/models/iresnet.py``:

- BN-first blocks: BN -> 3x3 conv -> BN -> PReLU -> 3x3 conv (the
  stride on this second conv) -> BN, a residual add and no activation
  after it; the downsample is a 1x1 conv plus BN;
- per-channel PReLU, ``where(x >= 0, x, alpha * x)`` with an f32 alpha
  cast to the compute dtype;
- a 3x3/s1 stem, every stage at stride 2 (112 -> 7 with four stages);
- the "E" head: BN -> dropout -> flatten (NHWC order, so the JAX ``fc``
  kernel needs no permute) -> an f32 ``fc`` -> an f32 BN ``features``.

The convs pad explicitly (``padding=1``), as the JAX module does, which
is torch's padding. Module names are the flax names (``conv1``,
``layer2_0``, ``prelu``, ``features``) so the JAX ``.npz`` key space
maps onto ``state_dict`` (interop/port.py; ``prelu/alpha`` is a plain
leaf). The stem, head and int8 pins refuse with JAX's messages.
Imported InsightFace checkpoints expect ``--input_norm fixed``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tf_face_toolbox_tpu_torch.models.layers import (
    BatchNorm,
    TrainContext,
    conv_weight,
    dropout,
)


class PReLU(nn.Module):
    """Per-channel PReLU: ``where(x >= 0, x, alpha.to(x.dtype) * x)``,
    alpha f32 (0.25 at init)."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class PlainConv(nn.Module):
    """Bias-free conv with explicit symmetric ``padding`` (flax
    ``nn.Conv(..., padding=p, use_bias=False)``; a 1x1 at SAME pads
    nothing), NHWC in and out, in the compute dtype; ``groups`` as
    ``feature_group_count`` (``groups == features``: depthwise). The
    kernel is the module's ``weight``, JAX key ``.../kernel``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = strides
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = conv_weight(in_features, features, kernel_size, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), stride=self.strides,
                     padding=self.padding, groups=self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class IBasicBlock(nn.Module):
    """BN-first basic block with PReLU and the stride on the second conv."""

    branch_end = "bn3"      # the residual branch's last BN

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn1 = BatchNorm(in_features)
        self.conv1 = PlainConv(in_features, features, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.prelu = PReLU(features)
        self.conv2 = PlainConv(features, features, 3, strides, 1,
                               dtype=dtype)
        self.bn3 = BatchNorm(features)
        if strides != 1 or in_features != features:
            self.downsample_conv = PlainConv(in_features, features, 1,
                                             strides, dtype=dtype)
            self.downsample_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        dt = self.dtype
        y = self.bn1(x, dt, train)
        y = self.bn2(self.conv1(y), dt, train)
        y = self.prelu(y)
        y = self.bn3(self.conv2(y), dt, train)
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(self.downsample_conv(x), dt, train)
        else:
            identity = x
        return y + identity          # no activation after the add


def _half(size: int, strides: int) -> int:
    """A 3x3 conv's output size at padding 1: ceil(size / strides)."""
    return -(-size // strides)


class IResNet(nn.Module):
    """iresnet-18/50/100: (N, H, W, 3) fixed-normalized pixels -> (N, D)
    f32. ``input_size`` sizes the flatten head's ``fc`` (flax infers it
    at init)."""

    # flax's default kernel init: variance_scaling(1, fan_in, truncated)
    CONV_INIT = (1.0, "fan_in")

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 14, 3),
                 stage_widths: Sequence[int] = (64, 128, 256, 512),
                 embedding_dim: int = 512, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, stem: str = "face",
                 head_variant: str = "flatten",
                 quantized: bool | str = False, input_size: int = 112):
        super().__init__()
        if stem != "face":
            raise ValueError("iresnet is structurally a 3x3/s1 face-stem "
                             f"net; got stem={stem!r}")
        if head_variant != "flatten":
            raise ValueError("iresnet's head is structurally the "
                             "flatten 'E' head; got head_variant="
                             f"{head_variant!r}")
        if quantized:
            raise ValueError(
                "int8 serving is not supported for iresnet (the static-"
                "int8 residual carry covers the ConvBN block library "
                "only); serve fp — bf16 compute is the fast path")
        self.stage_sizes = tuple(stage_sizes)
        self.stem = stem
        self.head_variant = head_variant
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        widths = tuple(stage_widths)
        self.conv1 = PlainConv(3, widths[0], 3, 1, 1, dtype=dtype)
        self.bn1 = BatchNorm(widths[0])
        self.prelu = PReLU(widths[0])
        self.block_names: list[str] = []
        channels, size = widths[0], input_size
        for stage_idx, num_blocks in enumerate(self.stage_sizes):
            for block_idx in range(num_blocks):
                strides = 2 if block_idx == 0 else 1
                name = f"layer{stage_idx + 1}_{block_idx}"
                self.add_module(name, IBasicBlock(
                    channels, widths[stage_idx], strides, dtype))
                self.block_names.append(name)
                channels = widths[stage_idx]
                size = _half(size, strides)
        self.bn2 = BatchNorm(channels)
        self.fc = nn.Linear(channels * size * size, embedding_dim)
        self.features = BatchNorm(embedding_dim)

    def forward(self, images: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        dt = self.dtype
        x = self.prelu(self.bn1(self.conv1(images), dt, train))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = self.bn2(x, dt, train)
        x = x.reshape(x.shape[0], -1)             # NHWC flatten
        if train is not None and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, train.generator)
        # fc and the final BN in f32 under any compute dtype
        x = F.linear(x.to(torch.float32), self.fc.weight, self.fc.bias)
        return self.features(x, torch.float32, train)
