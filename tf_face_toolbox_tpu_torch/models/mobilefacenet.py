"""MobileFaceNet (Chen et al. 2018): the lightweight face-embedding net.

Counterpart of ``tf_face_toolbox_tpu/models/mobilefacenet.py``:
inverted-residual bottlenecks (1x1 expand -> depthwise 3x3 -> linear 1x1
project, PReLU after the first two), a 3x3/s2 conv plus depthwise 3x3
stem, a 1x1 conv to the head width, and the GDConv head. NHWC, as the
rest of the port.

- The depthwise 3x3 is ``F.conv2d(groups=C)``; its HWIO (3, 3, 1, C)
  kernel is the port's (C, 1, 3, 3), as any grouped conv.
- GDConv is JAX's ``einsum("nhwc,hwc->nc")`` with an (h, w, c)
  parameter, summed in f32 and rounded once to the compute dtype. Its
  shape needs the final map's size when the module is built, so the net
  takes ``input_size``, as the flatten heads do.
- ``gdconv_bn`` runs in the compute dtype; ``linear`` (bias-free) and
  ``features`` in f32.
- The residual is added only at stride 1 with matching channels.

The stem, head and int8 pins refuse with JAX's messages.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tf_face_toolbox_tpu_torch.models.iresnet import PlainConv, PReLU
from tf_face_toolbox_tpu_torch.models.layers import (
    BatchNorm,
    TrainContext,
    dropout,
)

# (expansion t, channels c, repeats n, first-block stride s) per stage,
# the paper's table 1: 112 -> 56 (stem) -> 28 -> 14 -> 7
MOBILEFACENET_STAGES = (
    (2, 64, 5, 2),
    (4, 128, 1, 2),
    (2, 128, 6, 1),
    (4, 128, 1, 2),
    (2, 128, 2, 1),
)


class Bottleneck(nn.Module):
    """Inverted residual: 1x1 expand -> dw 3x3 -> 1x1 linear project."""

    def __init__(self, in_features: int, features: int, expansion: int,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_features * expansion
        self.dtype = dtype
        self.residual = strides == 1 and in_features == features
        # the residual branch's last BN (none without the residual)
        self.branch_end = "project_bn" if self.residual else None
        self.expand = PlainConv(in_features, mid, 1, dtype=dtype)
        self.expand_bn = BatchNorm(mid)
        self.expand_prelu = PReLU(mid)
        self.dw = PlainConv(mid, mid, 3, strides, 1, groups=mid, dtype=dtype)
        self.dw_bn = BatchNorm(mid)
        self.dw_prelu = PReLU(mid)
        self.project = PlainConv(mid, features, 1, dtype=dtype)
        self.project_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        dt = self.dtype
        y = self.expand_prelu(self.expand_bn(self.expand(x), dt, train))
        y = self.dw_prelu(self.dw_bn(self.dw(y), dt, train))
        y = self.project_bn(self.project(y), dt, train)
        return y + x if self.residual else y


def gdconv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Global depthwise conv of NHWC ``x`` with an (h, w, c) ``weight``:
    ``einsum("nhwc,hwc->nc")``, summed in f32, rounded to x's dtype."""
    return torch.einsum("nhwc,hwc->nc", x.to(torch.float32),
                        weight.to(x.dtype).to(torch.float32)).to(x.dtype)


class GDConvHead(nn.Module):
    """GDConv(h x w) -> BN -> dropout -> bias-free linear(D) -> BN."""

    def __init__(self, in_features: int, spatial: tuple[int, int],
                 embedding_dim: int, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = spatial
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        # flax's variance_scaling(2, fan_in, truncated normal): fan_in h*w
        self.gdconv = nn.Parameter(torch.randn(h, w, in_features)
                                   * math.sqrt(2.0 / (h * w)))
        self.gdconv_bn = BatchNorm(in_features)
        self.linear = nn.Linear(in_features, embedding_dim, bias=False)
        self.features = BatchNorm(embedding_dim)

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        x = self.gdconv_bn(gdconv(x, self.gdconv), self.dtype, train)
        if train is not None and self.dropout_rate > 0:
            x = dropout(x, self.dropout_rate, train.generator)
        # the projection and its BN in f32 under any compute dtype
        x = F.linear(x.to(torch.float32), self.linear.weight)
        return self.features(x, torch.float32, train)


class MobileFaceNet(nn.Module):
    """MobileFaceNet: (N, H, W, 3) pixels -> (N, D) f32.

    ``stages``: (expansion, channels, repeats, stride) entries;
    ``width_mult`` scales every channel count (max(8, round(c * m)));
    ``input_size`` sizes the GDConv parameter (H and W divisible by 16 at
    the published stages: 112 -> 7).
    """

    # flax's default kernel init: variance_scaling(1, fan_in, truncated)
    CONV_INIT = (1.0, "fan_in")

    def __init__(self, stages: Sequence[tuple[int, int, int, int]]
                 = MOBILEFACENET_STAGES, stem_width: int = 64,
                 head_width: int = 512, width_mult: float = 1.0,
                 embedding_dim: int = 512, dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, stem: str = "mobile",
                 head_variant: str = "gdconv",
                 quantized: bool | str = False, input_size: int = 112):
        super().__init__()
        if stem != "mobile":
            raise ValueError("mobilefacenet's stem is structurally the "
                             "paper's conv3x3/s2 + depthwise pair; got "
                             f"stem={stem!r}")
        if head_variant != "gdconv":
            raise ValueError("mobilefacenet's head is structurally "
                             "GDConv; got head_variant="
                             f"{head_variant!r}")
        if quantized:
            raise ValueError(
                "int8 serving is not supported for mobilefacenet (the "
                "static-int8 residual carry covers the ConvBN block "
                "library only); serve fp — at ~1M params the model is "
                "latency-bound, not compute-bound, so int8 buys little")
        self.stem = stem
        self.head_variant = head_variant
        self.dtype = dtype

        def w(c: int) -> int:
            return max(8, int(round(c * width_mult)))

        w0 = w(stem_width)
        self.conv1 = PlainConv(3, w0, 3, 2, 1, dtype=dtype)
        self.conv1_bn = BatchNorm(w0)
        self.conv1_prelu = PReLU(w0)
        self.dw1 = PlainConv(w0, w0, 3, 1, 1, groups=w0, dtype=dtype)
        self.dw1_bn = BatchNorm(w0)
        self.dw1_prelu = PReLU(w0)
        size = -(-input_size // 2)
        channels = w0
        self.block_names: list[str] = []
        for si, (t, c, n, s) in enumerate(stages):
            for bi in range(n):
                strides = s if bi == 0 else 1
                name = f"stage{si + 1}_{bi}"
                self.add_module(name, Bottleneck(channels, w(c), t, strides,
                                                 dtype))
                self.block_names.append(name)
                channels = w(c)
                size = -(-size // strides)
        wh = w(head_width)
        self.conv2 = PlainConv(channels, wh, 1, dtype=dtype)
        self.conv2_bn = BatchNorm(wh)
        self.conv2_prelu = PReLU(wh)
        self.head = GDConvHead(wh, (size, size), embedding_dim,
                               dropout_rate, dtype)

    def forward(self, images: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        dt = self.dtype
        x = self.conv1_prelu(self.conv1_bn(self.conv1(images), dt, train))
        x = self.dw1_prelu(self.dw1_bn(self.dw1(x), dt, train))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = self.conv2_prelu(self.conv2_bn(self.conv2(x), dt, train))
        return self.head(x, train)
