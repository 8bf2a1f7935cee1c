"""DenseNet-BC backbone producing a face embedding.

Counterpart of ``tf_face_toolbox_tpu/models/densenet.py``: pre-activation
dense layers (BN -> ReLU -> 1x1 to 4k, BN -> ReLU -> 3x3 to k, the k
new channels concatenated onto the stream), 1x1 transitions that halve
the channels followed by a 2x2/2 VALID average pool, a final BN and
ReLU, and the embedding head. Face stem: a bias-free 3x3 conv then a
3x3/2 SAME max pool (112 -> 56, the ResNet face stem's stage maps);
imagenet stem: a bias-free 7x7/2 conv then the same pool. ``quantized``
(JAX's modes, models/layers.ConvBN) applies to every dense-layer and
transition conv, on its post-activation input; the stem conv stays fp,
and the concatenated stream stays in the compute dtype (no carry).
DenseNet has no grouped conv, so "static_dense" is "static"; "qat"
trains fp, as JAX's DenseNet does.

Module names follow flax's auto-names in each scope (``Conv_0``,
``DenseLayer_<n>`` counted over the whole net, ``_BNReLUConv_<n>`` for
the transitions, ``BatchNorm_0``, ``EmbeddingHead_0``), so the JAX key
space maps onto ``state_dict`` (interop/port.py). Each ``torch.cat``
copies the whole stream so far; XLA keeps those concats as views.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tf_face_toolbox_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    EmbeddingHead,
    QuantConv,
    TrainContext,
    check_quant_mode,
    conv_weight,
    max_pool_same_nhwc,
)


class _BNReLUConv(QuantConv):
    """Pre-activation BN -> ReLU -> bias-free SAME conv; the kernel is the
    module's own ``weight`` (JAX key ``.../_BNReLUConv_i/kernel``), in
    ``quantized``'s mode ("qat" runs fp, as JAX's module does)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32,
                 quantized: bool | str = False):
        super().__init__()
        self.dtype = dtype
        self.BatchNorm_0 = BatchNorm(in_features)
        self.weight = conv_weight(in_features, features, kernel_size)
        self._init_quant(quantized, 1)
        if self.mode == "qat":
            self.mode = False

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        x = torch.relu(self.BatchNorm_0(x, self.dtype, train))
        return self.quant_conv(x, 1, 1, self.dtype, train)


class DenseLayer(nn.Module):
    """Bottlenecked dense layer: BN-ReLU-1x1(4k) -> BN-ReLU-3x3(k), then
    the k new channels after the input's."""

    def __init__(self, in_features: int, growth_rate: int,
                 dtype: torch.dtype = torch.float32,
                 quantized: bool | str = False):
        super().__init__()
        self.add_module("_BNReLUConv_0", _BNReLUConv(
            in_features, 4 * growth_rate, 1, dtype, quantized))
        self.add_module("_BNReLUConv_1", _BNReLUConv(
            4 * growth_rate, growth_rate, 3, dtype, quantized))

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        y = getattr(self, "_BNReLUConv_0")(x, train)
        y = getattr(self, "_BNReLUConv_1")(y, train)
        return torch.cat([x, y], dim=-1)


class DenseNet(nn.Module):
    """DenseNet-BC: (N, H, W, 3) standardized pixels -> (N, D) f32.

    ``input_size`` sizes the flatten head's Dense (flax infers it at
    init); the gap head does not use it.
    """

    def __init__(self, stage_sizes: Sequence[int] = (6, 12, 24, 16),
                 growth_rate: int = 32, compression: float = 0.5,
                 embedding_dim: int = 512, stem: str = "face",
                 head_variant: str = "gap", dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 quantized: bool | str = False, input_size: int = 112):
        super().__init__()
        check_quant_mode(quantized)
        if stem not in ("face", "imagenet"):
            raise ValueError(f"unknown stem: {stem}")
        self.stage_sizes = tuple(stage_sizes)
        self.quantized = quantized
        self.stem = stem
        self.head_variant = head_variant
        self.dtype = dtype
        channels = 2 * growth_rate
        if stem == "face":
            self.Conv_0 = Conv(3, channels, 3, 1, dtype)
            size = -(-input_size // 2)               # max pool 3x3/s2
        else:
            self.Conv_0 = Conv(3, channels, 7, 2, dtype)
            size = -(-(-(-input_size // 2)) // 2)
        # per stage: its layers, then its transition (None after the last)
        self.stages: list[tuple[list[str], str | None]] = []
        layer = 0
        for stage_idx, num_layers in enumerate(self.stage_sizes):
            names = []
            for _ in range(num_layers):
                name = f"DenseLayer_{layer}"
                self.add_module(name, DenseLayer(channels, growth_rate,
                                                 dtype, quantized))
                names.append(name)
                channels += growth_rate
                layer += 1
            transition = None
            if stage_idx != len(self.stage_sizes) - 1:
                transition = f"_BNReLUConv_{stage_idx}"
                out = int(channels * compression)
                self.add_module(transition,
                                _BNReLUConv(channels, out, 1, dtype,
                                            quantized))
                channels = out
                size //= 2                           # avg pool 2x2/2 VALID
            self.stages.append((names, transition))
        self.BatchNorm_0 = BatchNorm(channels)
        self.EmbeddingHead_0 = EmbeddingHead(
            channels, embedding_dim, head_variant, spatial=(size, size),
            dtype=dtype, dropout_rate=dropout_rate)

    def forward(self, images: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        x = self.Conv_0(images)
        x = max_pool_same_nhwc(x, 3, 2)
        for names, transition in self.stages:
            for name in names:
                x = getattr(self, name)(x, train)
            if transition is not None:
                x = getattr(self, transition)(x, train)
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2)
                x = x.permute(0, 2, 3, 1).contiguous()
        x = torch.relu(self.BatchNorm_0(x, self.dtype, train))
        return self.EmbeddingHead_0(x, train)
