"""ResNet-family backbones: ResNet, SE-ResNet, ResNeXt (one module).

Counterpart of ``tf_face_toolbox_tpu/models/resnet.py``: bottleneck
blocks with a grouped 3x3 (``groups``, ResNeXt) and squeeze-excite
after the last 1x1 (``se_reduction``, SE-ResNet); face, imagenet,
space2depth and dct stems. The dct stem takes standardized pixels,
which it turns into 8x8 block coefficients (``ops/dct.block_dct``), or
coefficients (N, H/8, W/8, 192) from ``ops/dct.prepare_coefficients``;
a frequency BatchNorm, a 1x1 ConvBN to 4 * ``dct_stem_features`` and a
depth-to-space take them to (H/4, W/4, ``dct_stem_features``). Eval by
default; ``net(images, train=TrainContext(...))`` runs train mode
(models/layers.py).

``quantized`` (JAX's modes, models/layers.ConvBN) applies to every
bottleneck conv; the stems stay fp. In "static" and "static_dense" the
stream between blocks is the static-int8 residual carry: quantized once
at each block's input with the frozen scale ``block_<i>_in_max / 127``
(a buffer of the net, JAX key ``quant_stats/block_<i>_in_max``), and
the block's first conv, its projection and its dequantized skip all
read that one int8 tensor. "calibrate" records those maxima with the
convs'; "qat" fake-quantizes the stream in a train forward.

``remat`` (the JAX module's argument) recomputes each bottleneck block
in backward instead of keeping its activations: ``True`` keeps only the
block's input, ``"save_convs"`` also its conv outputs (the BatchNorms,
ReLUs and residual add are recomputed from them). It changes when work
is done, not what is computed, and no parameter or buffer name.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils import checkpoint

from tf_face_toolbox_tpu_torch.models.layers import (
    CALIBRATED,
    BatchNorm,
    ConvBN,
    EmbeddingHead,
    FrozenStats,
    SqueezeExcite,
    TrainContext,
    _over_127,
    check_calibrated,
    check_quant_mode,
    fake_quant_scale,
    fake_quant_ste,
    max_pool_same_nhwc,
    quantize_activation,
)
from tf_face_toolbox_tpu_torch.ops.dct import block_dct


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (grouped) -> 1x1 [-> squeeze-excite] bottleneck with
    residual add (NHWC)."""

    def __init__(self, in_features: int, features: int, strides: int,
                 expansion: int = 4, dtype: torch.dtype = torch.float32,
                 groups: int = 1, se_reduction: int = 0,
                 quantized: bool | str = False):
        super().__init__()
        out_features = features * expansion
        self.strides = strides
        self.dtype = dtype
        q = dict(dtype=dtype, quantized=quantized)
        self.ConvBN_0 = ConvBN(in_features, features, 1, **q)
        self.ConvBN_1 = ConvBN(features, features, 3, strides, groups=groups,
                               **q)
        self.ConvBN_2 = ConvBN(features, out_features, 1, relu=False, **q)
        if se_reduction > 0:
            self.SqueezeExcite_0 = SqueezeExcite(out_features, se_reduction)
        if in_features != out_features or strides != 1:
            self.ConvBN_3 = ConvBN(in_features, out_features, 1, strides,
                                   relu=False, **q)

    def forward(self, x: torch.Tensor | None,
                train: TrainContext | None = None,
                prequant: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
        """``prequant = (xq int8, xs)``: the static-int8 carry in place of
        ``x`` (None); the first conv, the projection and the skip (dequantized,
        ``xq * xs`` in the compute dtype) read it."""
        if prequant is not None:
            xq, xs = prequant
            x = xq.to(self.dtype) * xs.to(self.dtype)
        y = self.ConvBN_0(x, train, prequant)
        y = self.ConvBN_2(self.ConvBN_1(y, train), train)
        if hasattr(self, "SqueezeExcite_0"):
            y = self.SqueezeExcite_0(y)
        residual = (self.ConvBN_3(x, train, prequant)
                    if hasattr(self, "ConvBN_3") else x)
        return torch.relu(residual + y)


def block_strides(stage_idx: int, block_idx: int, stem: str) -> int:
    """The face stem keeps stage 0 at stride 2 (112 -> 56); the imagenet,
    space2depth and dct stems already downsampled, so their stage 0 runs
    at stride 1."""
    first = block_idx == 0
    return 2 if first and (stage_idx > 0 or stem == "face") else 1


class ResNet(FrozenStats):
    """ResNet producing a face embedding: (N, H, W, 3) -> (N, D) f32.

    ``input_size`` sizes the flatten head's Dense (flax infers it at
    init); the gap head does not use it.
    """

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width_per_group: int = 64,
                 stage_widths: Sequence[int] | None = None,
                 groups: int = 1, se_reduction: int = 0,
                 expansion: int = 4, embedding_dim: int = 512,
                 stem: str = "face", head_variant: str = "gap",
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 quantized: bool | str = False, remat: bool | str = False,
                 input_size: int = 112, dct_stem_features: int = 256):
        super().__init__()
        check_quant_mode(quantized)
        if remat not in (False, True, "save_convs"):
            raise ValueError(f"unknown remat {remat!r}; have False, True, "
                             "'save_convs'")
        if stem not in ("face", "imagenet", "space2depth", "dct"):
            raise ValueError(f"unknown stem: {stem}")
        self.stage_sizes = tuple(stage_sizes)
        self.groups = groups
        self.remat = remat
        self.stem = stem
        self.head_variant = head_variant
        self.dtype = dtype
        self.quantized = quantized

        size = input_size
        channels = 64
        if stem == "face":
            self.ConvBN_0 = ConvBN(3, 64, 3, 1, dtype=dtype)
        elif stem == "space2depth":
            self.ConvBN_0 = ConvBN(12, 64, 3, 1, dtype=dtype)
            size //= 2
        elif stem == "dct":
            # the frequency norm, then the 1x1 up-projection whose 4 * C
            # channels depth-to-space lays out as a 2x2 block each
            self.BatchNorm_0 = BatchNorm(192)
            self.ConvBN_0 = ConvBN(192, 4 * dct_stem_features, 1, 1,
                                   dtype=dtype)
            size = size // 8 * 2
            channels = dct_stem_features
        else:
            self.ConvBN_0 = ConvBN(3, 64, 7, 2, dtype=dtype)
            size = -(-size // 2)
            size = -(-size // 2)          # max pool 3x3/s2
        counter = 0
        for stage_idx, num_blocks in enumerate(self.stage_sizes):
            features = (stage_widths[stage_idx] if stage_widths is not None
                        else width_per_group * groups * 2 ** stage_idx)
            for block_idx in range(num_blocks):
                strides = block_strides(stage_idx, block_idx, stem)
                size = -(-size // strides)
                self.add_module(
                    f"BottleneckBlock_{counter}",
                    BottleneckBlock(channels, features, strides, expansion,
                                    dtype=dtype, groups=groups,
                                    se_reduction=se_reduction,
                                    quantized=quantized))
                if quantized in CALIBRATED:
                    self.register_buffer(f"block_{counter}_in_max",
                                         torch.full((), float("nan")))
                    self.stat_names += (f"block_{counter}_in_max",)
                channels = features * expansion
                counter += 1
        self.num_blocks = counter
        self.EmbeddingHead_0 = EmbeddingHead(
            channels, embedding_dim, head_variant, spatial=(size, size),
            dtype=dtype, dropout_rate=dropout_rate)

    def _dct_stem(self, x: torch.Tensor,
                  train: TrainContext | None) -> torch.Tensor:
        if x.shape[-1] == 3:
            x = block_dct(x).to(self.dtype)
        elif x.shape[-1] != 192:
            raise ValueError(
                f"dct stem wants (N,H,W,3) pixels or (N,h,w,192) "
                f"coefficients, got trailing dim {x.shape[-1]}")
        x = self.ConvBN_0(self.BatchNorm_0(x, self.dtype, train), train)
        return depth_to_space(x)

    def blocks(self) -> list[BottleneckBlock]:
        return [getattr(self, f"BottleneckBlock_{i}")
                for i in range(self.num_blocks)]

    def forward(self, images: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        """images: (N, H, W, 3) standardized pixels (or, with the dct
        stem, (N, H/8, W/8, 192) coefficients) -> (N, D) f32."""
        x = images.to(self.dtype)
        if self.stem == "space2depth":
            x = space_to_depth(x)
        if self.stem == "dct":
            x = self._dct_stem(x, train)
        else:
            x = self.ConvBN_0(x, train)
        if self.stem == "imagenet":
            x = max_pool_same_nhwc(x, 3, 2)
        q = self.quantized
        for i, block in enumerate(self.blocks()):
            if q == "calibrate" and train is None:
                stat = getattr(self, f"block_{i}_in_max")
                stat.copy_(torch.fmax(
                    stat, x.detach().to(torch.float32).abs().amax()))
            elif q == "qat" and train is not None:
                # the stream fake-quantized as the static carry will
                # serve it, per tensor over this rank's batch
                xf = x.to(torch.float32)
                x = fake_quant_ste(xf, fake_quant_scale(xf)).to(self.dtype)
            elif q in ("static", "static_dense") and train is None:
                stat = getattr(self, f"block_{i}_in_max")
                check_calibrated(self, stat)
                xs = _over_127(torch.clamp_min(stat, 1e-12))
                xq = quantize_activation(x.to(torch.float32), xs)
                x = block(None, train, (xq, xs))
                continue
            if self.remat and train is not None and torch.is_grad_enabled():
                x = _recomputed(block, x, train, self.remat)
            else:
                x = block(x, train)
        return self.EmbeddingHead_0(x, train)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """The space2depth stem's re-layout (TResNet): each 2x2 pixel block
    of NHWC ``x`` becomes 4 * C channels, (N, H, W, C) -> (N, H/2, W/2,
    4C), in JAX's element order (row in the block, then column, then
    channel). H and W must be even."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """The dct stem's re-layout, (N, H, W, 4C) -> (N, 2H, 2W, C): each
    pixel's channels as (row in the 2x2 block, column, channel)."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c)


def _save_conv_outputs(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.convolution.default:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _recomputed(block: BottleneckBlock, x: torch.Tensor, train: TrainContext,
                remat) -> torch.Tensor:
    """``block(x, train)`` under ``torch.utils.checkpoint``.

    The first call is the forward, and its BatchNorms put their updated
    running statistics into ``train.stats``. Backward calls it again; a
    BatchNorm already in ``train.stats`` starts from those values, so the
    recompute would advance its statistics once more. It therefore puts
    back the entries it found: the statistics stay as the forward (and
    any forward since, such as the next micro-batch's) left them.
    """
    calls = 0

    def run(x):
        nonlocal calls
        calls += 1
        if calls == 1:
            return block(x, train)
        saved = dict(train.stats)
        try:
            return block(x, train)
        finally:
            # also when the recompute stops early (by an exception) once
            # it has what backward needs
            train.stats.clear()
            train.stats.update(saved)

    context_fn = checkpoint.noop_context_fn
    if remat == "save_convs":
        def context_fn():
            return checkpoint.create_selective_checkpoint_contexts(
                _save_conv_outputs)
    return checkpoint.checkpoint(run, x, use_reentrant=False,
                                 context_fn=context_fn)
