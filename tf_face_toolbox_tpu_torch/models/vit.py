"""FaceViT: a Vision Transformer whose tokens are the JPEG 8x8 blocks.

Counterpart of ``tf_face_toolbox_tpu/models/vit.py``. A 112 x 112 face
is 14 x 14 blocks of 192 DCT coefficients, a patch-8 token grid whose
patch embedding follows the fixed DCT rotation. The net takes
standardized pixels (N, H, W, 3), which it turns into coefficients with
``ops/dct.block_dct``, or coefficients (N, H/8, W/8, 192) from
``ops/dct.prepare_coefficients``; one set of weights serves both.

The JAX rounding points are kept in a bf16 net: LayerNorm statistics
and affine in f32, the result in the compute dtype (epsilon 1e-6); the
attention scores in the compute dtype, divided by sqrt(dh) rounded to
it; the softmax in f32, its probabilities cast back before the second
product; GELU the tanh approximation (flax ``nn.gelu``). The attention
is two matmuls around the softmax, as JAX writes it.

Module names give the JAX keys: ``freq_bn``, ``token_proj``,
``pos_embedding`` (1, T, W), ``Block_{i}/{ln1, attn/qkv, attn/out, ln2,
mlp1, mlp2}``, ``ln_final``, ``EmbeddingHead_0``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tf_face_toolbox_tpu_torch.models.layers import (
    BatchNorm,
    EmbeddingHead,
    TrainContext,
)
from tf_face_toolbox_tpu_torch.ops.dct import block_dct

LN_EPS = 1e-6


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """flax ``nn.Dense(dtype=x.dtype)``: kernel and bias cast to it."""
    dt = x.dtype
    return F.linear(x, layer.weight.to(dt), layer.bias.to(dt))


class LayerNormF32(nn.Module):
    """LayerNorm over the last axis with f32 statistics and f32 affine;
    the result in the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight,
                         self.bias, LN_EPS)
        return y.to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Dot-product attention of ``num_heads`` heads as two matmuls around
    an f32 softmax; qkv's output is laid out (3, heads, dh)."""

    def __init__(self, width: int, num_heads: int):
        super().__init__()
        if width % num_heads:
            raise ValueError(f"width {width} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads = num_heads
        self.qkv = nn.Linear(width, 3 * width)
        self.out = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, w = x.shape
        dh = w // self.num_heads
        qkv = _linear(x, self.qkv).reshape(n, t, 3, self.num_heads, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        # a fill on the device: a host tensor's copy would wait for the
        # card's queue to drain, in every block
        root = torch.full((), math.sqrt(dh), dtype=x.dtype, device=x.device)
        scores = (q @ k.transpose(-1, -2)) / root
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        out = (probs @ v).transpose(1, 2).reshape(n, t, w)
        return _linear(out, self.out)


def drop_path(y: torch.Tensor, rate: float,
              generator: torch.Generator | None) -> torch.Tensor:
    """Stochastic depth of a residual branch: each sample's branch kept
    with probability 1 - rate (one draw a sample from ``generator``) and
    divided by it, in y's dtype; dropped ones are zero."""
    keep = 1.0 - rate
    mask = torch.rand((y.shape[0], 1, 1), generator=generator,
                      device=y.device) < keep
    scale = torch.full((), keep, dtype=y.dtype, device=y.device)
    return torch.where(mask, y / scale, torch.zeros((), dtype=y.dtype,
                                                    device=y.device))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: LN -> attention -> add, LN -> MLP (GELU)
    -> add. ``drop_path``: in train mode each residual branch is dropped
    for a sample with this probability, a draw a branch (eval is
    deterministic and equals drop_path 0)."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: int = 4,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.ln1 = LayerNormF32(width)
        self.attn = MultiHeadAttention(width, num_heads)
        self.ln2 = LayerNormF32(width)
        self.mlp1 = nn.Linear(width, mlp_ratio * width)
        self.mlp2 = nn.Linear(mlp_ratio * width, width)

    def _branch(self, y: torch.Tensor, train: TrainContext | None):
        if self.drop_path <= 0.0 or train is None:
            return y
        return drop_path(y, self.drop_path, train.generator)

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        x = x + self._branch(self.attn(self.ln1(x)), train)
        y = F.gelu(_linear(self.ln2(x), self.mlp1), approximate="tanh")
        return x + self._branch(_linear(y, self.mlp2), train)


class FaceViT(nn.Module):
    """JPEG-block-token ViT: (N, H, W, 3) pixels or (N, H/8, W/8, 192)
    coefficients -> (N, D) f32, un-normalized.

    ``input_size`` sizes the positional table, (input_size / 8)^2
    tokens: a net serves the grid it was made for
    (``resize_pos_embedding`` adapts weights to another).
    ``drop_path_rate`` ramps linearly over the blocks, from 0 at the
    first to the rate at the last.
    """

    def __init__(self, depth: int = 12, width: int = 384, num_heads: int = 6,
                 mlp_ratio: int = 4, embedding_dim: int = 512,
                 dropout_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, stem: str = "dct",
                 head_variant: str = "gap", quantized: bool | str = False,
                 input_size: int = 112):
        super().__init__()
        if stem != "dct":
            raise ValueError("FaceViT's tokens are structurally the 8×8 "
                             f"DCT blocks; got stem={stem!r}")
        if head_variant != "gap":
            raise ValueError("FaceViT's head is structurally gap→FC→BN; "
                             f"got head_variant={head_variant!r}")
        if quantized:
            raise ValueError(
                "int8 serving is not supported for the ViT family (the "
                "static-int8 residual carry covers the ConvBN block "
                "library only); serve fp — every layer is already a "
                "full-tile MXU matmul")
        if input_size % 8:
            raise ValueError(f"input_size {input_size} is not a multiple "
                             "of 8 (one token a JPEG block)")
        self.depth, self.width = depth, width
        self.stem, self.head_variant = stem, head_variant
        self.dtype = dtype
        tokens = (input_size // 8) ** 2
        self.freq_bn = BatchNorm(192)
        self.token_proj = nn.Linear(192, width)
        self.pos_embedding = nn.Parameter(torch.zeros(1, tokens, width))
        for i in range(depth):
            rate = drop_path_rate * i / max(depth - 1, 1)
            self.add_module(f"Block_{i}", EncoderBlock(
                width, num_heads, mlp_ratio, drop_path=rate))
        self.ln_final = LayerNormF32(width)
        self.EmbeddingHead_0 = EmbeddingHead(width, embedding_dim, "gap",
                                             dtype=dtype,
                                             dropout_rate=dropout_rate)

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"Block_{i}") for i in range(self.depth)]

    def forward(self, images: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        x = images
        if x.shape[-1] == 3:
            # the DCT in the compute dtype, as JAX's block_dct(x.astype)
            x = block_dct(x.to(self.dtype))
        elif x.shape[-1] != 192:
            raise ValueError(
                f"dct tokens want (N,H,W,3) pixels or (N,h,w,192) "
                f"coefficients, got trailing dim {x.shape[-1]}")
        x = self.freq_bn(x.to(self.dtype), self.dtype, train)
        n, h, w, c = x.shape
        t = h * w
        x = _linear(x.reshape(n, t, c), self.token_proj)
        x = x + self.pos_embedding.to(self.dtype)
        for block in self.blocks():
            x = block(x, train)
        x = self.ln_final(x)
        return self.EmbeddingHead_0(x.reshape(n, 1, t, self.width), train)


def _resize_matrix(old: int, new: int) -> np.ndarray:
    """(old, new) weights of ``jax.image.resize``'s antialiased bilinear
    resize along one axis: a triangle kernel at half-pixel sample points,
    widened by old / new when shrinking, each column normalized."""
    scale = new / old
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(new) + 0.5) / scale - 0.5
    x = np.abs(sample[None, :] - np.arange(old)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= old - 0.5)
    return np.where(inside[None, :], weights, 0.0)


def resize_pos_embedding(variables: dict, new_hw: tuple[int, int],
                         old_hw: tuple[int, int] | None = None) -> dict:
    """A FaceViT's flat JAX-key variables adapted to another token grid
    (another input size): the (1, T, W) table laid out as its 2-D grid,
    resized as ``jax.image.resize(..., "bilinear")`` does (half-pixel,
    antialiased when shrinking), flattened back. Every other leaf is
    resolution-independent. Returns a new dict; ``old_hw`` defaults to
    the square grid of the stored token count."""
    pos = np.asarray(variables["params/pos_embedding"], np.float32)
    t, w = pos.shape[1], pos.shape[2]
    if old_hw is None:
        side = int(round(t ** 0.5))
        if side * side != t:
            raise ValueError(f"stored pos_embedding has {t} tokens, not a "
                             "square grid; pass old_hw explicitly")
        old_hw = (side, side)
    if old_hw[0] * old_hw[1] != t:
        raise ValueError(f"old_hw {old_hw} != stored token count {t}")
    grid = pos.reshape(*old_hw, w).astype(np.float64)
    rows = _resize_matrix(old_hw[0], new_hw[0])
    cols = _resize_matrix(old_hw[1], new_hw[1])
    resized = np.einsum("hH,wW,hwc->HWc", rows, cols, grid)
    out = dict(variables)
    out["params/pos_embedding"] = resized.reshape(
        1, new_hw[0] * new_hw[1], w).astype(np.float32)
    return out
