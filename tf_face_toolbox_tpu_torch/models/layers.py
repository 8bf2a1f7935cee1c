"""Shared layers, fp eval: ConvBN, BatchNorm, EmbeddingHead, l2_normalize.

Counterpart of ``tf_face_toolbox_tpu/models/layers.py``. Activations
are NHWC, as in the JAX package, and stay physically NHWC: a conv runs
on the ``permute(0, 3, 1, 2)`` view, which is a channels_last NCHW
tensor and needs no copy. Module and attribute names follow the flax
auto-names (``ConvBN_0``, ``BatchNorm_0``, ``Dense_0``) so the JAX
``.npz`` key space maps onto ``state_dict`` mechanically
(interop/port.py).

``dtype`` is the compute dtype; parameters and BN statistics stay f32.
BatchNorm runs in f32 on the (possibly bf16) conv output and rounds to
the compute dtype after, as flax's BatchNorm does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def same_pad(h: int, w: int, k: int, s: int) -> tuple[int, int, int, int]:
    """TF/JAX "SAME" padding as (top, bottom, left, right).

    The output is ceil(size / s); the total padding is split with the
    smaller half before. At stride 2 on an even size this is
    asymmetric (3x3/s2 pads 0/1, 7x7/s2 at 112 pads 2/3), which
    PyTorch's symmetric ``padding=k//2`` does not reproduce.
    """
    def one(size: int) -> tuple[int, int]:
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        return total // 2, total - total // 2

    top, bottom = one(h)
    left, right = one(w)
    return top, bottom, left, right


def conv2d_same_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with an OIHW ``weight``; NHWC result."""
    k = weight.shape[-1]
    top, bottom, left, right = same_pad(x.shape[1], x.shape[2], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool_same_nhwc(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """SAME max pool of NHWC ``x``; the padding is -inf."""
    top, bottom, left, right = same_pad(x.shape[1], x.shape[2], k, s)
    x = F.pad(x, (0, 0, left, right, top, bottom), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1).contiguous()


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis (flax ``nn.BatchNorm``)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        # flax order: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul + self.bias
        return y.to(out_dtype)


class ConvBN(nn.Module):
    """Conv (no bias) -> eval BatchNorm -> optional ReLU, NHWC."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, relu: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = strides
        self.relu = relu
        self.dtype = dtype
        fan_in = in_features * kernel_size * kernel_size
        self.weight = nn.Parameter(
            torch.randn(features, in_features, kernel_size, kernel_size)
            * math.sqrt(2.0 / fan_in))
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d_same_nhwc(x.to(self.dtype), self.weight.to(self.dtype),
                             self.strides)
        y = self.BatchNorm_0(y, self.dtype)
        return torch.relu(y) if self.relu else y


class EmbeddingHead(nn.Module):
    """pool/flatten -> Dense(dim) -> BN, f32 output (flax EmbeddingHead).

    ``gap``: global average pool -> Dense -> BN.
    ``flatten``: BN -> flatten (NHWC order) -> Dense -> BN; needs the
    final map's ``spatial`` (h, w) to size the Dense.
    """

    def __init__(self, in_features: int, embedding_dim: int = 512,
                 variant: str = "gap", spatial: tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.variant = variant
        self.dtype = dtype
        if variant == "gap":
            dense_in = in_features
            self.BatchNorm_0 = BatchNorm(embedding_dim)
        elif variant == "flatten":
            dense_in = in_features * spatial[0] * spatial[1]
            self.BatchNorm_0 = BatchNorm(in_features)
            self.BatchNorm_1 = BatchNorm(embedding_dim)
        else:
            raise ValueError(f"unknown head variant: {variant}")
        self.Dense_0 = nn.Linear(dense_in, embedding_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.variant == "gap":
            # jnp.mean of a bf16 map sums in f32 and returns bf16
            x = x.to(torch.float32).mean(dim=(1, 2)).to(self.dtype)
            final_bn = self.BatchNorm_0
        else:
            x = self.BatchNorm_0(x, self.dtype).reshape(x.shape[0], -1)
            final_bn = self.BatchNorm_1
        x = F.linear(x.to(self.dtype), self.Dense_0.weight.to(self.dtype),
                     self.Dense_0.bias.to(self.dtype))
        # final BN and the embedding are f32 under any compute dtype
        return final_bn(x, torch.float32)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x^2) + eps): safe at zero. Not F.normalize, which
    divides by max(norm, eps)."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True)
                          + eps)
