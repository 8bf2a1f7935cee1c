"""Shared layers: ConvBN, Conv, BatchNorm, SqueezeExcite, EmbeddingHead,
l2_normalize.

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

A forward given ``train=TrainContext(...)`` runs in train mode: BatchNorm
normalizes with the batch's statistics and puts its updated running
statistics into the context (the module's buffers stay as they were;
the train step decides whether to keep them), and the flatten head's
dropout draws from the context's generator. Without one it is eval.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
MOMENTUM = 0.9             # flax's convention: the running stats' weight


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
                     bias: torch.Tensor | None = None,
                     groups: int = 1) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with an OIHW ``weight`` (O, I / groups,
    kh, kw); NHWC result."""
    k = weight.shape[-1]
    top, bottom, left, right = same_pad(x.shape[1], x.shape[2], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool_same_nhwc(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """SAME max pool of NHWC ``x``; the padding is -inf."""
    top, bottom, left, right = same_pad(x.shape[1], x.shape[2], k, s)
    x = F.pad(x, (0, 0, left, right, top, bottom), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1).contiguous()


class TrainContext:
    """What a train-mode forward threads through the modules.

    ``stats``: BatchNorm module -> its updated (running_mean,
    running_var), filled by the forward. A module already in it starts
    from those values, not its buffers, so micro-batches that share one
    context advance the statistics one after another.
    ``generator``: what dropout draws from.
    """

    def __init__(self, generator: torch.Generator | None = None):
        self.stats: dict[nn.Module, tuple[torch.Tensor, torch.Tensor]] = {}
        self.generator = generator


class _TrainNorm(torch.autograd.Function):
    """flax's train-mode normalization over every axis but the last.

    Statistics in f32 over N*H*W: the mean and the biased variance in
    flax's fast form, max(0, E[x^2] - E[x]^2). The output is (x - mean)
    * (rsqrt(var + eps) * scale) + bias, rounded to ``out_dtype``.
    Saves only the input and the per-channel statistics: backward
    recomputes the normalized values (the f32 intermediates of a
    bf16 net would otherwise stay alive until backward).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, out_dtype):
        dims = tuple(range(x.ndim - 1))
        xf = x.to(torch.float32)
        mean = xf.mean(dims)
        var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        invstd = torch.rsqrt(var + BN_EPS)
        y = (xf - mean) * (invstd * weight) + bias
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, grad_y, _grad_mean, _grad_var):
        x, mean, invstd, weight = ctx.saved_tensors
        dims = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        g = grad_y.to(torch.float32)
        xhat = (x.to(torch.float32) - mean) * invstd
        grad_bias = g.sum(dims)
        grad_weight = (g * xhat).sum(dims)
        grad_x = (weight * invstd / n) * (n * g - grad_bias
                                          - xhat * grad_weight)
        return grad_x.to(x.dtype), grad_weight, grad_bias, None


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax ``nn.BatchNorm``, momentum 0.9:
    running = 0.9 * running + 0.1 * batch, with the biased variance)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype,
                train: TrainContext | None = None) -> torch.Tensor:
        if train is not None:
            y, mean, var = _TrainNorm.apply(x, self.weight, self.bias,
                                            out_dtype)
            old_mean, old_var = train.stats.get(
                self, (self.running_mean, self.running_var))
            train.stats[self] = (MOMENTUM * old_mean + (1 - MOMENTUM) * mean,
                               MOMENTUM * old_var + (1 - MOMENTUM) * var)
            return y
        # flax order: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul + self.bias
        return y.to(out_dtype)


def conv_weight(in_features: int, features: int, kernel_size: int,
                 groups: int = 1) -> nn.Parameter:
    fan_in = in_features // groups * kernel_size * kernel_size
    return nn.Parameter(
        torch.randn(features, in_features // groups, kernel_size, kernel_size)
        * math.sqrt(2.0 / fan_in))


class Conv(nn.Module):
    """Bias-free SAME conv in the compute dtype (flax ``nn.Conv(...,
    use_bias=False)``): its kernel is the module's own ``weight``, JAX
    key ``.../kernel``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.weight = conv_weight(in_features, features, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same_nhwc(x.to(self.dtype), self.weight.to(self.dtype),
                                self.strides)


class ConvBN(nn.Module):
    """Conv (no bias; ``groups`` splits the channels as
    ``feature_group_count`` does) -> eval BatchNorm -> optional ReLU,
    NHWC."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, relu: bool = True,
                 dtype: torch.dtype = torch.float32, groups: int = 1):
        super().__init__()
        self.strides = strides
        self.relu = relu
        self.dtype = dtype
        self.groups = groups
        self.weight = conv_weight(in_features, features, kernel_size, groups)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        y = conv2d_same_nhwc(x.to(self.dtype), self.weight.to(self.dtype),
                             self.strides, groups=self.groups)
        y = self.BatchNorm_0(y, self.dtype, train)
        return torch.relu(y) if self.relu else y


def squeeze_excite(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Squeeze-and-excitation gate of NHWC ``x``: mean over H, W ->
    Dense -> ReLU -> Dense -> sigmoid -> ``x * s``, all in ``x.dtype``
    with flax ``nn.Dense(dtype=x.dtype)``'s rounding points (the product
    rounds before the bias add). Weights are (out, in)."""
    dt = x.dtype
    # jnp.mean of a bf16 map sums in f32 and returns bf16
    s = x.to(torch.float32).mean(dim=(1, 2)).to(dt)
    s = torch.relu(s @ w0.to(dt).T + b0.to(dt))
    s = torch.sigmoid(s @ w1.to(dt).T + b1.to(dt))
    return x * s[:, None, None, :]


class SqueezeExcite(nn.Module):
    """flax ``SqueezeExcite``: a hidden width of max(C // reduction, 8),
    its two Dense layers computed in the compute dtype."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        hidden = max(features // reduction, 8)
        self.Dense_0 = nn.Linear(features, hidden)
        self.Dense_1 = nn.Linear(hidden, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.Dense_0.weight, self.Dense_0.bias,
                              self.Dense_1.weight, self.Dense_1.bias)


class EmbeddingHead(nn.Module):
    """pool/flatten -> Dense(dim) -> BN, f32 output (flax EmbeddingHead).

    ``gap``: global average pool -> Dense -> BN.
    ``flatten``: BN -> dropout (train mode) -> flatten (NHWC order) ->
    Dense -> BN; needs the final map's ``spatial`` (h, w) to size the
    Dense.
    """

    def __init__(self, in_features: int, embedding_dim: int = 512,
                 variant: str = "gap", spatial: tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.variant = variant
        self.dtype = dtype
        self.dropout_rate = dropout_rate
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

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        if self.variant == "gap":
            # jnp.mean of a bf16 map sums in f32 and returns bf16
            x = x.to(torch.float32).mean(dim=(1, 2)).to(self.dtype)
            final_bn = self.BatchNorm_0
        else:
            x = self.BatchNorm_0(x, self.dtype, train)
            if train is not None and self.dropout_rate > 0:
                x = dropout(x, self.dropout_rate, train.generator)
            x = x.reshape(x.shape[0], -1)
            final_bn = self.BatchNorm_1
        x = F.linear(x.to(self.dtype), self.Dense_0.weight.to(self.dtype),
                     self.Dense_0.bias.to(self.dtype))
        # final BN and the embedding are f32 under any compute dtype
        return final_bn(x, torch.float32, train)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and divide the
    kept values by it; the mask comes from ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x^2) + eps): safe at zero. Not F.normalize, which
    divides by max(norm, eps)."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True)
                          + eps)
