"""Batch-norm folding for inference.

At eval time BN(conv(x, K)) is one conv with a per-output-channel
rescaled kernel plus a bias:

    y = g * (conv(x, K) - mu) / sqrt(var + eps) + beta
      = conv(x, K * r) + (beta - mu * r),      r = g / sqrt(var + eps)

Counterpart of ``tf_face_toolbox_tpu/serving/fold.py``. Folding runs in
float32 on the JAX variables tree (HWIO kernels); the folded kernel is
cast to the compute dtype once and stored OIHW for ``F.conv2d``, the
bias stays float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models.layers import BN_EPS, conv2d_same_nhwc


def as_f32(a) -> torch.Tensor:
    """A host array (or JAX-tree leaf) as a float32 tensor (a copy)."""
    return torch.tensor(np.asarray(a, np.float32))


@dataclass(frozen=True)
class FoldedConv:
    """A ConvBN collapsed to conv + bias (+ the ConvBN's static config)."""

    kernel: torch.Tensor     # (cout, cin, kh, kw), compute dtype
    bias: torch.Tensor       # (cout,) float32
    strides: int
    relu: bool

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """SAME conv of NHWC x (cuDNN on the channels_last view), then
        + bias in the conv's dtype, then ReLU: JAX's order and rounding."""
        y = conv2d_same_nhwc(x, self.kernel, self.strides)
        y = y + self.bias.to(y.dtype)
        return torch.relu(y) if self.relu else y

    def to(self, device) -> "FoldedConv":
        return FoldedConv(self.kernel.to(device), self.bias.to(device),
                          self.strides, self.relu)


def bn_affine(bn_params: Any, bn_stats: Any
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as a per-channel affine (r, c) in f32:
    BN(x) = x * r + c with r = scale / sqrt(var + eps), c = bias - mean * r."""
    r = as_f32(bn_params["scale"]) * torch.rsqrt(as_f32(bn_stats["var"])
                                                 + BN_EPS)
    return r, as_f32(bn_params["bias"]) - as_f32(bn_stats["mean"]) * r


def fold_conv_bn(convbn_params: Any, convbn_stats: Any, *, strides: int = 1,
                 relu: bool = True, dtype=torch.float32) -> FoldedConv:
    """Fold one ConvBN's {params, batch_stats} (JAX tree layout:
    ``{"kernel", "BatchNorm_0": {"scale", "bias"}}`` and
    ``{"BatchNorm_0": {"mean", "var"}}``) into a FoldedConv."""
    kernel = as_f32(convbn_params["kernel"])                # HWIO
    r, c = bn_affine(convbn_params["BatchNorm_0"], convbn_stats["BatchNorm_0"])
    return FoldedConv(
        kernel=(kernel * r).permute(3, 2, 0, 1).contiguous().to(dtype),
        bias=c,
        strides=strides,
        relu=relu,
    )


def fold_dense_bn(dense_params: Any, bn_params: Any, bn_stats: Any, *,
                  dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold Dense -> BatchNorm (the embedding head) into (W' (in, out)
    in ``dtype``, b' f32):

    emb = scale * (x @ W + b - mean) / sqrt(var+eps) + beta
        = x @ (W * r) + ((b - mean) * r + beta)
    """
    r, _ = bn_affine(bn_params, bn_stats)
    w = as_f32(dense_params["kernel"])
    b = as_f32(dense_params["bias"])
    return ((w * r).to(dtype),
            (b - as_f32(bn_stats["mean"])) * r + as_f32(bn_params["bias"]))
