"""The reference's layers, NCHW in f32.

``quant="int8"`` is the control's precision: every conv and Dense
reads its input and kernel rounded to symmetric int8 (the input per
sample, the kernel per output channel; round half to even) and sums in
f32, as a W8A8 int8 path would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def int8_round(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """``x`` rounded to symmetric int8 with one scale per slice over
    ``dims`` (max |x| / 127), returned dequantized."""
    scale = (x.abs().amax(dim=dims, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(x / scale).clamp(-127, 127) * scale


def conv(x: torch.Tensor, kernel_hwio: torch.Tensor, stride: int,
         pad: tuple[int, int, int, int], quant: str | None = None
         ) -> torch.Tensor:
    """Conv of NCHW ``x`` with an HWIO kernel after zero padding ``pad``
    = (left, right, top, bottom)."""
    w = kernel_hwio.permute(3, 2, 0, 1)
    if quant == "int8":
        x = int8_round(x, (1, 2, 3))
        w = int8_round(w, (1, 2, 3))
    if any(pad):
        x = F.pad(x, pad)
    return F.conv2d(x, w, stride=stride)


def same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    """TF "SAME": output ceil(size / stride), the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x, kernel_hwio, stride, quant=None):
    k = kernel_hwio.shape[0]
    top, bottom = same_pad(x.shape[2], k, stride)
    left, right = same_pad(x.shape[3], k, stride)
    return conv(x, kernel_hwio, stride, (left, right, top, bottom), quant)


def batch_norm(x: torch.Tensor, v: dict, path: str) -> torch.Tensor:
    """BatchNorm over axis 1 with the running statistics, eps 1e-5."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = v[f"batch_stats/{path}/mean"].reshape(shape)
    var = v[f"batch_stats/{path}/var"].reshape(shape)
    scale = v[f"params/{path}/scale"].reshape(shape)
    bias = v[f"params/{path}/bias"].reshape(shape)
    return (x - mean) / torch.sqrt(var + 1e-5) * scale + bias


def dense(x: torch.Tensor, v: dict, path: str, quant=None) -> torch.Tensor:
    w = v[f"params/{path}/kernel"]
    if quant == "int8":
        x = int8_round(x, (1,))
        w = int8_round(w, (0,))
    return x @ w + v[f"params/{path}/bias"]
