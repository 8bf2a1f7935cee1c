"""The eval chain's input: center crop and per-image standardization."""

from __future__ import annotations

import torch


def standardized_crops(u8: torch.Tensor, size: int, norm: str
                       ) -> torch.Tensor:
    """(N, S, S, 3) uint8 faces -> (N, 3, size, size) f32: the centered
    ``size`` crop, standardized per image (tf.image's
    per_image_standardization: population std floored at 1/sqrt(H*W*C))
    or with InsightFace's fixed (x - 127.5) / 127.5."""
    n, h, w, _ = u8.shape
    top, left = (h - size) // 2, (w - size) // 2
    x = u8[:, top:top + size, left:left + size, :].to(torch.float32)
    if norm == "fixed":
        x = (x - 127.5) / 127.5
    elif norm == "per_image":
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True).sqrt()
        x = (x - mean) / std.clamp_min(1.0 / (x[0].numel() ** 0.5))
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return x.permute(0, 3, 1, 2).contiguous()


def flip_averaged(forward, x: torch.Tensor) -> torch.Tensor:
    """l2normalize(f(x) + f(mirror x)) of NCHW ``x``."""
    s = forward(x) + forward(x.flip(3))
    return s / torch.sqrt(s.square().sum(dim=1, keepdim=True) + 1e-12)
