"""Eval preprocessing: crop, resize, flip and tf.image standardization.

The fp eval half of ``tf_face_toolbox_tpu/ops/preprocess.py``. Images
are NHWC at every function, as in the JAX package. Resize is the same
pair of dense half-pixel bilinear matrices (``_bilinear_matrix``), so
the two packages sample identically. The train-time random ops come
with the training slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def per_image_standardization(images: torch.Tensor) -> torch.Tensor:
    """tf.image.per_image_standardization, batched over axis 0.

    (x - mean) / max(std, 1/sqrt(N)) with N = H*W*C and the population
    std (ddof=0). Returns float32.
    """
    x = images.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    n = float(np.prod(x.shape[1:]))
    mean = x.mean(dim=dims, keepdim=True)
    std = torch.sqrt(torch.square(x - mean).mean(dim=dims, keepdim=True))
    adjusted = torch.clamp_min(std, 1.0 / np.sqrt(n))
    return (x - mean) / adjusted


def fixed_standardization(images: torch.Tensor) -> torch.Tensor:
    """InsightFace input normalization: (x - 127.5) / 127.5."""
    return (images.to(torch.float32) - 127.5) / 127.5


def standardize(images: torch.Tensor, norm: str = "per_image"
                ) -> torch.Tensor:
    """Dispatch on the standardization convention (see each fn)."""
    if norm == "per_image":
        return per_image_standardization(images)
    if norm == "fixed":
        return fixed_standardization(images)
    raise ValueError(f"unknown norm {norm!r}; want per_image|fixed")


def flip_left_right(images: torch.Tensor) -> torch.Tensor:
    """Deterministic horizontal flip (width axis of NHWC)."""
    return images.flip(2)


def apply_flip_mask(images: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    """Flip images[i] where mask[i]."""
    m = mask.to(device=images.device, dtype=torch.bool).reshape(-1, 1, 1, 1)
    return torch.where(m, images.flip(2), images)


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) dense bilinear interpolation matrix, half-pixel centers.

    Row o holds the two taps for source coordinate (o+0.5)*in/out - 0.5,
    clamped at the borders. A clamped row holds one tap of weight
    (1-f)+f, summed in float32 as the JAX package sums it.
    """
    m = np.zeros((out_size, in_size), np.float32)
    if out_size == in_size:
        np.fill_diagonal(m, 1.0)
        return m
    scale = in_size / out_size
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = min(max(lo, 0), in_size - 1)
        hi_c = min(max(lo + 1, 0), in_size - 1)
        m[o, lo_c] += 1.0 - frac
        m[o, hi_c] += frac
    return m


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """Batched bilinear resize as two matrix products.

    images: (N, H, W, C) any float/int dtype -> (N, out_h, out_w, C) f32.
    """
    _, h, w, _ = images.shape
    dev = images.device
    rh = torch.from_numpy(_bilinear_matrix(out_h, h)).to(dev)
    rw = torch.from_numpy(_bilinear_matrix(out_w, w)).to(dev)
    x = images.to(torch.float32)
    x = torch.einsum("oh,nhwc->nowc", rh, x)
    return torch.einsum("pw,nowc->nopc", rw, x)


def crop_at(images: torch.Tensor, offsets, crop_h: int, crop_w: int
            ) -> torch.Tensor:
    """Batched crop at per-image (y, x) offsets.

    offsets: (N, 2) ints (array or tensor). Output (N, crop_h, crop_w, C).
    """
    if isinstance(offsets, torch.Tensor):
        offsets = offsets.cpu().numpy()
    offs = np.asarray(offsets, np.int64)
    n, h, w, _ = images.shape
    if offs.shape != (n, 2):
        raise ValueError(f"offsets must be ({n}, 2), got {offs.shape}")
    # clamp like lax.dynamic_slice, which keeps the window in bounds
    ys = np.clip(offs[:, 0], 0, h - crop_h)
    xs = np.clip(offs[:, 1], 0, w - crop_w)
    if (ys == ys[0]).all() and (xs == xs[0]).all():
        y, x = int(ys[0]), int(xs[0])
        return images[:, y:y + crop_h, x:x + crop_w, :]
    return torch.stack([images[i, y:y + crop_h, x:x + crop_w, :]
                        for i, (y, x) in enumerate(zip(ys, xs))])


def center_offsets(batch: int, in_h: int, in_w: int,
                   crop_h: int, crop_w: int) -> np.ndarray:
    off = np.array([(in_h - crop_h) // 2, (in_w - crop_w) // 2], np.int32)
    return np.broadcast_to(off, (batch, 2))


def preprocess_eval(images_u8: torch.Tensor, crop_h: int, crop_w: int,
                    norm: str = "per_image") -> torch.Tensor:
    """Eval chain: center crop -> standardize (no flip). Returns f32."""
    n, h, w, _ = images_u8.shape
    offs = center_offsets(n, h, w, crop_h, crop_w)
    x = crop_at(images_u8, offs, crop_h, crop_w)
    return standardize(x.to(torch.float32), norm)


def preprocess_eval_resize(images_u8: torch.Tensor,
                           out_h: int, out_w: int) -> torch.Tensor:
    """Eval chain for mismatched input sizes: resize -> standardize."""
    return per_image_standardization(
        resize_bilinear(images_u8, out_h, out_w))
