"""Preprocessing: crop, resize, flip, tf.image standardization, and the
train-time random ops.

Counterpart of ``tf_face_toolbox_tpu/ops/preprocess.py``. Images are
NHWC at every function, as in the JAX package. Resize is the same pair
of dense half-pixel bilinear matrices (``_bilinear_matrix``), so the
two packages sample identically.

The random ops draw from an explicit ``torch.Generator`` on the
generator's device and move what they drew to the images' device. The
JAX package draws from threefry keys, a stream the port does not
reproduce: the parity tests inject the draws (``crop_at`` offsets,
``apply_flip_mask`` masks, ``erase_with``'s values).
"""

from __future__ import annotations

import functools
import math

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


def random_flip_mask(generator: torch.Generator, n: int) -> torch.Tensor:
    """(n,) bool, each True with probability 0.5, on the generator's
    device."""
    return torch.rand(n, generator=generator,
                      device=generator.device) < 0.5


def random_flip_left_right(generator: torch.Generator, images: torch.Tensor
                           ) -> torch.Tensor:
    """Per-image Bernoulli(0.5) horizontal flip (tf.image semantics)."""
    return apply_flip_mask(images, random_flip_mask(generator,
                                                    images.shape[0]))


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


def random_offsets(generator: torch.Generator, batch: int, in_h: int,
                   in_w: int, crop_h: int, crop_w: int) -> torch.Tensor:
    """(batch, 2) int32 crop offsets (y, x), uniform over the positions
    that keep the window inside, on the generator's device."""
    dev = generator.device
    ys = torch.randint(0, in_h - crop_h + 1, (batch,), generator=generator,
                       device=dev)
    xs = torch.randint(0, in_w - crop_w + 1, (batch,), generator=generator,
                       device=dev)
    return torch.stack([ys, xs], dim=-1).to(torch.int32)


def preprocess_train(generator: torch.Generator, images_u8: torch.Tensor,
                     crop_h: int, crop_w: int, norm: str = "per_image"
                     ) -> torch.Tensor:
    """Training chain: random crop -> random flip -> standardize, f32.

    Offsets and the flip mask come from ``generator`` in that order (a
    CPU generator keeps the crop free of a device sync).
    """
    n, h, w, _ = images_u8.shape
    offs = random_offsets(generator, n, h, w, crop_h, crop_w)
    x = crop_at(images_u8, offs, crop_h, crop_w).to(torch.float32)
    x = random_flip_left_right(generator, x)
    return standardize(x, norm)


def erase_with(images: torch.Tensor, active: torch.Tensor,
               frac: torch.Tensor, log_aspect: torch.Tensor,
               u_top: torch.Tensor, u_left: torch.Tensor,
               fill: torch.Tensor) -> torch.Tensor:
    """Random erasing given its draws (the deterministic part of
    ``random_erase``): image i, where ``active[i]``, gets a rectangle of
    area ``frac[i]`` * H * W and aspect exp(``log_aspect[i]``), at
    floor(u * (free rows + 1)) / floor(u * (free columns + 1)), filled
    from ``fill`` (the images' shape)."""
    n, h, w, _ = images.shape
    dev = images.device
    a = torch.exp(log_aspect)
    target = frac * h * w
    eh = torch.clamp(torch.round(torch.sqrt(target * a)), 1, h)
    ew = torch.clamp(torch.round(torch.sqrt(target / a)), 1, w)
    top = torch.floor(u_top * (h - eh + 1))
    left = torch.floor(u_left * (w - ew + 1))
    rows = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1, 1)
    cols = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w, 1)

    def col(v):
        return v.to(dev).reshape(n, 1, 1, 1)

    mask = ((rows >= col(top)) & (rows < col(top + eh))
            & (cols >= col(left)) & (cols < col(left + ew))
            & col(active).to(torch.bool))
    return torch.where(mask, fill.to(device=dev, dtype=images.dtype), images)


def random_erase(generator: torch.Generator, images: torch.Tensor,
                 prob: float = 0.5, area: tuple[float, float] = (0.02, 0.33),
                 aspect: float = 0.3) -> torch.Tensor:
    """Random erasing (Zhong et al., AAAI 2020), RE-R: with probability
    ``prob`` an image gets a rectangle of area fraction ~U(area) and
    aspect ratio ~exp(U(log a, -log a)) filled with unit gaussian noise.
    Applied after standardization. Draws (and the fill) come from
    ``generator``; ``erase_with`` does the rest."""
    n = images.shape[0]
    dev = generator.device

    def uniform(lo, hi):
        return torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo

    active = torch.rand(n, generator=generator, device=dev) < prob
    frac = uniform(area[0], area[1])
    log_a = uniform(math.log(aspect), -math.log(aspect))
    u_top = uniform(0.0, 1.0)
    u_left = uniform(0.0, 1.0)
    fill = torch.randn(images.shape, generator=generator, device=dev)
    return erase_with(images, active, frac, log_a, u_top, u_left, fill)


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
