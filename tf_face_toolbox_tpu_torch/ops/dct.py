"""Blockwise 8x8 DCT ops for the JPEG-domain networks (the dct stem of
``models/resnet.py`` and the token grid of ``models/vit.py``).

Counterpart of ``tf_face_toolbox_tpu/ops/dct.py``:

- ``block_dct``: pixels -> per-channel orthonormal coefficients, an
  exact, invertible re-layout (the networks' pixel input);
- ``prepare_coefficients``: a JPEG's quantized YCbCr coefficients ->
  the same tensor ``block_dct`` gives for the standardized decoded
  pixels, computed in the frequency domain (the colour conversion is a
  per-frequency channel mix; the per-image standardization takes the
  mean from the DC band and the energy from Parseval), so no pixel is
  made;
- ``flip_coefficients``: the horizontal flip in the frequency domain,
  for flip-averaged extraction of coefficients.

The basis is ``ops/jpeg.py``'s orthonormal A (forward X = A x A^T): a
constant block of value mu has DC = 8 mu, and sum x^2 = sum X^2.
"""

from __future__ import annotations

import math

import torch

from tf_face_toolbox_tpu_torch.ops.jpeg import (
    dequantize,
    device_constant,
    idct_basis,
)

# JFIF YCbCr -> RGB (rows R, G, B over Y, Cb, Cr): decode_dct's per-pixel
# mix, which commutes with the per-channel DCT
_YCC_TO_RGB = (
    (1.0, 0.0, 1.402),
    (1.0, -0.344136286, -0.714136286),
    (1.0, 1.772, 0.0),
)


def block_dct(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) float pixels -> (N, H/8, W/8, C * 64) coefficients,
    in ``x``'s dtype. The last axis orders as (C, 8u, 8v): channel-major,
    then the 8x8 frequency block row-major, as prepare_coefficients."""
    n, h, w, c = x.shape
    if h % 8 or w % 8:
        raise ValueError(f"spatial dims must be multiples of 8, got {(h, w)}")
    a = idct_basis(x.dtype, x.device)
    blocks = x.reshape(n, h // 8, 8, w // 8, 8, c).permute(0, 1, 3, 5, 2, 4)
    # X[u, v] = sum_yx A[u, y] A[v, x] x[y, x]
    z = a @ blocks @ a.T
    return z.reshape(n, h // 8, w // 8, c * 64)


def block_idct(z: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """The inverse of ``block_dct``."""
    n, bh, bw, _ = z.shape
    a = idct_basis(z.dtype, z.device)
    blocks = z.reshape(n, bh, bw, channels, 8, 8)
    x = (a.T @ blocks @ a).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, bh * 8, bw * 8, channels)


def standardize_coefficients(z: torch.Tensor) -> torch.Tensor:
    """tf.image.per_image_standardization of the pixels the coefficients
    stand for, in the frequency domain (f32): the pixel sum is 8 times
    the DC sum, the sum of squares the coefficients' (Parseval); the
    variance is clamped at 0 and the std floored at rsqrt(pixels).
    Standardizing is affine, so only the DC band shifts."""
    n, bh, bw, ck = z.shape
    c = ck // 64
    num_pix = bh * 8 * bw * 8 * c
    zf = z.to(torch.float32).reshape(n, bh, bw, c, 64)
    mean = 8.0 * zf[..., 0].sum(dim=(1, 2, 3)) / num_pix
    energy = zf.square().sum(dim=(1, 2, 3, 4)) / num_pix
    var = torch.clamp_min(energy - mean.square(), 0.0)
    adj = torch.clamp_min(torch.sqrt(var), 1.0 / math.sqrt(num_pix))
    shift = torch.zeros(64, device=z.device)
    shift[0] = 8.0
    out = (zf - mean[:, None, None, None, None] * shift) \
        / adj[:, None, None, None, None]
    return out.reshape(n, bh, bw, ck)


def prepare_coefficients(coef: torch.Tensor, qtab: torch.Tensor
                         ) -> torch.Tensor:
    """(N, bh, bw, 3, 64) int16 natural-order YCbCr coefficients + (N, 3,
    64) uint16 quantization tables (``NativeShardReader.dct_batch``) ->
    (N, bh, bw, 192) f32: what ``block_dct`` gives for the standardized
    decoded pixels, up to decode rounding (libjpeg's range limit and the
    round to uint8 are skipped; a sub-LSB difference that a per-face
    cosine of 0.999 absorbs).

    JPEG stores level-shifted components, pixel = idct(c) + 128, so RGB
    = M idct(c) + 128 (the chroma shifts cancel): on coefficients, M c
    per frequency plus 128 * 8 on the DC band.
    """
    c = dequantize(coef, qtab)
    m = device_constant(_YCC_TO_RGB, torch.float32, coef.device)
    z = torch.einsum("rc,nhwck->nhwrk", m, c)
    z[..., 0] += 128.0 * 8.0
    n, bh, bw = z.shape[:3]
    return standardize_coefficients(z.reshape(n, bh, bw, 3 * 64))


def flip_coefficients(z: torch.Tensor) -> torch.Tensor:
    """The horizontal image flip of ``block_dct`` coefficients: block
    columns reversed, odd horizontal frequencies v negated (A[v, 7 - x]
    = (-1)^v A[v, x]). Exact."""
    n, bh, bw, ck = z.shape
    sign = device_constant(tuple((-1.0) ** v for v in range(8)), z.dtype,
                           z.device)
    zz = z.flip(2).reshape(n, bh, bw, ck // 64, 8, 8) * sign
    return zz.reshape(n, bh, bw, ck)
