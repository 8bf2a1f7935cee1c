"""The back half of a JPEG decode on the device: dequantize, inverse DCT,
YCbCr -> RGB.

Counterpart of ``tf_face_toolbox_tpu/ops/jpeg_tpu.py``. The native
loader stops after entropy decode (``data/native.NativeShardReader.
dct_batch``: quantized coefficients and quantization tables) and
``decode_dct`` finishes the image: one multiply, two 8x8 matmuls a
block, the level shift and the JFIF colour conversion, round and clip
to uint8. The result is within one LSB of libjpeg's integer IDCT and
feeds the same preprocess chain as decoded pixels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.cache
def _idct_matrix() -> np.ndarray:
    """8-point DCT-II basis A with A[u, y] = c(u) cos((2y+1)u pi/16):
    forward X = A x A^T, inverse x = A^T X A (A is orthonormal)."""
    u = np.arange(8)[:, None]
    y = np.arange(8)[None, :]
    a = np.cos((2 * y + 1) * u * np.pi / 16)
    a[0] *= 1.0 / np.sqrt(2)
    return (a * 0.5).astype(np.float32)


@functools.cache
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """A constant tensor, made once a dtype and device: a copy from the
    host in every call would wait for the card's queue to drain."""
    return torch.tensor(values, dtype=dtype, device=device)


def idct_basis(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``_idct_matrix()`` as a tensor on ``device``."""
    return device_constant(tuple(map(tuple, _idct_matrix().tolist())), dtype,
                           device)


def dequantize(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """(N, bh, bw, C, 64) coefficients times their (N, C, 64) tables, f32."""
    return coef.to(torch.float32) * qtab.to(torch.float32)[:, None, None]


def decode_dct(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """(N, bh, bw, 3, 64) int16 coefficients + (N, 3, 64) uint16
    quantization tables -> (N, 8 bh, 8 bw, 3) uint8 RGB.

    Natural-order coefficients and tables, as libjpeg stores them. Each
    component is range-limited to [0, 255] before the colour
    conversion, as libjpeg does (without it, IDCT overshoot at hard
    edges would leave its output by more than 2 LSB); the RGB values
    are rounded half to even, then clipped.
    """
    n, bh, bw = coef.shape[:3]
    blocks = dequantize(coef, qtab).reshape(n, bh, bw, 3, 8, 8)
    a = idct_basis(torch.float32, coef.device)
    # x[y, x] = sum_uv A[u, y] A[v, x] X[u, v]
    pix = torch.clamp(a.T @ blocks @ a + 128.0, 0.0, 255.0)
    img = pix.permute(0, 1, 4, 2, 5, 3).reshape(n, bh * 8, bw * 8, 3)
    y, cb, cr = img[..., 0], img[..., 1] - 128.0, img[..., 2] - 128.0
    rgb = torch.stack([y + 1.402 * cr,
                       y - 0.344136286 * cb - 0.714136286 * cr,
                       y + 1.772 * cb], dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)
