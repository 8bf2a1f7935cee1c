"""Face alignment: 5-landmark similarity transform to the canonical crop.

Counterpart of ``tf_face_toolbox_tpu/ops/align.py``. Given the standard
5 facial landmarks (eye centers, nose tip, mouth corners), estimate the
least-squares similarity transform onto the ArcFace 112x112 template
(Umeyama 1991, the closed form skimage.transform.SimilarityTransform
uses) and warp.

Two warps with one semantics:
- :func:`warp_similarity`: vectorized float64 numpy, the pack-time host
  path (``cli.pack --landmarks`` aligns while packing through
  :func:`align_face`, so packing never runs a device warp);
- :func:`warp_similarity_torch`: a 4-tap bilinear gather on a torch
  device, the twin of JAX's ``warp_similarity_jax`` (its
  ``map_coordinates(order=1, cval=0)`` arithmetic, bit for bit).

Both sample bilinearly and fill outside the source with 0, matching
cv2.warpAffine's defaults. ``F.grid_sample`` is not used: its
coordinate normalisation to [-1, 1] and back moves the taps.
"""

from __future__ import annotations

import numpy as np
import torch

# The canonical ArcFace/InsightFace 5-point destination template for a
# 112x112 crop: [left eye, right eye, nose, left mouth, right mouth]
# in (x, y) pixel coordinates.
ARCFACE_TEMPLATE_112 = np.array(
    [[38.2946, 51.6963],
     [73.5318, 51.5014],
     [56.0252, 71.7366],
     [41.5493, 92.3655],
     [70.7299, 92.2041]], np.float64)


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform src → dst (Umeyama 1991).

    src, dst: (K, 2) point sets in (x, y). Returns the (2, 3) matrix M
    with ``dst ≈ M @ [x, y, 1]ᵀ`` (rotation+uniform scale+translation;
    reflections are excluded via the determinant correction).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 2:
        raise ValueError(f"point sets must both be (K, 2); got "
                         f"{src.shape} vs {dst.shape}")
    k = src.shape[0]
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / k
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt)) or 1.0
    diag = np.array([1.0, d])
    rot = u @ np.diag(diag) @ vt
    var_s = (sc ** 2).sum() / k
    if var_s == 0:
        raise ValueError("degenerate source landmarks (zero variance)")
    scale = (s * diag).sum() / var_s
    t = mu_d - scale * rot @ mu_s
    return np.hstack([scale * rot, t[:, None]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """(2,3) affine → its (2,3) inverse."""
    a = np.vstack([m, [0.0, 0.0, 1.0]])
    return np.linalg.inv(a)[:2]


def warp_similarity(image: np.ndarray, matrix: np.ndarray,
                    out_h: int, out_w: int) -> np.ndarray:
    """Warp ``image`` (H, W, C) uint8 by the src→dst ``matrix`` (2, 3);
    output (out_h, out_w, C) uint8. Bilinear, zero fill outside."""
    image = np.asarray(image)
    h, w = image.shape[:2]
    inv = _invert_affine(np.asarray(matrix, np.float64))
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx, fy = sx - x0, sy - y0
    out = np.zeros((out_h, out_w) + image.shape[2:], np.float64)
    img = image.astype(np.float64)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            wgt = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                   * valid)
            tap = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
            out += tap * wgt[..., None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _sample_coordinates(matrix: np.ndarray, out_h: int, out_w: int
                        ) -> tuple[np.ndarray, np.ndarray]:
    """The source (y, x) of every output pixel as JAX's warp makes them:
    ``inv`` in float64, the grid in float32, the sum rounded to float32
    once (``jnp.asarray`` of a float64 array)."""
    inv = _invert_affine(np.asarray(matrix, np.float64))
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float32)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    return (np.asarray(sy, np.float32), np.asarray(sx, np.float32))


def warp_similarity_torch(image, matrix, out_h: int, out_w: int, *,
                          device=None) -> torch.Tensor:
    """Device twin of :func:`warp_similarity`: the arithmetic of JAX's
    ``warp_similarity_jax`` (``map_coordinates`` at order 1, cval 0).

    ``image``: (H, W, C) or (N, H, W, C) uint8, a numpy array or a
    tensor; ``matrix``: (2, 3) src→dst, or (N, 2, 3) one an image, a
    host constant (alignment geometry is per-image metadata). Returns
    uint8 (out_h, out_w, C) (or (N, ...)) on ``device``: the image
    tensor's device by default, the card for a host array.

    Per output pixel and channel, in f32: ``lower = floor(c)``, ``w1 =
    c - lower``, ``w0 = 1 - w1`` on each axis; each of the four taps,
    in ``itertools.product`` order (y0, x0), (y0, x1), (y1, x0), (y1,
    x1), is ``(wy * wx) * v``, with ``v`` 0 where the tap's index lies
    outside the image; the taps summed left to right, then rounded half
    to even, clipped and cast to uint8.
    """
    if device is None:
        device = image.device if torch.is_tensor(image) else "cuda"
    img = torch.as_tensor(image).to(device)
    mats = np.asarray(matrix, np.float64)
    single = img.dim() == 3
    if single:
        img = img[None]
    if mats.ndim == 2:
        mats = np.broadcast_to(mats, (img.shape[0], 2, 3))
    if mats.shape != (img.shape[0], 2, 3):
        raise ValueError(f"matrix must be (2, 3) or (N, 2, 3) for "
                         f"{img.shape[0]} images; got {mats.shape}")
    n, h, w, c = img.shape
    coords = [_sample_coordinates(m, out_h, out_w) for m in mats]
    sy = torch.from_numpy(np.stack([cy for cy, _ in coords])).to(device)
    sx = torch.from_numpy(np.stack([cx for _, cx in coords])).to(device)
    src = img.to(torch.float32).reshape(n * h * w, c)
    base = (torch.arange(n, device=device) * (h * w)).view(n, 1, 1)

    def taps(coord: torch.Tensor):
        lower = torch.floor(coord)
        upper_weight = coord - lower
        index = lower.to(torch.int32)
        return ((index, 1 - upper_weight), (index + 1, upper_weight))

    out = None
    for (yi, wy), (xi, wx) in ((a, b) for a in taps(sy) for b in taps(sx)):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        flat = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        value = src[flat].masked_fill_(~valid[..., None], 0.0)
        term = (wy * wx)[..., None] * value
        out = term if out is None else out + term
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return out[0] if single else out


def align_face(image: np.ndarray, landmarks: np.ndarray,
               size: int = 112) -> np.ndarray:
    """Align a face to the ArcFace template, scaled to ``size``².

    ``landmarks``: (5, 2) (x, y) points — left eye, right eye, nose,
    left mouth corner, right mouth corner — in ``image`` coordinates.
    """
    landmarks = np.asarray(landmarks, np.float64)
    if landmarks.shape != (5, 2):
        raise ValueError(f"landmarks must be (5, 2) (x, y); got "
                         f"{landmarks.shape}")
    template = ARCFACE_TEMPLATE_112 * (size / 112.0)
    m = umeyama(landmarks, template)
    return warp_similarity(image, m, size, size)
