"""Fused input kernel: u8 -> resize -> flip -> standardize, one pass.

Counterpart of ``tf_face_toolbox_tpu/ops/pallas_preprocess.py``. A
CUDA tensor goes through the hand-written kernel in
``csrc/preprocess.cu``; a CPU tensor goes through
``fused_preprocess_reference``, the plain PyTorch version (explicit f32
matrix products with the ``_bilinear_matrix`` weights) that the tests
hold against the JAX package and the kernel against on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.ops.preprocess import _bilinear_matrix


def _check_args(images: torch.Tensor, flip_mask: torch.Tensor, out_dtype):
    if images.ndim != 4:
        raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
    if tuple(flip_mask.shape) != (images.shape[0],):
        raise ValueError(f"flip_mask must be ({images.shape[0]},), got "
                         f"{tuple(flip_mask.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def fused_preprocess_reference(images: torch.Tensor, flip_mask: torch.Tensor,
                               *, out_h: int, out_w: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same math and rounding points."""
    _check_args(images, flip_mask, out_dtype)
    n, h, w, c = images.shape
    dev = images.device
    rh = torch.from_numpy(_bilinear_matrix(out_h, h)).to(dev)
    rw = torch.from_numpy(_bilinear_matrix(out_w, w)).to(dev)
    y = torch.einsum("oh,nhwc->nowc", rh, images.to(torch.float32))
    flip = flip_mask.to(device=dev, dtype=torch.bool).reshape(n, 1, 1)
    rw_sel = torch.where(flip, rw.flip(0), rw)                # (N, W', W)
    y = torch.einsum("npw,nowc->nopc", rw_sel, y)
    mean = y.mean(dim=(1, 2, 3), keepdim=True)
    var = torch.square(y - mean).mean(dim=(1, 2, 3), keepdim=True)
    adjusted = torch.clamp_min(torch.sqrt(var),
                               1.0 / np.sqrt(out_h * out_w * c))
    return ((y - mean) / adjusted).to(out_dtype)


@functools.lru_cache(maxsize=16)
def _taps(out_size: int, in_size: int, device: torch.device):
    """The nonzeros of each _bilinear_matrix row as two taps:
    (out, 2) int32 source indices and (out, 2) f32 weights on device.
    A row with one nonzero (clamped border, or no resize) gets a second
    tap of weight 0 at the same index."""
    m = _bilinear_matrix(out_size, in_size)
    idx = np.zeros((out_size, 2), np.int32)
    wt = np.zeros((out_size, 2), np.float32)
    for o in range(out_size):
        nz = np.nonzero(m[o])[0]
        if not 1 <= len(nz) <= 2:
            raise AssertionError(f"bilinear row {o} has {len(nz)} taps")
        idx[o, :] = nz[0]
        idx[o, :len(nz)] = nz
        wt[o, :len(nz)] = m[o, nz]
    return (torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device))


def fused_preprocess(images: torch.Tensor, flip_mask: torch.Tensor, *,
                     out_h: int, out_w: int,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Fused resize -> flip -> standardize for a batch of images.

    Args:
      images: (N, H, W, C) uint8 aligned face crops (the kernel takes
        uint8; the CPU path takes any castable dtype).
      flip_mask: (N,) bool/int, per-image horizontal flip.
      out_h/out_w: output resolution.
      out_dtype: torch.float32 or torch.bfloat16.

    Returns (N, out_h, out_w, C) standardized pixels in ``out_dtype``.
    A CPU tensor runs the plain version; a CUDA tensor runs the kernel.
    """
    _check_args(images, flip_mask, out_dtype)
    if images.device.type == "cpu":
        return fused_preprocess_reference(images, flip_mask, out_h=out_h,
                                          out_w=out_w, out_dtype=out_dtype)
    if images.device.type != "cuda":
        raise ValueError(f"no kernel for device {images.device}")
    if images.dtype != torch.uint8:
        raise ValueError(f"the kernel takes uint8 images, got {images.dtype}")
    from tf_face_toolbox_tpu_torch.kernels.build import check, load_library

    lib = load_library()
    n, h, w, c = images.shape
    images = images.contiguous()
    flips = flip_mask.to(device=images.device, dtype=torch.int32).contiguous()
    h_idx, h_wt = _taps(out_h, h, images.device)
    w_idx, w_wt = _taps(out_w, w, images.device)
    out = torch.empty((n, out_h, out_w, c), dtype=out_dtype,
                      device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    status = lib.tfft_preprocess(
        images.data_ptr(), flips.data_ptr(), h_idx.data_ptr(),
        h_wt.data_ptr(), w_idx.data_ptr(), w_wt.data_ptr(), out.data_ptr(),
        n, h, w, c, out_h, out_w, int(out_dtype == torch.bfloat16),
        float(1.0 / np.sqrt(out_h * out_w * c)), images.device.index or 0,
        stream)
    check(lib, status, "tfft_preprocess")
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0


def fused_eval_preprocess(images: torch.Tensor, out_h: int, out_w: int,
                          **kw) -> torch.Tensor:
    """Eval chain: resize + standardize, no flip."""
    zeros = torch.zeros((images.shape[0],), dtype=torch.int32,
                        device=images.device)
    return fused_preprocess(images, zeros, out_h=out_h, out_w=out_w, **kw)
