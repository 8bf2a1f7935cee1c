"""Port preprocessing and the fused input kernel vs the JAX package.

The same numpy inputs go through tf_face_toolbox_tpu (the reference;
its Pallas kernel in interpret mode) and tf_face_toolbox_tpu_torch (on
the CPU, the kernel's plain PyTorch version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.ops import pallas_preprocess as jpp
from tf_face_toolbox_tpu.ops import preprocess as jpre
from tf_face_toolbox_tpu_torch.ops import fused_preprocess as tpp
from tf_face_toolbox_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at x (8 significant bits)."""
    _, exp = np.frexp(np.asarray(x, np.float32))
    return np.ldexp(1.0, exp - 8)


@pytest.mark.parametrize("out_size,in_size",
                         [(112, 120), (12, 20), (16, 10), (14, 14), (7, 120)])
def test_bilinear_matrix_identical(out_size, in_size):
    np.testing.assert_array_equal(tpre._bilinear_matrix(out_size, in_size),
                                  jpre._bilinear_matrix(out_size, in_size))


_CHAINS = {
    "resize_bilinear": (lambda x: jpre.resize_bilinear(x, 12, 10),
                        lambda x: tpre.resize_bilinear(x, 12, 10)),
    "per_image_standardization": (jpre.per_image_standardization,
                                  tpre.per_image_standardization),
    "fixed_standardization": (jpre.fixed_standardization,
                              tpre.fixed_standardization),
    "preprocess_eval": (lambda x: jpre.preprocess_eval(x, 14, 14),
                        lambda x: tpre.preprocess_eval(x, 14, 14)),
    "preprocess_eval_resize": (lambda x: jpre.preprocess_eval_resize(x, 12, 12),
                               lambda x: tpre.preprocess_eval_resize(x, 12, 12)),
}


@pytest.mark.parametrize("name", sorted(_CHAINS))
def test_preprocess_ops_match_jax(name):
    jfn, tfn = _CHAINS[name]
    x = _u8((3, 18, 16, 3), seed=4)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # rtol: resized values reach 255, where one f32 step is 1.5e-5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_flip_ops_match_jax():
    x = _u8((4, 6, 5, 3), seed=5)
    mask = np.array([1, 0, 0, 1], bool)
    np.testing.assert_array_equal(
        tpre.apply_flip_mask(torch.from_numpy(x), torch.from_numpy(mask)),
        np.asarray(jpre.apply_flip_mask(jnp.asarray(x), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        tpre.flip_left_right(torch.from_numpy(x)),
        np.asarray(jpre.flip_left_right(jnp.asarray(x))))


def test_crop_at_per_image_offsets_match_jax():
    x = _u8((3, 10, 9, 3), seed=6)
    offs = np.array([[0, 0], [2, 1], [3, 4]], np.int32)
    np.testing.assert_array_equal(
        tpre.crop_at(torch.from_numpy(x), offs, 6, 5),
        np.asarray(jpre.crop_at(jnp.asarray(x), jnp.asarray(offs), 6, 5)))


# (images shape, flip mask, out_h, out_w, out dtype) — the sizes of
# tests/test_pallas_preprocess.py
_FUSED_CASES = {
    "no_flip_20x16_to_12": ((4, 20, 16, 3), [0, 0, 0, 0], 12, 12, "f32"),
    "mixed_flip_14": ((6, 14, 14, 3), [1, 0, 1, 1, 0, 0], 14, 14, "f32"),
    "upscale_rect_16x12": ((2, 10, 8, 3), [0, 1], 16, 12, "f32"),
    "bf16_out_16_to_12": ((3, 16, 16, 3), [0, 1, 0], 12, 12, "bf16"),
    "main_path_120_to_112": ((2, 120, 120, 3), [0, 1], 112, 112, "bf16"),
}


@pytest.mark.parametrize("case", sorted(_FUSED_CASES))
def test_fused_preprocess_matches_jax_kernel(case):
    shape, mask, out_h, out_w, dt = _FUSED_CASES[case]
    x = _u8(shape, seed=len(case))
    mask = np.asarray(mask, np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jpp.fused_preprocess(
        jnp.asarray(x), jnp.asarray(mask), out_h=out_h, out_w=out_w,
        out_dtype=jdt, interpret=True), np.float32)
    got = tpp.fused_preprocess(torch.from_numpy(x), torch.from_numpy(mask),
                               out_h=out_h, out_w=out_w, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        # one bf16 step, beyond the f32 tolerance: near zero (y - mean)
        # cancels and only the absolute f32 error means anything
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-5).all()


def test_constant_image_hits_the_std_floor():
    x = np.full((2, 12, 12, 3), 9, np.uint8)
    want = np.asarray(jpp.fused_eval_preprocess(jnp.asarray(x), 12, 12,
                                                interpret=True))
    got = tpp.fused_eval_preprocess(torch.from_numpy(x), 12, 12).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, 0.0, atol=1e-5)


def test_taps_reproduce_the_bilinear_matrix():
    """The kernel's 2-tap tables are the nonzeros of each matrix row."""
    for out_size, in_size in ((112, 120), (16, 10), (14, 14), (5, 64)):
        idx, wt = tpp._taps(out_size, in_size, torch.device("cpu"))
        m = np.zeros((out_size, in_size), np.float32)
        for o in range(out_size):
            for t in range(2):
                m[o, idx[o, t]] += wt[o, t].item()
        np.testing.assert_array_equal(
            m, tpre._bilinear_matrix(out_size, in_size))


def test_fused_preprocess_rejects_bad_inputs():
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="flip_mask"):
        tpp.fused_preprocess(x, torch.zeros(3), out_h=4, out_w=4)
    with pytest.raises(ValueError, match="out_dtype"):
        tpp.fused_preprocess(x, torch.zeros(2), out_h=4, out_w=4,
                             out_dtype=torch.float16)

