"""Port train-time preprocessing vs the JAX package.

The two packages draw from different random streams (threefry keys /
``torch.Generator``), so the draws are injected: crop offsets and flip
masks into ``crop_at`` / ``apply_flip_mask`` / ``standardize``, and
random erasing's values (drawn with the JAX function's own key split)
into the port's ``erase_with``. The trainer's augmentation runs kernel
1 at an identity resize (crop to 112, flip, standardize): its plain
version is held against the JAX kernel in interpret mode, and its
launch plan's tables (replayed in numpy) against the plain version.
f32 atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_preprocess import _bf16_ulp, _emulate, _u8
from tf_face_toolbox_tpu.ops import pallas_preprocess as jfp
from tf_face_toolbox_tpu.ops import preprocess as jpp
from tf_face_toolbox_tpu_torch.ops import fused_preprocess as tfp
from tf_face_toolbox_tpu_torch.ops import preprocess as tpp
from tf_face_toolbox_tpu_torch.train.trainer import TrainConfig, _augment

torch.set_num_threads(1)


def test_random_offsets_cover_the_valid_range():
    g = torch.Generator().manual_seed(0)
    offs = tpp.random_offsets(g, 4000, 20, 17, 16, 12)
    assert offs.shape == (4000, 2) and offs.dtype == torch.int32
    ys, xs = offs[:, 0].numpy(), offs[:, 1].numpy()
    assert set(ys) == set(range(5)) and set(xs) == set(range(6))
    # the JAX function's range, for comparison
    j = np.asarray(jpp.random_offsets(jax.random.key(0), 4000, 20, 17, 16, 12))
    assert set(j[:, 0]) == set(ys) and set(j[:, 1]) == set(xs)


def test_random_flip_mask_is_fair_and_seeded():
    m = tpp.random_flip_mask(torch.Generator().manual_seed(1), 20000)
    assert m.dtype == torch.bool and abs(m.float().mean().item() - 0.5) < 0.02
    again = tpp.random_flip_mask(torch.Generator().manual_seed(1), 20000)
    assert torch.equal(m, again)


@pytest.mark.parametrize("norm", ["per_image", "fixed"])
def test_crop_flip_standardize_matches_jax(norm):
    x = _u8((6, 20, 18, 3), seed=3)
    rng = np.random.default_rng(4)
    offs = np.stack([rng.integers(0, 5, 6), rng.integers(0, 3, 6)],
                    -1).astype(np.int32)
    mask = np.array([1, 0, 0, 1, 1, 0], bool)
    want = jpp.standardize(jpp.apply_flip_mask(
        jpp.crop_at(jnp.asarray(x), jnp.asarray(offs), 16, 16)
        .astype(jnp.float32), jnp.asarray(mask)), norm)
    got = tpp.standardize(tpp.apply_flip_mask(
        tpp.crop_at(torch.from_numpy(x), offs, 16, 16).to(torch.float32),
        torch.from_numpy(mask)), norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_preprocess_train_draws_offsets_then_flips():
    """preprocess_train = crop at the generator's offsets, flip by its
    next draw, standardize (the order the trainer's kernel route
    uses)."""
    x = torch.from_numpy(_u8((8, 20, 20, 3), seed=5))
    got = tpp.preprocess_train(torch.Generator().manual_seed(9), x, 16, 16)
    g = torch.Generator().manual_seed(9)
    offs = tpp.random_offsets(g, 8, 20, 20, 16, 16)
    mask = tpp.random_flip_mask(g, 8)
    want = tpp.per_image_standardization(tpp.apply_flip_mask(
        tpp.crop_at(x, offs, 16, 16).float(), mask))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_identity_resize_flip_path_matches_jax_kernel(dt):
    """The trainer's kernel call: a crop at the output size (identity
    resize, every second tap weight 0), random flips; the port on the
    CPU (its plain version) vs the JAX kernel in interpret mode."""
    x = _u8((5, 24, 24, 3), seed=11)
    mask = np.array([1, 0, 1, 1, 0], np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jfp.fused_preprocess(
        jnp.asarray(x), jnp.asarray(mask), out_h=24, out_w=24,
        out_dtype=jdt, interpret=True), np.float32)
    got = tfp.fused_preprocess(torch.from_numpy(x), torch.from_numpy(mask),
                               out_h=24, out_w=24, out_dtype=tdt)
    assert got.dtype == tdt
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-5).all()


def test_train_shape_launch_plan():
    """(256, 112, 112, 3) u8 -> bf16 112: identity taps (second weight
    0), one chunk a band, 16-byte images (37,632 bytes), so bulk
    copies and a persisting plan; its tables, replayed, give the plain
    version with flips."""
    plan = tfp.launch_plan(256, 112, 112, 3, 112, 112, torch.bfloat16)
    idx, wt = tfp._taps_np(112, 112)
    assert (idx[:, 0] == np.arange(112)).all() and (wt[:, 1] == 0).all()
    assert 112 * 112 * 3 % 16 == 0 and plan["copy"] == "bulk"
    assert len(plan["chunks"]) == plan["cluster"] and plan["persist"]
    assert all(r[3] == 0 for r in plan["rows"])     # no second row tap
    x = _u8((2, 112, 112, 3), seed=2)
    flips = np.array([1, 0])
    got = _emulate(x, flips, plan, 112, 112)
    want = tfp.fused_preprocess_reference(
        torch.from_numpy(x), torch.from_numpy(flips), out_h=112,
        out_w=112).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_erase_draws(key, n, shape, prob, area=(0.02, 0.33), aspect=0.3):
    """random_erase's draws, with its own key split."""
    k_on, k_area, k_asp, k_top, k_left, k_fill = jax.random.split(key, 6)
    return [np.array(v) for v in (
        jax.random.bernoulli(k_on, prob, (n,)),
        jax.random.uniform(k_area, (n,), minval=area[0], maxval=area[1]),
        jax.random.uniform(k_asp, (n,), minval=jnp.log(aspect),
                           maxval=-jnp.log(aspect)),
        jax.random.uniform(k_top, (n,)),
        jax.random.uniform(k_left, (n,)),
        jax.random.normal(k_fill, shape, jnp.float32))]


@pytest.mark.parametrize("seed,prob", [(0, 0.5), (1, 1.0), (2, 0.8)])
def test_erase_with_matches_jax_random_erase(seed, prob):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, 14, 12, 3)).astype(np.float32)
    key = jax.random.key(seed)
    want = np.asarray(jpp.random_erase(key, jnp.asarray(x), prob))
    draws = _jax_erase_draws(key, 16, x.shape, prob)
    got = tpp.erase_with(torch.from_numpy(x),
                         *(torch.from_numpy(v) for v in draws)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).any(axis=(1, 2, 3)).sum() == draws[0].sum()


def test_random_erase_probability_and_seed():
    x = torch.zeros((64, 10, 10, 3))
    assert torch.equal(tpp.random_erase(torch.Generator().manual_seed(0), x,
                                        0.0), x)
    out = tpp.random_erase(torch.Generator().manual_seed(0), x, 1.0)
    assert (out != 0).any(dim=(1, 2, 3)).all()
    again = tpp.random_erase(torch.Generator().manual_seed(0), x, 1.0)
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trainer_kernel_route_equals_plain_route(dtype):
    """The trainer's two augment routes draw the same offsets and flips
    from one generator state: fused_preprocess on the crop (here its
    plain version) and the plain chain agree."""
    x = torch.from_numpy(_u8((8, 20, 20, 3), seed=6))
    kw = dict(image_size=16, crop_from=20, dtype=dtype)
    kern = _augment(TrainConfig(**kw, pallas_input=True), x,
                    torch.Generator().manual_seed(4), None)
    plain = _augment(TrainConfig(**kw), x, torch.Generator().manual_seed(4),
                     None)
    assert kern.dtype == dtype
    got, want = kern.float().numpy(), plain.to(dtype).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:       # one bf16 step beyond the f32 tolerance
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-5).all()


def test_pallas_input_with_fixed_norm_takes_the_plain_chain(caplog):
    """The kernel bakes per-image standardization in; with input_norm
    "fixed" the trainer warns and augments through the plain chain (the
    reference's rule), (x - 127.5) / 127.5 of the crop."""
    from tf_face_toolbox_tpu_torch.train.trainer import (
        create_train_state, make_train_step)

    cfg = TrainConfig(network="resnet_tiny", num_classes=4, embedding_dim=8,
                      image_size=16, crop_from=20, global_batch=4,
                      pallas_input=True, input_norm="fixed")
    x = torch.from_numpy(_u8((4, 20, 20, 3), seed=8))
    got = _augment(cfg, x, torch.Generator().manual_seed(2), None)
    g = torch.Generator().manual_seed(2)
    offs = tpp.random_offsets(g, 4, 20, 20, 16, 16)
    mask = tpp.random_flip_mask(g, 4)
    want = (tpp.apply_flip_mask(tpp.crop_at(x, offs, 16, 16).float(), mask)
            - 127.5) / 127.5
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    state, net = create_train_state(cfg, 0, device="cpu")
    with caplog.at_level("WARNING"):
        make_train_step(net, cfg, state)
    assert "per_image standardization only" in caplog.text
