"""Port margin-softmax head and LR schedules vs the JAX package.

Same inputs (numpy, seeded) through ``tf_face_toolbox_tpu.ops.losses``
and ``tf_face_toolbox_tpu_torch.ops.losses``: loss values and gradients
with respect to the embeddings and the classifier (``jax.grad`` against
autograd), f32, rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.ops import losses as jl
from tf_face_toolbox_tpu.train import schedule as js
from tf_face_toolbox_tpu_torch.ops import losses as tl
from tf_face_toolbox_tpu_torch.train import schedule as ts

torch.set_num_threads(1)

N, D, C = 12, 16, 10

# (config, sub-centers, angle of each sample to its class weight or None)
CASES = {
    "softmax": (tl.MarginConfig.softmax(16.0), 1, None),
    "cosface": (tl.MarginConfig.cosface(16.0), 1, None),
    "arcface": (tl.MarginConfig.arcface(16.0), 1, None),
    "sphereface": (tl.MarginConfig.sphereface(16.0), 1, None),
    "combined": (tl.MarginConfig(scale=32.0, m1=1.1, m2=0.3, m3=0.2), 1,
                 None),
    # samples 2.8 / 2.3 rad from their class weight: m1 * theta + m2 > pi
    # takes the linear extension (and stays clear of arccos's poles)
    "arcface_past_pi": (tl.MarginConfig.arcface(16.0), 1, 2.8),
    "sphereface_past_pi": (tl.MarginConfig.sphereface(16.0, 1.5), 1, 2.3),
    "arcface_subcenters3": (tl.MarginConfig.arcface(16.0), 3, None),
    "cosface_subcenters3": (tl.MarginConfig.cosface(16.0), 3, None),
}


def _inputs(k, theta, seed=0):
    """Classifier rows of norm ~1 (gradients of order 1, so an f32
    atol of 1e-6 is meaningful), and embeddings of norm ~4 (at angle
    ``theta`` to their class's first row where given)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((C * k, D)) / np.sqrt(D)
    labels = rng.integers(0, C, N)
    emb = rng.standard_normal((N, D))
    if theta is not None:
        wt = w[labels * k]
        wt /= np.linalg.norm(wt, axis=1, keepdims=True)
        u = emb - (emb * wt).sum(1, keepdims=True) * wt
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        emb = 4.0 * (np.cos(theta) * wt + np.sin(theta) * u)
    return (emb.astype(np.float32), w.astype(np.float32),
            labels.astype(np.int32))


def _jcfg(cfg):
    return jl.MarginConfig(scale=cfg.scale, m1=cfg.m1, m2=cfg.m2, m3=cfg.m3)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(name):
    cfg, k, theta = CASES[name]
    emb, w, labels = _inputs(k, theta)

    def jloss(e, ww):
        return jl.margin_softmax_loss(e, ww, jnp.asarray(labels), _jcfg(cfg),
                                      subcenters=k)

    want, (ge, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(emb), jnp.asarray(w))
    te = torch.from_numpy(emb).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tl.margin_softmax_loss(te, tw, torch.from_numpy(labels), cfg,
                                 subcenters=k)
    got.backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.item(), float(want), **tol)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), **tol)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), **tol)
    if theta is not None:
        cos = tl.cosine_logits(te.detach(), tw.detach())
        t = torch.arccos(cos.gather(1, torch.from_numpy(labels).long()
                                    [:, None]))
        assert (cfg.m1 * t + cfg.m2 > np.pi).all()


@pytest.mark.parametrize("name", ["arcface", "combined", "sphereface"])
def test_apply_margin_clips_before_arccos(name):
    """cos(theta) past +-1 (GEMM rounding) is clipped to +-(1 - 1e-7)
    before arccos, on the target column only; other columns keep their
    raw value."""
    cfg = CASES[name][0]
    rng = np.random.default_rng(3)
    cos = rng.uniform(-1, 1, (N, C)).astype(np.float32)
    labels = rng.integers(0, C, N).astype(np.int32)
    cos[np.arange(N), labels] = np.where(np.arange(N) % 2, 1.0 + 3e-7,
                                         -1.0 - 3e-7)
    cos[0, (labels[0] + 1) % C] = 1.0 + 3e-7
    want = jl.apply_margin(jnp.asarray(cos), jnp.asarray(labels), _jcfg(cfg))
    got = tl.apply_margin(torch.from_numpy(cos), torch.from_numpy(labels),
                          cfg)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_margined_target_clamps_theta_at_zero():
    """m2 < 0 (the adaptive heads' negative margins) clamps theta_m at 0:
    cos(0) = 1."""
    cfg = tl.MarginConfig(m2=-0.5)
    cos = torch.tensor([0.999, 0.5, -0.2])
    got = tl.margined_target(cos, cfg)
    want = jl.margined_target(jnp.asarray(cos.numpy()), _jcfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got[0].item() == pytest.approx(1.0)


def test_subcenter_pool_matches_jax():
    rng = np.random.default_rng(5)
    cos = rng.uniform(-1, 1, (N, C * 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.subcenter_pool(torch.from_numpy(cos), 3).numpy(),
        np.asarray(jl.subcenter_pool(jnp.asarray(cos), 3)))
    with pytest.raises(ValueError, match="not divisible"):
        tl.subcenter_pool(torch.from_numpy(cos[:, :-1]), 3)


def test_cosine_logits_uses_the_safe_l2_normalize():
    """A zero row gives cosines of 0, not NaN (x / sqrt(sum x^2 + eps))."""
    emb = np.zeros((2, D), np.float32)
    emb[1, 0] = 1.0
    w = np.random.default_rng(0).standard_normal((C, D)).astype(np.float32)
    got = tl.cosine_logits(torch.from_numpy(emb), torch.from_numpy(w))
    want = jl.cosine_logits(jnp.asarray(emb), jnp.asarray(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert (got[0] == 0).all()


def test_margin_constructors_match_jax():
    for ctor in ("softmax", "arcface", "cosface", "sphereface"):
        a = getattr(tl.MarginConfig, ctor)(30.0)
        b = getattr(jl.MarginConfig, ctor)(30.0)
        assert (a.scale, a.m1, a.m2, a.m3) == (b.scale, b.m1, b.m2, b.m3)


def test_init_classifier_weights():
    g = torch.Generator().manual_seed(0)
    w = tl.init_classifier_weights(2000, 64, generator=g)
    assert w.shape == (2000, 64) and w.dtype == torch.float32
    assert abs(w.std().item() - 0.01) < 2e-4
    g2 = torch.Generator().manual_seed(0)
    torch.testing.assert_close(
        tl.init_classifier_weights(2000, 64, generator=g2), w,
        rtol=0, atol=0)


@pytest.mark.parametrize("warmup", [0, 7])
@pytest.mark.parametrize("boundaries", [(), (5, 20), (40, 12, 30)])
def test_staircase_matches_jax(warmup, boundaries):
    want = js.staircase(0.1, boundaries, 0.5, warmup)
    got = ts.staircase(0.1, boundaries, 0.5, warmup)
    steps = np.arange(51)
    np.testing.assert_allclose([got(s) for s in steps],
                               np.asarray([want(s) for s in steps]),
                               rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 7])
@pytest.mark.parametrize("final_scale", [0.0, 0.1])
def test_cosine_matches_jax(warmup, final_scale):
    want = js.cosine(0.2, 40, warmup, final_scale)
    got = ts.cosine(0.2, 40, warmup, final_scale)
    steps = np.arange(51)        # past total_steps: the final value holds
    np.testing.assert_allclose([got(s) for s in steps],
                               np.asarray([want(s) for s in steps]),
                               rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="total_steps"):
        ts.cosine(0.2, 0)
