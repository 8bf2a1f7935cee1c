"""The port's norm-adaptive and auxiliary losses against the JAX package's.

Mirrors tests/test_adaptive_losses.py, tests/test_curricular.py and the
rest of tests/test_losses.py. The same numpy-seeded inputs go through
each JAX function and its counterpart in
``tf_face_toolbox_tpu_torch/ops/losses.py``: values, and gradients by
autograd against ``jax.grad``. The class-sharded heads
(``parallel/sharded_softmax.py``) run on four gloo ranks
(``torch_dist.Ranks``, spawned once for the module) against JAX's
``shard_map`` on the fake CPU mesh: the per-sample margins in the exact
and the sampled head (JAX's draws installed in place of the port's),
the center loss and update at data 2 x model 2, and CurricularFace with
padded classes.

Tolerances (f32 on the CPU): values rtol 1e-5, atol 1e-6; gradients
rtol 1e-4, atol 2e-6. The center update is a sum in another order
(``index_add_`` against JAX's one-hot product): it is held to f32
rounding, rtol 1e-5 and atol 1e-6 of its values.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist as td
from tf_face_toolbox_tpu.ops import losses as jl
from tf_face_toolbox_tpu.parallel import sharded_softmax as jss
from tf_face_toolbox_tpu.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
)
from tf_face_toolbox_tpu_torch.ops import losses as tl
from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss

torch.set_num_threads(1)

VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=2e-6)
SEEDS = [101, 202, 303, 404]     # the port's generator seeds by shard


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(4) as r:
        yield r


def _rand(n=16, d=32, c=40, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return ((scale * rng.normal(size=(n, d))).astype(np.float32),
            rng.normal(size=(c, d)).astype(np.float32),
            rng.integers(0, c, n).astype(np.int32))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


def _port_value_and_grad(fn, *arrays):
    """fn(*tensors) -> scalar; (its value, the gradients of each array:
    zeros where none reaches it)."""
    ts = [_t(a, grad=True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return out.item(), [np.zeros_like(a) if t.grad is None else
                        t.grad.numpy() for a, t in zip(arrays, ts)]


def _jax_value_and_grad(fn, *arrays):
    value, grads = jax.value_and_grad(fn, argnums=tuple(
        range(len(arrays))))(*map(jnp.asarray, arrays))
    return float(value), [np.asarray(g) for g in grads]


def _both(port_fn, jax_fn, *arrays):
    """Values within VALUE and gradients within GRAD of each other."""
    got, g_got = _port_value_and_grad(port_fn, *arrays)
    want, g_want = _jax_value_and_grad(jax_fn, *arrays)
    _close(got, want, VALUE)
    for a, b in zip(g_got, g_want, strict=True):
        _close(a, b, GRAD)
    return got


def _cfgs(**kw):
    return tl.MarginConfig(**kw), jl.MarginConfig(**kw)


# ------------------------------------------------------------- margins

# (cos, extra_m2, extra_m3, config): theta_m < 0 (a negative margin
# larger than theta clamps at 0), past pi (a margin that carries theta
# over pi takes the linear extension), m2 = 0 with an extra (the arccos
# path), m3 only
_TARGETS = {
    "clamp_below_zero": (np.array([0.99, 0.95, 0.9], np.float32),
                         np.array([-0.5, -0.4, -1.0], np.float32), None,
                         dict()),
    "past_pi": (np.array([-0.9, -0.99, -0.5], np.float32),
                np.array([0.8, 0.5, 1.2], np.float32), None,
                dict(m2=0.3)),
    "extra_m2_only": (np.array([0.3, -0.2, 0.7], np.float32),
                      np.array([0.2, 0.1, 0.0], np.float32), None, dict()),
    "extra_m3_sphereface": (np.array([0.3, -0.2, 0.7], np.float32), None,
                            np.array([0.2, 0.1, 0.4], np.float32),
                            dict(m1=1.35, m3=0.1)),
}


@pytest.mark.parametrize("name", list(_TARGETS))
def test_margined_target_with_extras_matches_jax(name):
    cos, m2, m3, kw = _TARGETS[name]
    pc, jc = _cfgs(**kw)
    extras = [a for a in (m2, m3) if a is not None]

    def port(c, *ex):
        it = iter(ex)
        return tl.margined_target(c, pc, next(it) if m2 is not None
                                  else None, next(it) if m3 is not None
                                  else None).sum()

    def jax_fn(c, *ex):
        it = iter(ex)
        return jl.margined_target(c, jc, next(it) if m2 is not None
                                  else None, next(it) if m3 is not None
                                  else None).sum()

    _both(port, jax_fn, cos, *extras)
    if name == "clamp_below_zero":
        # theta_m = 0 for the rows whose margin passes below -theta
        got = tl.margined_target(_t(cos), pc, _t(m2))
        assert got[2].item() == pytest.approx(1.0)
    if name == "past_pi":
        theta_m = np.arccos(cos) + 0.3 + m2
        got = tl.margined_target(_t(cos), pc, _t(m2)).numpy()
        np.testing.assert_allclose(got, -1.0 - (theta_m - np.pi), rtol=1e-5)


_EXTRAS = {"m2": (True, False, 1), "m3": (False, True, 1),
           "both": (True, True, 1), "both_subcenters": (True, True, 2)}


@pytest.mark.parametrize("name", list(_EXTRAS))
def test_margin_softmax_with_extras_matches_jax(name):
    with_m2, with_m3, k = _EXTRAS[name]
    emb, w, labels = _rand(seed=7, c=20 * k)
    rng = np.random.default_rng(8)
    m2 = rng.uniform(-0.3, 0.3, 16).astype(np.float32)
    m3 = rng.uniform(0.0, 0.4, 16).astype(np.float32)
    labels = labels % 20
    pc, jc = _cfgs(scale=48.0, m2=0.2)

    def port(e, ww):
        return tl.margin_softmax_loss(
            e, ww, torch.as_tensor(labels), pc,
            _t(m2) if with_m2 else None, _t(m3) if with_m3 else None,
            subcenters=k)

    def jax_fn(e, ww):
        return jl.margin_softmax_loss(
            e, ww, jnp.asarray(labels), jc,
            jnp.asarray(m2) if with_m2 else None,
            jnp.asarray(m3) if with_m3 else None, subcenters=k)

    _both(port, jax_fn, emb, w)


def test_constant_per_sample_margin_equals_fixed():
    emb, w, labels = map(_t, _rand())
    fixed = tl.margin_softmax_loss(emb, w, labels, tl.MarginConfig(
        scale=32.0, m2=0.3, m3=0.1))
    per_sample = tl.margin_softmax_loss(
        emb, w, labels, tl.MarginConfig(scale=32.0),
        extra_m2=torch.full((16,), 0.3), extra_m3=torch.full((16,), 0.1))
    np.testing.assert_allclose(per_sample.item(), fixed.item(), rtol=1e-6)


# ------------------------------------------------------------- MagFace

@pytest.mark.parametrize("case", ["in_range", "zero_row"])
def test_magface_matches_jax(case):
    """The margins, the regularizer and the gradient of margin loss plus
    lambda * g through the clipped norm; a zero embedding's gradient is
    finite (the eps inside the norm)."""
    emb, w, labels = _rand(n=8, scale=8.0, seed=3)
    if case == "zero_row":
        emb[2] = 0.0
    cfg_p, cfg_j = tl.MagFaceConfig(), jl.MagFaceConfig()
    pc, jc = _cfgs(scale=32.0)

    def port(e, ww):
        m2, g = tl.magface_margins(e, cfg_p)
        return (tl.margin_softmax_loss(e, ww, torch.as_tensor(labels), pc,
                                       extra_m2=m2)
                + cfg_p.lambda_g * g)

    def jax_fn(e, ww):
        m2, g = jl.magface_margins(e, cfg_j)
        return (jl.margin_softmax_loss(e, ww, jnp.asarray(labels), jc,
                                       extra_m2=m2)
                + cfg_j.lambda_g * g)

    _both(port, jax_fn, emb, w)
    m, g = tl.magface_margins(_t(emb), cfg_p)
    jm, jg = jl.magface_margins(jnp.asarray(emb), cfg_j)
    _close(m, jm, VALUE)
    _close(g.item(), float(jg), VALUE)
    grad = _port_value_and_grad(port, emb, w)[1][0]
    assert np.isfinite(grad).all()
    if case == "in_range":
        # the radial component: the loss shapes the magnitude
        radial = np.abs(np.sum(grad * emb, axis=1))
        assert np.median(radial) > 1e-6


def test_magface_margin_is_linear_in_norm():
    cfg = tl.MagFaceConfig()
    norms = np.array([10.0, 60.0, 110.0, 200.0, 3.0], np.float32)
    emb = np.zeros((5, 8), np.float32)
    emb[:, 0] = norms
    m, g = tl.magface_margins(_t(emb), cfg)
    m = m.numpy()
    assert m[0] == pytest.approx(cfg.l_m)
    assert m[1] == pytest.approx(0.5 * (cfg.l_m + cfg.u_m))
    assert m[2] == pytest.approx(cfg.u_m)
    assert m[3] == pytest.approx(cfg.u_m)
    assert m[4] == pytest.approx(cfg.l_m)
    a = np.clip(norms, cfg.l_a, cfg.u_a)
    np.testing.assert_allclose(g.item(), np.mean(1.0 / a + a / cfg.u_a ** 2),
                               rtol=1e-6)


# ------------------------------------------------------------- AdaFace

@pytest.mark.parametrize("override", [False, True])
def test_adaface_margins_match_jax(override):
    """Margins and the new statistics, with the batch's own moments or
    given ones (the trainer's global-batch override), from the official
    start and from a later state."""
    rng = np.random.default_rng(3)
    norms = np.abs(rng.normal(20.0, 5.0, size=(32,))).astype(np.float32)
    norms[0] = 150.0     # clipped at 100
    cfg_p, cfg_j = tl.AdaFaceConfig(), jl.AdaFaceConfig()
    moments = (dict(batch_mean=np.float32(18.5), batch_std=np.float32(4.25))
               if override else {})
    for mean, std in ((20.0, 100.0), (17.0, 6.0)):
        stats = {"norm_mean": np.float32(mean), "norm_std": np.float32(std)}
        got = tl.adaface_margins(
            _t(norms), {k: _t(v) for k, v in stats.items()}, cfg_p,
            **{k: _t(v) for k, v in moments.items()})
        want = jl.adaface_margins(
            jnp.asarray(norms), {k: jnp.asarray(v) for k, v in stats.items()},
            cfg_j, **{k: jnp.asarray(v) for k, v in moments.items()})
        _close(got[0], want[0], VALUE)
        _close(got[1], want[1], VALUE)
        for k in ("norm_mean", "norm_std"):
            _close(got[2][k], want[2][k], VALUE)


def test_adaface_margins_match_official_formulas():
    cfg = tl.AdaFaceConfig()
    rng = np.random.default_rng(3)
    norms = np.abs(rng.normal(20.0, 5.0, size=(32,))).astype(np.float32)
    m2, m3, new = tl.adaface_margins(_t(norms), tl.adaface_stats_init(), cfg)
    safe = np.clip(norms, 1e-3, 100.0)
    mean = cfg.t_alpha * safe.mean() + (1 - cfg.t_alpha) * 20.0
    std = cfg.t_alpha * safe.std(ddof=1) + (1 - cfg.t_alpha) * 100.0
    np.testing.assert_allclose(new["norm_mean"].item(), mean, rtol=1e-5)
    np.testing.assert_allclose(new["norm_std"].item(), std, rtol=1e-5)
    scaler = np.clip((safe - mean) / (std + cfg.eps) * cfg.h, -1.0, 1.0)
    np.testing.assert_allclose(m2.numpy(), -cfg.m * scaler, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(m3.numpy(), cfg.m * scaler + cfg.m,
                               rtol=1e-4, atol=1e-6)


def test_adaface_scaler_saturates_and_norms_are_detached():
    cfg = tl.AdaFaceConfig()
    stats = {"norm_mean": torch.tensor(20.0), "norm_std": torch.tensor(1.0)}
    m2, m3, _ = tl.adaface_margins(torch.tensor([90.0, 1e-2]), stats, cfg)
    np.testing.assert_allclose(m2.numpy(), [-cfg.m, cfg.m], atol=1e-5)
    np.testing.assert_allclose(m3.numpy(), [2 * cfg.m, 0.0], atol=1e-5)
    e = torch.tensor([[300.0, 0.0], [0.0, 0.0], [3.0, 4.0]],
                     requires_grad=True)
    norms = tl.adaface_norms(e)
    assert not norms.requires_grad
    np.testing.assert_allclose(norms.numpy(), [100.0, 1e-3, 5.0], rtol=1e-6)


# ------------------------------------------------------------ Curricular

def _np_curricular(emb, w, labels, s, m, t):
    """Transcription of the official forward (update-then-use t)."""
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    wn = w / np.linalg.norm(w, axis=1, keepdims=True)
    cos = np.clip(e @ wn.T, -1 + 1e-7, 1 - 1e-7)
    n = len(labels)
    tgt = cos[np.arange(n), labels]
    t_new = 0.01 * tgt.mean() + 0.99 * t
    th = np.arccos(tgt) + m
    target = np.where(th <= np.pi, np.cos(th), -1.0 - (th - np.pi))
    logits = np.where(cos > target[:, None], cos * (t_new + cos), cos)
    logits[np.arange(n), labels] = target
    logits = s * logits
    logits -= logits.max(axis=1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    return -logp[np.arange(n), labels].mean(), t_new


@pytest.mark.parametrize("t0,k", [(0.0, 1), (0.3, 1), (0.2, 2)])
def test_curricular_loss_matches_jax(t0, k):
    """Loss, t' and gradients; sub-centers pooled before the clip."""
    emb, w, labels = _rand(c=8 * k, seed=0)
    labels = labels % 8
    pc, jc = _cfgs(scale=32.0, m2=0.5)

    def port(e, ww):
        return tl.curricular_loss(e, ww, torch.as_tensor(labels), pc,
                                  torch.tensor(t0), subcenters=k)[0]

    def jax_fn(e, ww):
        return jl.curricular_loss(e, ww, jnp.asarray(labels), jc,
                                  jnp.float32(t0), subcenters=k)[0]

    _both(port, jax_fn, emb, w)
    t_new = tl.curricular_loss(_t(emb), _t(w), torch.as_tensor(labels), pc,
                               torch.tensor(t0), subcenters=k)[1]
    want_t = jl.curricular_loss(jnp.asarray(emb), jnp.asarray(w),
                                jnp.asarray(labels), jc, jnp.float32(t0),
                                subcenters=k)[1]
    _close(t_new.item(), float(want_t), VALUE)
    if k == 1:
        loss, oracle_t = _np_curricular(emb, w, labels, 32.0, 0.5, t0)
        np.testing.assert_allclose(port(_t(emb), _t(w)).item(), loss,
                                   rtol=1e-5)
        np.testing.assert_allclose(t_new.item(), oracle_t, rtol=1e-5)


def test_curricular_no_hard_negatives_reduces_to_arcface():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 16)).astype(np.float32)
    labels = rng.integers(0, 5, 10)
    emb = w[labels] + 0.01 * rng.normal(size=(10, 16)).astype(np.float32)
    cfg = tl.MarginConfig(scale=24.0, m2=0.3)
    got, _ = tl.curricular_loss(_t(emb), _t(w), torch.as_tensor(labels), cfg,
                                torch.tensor(0.0))
    want = tl.margin_softmax_loss(_t(emb), _t(w), torch.as_tensor(labels),
                                  cfg)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    assert tl.curricular_t_init()["t"].item() == 0.0


# -------------------------------------------------------- center loss

def test_center_loss_matches_jax():
    """Value and embedding gradient; the centers get no gradient."""
    emb, _, labels = _rand(n=12, d=8, c=5, seed=1)
    centers = np.random.default_rng(2).normal(size=(5, 8)).astype(np.float32)

    got = _both(lambda e, c: tl.center_loss(e, c, torch.as_tensor(labels)),
                lambda e, c: jl.center_loss(e, c, jnp.asarray(labels)),
                emb, centers)
    want = 0.5 * np.mean([np.sum((emb[i] - centers[y]) ** 2)
                          for i, y in enumerate(labels)])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _, (_, g_c) = _port_value_and_grad(
        lambda e, c: tl.center_loss(e, c, torch.as_tensor(labels)),
        emb, centers)
    assert not g_c.any()


@pytest.mark.parametrize("alpha", [0.5, 0.1])
def test_center_update_matches_jax(alpha):
    """JAX's one-hot segment sums against the port's ``index_add_``: f32
    rounding apart; a class absent from the batch stays."""
    emb, _, labels = _rand(n=24, d=8, c=10, seed=4)
    labels[labels == 3] = 4        # class 3 absent
    centers = np.random.default_rng(5).normal(size=(10, 8)).astype(
        np.float32)
    got = tl.center_update(_t(emb), _t(centers), torch.as_tensor(labels),
                           alpha=alpha).numpy()
    want = np.asarray(jl.center_update(jnp.asarray(emb), jnp.asarray(centers),
                                       jnp.asarray(labels), alpha=alpha))
    _close(got, want, VALUE)
    np.testing.assert_array_equal(got[3], centers[3])


def test_center_update_converges_to_class_mean():
    emb, _, labels = _rand(n=24, d=8, c=4, seed=4)
    centers = torch.zeros(4, 8)
    for _ in range(60):
        centers = tl.center_update(_t(emb), centers, torch.as_tensor(labels))
    for j in range(4):
        if (labels == j).any():
            np.testing.assert_allclose(centers[j].numpy(),
                                       emb[labels == j].mean(0), atol=1e-3)
        else:
            assert not centers[j].any()


# ------------------------------------------------------------- triplet

def _np_batch_hard(e, labels, margin):
    e = e / np.linalg.norm(e, axis=1, keepdims=True)
    n = len(labels)
    d = np.sqrt(np.maximum(((e[:, None] - e[None, :]) ** 2).sum(-1), 1e-12))
    terms, count = 0.0, 0
    for i in range(n):
        pos = [j for j in range(n) if labels[j] == labels[i] and j != i]
        neg = [j for j in range(n) if labels[j] != labels[i]]
        if not pos or not neg:
            continue
        terms += max(margin + d[i, pos].max() - d[i, neg].min(), 0.0)
        count += 1
    return terms / max(count, 1)


def _triplet_case(name):
    rng = np.random.default_rng(9)
    if name == "satisfied":
        base = np.eye(3, 8, dtype=np.float32) * 10
        e = np.repeat(base, 4, axis=0) + 0.01 * rng.normal(
            size=(12, 8)).astype(np.float32)
        return e, np.repeat(np.arange(3), 4), 0.1, True
    e = rng.normal(size=(20, 16)).astype(np.float32)
    if name == "singletons":
        return e[:6], np.arange(6), 0.3, True
    labels = rng.integers(0, 5, 20)
    return e, labels, 0.3, name != "unnormalized"


@pytest.mark.parametrize("name", ["random", "singletons", "satisfied",
                                  "unnormalized"])
def test_batch_hard_triplet_matches_jax(name):
    """Value and gradient (the Gram-form distances); singleton anchors
    leave the mean (all singletons: 0, not NaN); a satisfied margin is
    0."""
    e, labels, margin, normalized = _triplet_case(name)
    got = _both(
        lambda x: tl.batch_hard_triplet_loss(x, torch.as_tensor(labels),
                                             margin, normalized),
        lambda x: jl.batch_hard_triplet_loss(x, jnp.asarray(labels), margin,
                                             normalized), e)
    if name in ("singletons", "satisfied"):
        assert got == 0.0
    elif name == "random":
        np.testing.assert_allclose(got, _np_batch_hard(e, labels, margin),
                                   rtol=1e-4)


# ----------------------------------------------- sharded, on gloo ranks

def _jax_mesh(data, model):
    return create_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])


def _run(ranks, model, **kw):
    """``td.sharded_head`` on the grid: (mean loss over the model rows,
    emb gradient summed over each row, w gradient of data row 0)."""
    out = ranks.run(td.sharded_head, model=model, **kw)
    data = 4 // model
    rows = [out[d * model:(d + 1) * model] for d in range(data)]
    for row in rows:
        assert len({r[0] for r in row}) == 1
    return (float(np.mean([row[0][0] for row in rows])),
            np.concatenate([sum(r[1] for r in row) for row in rows]),
            np.concatenate([r[2] for r in rows[0]]))


def _jax_sharded(fn, emb, w, labels, *extras):
    """JAX's value and (emb, w) gradients of ``fn(e, w, y, *extras)`` under
    shard_map on a (1, 4) mesh."""
    f = jax.jit(shard_map(
        fn, mesh=_jax_mesh(1, 4),
        in_specs=(P(), P(MODEL_AXIS, None), P(), *[P()] * len(extras)),
        out_specs=P()))
    y = jnp.asarray(labels)
    ex = [jnp.asarray(a) for a in extras]
    value, grads = jax.value_and_grad(
        lambda e, w_: f(e, w_, y, *ex), argnums=(0, 1))(jnp.asarray(emb),
                                                         jnp.asarray(w))
    return float(value), *map(np.asarray, grads)


def _assert_head(got, want):
    _close(got[0], want[0], VALUE)
    _close(got[1], want[1], GRAD)
    _close(got[2], want[2], GRAD)


@pytest.mark.parametrize("padded", [False, True])
def test_sharded_extras_exact_head_matches_jax(ranks, padded):
    """MagFace/AdaFace-style per-sample margins in the exact head on a
    (1, 4) grid: JAX's loss and gradients; 37 classes padded to 40."""
    emb, w, labels = _rand(seed=7, c=37 if padded else 40)
    if padded:
        w = np.concatenate([w, np.random.default_rng(2).normal(
            size=(3, 32)).astype(np.float32)])
    rng = np.random.default_rng(8)
    m2 = rng.uniform(-0.3, 0.3, 16).astype(np.float32)
    m3 = rng.uniform(0.0, 0.4, 16).astype(np.float32)
    pc, jc = _cfgs(scale=48.0, m2=0.1)
    total = 37 if padded else None
    got = _run(ranks, 4, emb=emb, w=w, labels=labels,
               margin=dataclasses.asdict(pc), total_classes=total,
               extra_m2=m2, extra_m3=m3)
    want = _jax_sharded(
        lambda e, w_, y, a, b: jss.sharded_margin_softmax_loss(
            e, w_, y, jc, axis_name=MODEL_AXIS, total_classes=total,
            extra_m2=a, extra_m3=b), emb, w, labels, m2, m3)
    _assert_head(got, want)
    # and the one-device loss with the same margins
    one = tl.margin_softmax_loss(_t(emb), _t(w[:37] if padded else w),
                                 torch.as_tensor(labels), pc, _t(m2), _t(m3))
    np.testing.assert_allclose(got[0], one.item(), rtol=1e-5)


def test_sharded_extras_sampled_head_matches_jax(ranks):
    """Half of each shard sampled, JAX's draws installed, per-sample
    margins in: the port's loss and gradients are JAX's."""
    emb, w, labels = _rand(seed=5, d=16, c=128)
    rng = np.random.default_rng(6)
    m2 = rng.uniform(-0.2, 0.3, 16).astype(np.float32)
    m3 = rng.uniform(0.0, 0.4, 16).astype(np.float32)
    pc, jc = _cfgs(scale=32.0)
    key = jax.random.key(11)
    draws = {SEEDS[m]: np.asarray(jax.random.uniform(
        jax.random.fold_in(key, m), (32,))) for m in range(4)}
    got = _run(ranks, 4, emb=emb, w=w, labels=labels,
               margin=dataclasses.asdict(pc), budget=16, seeds=SEEDS,
               draws=draws, extra_m2=m2, extra_m3=m3)
    want = _jax_sharded(
        lambda e, w_, y, a, b: jss.sampled_sharded_margin_softmax_loss(
            e, w_, y, jc, key, 16, axis_name=MODEL_AXIS, extra_m2=a,
            extra_m3=b), emb, w, labels, m2, m3)
    _assert_head(got, want)


def test_sharded_center_loss_and_update_at_two_by_two(ranks):
    """Data 2 x model 2: the loss and its emb gradient are JAX's, and
    each shard's update, taken over the global batch (the sums over the
    data axis), is JAX's on both of its data ranks, at f32 rounding."""
    emb, _, labels = _rand(n=16, d=8, c=40, seed=5)
    labels[:4] = labels[8:12]      # classes in both data blocks
    centers = np.random.default_rng(6).normal(size=(40, 8)).astype(
        np.float32)
    out = ranks.run(td.center_head, model=2, emb=emb, centers=centers,
                    labels=labels, alpha=0.5)

    specs = (P(DATA_AXIS), P(MODEL_AXIS, None), P(DATA_AXIS))
    f_loss = shard_map(
        lambda e, c, y: jax.lax.pmean(
            jss.sharded_center_loss(e, c, y, MODEL_AXIS), DATA_AXIS),
        mesh=_jax_mesh(2, 2), in_specs=specs, out_specs=P(), check_vma=False)
    f_update = jax.jit(shard_map(
        lambda e, c, y: jss.sharded_center_update(
            e, c, y, data_axis=DATA_AXIS, model_axis=MODEL_AXIS, alpha=0.5),
        mesh=_jax_mesh(2, 2), in_specs=specs,
        out_specs=P(MODEL_AXIS, None), check_vma=False))
    e, c, y = map(jnp.asarray, (emb, centers, labels))
    loss, g_e = jax.value_and_grad(lambda ee: f_loss(ee, c, y))(e)
    new = np.asarray(f_update(e, c, y))
    _close(np.mean([out[0][0], out[2][0]]), float(loss), VALUE)
    # each data block's gradient, summed over its model row; the global
    # loss is the mean of the two rows'
    g_got = np.concatenate([out[0][1] + out[1][1], out[2][1] + out[3][1]])
    _close(g_got / 2, np.asarray(g_e), GRAD)
    for m in range(2):
        np.testing.assert_array_equal(out[m][2], out[2 + m][2])
    _close(np.concatenate([out[0][2], out[1][2]]), new, VALUE)
    want = tl.center_update(_t(emb), _t(centers), torch.as_tensor(labels))
    _close(np.concatenate([out[0][2], out[1][2]]), want.numpy(), VALUE)


def _jax_curricular(emb, w, labels, cfg, t, total, k, data):
    """JAX's (loss: the mean over the data rows, t', emb gradient, w
    gradient) on a (data, 4 / data) mesh."""
    def local(e, w_, y):
        loss, t_new = jss.sharded_curricular_loss(
            e, w_, y, cfg, jnp.float32(t), axis_name=MODEL_AXIS,
            total_classes=total, subcenters=k,
            data_axis=DATA_AXIS if data > 1 else None)
        return jax.lax.pmean(loss, DATA_AXIS), t_new

    f = shard_map(local, mesh=_jax_mesh(data, 4 // data),
                  in_specs=(P(DATA_AXIS), P(MODEL_AXIS, None), P(DATA_AXIS)),
                  out_specs=(P(), P()), check_vma=False)
    y = jnp.asarray(labels)
    (loss, t_new), grads = jax.value_and_grad(
        lambda e, w_: f(e, w_, y), argnums=(0, 1), has_aux=True)(
            jnp.asarray(emb), jnp.asarray(w))
    return float(loss), float(t_new), *map(np.asarray, grads)


@pytest.mark.parametrize("data,k", [(1, 1), (1, 2), (2, 1)])
def test_sharded_curricular_padded_classes_matches_jax(ranks, data, k):
    """13 classes padded to 16 (K sub-centers each) over the model axis:
    loss, t' and gradients are JAX's; at data 2 t' comes from the global
    batch (r averaged over the data axis). At data 1 the loss is the
    one-device loss over the 13 real classes."""
    model = 4 // data
    emb, w, labels = _rand(n=16, c=16 * k, seed=4)
    labels = np.clip(labels % 16, 0, 12)
    pc, jc = _cfgs(scale=24.0, m2=0.4)
    out = ranks.run(td.curricular_head, model=model, emb=emb, w=w,
                    labels=labels, margin=dataclasses.asdict(pc), t=0.1,
                    total_classes=13, subcenters=k, data_sync=data > 1)
    rows = [out[d * model:(d + 1) * model] for d in range(data)]
    for r in out:
        assert r[1] == out[0][1]          # one t' on every rank
    # the global loss is the mean of the rows': so are its gradients
    loss = float(np.mean([row[0][0] for row in rows]))
    g_e = np.concatenate([sum(r[2] for r in row) for row in rows]) / data
    g_w = sum(np.concatenate([r[3] for r in row]) for row in rows) / data
    want = _jax_curricular(emb, w, labels, jc, 0.1, 13, k, data)
    _close(loss, want[0], VALUE)
    _close(out[0][1], want[1], VALUE)
    _close(g_e, want[2], GRAD)
    _close(g_w, want[3], GRAD)
    if data == 1:
        one, t_one = tl.curricular_loss(_t(emb), _t(w[:13 * k]),
                                        torch.as_tensor(labels), pc,
                                        torch.tensor(0.1), subcenters=k)
        np.testing.assert_allclose(loss, one.item(), rtol=1e-5)
        np.testing.assert_allclose(out[0][1], t_one.item(), rtol=1e-6)
