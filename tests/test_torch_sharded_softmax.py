"""The port's class-sharded head (``parallel/sharded_softmax.py``) on four
gloo ranks, against the JAX package's ``sharded_softmax.py`` under
``shard_map`` on the fake CPU mesh and against the one-device loss.

Mirrors tests/test_parallel.py: the exact head equals the one-device
loss (loss and gradients; padded classes; a pad whose logit overflows
``exp`` gives no NaN); the sampled head at full budget is exact, its
gradient's mean over draws is the exact gradient, pads never enter its
denominator, its budget is checked; with the compact exchange
(``data_sync``) at full budget it equals the exact data-parallel
gradient, and at a partial budget it is the same on a data axis of 1, 2
and 4. Where the draws matter, JAX's own (``jax.random.uniform`` of the
same keys) are installed in place of the port's ``draw_uniforms``, and
loss and gradients then match JAX's at f32 rtol 1e-4, atol 2e-6. The
ranks form a (1, 4) grid, or (2, 2) for the data axis; the four are
spawned once for the module (``torch_dist.Ranks``).
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
from tf_face_toolbox_tpu.ops.losses import MarginConfig as JaxMargin
from tf_face_toolbox_tpu.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    create_mesh,
)
from tf_face_toolbox_tpu.parallel.sharded_softmax import (
    sampled_sharded_margin_softmax_loss as jax_sampled,
    sharded_margin_softmax_loss as jax_sharded,
)
from tf_face_toolbox_tpu_torch.ops.losses import (
    MarginConfig,
    margin_softmax_loss,
)
from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss

torch.set_num_threads(1)

MARGINS = {"softmax": MarginConfig.softmax(),
           "arcface": MarginConfig.arcface(),
           "cosface": MarginConfig.cosface()}
SEEDS = [101, 202, 303, 404]     # the port's generator seeds by shard


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(4) as r:
        yield r


def _data(seed, n, d, c, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.normal(size=(n, d))).astype(np.float32), \
        (scale * rng.normal(size=(c, d))).astype(np.float32), \
        rng.integers(0, c, n)


def _one_device(emb, w, labels, cfg):
    """The port's one-device loss and its (emb, w) gradients."""
    e = torch.tensor(emb, requires_grad=True)
    ww = torch.tensor(w, requires_grad=True)
    loss = margin_softmax_loss(e, ww, torch.as_tensor(labels), cfg)
    loss.backward()
    return loss.item(), e.grad.numpy(), ww.grad.numpy()


def _run(ranks, model, emb, w, labels, cfg, **kw):
    """The head on the grid: (loss, emb gradient, global w gradient), the
    emb gradient summed over each model row, the w gradient joined from
    data row 0's shards; and the per-rank results."""
    out = ranks.run(td.sharded_head, model=model, emb=emb, w=w,
                    labels=labels, margin=dataclasses.asdict(cfg), **kw)
    data = 4 // model
    rows = [out[d * model:(d + 1) * model] for d in range(data)]
    for row in rows:       # one loss a model row
        assert len({r[0] for r in row}) == 1
    loss = float(np.mean([row[0][0] for row in rows]))
    g_e = np.concatenate([sum(r[1] for r in row) for row in rows])
    g_w = np.concatenate([r[2] for r in rows[0]])
    return loss, g_e, g_w, out


def _jax_mesh(data, model):
    return create_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])


def _jax_exact(emb, w, labels, cfg, total_classes=None):
    mesh = _jax_mesh(1, 4)
    f = jax.jit(shard_map(
        lambda e, w_, y: jax_sharded(e, w_, y, JaxMargin(
            **dataclasses.asdict(cfg)), axis_name=MODEL_AXIS,
            total_classes=total_classes),
        mesh=mesh, in_specs=(P(), P(MODEL_AXIS, None), P()), out_specs=P()))
    y = jnp.asarray(labels)
    loss, (g_e, g_w) = jax.value_and_grad(
        lambda e, w_: f(e, w_, y), argnums=(0, 1))(jnp.asarray(emb),
                                                     jnp.asarray(w))
    return float(loss), np.asarray(g_e), np.asarray(g_w)


def _close(got, want, rtol=1e-4, atol=2e-6):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(MARGINS))
def test_sharded_softmax_matches_single_device(ranks, name):
    """Loss and gradients are the one-device math (rtol 1e-5 / atol 1e-5,
    tests/test_parallel.py's bounds) and JAX's sharded head's."""
    cfg = MARGINS[name]
    emb, w, labels = _data(0, 16, 32, 40)
    loss, g_e, g_w, _ = _run(ranks, 4, emb, w, labels, cfg)
    one = _one_device(emb, w, labels, cfg)
    np.testing.assert_allclose(loss, one[0], rtol=1e-5)
    np.testing.assert_allclose(g_e, one[1], atol=1e-5)
    np.testing.assert_allclose(g_w, one[2], atol=1e-5)
    _close((loss, g_e, g_w), _jax_exact(emb, w, labels, cfg))


def test_sharded_softmax_padded_classes(ranks):
    """37 classes padded to 40 over 4 shards: the pads change neither the
    loss nor the real rows' gradients, and get none."""
    emb, w, labels = _data(1, 8, 16, 37)
    pad = np.random.default_rng(2).normal(size=(3, 16)).astype(np.float32)
    w_pad = np.concatenate([w, pad])
    cfg = MarginConfig.cosface()
    loss, g_e, g_w, _ = _run(ranks, 4, emb, w_pad, labels, cfg,
                             total_classes=37)
    one = _one_device(emb, w, labels, cfg)
    np.testing.assert_allclose(loss, one[0], rtol=1e-5)
    np.testing.assert_allclose(g_e, one[1], atol=1e-5)
    np.testing.assert_allclose(g_w[:37], one[2], atol=1e-5)
    assert not g_w[37:].any()
    _close((loss, g_e, g_w), _jax_exact(emb, w_pad, labels, cfg, 37))


def test_sharded_softmax_pad_overflow_no_nan(ranks):
    """Pad rows aligned with the embeddings (raw logit 64 above the valid
    ones): the masked logits are shifted, so exp never overflows."""
    d = 16
    emb = np.ones((4, d), np.float32)
    w = np.concatenate([-np.ones((2, d)), np.ones((6, d))]).astype(np.float32)
    labels = np.zeros(4, np.int64)
    cfg = MarginConfig.softmax(scale=64.0)
    loss, _, _, _ = _run(ranks, 4, emb, w, labels, cfg, total_classes=2)
    assert np.isfinite(loss), loss
    np.testing.assert_allclose(loss, _one_device(emb, w[:2], labels, cfg)[0],
                               rtol=1e-5)


def test_sampled_pfc_full_budget_is_exact(ranks):
    """budget == C_local: every column, q = 1: the exact loss and
    gradients, whatever the draws."""
    emb, w, labels = _data(2, 16, 32, 64)
    cfg = MarginConfig.cosface()
    loss, g_e, g_w, _ = _run(ranks, 4, emb, w, labels, cfg, budget=16,
                             seeds=SEEDS)
    one = _one_device(emb, w, labels, cfg)
    np.testing.assert_allclose(loss, one[0], rtol=1e-5)
    np.testing.assert_allclose(g_e, one[1], atol=1e-5)
    np.testing.assert_allclose(g_w, one[2], atol=1e-5)


def test_sampled_pfc_gradient_expectation_matches_exact(ranks):
    """Unbiasedness: the importance-corrected sampled gradient, averaged
    over 600 of the port's own draws (half of each 64-column shard), is
    the exact gradient to Monte-Carlo noise (a few percent)."""
    emb, w, labels = _data(3, 8, 16, 256, scale=0.5)
    cfg = MarginConfig.softmax(scale=8.0)
    _, g_e, g_w, _ = _run(ranks, 4, emb, w, labels, cfg, budget=32,
                          seeds=SEEDS, repeats=600)
    _, ge_x, gw_x = _one_device(emb, w, labels, cfg)

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9)

    assert rel(g_e, ge_x) < 0.08, rel(g_e, ge_x)
    assert rel(g_w, gw_x) < 0.08, rel(g_w, gw_x)


def test_sampled_pfc_padded_classes_masked(ranks):
    """Pads with huge weights never reach the denominator."""
    emb, w, labels = _data(4, 8, 16, 37)
    w_pad = np.concatenate([w, 100.0 * np.ones((3, 16), np.float32)])
    cfg = MarginConfig.cosface()
    loss, _, g_w, _ = _run(ranks, 4, emb, w_pad, labels, cfg, budget=10,
                           seeds=SEEDS, total_classes=37)
    np.testing.assert_allclose(loss, _one_device(emb, w, labels, cfg)[0],
                               rtol=1e-5)
    assert not g_w[37:].any()


def test_sampled_pfc_budget_validation():
    """The JAX head's checks: a budget in (0, C_local], and no smaller
    than the positives a shard can own (min(rows, C_local))."""
    cfg = MarginConfig.cosface()
    gen = torch.Generator().manual_seed(0)
    e, w = torch.zeros(8, 16), torch.randn(64, 16)
    y = torch.zeros(8, dtype=torch.long)
    with pytest.raises(ValueError, match="overflow"):
        ss.sampled_sharded_margin_softmax_loss(e, w, y, cfg, gen, 4)
    for budget in (0, 65):
        with pytest.raises(ValueError, match=r"must be in \(0, 64\]"):
            ss.sampled_sharded_margin_softmax_loss(e, w, y, cfg, gen, budget)
    assert torch.isfinite(ss.sampled_sharded_margin_softmax_loss(
        e, w, y, cfg, gen, 8))


def test_adaptive_margins_raise_naming_item_9():
    """MagFace's and AdaFace's per-sample margins (extra_m2 / extra_m3)
    raised naming item 9 in every head until it was ported; now each
    head takes them: zero margins on ArcFace's m2 give its loss bit for
    bit, others change it (their values against JAX:
    tests/test_torch_adaptive_losses.py)."""
    cfg = MarginConfig.arcface()
    gen = torch.Generator()
    e, w, y = torch.randn(4, 8, generator=gen), torch.randn(
        12, 8, generator=gen), torch.arange(4)
    zero, some = torch.zeros(4), torch.full((4,), 0.2)

    def heads(**extra):
        return (ss.sharded_margin_softmax_loss(e, w, y, cfg, **extra),
                ss.local_margin_logits(e, w, y, cfg, **extra)[0],
                ss.sampled_sharded_margin_softmax_loss(
                    e, w, y, cfg, torch.Generator().manual_seed(1), 4,
                    **extra))

    plain = heads()
    for extra in (dict(extra_m2=zero), dict(extra_m3=zero),
                  dict(extra_m2=zero, extra_m3=zero)):
        for a, b in zip(heads(**extra), plain, strict=True):
            assert torch.equal(a, b)
    for extra in (dict(extra_m2=some), dict(extra_m3=some)):
        for a, b in zip(heads(**extra), plain, strict=True):
            assert not torch.equal(a, b)


def _jax_draws(key, model, c_local):
    """JAX's per-shard keys of the sampled head, by the port's seeds."""
    return {SEEDS[m]: np.asarray(jax.random.uniform(
        jax.random.fold_in(key, m), (c_local,))) for m in range(model)}


def test_sampled_pfc_matches_jax_with_its_draws(ranks):
    """Half of each shard sampled, JAX's draws installed: the port's loss
    and gradients are JAX's."""
    emb, w, labels = _data(5, 16, 16, 128)
    cfg = MarginConfig.cosface()
    key = jax.random.key(11)
    loss, g_e, g_w, _ = _run(ranks, 4, emb, w, labels, cfg, budget=16,
                             seeds=SEEDS, draws=_jax_draws(key, 4, 32))
    mesh = _jax_mesh(1, 4)
    f = jax.jit(shard_map(
        lambda e, w_, y, k: jax_sampled(e, w_, y, JaxMargin(
            **dataclasses.asdict(cfg)), k, 16, axis_name=MODEL_AXIS),
        mesh=mesh, in_specs=(P(), P(MODEL_AXIS, None), P(), P()),
        out_specs=P()))
    y = jnp.asarray(labels)
    want, grads = jax.value_and_grad(lambda e, w_: f(e, w_, y, key),
                                     argnums=(0, 1))(jnp.asarray(emb),
                                                     jnp.asarray(w))
    _close((loss, g_e, g_w), (float(want), *map(np.asarray, grads)))
    # and not the exact loss: the budget really samples
    assert abs(loss - _one_device(emb, w, labels, cfg)[0]) > 1e-3


def _jax_compact(data, emb, w, labels, cfg, budget, key):
    """tests/test_parallel.py's ``_sampled_dp``: the data-gathered
    positives and the compact exchange on a (data, 2) mesh -> (the mean
    loss over data, the data-combined classifier gradient)."""
    def local(e, w_, y, k):
        def loss_fn(ww):
            return jax_sampled(e, ww, y, JaxMargin(**dataclasses.asdict(cfg)),
                               k, budget, axis_name=MODEL_AXIS,
                               data_axis=DATA_AXIS) / 2
        value, g = jax.value_and_grad(loss_fn)(w_)
        return jax.lax.pmean(value * 2, DATA_AXIS), g

    f = jax.jit(shard_map(
        local, mesh=_jax_mesh(data, 2),
        in_specs=(P(DATA_AXIS), P(MODEL_AXIS, None), P(DATA_AXIS), P()),
        out_specs=(P(), P(MODEL_AXIS, None)), check_vma=False))
    loss, g = f(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), key)
    return float(loss), np.asarray(g)


def test_sampled_pfc_compact_full_budget_matches_exact_dp(ranks):
    """On a (2, 2) grid at budget == C_local the compact exchange gives
    the exact loss and the exact, already data-averaged classifier
    gradient, the same on both ranks of a data column."""
    emb, w, labels = _data(8, 16, 16, 64)
    cfg = MarginConfig.cosface()
    loss, _, g_w, out = _run(ranks, 2, emb, w, labels, cfg, budget=32,
                             seeds=SEEDS, data_sync=True)
    one = _one_device(emb, w, labels, cfg)
    np.testing.assert_allclose(loss, one[0], rtol=1e-5)
    np.testing.assert_allclose(g_w, one[2], atol=1e-5)
    for m in range(2):
        np.testing.assert_array_equal(out[m][2], out[2 + m][2])
    want = _jax_compact(4, emb, w, labels, cfg, 32, jax.random.key(3))
    _close((loss, g_w), want)


def test_sampled_pfc_compact_is_data_mesh_invariant(ranks):
    """The positives of the global batch and a key shared by the data
    ranks make the sampled set a function of the global batch: at half
    of each shard, with JAX's draws, the port's (2, 2) grid gives JAX's
    loss and classifier gradient on (1, 2) and (4, 2) meshes."""
    emb, w, labels = _data(9, 16, 16, 128, scale=0.5)
    cfg = MarginConfig.softmax(scale=8.0)
    key = jax.random.key(11)
    loss, _, g_w, _ = _run(ranks, 2, emb, w, labels, cfg, budget=32,
                           seeds=SEEDS, data_sync=True,
                           draws=_jax_draws(key, 2, 64))
    for data in (1, 4):
        _close((loss, g_w), _jax_compact(data, emb, w, labels, cfg, 32, key))


def test_sampled_pfc_compact_degenerates_at_data_1(ranks):
    """A data axis of 1: the gathers and the compact average are the
    identity, so ``data_sync`` changes nothing, bit for bit."""
    emb, w, labels = _data(10, 8, 16, 128)
    cfg = MarginConfig.cosface()
    runs = [_run(ranks, 4, emb, w, labels, cfg, budget=8, seeds=SEEDS,
                 data_sync=sync)[:3] for sync in (True, False)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1:], runs[1][1:]):
        np.testing.assert_array_equal(a, b)
