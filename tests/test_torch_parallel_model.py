"""The port's train step on a (data 2, model 2) grid of four gloo ranks,
against the JAX package's ``make_train_step`` on ``create_mesh(data=2,
model=2)`` and against ``parallel.reference.replica_loop_step(model=2)``.

Each rank (each JAX device) takes its 16 of 64 global f32 rows
(``augment=False``), from the same variables and global classifier: the
exact head at 13 classes (padded to 14, a pad on shard 1), sub-centers
K=2, and the sampled head at 201 classes and rate 0.5 (C_local 101 > 64
rows, so it really samples) with JAX's draws installed in place of the
port's. Three straight steps leave the four ranks with the same
replicated tensors, and the ranks of a model index with the same shard,
bit for bit. Each of the three steps, taken from the JAX trainer's state
before it, holds to JAX's state after it at the first-step tolerance of
tests/test_torch_parallel.py (rtol 1e-4, atol 2e-6; the momentum's atol
over the learning rate; metrics rtol 1e-4), and to the plain version's
step from the same state at f32 rounding (rtol 1e-5 of each value, or of
its tensor's largest where the value is smaller: four ranks sum in
another order than the by-hand loop).

Why each step starts from the reference's state: two f32 trajectories
1e-6 apart flip a ReLU somewhere by the third step about as often as
not here (measured over data seeds 7-11: two of five runs of the exact
head and two of the sampled, a model axis of 1 included; the flipped
unit moves its channel's two BN biases, then the stem kernel by up to
2e-3), which no elementwise tolerance on the trajectory absorbs.

Also: ``accum_steps`` with the sampled head against the plain version, a
10^6-class sampled step at rate 0.01 on a (1, 4) grid, and a checkpoint
written at 2 x 2 that holds the global classifier and restores shard by
shard. The four ranks are spawned once for the module
(``torch_dist.Ranks``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models.resnet import ResNet as JaxResNet
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.train import trainer
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

LR = 0.025       # the learning rate of steps 1 and 3
ROWS = 64       # 16 a rank, as the data-axis test's 16 a device
DATA_SEED = 7   # the data-axis test's batches
CASES = {
    "exact_padded": dict(num_classes=13, global_batch=ROWS),
    "subcenters": dict(num_classes=13, subcenters=2, global_batch=ROWS),
    "sampled": dict(num_classes=201, pfc_sample_rate=0.5, global_batch=ROWS),
}


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(4) as r:
        yield r


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _trace(opt_state):
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _trace(s)
            if found is not None:
                return found
    return None


def _jax_snapshot(state):
    trace = _trace(state.opt_state)
    return {"vars": flatten_variables({"params": _np(state.params),
                                      "batch_stats": _np(state.batch_stats)}),
            "classifier": np.array(state.classifier),
            "momentum": {"params": flatten_variables(
                {"params": _np(trace["params"])}),
                "classifier": np.array(trace["classifier"])},
            "ema": None, "step": int(state.step)}


def _draws(rng, num_classes):
    """The JAX step's sampled-head keys for steps 0-2 and shards 0-1
    (fold_in(fold_in(fold_in(rng, step), 0x9FC), shard)), by the seeds
    of the port's generators for them (seed 0)."""
    c_local = -(-num_classes // 2)
    key = jax.random.wrap_key_data(rng)
    return {trainer._seed(0, step, trainer._PFC, m): np.asarray(
        jax.random.uniform(jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(key, step), 0x9FC), m), (c_local,)))
        for step in range(td.STEPS) for m in range(2)}


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """(flat variables, global classifier, draws, metrics, snapshots) of
    the JAX trainer on a (2, 2) mesh."""
    kw = CASES[name]
    cfg = jt.TrainConfig(**{**td.BASE, **kw, "dtype": jnp.float32})
    mesh = create_mesh(data=2, model=2, devices=jax.devices()[:4])
    net = JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16)
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    draws = (_draws(np.array(state.rng), kw["num_classes"])
             if "pfc_sample_rate" in kw else None)
    step = jt.make_train_step(net, cfg, mesh, state)
    metrics, snaps = [], []
    for x, y in td.batches(classes=kw["num_classes"], rows=ROWS,
                           seed=DATA_SEED):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(_jax_snapshot(state))
    return flat, cls, draws, metrics, snaps


def _walk(a, b, path=""):
    """(path, a, b) of each array leaf of ``b`` (``a`` may have more keys:
    the port's snapshot keeps the optimizer's count); other leaves must
    be equal."""
    if isinstance(a, dict):
        assert a.keys() >= b.keys(), path
        for k in b:
            yield from _walk(a[k], b[k], f"{path}/{k}")
    elif a is None or isinstance(a, (int, float)):
        assert a == b, path
    else:
        yield path, a, b


def _assert_close(got, want, rtol, atol):
    for path, a, b in _walk(got, want):
        # the momentum holds gradients: 1 / lr times an update
        tol = atol / LR if path.startswith("/momentum") else atol
        np.testing.assert_allclose(a, b, rtol=rtol, atol=tol, err_msg=path)


def _assert_rounding(got, plain):
    """f32 rounding apart: rtol 1e-5 of each value, or of its tensor's
    largest where the value is smaller (sums in another order). The
    Dense bias ahead of the head's BatchNorm has no gradient in exact
    arithmetic: its values are rounding noise (~1e-8), held by the JAX
    comparison's atol only."""
    for path, a, b in _walk(got, plain):
        if path.endswith("EmbeddingHead_0/Dense_0/bias"):
            continue
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=path)


def _replicated(snap):
    """A snapshot without its classifier shard and the shard's momentum."""
    return {**snap, "classifier": None,
            "momentum": {**snap["momentum"], "classifier": None}}


def _check_grid(out):
    """The four ranks' runs: the same metrics and replicated state, each
    model index's shard the same on both data ranks (bit for bit); the
    snapshots with the classifier reassembled from data row 0."""
    (m0, s0, _), *others = out
    for m, s, _ in others:
        assert m == m0
        for a, b in zip(s, s0, strict=True):
            for path, x, y in _walk(_replicated(a), _replicated(b)):
                assert np.array_equal(x, y), path
    for model_index in range(2):
        for a, b in zip(out[model_index][1], out[2 + model_index][1]):
            assert np.array_equal(a["classifier"], b["classifier"])
            assert np.array_equal(a["momentum"]["classifier"],
                                  b["momentum"]["classifier"])
    return m0, [td.join_shards([a, b]) for a, b in zip(s0, out[1][1])]


def _start(flat, cls) -> dict:
    """The snapshot of a fresh state from ``flat`` and ``cls``."""
    return {"vars": flat, "classifier": cls,
            "momentum": {"params": None, "classifier": None}, "ema": None,
            "step": 0, "count": 0}


def _forced(out):
    """``steps_from``'s per-rank results as ``train_steps``' are."""
    return [([m for m, _ in r], [s for _, s in r], 0) for r in out]


def _assert_metrics(got, want, rtol):
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_jax_on_a_data_model_mesh(ranks, name):
    """Three straight steps on the grid, each rank's tensors checked
    against the others'; then each of the three steps from the JAX
    trainer's state before it, against JAX's state after it and against
    the plain version's step from the same state."""
    flat, cls, draws, want_m, want = _jax_case(name)
    kw = {**CASES[name], "dtype": torch.float32}
    run = dict(model=2, classes=kw["num_classes"], draws=draws,
               data_seed=DATA_SEED)
    out = ranks.run(td.train_steps, cfg_kw=kw, flat=flat, cls=cls, **run)
    metrics, snaps = _check_grid(out)
    assert snaps[-1]["step"] == want[-1]["step"] == td.STEPS
    assert snaps[-1]["classifier"].shape == cls.shape
    _assert_close(snaps[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_metrics(metrics[:1], want_m[:1], rtol=1e-4)
    starts = [_start(flat, cls), *want[:-1]]
    forced_m, forced = _check_grid(_forced(ranks.run(
        td.steps_from, cfg_kw=kw, starts=starts, **run)))
    for got, w in zip(forced, want, strict=True):
        _assert_close(got, w, rtol=1e-4, atol=2e-6)
    _assert_metrics(forced_m, want_m, rtol=1e-4)
    # the plain version: the four ranks one after another in this process
    plain = td.steps_from(None, kw, starts, world=4, **run)
    for got, (_, w) in zip(forced, plain, strict=True):
        _assert_rounding(got, w)
    _assert_metrics(forced_m, [m for m, _ in plain], rtol=1e-5)


def test_accum_steps_with_the_sampled_head_match_the_plain_version(ranks):
    """accum_steps=2 (micro-batches of 4 rows a rank, one sample set a
    step for both, the budget's floor the 32 rows of a global
    micro-batch): each of two steps on the grid against the plain
    version's from the same state."""
    from tf_face_toolbox_tpu_torch.parallel.mesh import Topology
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state)

    kw = dict(num_classes=201, pfc_sample_rate=0.5, accum_steps=2,
              global_batch=ROWS, dtype=torch.float32)
    state, _ = create_train_state(TrainConfig(**{**td.BASE, **kw}), 0,
                                  mesh=Topology(data=2, model=2),
                                  whole_classifier=True, device="cpu")
    run = dict(model=2, classes=201, data_seed=DATA_SEED)
    _, snaps = _check_grid(ranks.run(td.train_steps, cfg_kw=kw, steps=1,
                                     **run))
    starts = [td.snapshot(state), snaps[0]]
    metrics, forced = _check_grid(_forced(ranks.run(
        td.steps_from, cfg_kw=kw, starts=starts, **run)))
    plain = td.steps_from(None, kw, starts, world=4, **run)
    for got, (_, w) in zip(forced, plain, strict=True):
        _assert_rounding(got, w)
    _assert_metrics(metrics, [m for m, _ in plain], rtol=1e-5)


def test_sampled_pfc_million_id_step(ranks):
    """A 10^6-class head at rate 0.01 on a (1, 4) grid: 250,000 classes a
    shard, 2,500 scored a step; the loss has the scale of log(10^6)."""
    kw = dict(num_classes=1_000_000, pfc_sample_rate=0.01,
              dtype=torch.float32)
    out = ranks.run(td.train_steps, cfg_kw=kw, model=4, classes=1_000_000,
                    steps=1, keep_snapshots=False)
    losses = {m[0]["loss"] for m, _, _ in out}
    assert len(losses) == 1
    loss = losses.pop()
    assert 5.0 < loss < 40.0, loss


def test_checkpoint_round_trip_at_two_by_two(ranks, tmp_path):
    """A 2 x 2 save holds the global (C_pad * K, D) classifier and its
    momentum; every rank restores its shard and the rest to the saved
    state bit for bit; a run of another class count raises naming both
    row counts; ``global_shapes`` is global."""
    run = str(tmp_path / "run")
    kw = dict(num_classes=13, subcenters=2, dtype=torch.float32)
    out = ranks.run(td.checkpoint_round_trip, train_dir=run, model=2,
                    cfg_kw=kw)
    for r in out:
        for path, a, b in _walk(r["saved"], r["restored"]):
            assert np.array_equal(a, b), path
        assert "28 rows, this run's 32" in r["error"], r["error"]
    shapes = out[0]["shapes"]
    assert shapes["classifier"] == shapes["momentum/classifier"] == (28, 16)
    raw = CheckpointManager(run).restore_raw()
    whole = td.join_shards([out[0]["saved"], out[1]["saved"]])
    np.testing.assert_array_equal(raw["classifier"].numpy(),
                                  whole["classifier"])
    np.testing.assert_array_equal(raw["momentum"]["classifier"].numpy(),
                                  whole["momentum"]["classifier"])
