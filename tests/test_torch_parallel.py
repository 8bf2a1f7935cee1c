"""The port's data-parallel step (``parallel/``, ``make_train_step(mesh=)``)
on two gloo ranks, against the JAX package's ``make_train_step`` on a
two-device ``data`` mesh.

Both start from the same variables (JAX init, through the flat ``.npz``
key space) and classifier, and take three steps on the same global f32
batches (``augment=False``: the random streams differ), each rank (each
JAX device) on its 16 of the 32 rows: the batch of the one-device
parity test, so that accum_steps 2 gives micro-batches of 8 rows there
and here (at 4 rows the head's BatchNorm over 4 values a channel turns
f32 rounding into ReLU flips past these tolerances, one device or two).
Tolerance (f32 on the CPU, as in tests/test_torch_trainer.py): loss, grad_norm and learning rate rtol
1e-4 at every step; params, classifier, BN statistics and EMA rtol
1e-4, atol 2e-6 after the first step and rtol 1e-3, atol 3e-4 after the
third; the momentum buffers, which hold gradients (an update over the
learning rate, 0.025 at both steps), rtol 1e-4 and those atols over
0.025. The two ranks end bit-identical, and equal to
``replica_loop_step`` run in this process bit for bit (one thread a
process on both sides, and a sum of two is the same in either order).

The two ranks are spawned once for the module (``torch_dist.Ranks``).
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
from tf_face_toolbox_tpu_torch.parallel import collectives
from tf_face_toolbox_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Topology,
    create_topology,
    init_distributed,
    local_batch_size,
    node_layout,
    rank_batch_size,
)
from tf_face_toolbox_tpu_torch.train import trainer
from tf_face_toolbox_tpu_torch.train.trainer import (
    StepParts,
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

LR = 0.025       # the learning rate of steps 1 and 3
CASES = {
    "cosface": {},
    "arcface": dict(margin_m2=0.5, margin_m3=0.0),
    "clip": dict(grad_clip_norm=1.0),
    "ema": dict(ema_decay=0.9),
    "accum2": dict(accum_steps=2),
    "skip_nonfinite": dict(skip_nonfinite=True),
}


def _nan_at(name):
    # a NaN in row 0 at step 1: rank 0's rows only
    return 1 if name == "skip_nonfinite" else None


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(2) as r:
        yield r


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _trace(opt_state):
    """optax's momentum trace in a chain's state."""
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
            "ema": (flatten_variables({"params": _np(state.ema_params)})
                    if state.ema_params is not None else None),
            "step": int(state.step)}


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """(initial flat variables, classifier, metrics, snapshots) of the JAX
    trainer on a data=2 mesh."""
    cfg = jt.TrainConfig(**{**td.BASE, **CASES[name], "dtype": jnp.float32})
    mesh = create_mesh(data=2, devices=jax.devices()[:2])
    net = JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16)
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(net, cfg, mesh, state)
    metrics, snaps = [], []
    for x, y in td.batches(_nan_at(name)):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(_jax_snapshot(state))
    return flat, cls, metrics, snaps


def _assert_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        assert got.keys() >= want.keys(), path
        for k in want:
            if k == "momentum":
                # the trace of gradients: 1 / lr times an update
                _assert_close(got[k], want[k], rtol, atol / LR, f"{path}/{k}")
            elif k != "count":
                _assert_close(got[k], want[k], rtol, atol, f"{path}/{k}")
    elif want is None:
        assert got is None, path
    elif isinstance(want, (int, float)):
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=path)


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif a is None or isinstance(a, (int, float)):
        assert a == b, path
    else:
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_jax_on_a_data_mesh(ranks, name):
    flat, cls, want_m, want = _jax_case(name)
    kw = {**CASES[name], "dtype": torch.float32}
    (m0, s0, _), (m1, s1, _) = ranks.run(td.train_steps, cfg_kw=kw,
                                         flat=flat, cls=cls,
                                         nan_at=_nan_at(name))
    # both ranks hold the same state and report the same metrics
    _assert_equal(s0[-1], s1[-1])
    _assert_same_metrics(m0, m1)
    assert s0[-1]["step"] == want[-1]["step"] == td.STEPS
    _assert_close(s0[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_close(s0[-1], want[-1], rtol=1e-3, atol=3e-4)
    for g, w in zip(m0, want_m):
        assert g.keys() == w.keys()
        for k in w:
            if np.isfinite(w[k]):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            else:
                assert not np.isfinite(g[k]), k
    if name == "skip_nonfinite":
        # one rank's NaN row: the averaged loss is NaN on both ranks, and
        # both skip (a rank applying alone would diverge silently)
        assert [m["skipped_nonfinite"] for m in m0] == [0.0, 1.0, 0.0]
        assert s0[1]["count"] == 1 and s0[-1]["count"] == 2
        _assert_equal({**s0[1], "step": 1, "count": 1},
                      {**s0[0], "step": 1, "count": 1})
    # the plain version: two replicas one after another in this process
    rm, rs = td.replica_steps(kw, 2, flat=flat, cls=cls,
                              nan_at=_nan_at(name))
    for got, want_s in zip(s0, rs):
        _assert_equal(got, want_s)
    _assert_same_metrics(m0, rm)


def _assert_same_metrics(ms, others):
    for a, b in zip(ms, others, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k


def test_collectives_average_over_two_ranks(ranks):
    got = ranks.run(td.collectives_case)
    assert got[0][:7] == got[1][:7]
    grads, ints, stat, loss, value, anyone, nobody, differs = got[0]
    assert grads == [[[1.5, 1.5]] * 3, [0.0, 1.5, 3.0, 4.5]]
    assert ints == [15.0, 15.0] and stat == 0.5 and loss == 1.0
    assert value == 0.9          # rank 0's, f64
    assert anyone and not nobody
    # a state that differs raises on every rank
    assert "x differs across ranks" in differs
    assert "x differs across ranks" in got[1][7]


def test_collectives_are_the_identity_at_one_rank():
    """At a data size of 1, or with no mesh, nothing is launched and
    nothing changes (no process group exists here)."""
    for mesh in (None, create_topology(1)):
        g = [torch.arange(3.0)]
        collectives.sync_gradients(g, mesh)
        collectives.sync_batch_stats(g, mesh)
        assert g[0].tolist() == [0.0, 1.0, 2.0]
        assert collectives.replicate_mean(torch.tensor(3.0), mesh) == 3.0
        assert collectives.broadcast_value(0.25, mesh) == 0.25
        assert collectives.any_rank(True, mesh)
        collectives.barrier(mesh)
        collectives.check_replicated(g, mesh, "g")


def test_topology_shapes():
    """Mirrors tests/test_parallel.py::test_mesh_shapes: every rank on the
    data axis by default; a model axis of 4 makes a (2, 4) grid, rank r
    at data index r // 4 and model index r % 4 (JAX's grid.reshape(data,
    model)); rows a data replica (JAX's local_batch_size) and rows a rank
    are named apart. Without a process group the axes have no groups."""
    topo = create_topology(8)
    assert topo.shape[DATA_AXIS] == 8 and topo.shape[MODEL_AXIS] == 1
    assert topo.is_main and topo.distributed
    grid = create_topology(8, model=4, rank=6)
    assert grid.shape == {DATA_AXIS: 2, MODEL_AXIS: 4} and grid.world == 8
    assert (grid.data_index, grid.model_index) == (1, 2)
    assert grid.data_group is None and grid.model_group is None
    assert local_batch_size(64, grid) == 32 and rank_batch_size(64, grid) == 8
    with pytest.raises(ValueError, match="not divisible by model=3"):
        create_topology(8, model=3)
    with pytest.raises(ValueError, match="8 ranks"):
        rank_batch_size(60, grid)
    assert create_topology(2, model=2).distributed     # data 1 x model 2
    assert local_batch_size(64, create_topology(2)) == 32
    with pytest.raises(ValueError):
        local_batch_size(63, topo)
    assert not create_topology(1).distributed


def test_node_layout_checks():
    """Mirrors tests/test_train.py::test_multislice_mesh_grouping: equal
    nodes, node-major, the model axis inside a node, and a virtual split
    that drops no rank."""
    assert node_layout(8, node_ids=[0] * 4 + [1] * 4) == 2
    assert node_layout(8, nodes=2) == 2            # one node split in two
    assert node_layout(8) == 1
    with pytest.raises(ValueError, match="not divisible"):
        node_layout(8, node_ids=[0] * 4 + [1] * 4, model=8)
    with pytest.raises(ValueError, match="not divisible"):
        node_layout(8, nodes=3)
    with pytest.raises(ValueError, match="node-major"):
        node_layout(8, node_ids=[0, 1] * 4)
    with pytest.raises(ValueError, match="uneven"):
        node_layout(6, node_ids=[0, 0, 0, 0, 1, 1])
    with pytest.raises(ValueError, match="found 2 nodes, expected 4"):
        node_layout(8, node_ids=[0] * 4 + [1] * 4, nodes=4)
    # a model axis of 2 fits inside 4-rank nodes
    topo = create_topology(8, model=2, node_ids=[0] * 4 + [1] * 4)
    assert (topo.data, topo.model, topo.nodes) == (4, 2, 2)


def test_init_distributed_needs_torchrun(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        init_distributed("cpu")


def test_two_ranks_join_node_major(ranks):
    topos = ranks.run(td.describe)
    assert topos == [(0, 0, 2, 1, "cpu"), (1, 1, 2, 1, "cpu")]


def test_accum_steps_is_checked_against_a_rank_s_rows():
    cfg = TrainConfig(**{**td.BASE, "accum_steps": 4, "global_batch": 12})
    state, net = create_train_state(cfg, 0, device="cpu")
    make_train_step(net, cfg, state)                # 12 rows, 4 micro
    with pytest.raises(ValueError, match="per-device batch 6"):
        make_train_step(net, cfg, state, mesh=create_topology(2))


def test_rows_of_a_rank():
    cfg = TrainConfig(**td.BASE)
    state, net = create_train_state(cfg, 0, device="cpu")
    parts = StepParts(net, cfg, state, Topology(rank=1, data=2))
    x, y = np.arange(32 * 2).reshape(32, 2), np.arange(32)
    xs, ys = parts.rows(x, y)
    assert ys.tolist() == list(range(16, 32))
    xs, ys = parts.rows(x[:16], y[:16])             # its rows already
    assert ys.tolist() == list(range(16))
    with pytest.raises(ValueError, match="neither the global batch"):
        parts.rows(x[:5], y[:5])


def test_augment_streams_by_rank(monkeypatch):
    """Rank 0 draws the streams of a one-device run (seeded from (rng,
    step, stream)), at any data size; other ranks draw their own."""
    seeds = []
    real = trainer._augment

    def spy(cfg, images, step_gen, erase_gen):
        seeds.append((step_gen.initial_seed(), erase_gen.initial_seed()))
        return real(cfg, images, step_gen, erase_gen)

    monkeypatch.setattr(trainer, "_augment", spy)
    cfg = TrainConfig(**{**td.BASE, "augment": True, "crop_from": 20,
                         "random_erase": 0.5})
    images = np.random.default_rng(0).integers(0, 256, (32, 20, 20, 3),
                                               np.uint8)
    labels = np.arange(32) % td.CLASSES
    losses = []
    for mesh in (None, Topology(rank=0, data=2), Topology(rank=1, data=2)):
        state, net = create_train_state(cfg, 5, device="cpu")
        state.step = 4
        parts = StepParts(net, cfg, state, mesh)
        # the same 8 rows on every rank
        terms, _, _ = parts.local(
            state, *parts.rows(images[:16], labels[:16]), parts.rank)
        losses.append(float(terms["margin"]))
    today = (trainer._seed(5, 4, trainer._AUGMENT),
             trainer._seed(5, 4, trainer._ERASE))
    assert seeds[0] == seeds[1] == today
    assert seeds[2] == (trainer._seed(5, 4, 1, trainer._AUGMENT),
                        trainer._seed(5, 4, 1, trainer._ERASE))
    assert seeds[2][0] != today[0] and seeds[2][1] != today[1]
    # the same rows, other crops and flips
    assert losses[0] == losses[1] != losses[2]


def test_two_ranks_augment_apart_and_agree(ranks):
    """augment=True with kernel 1's route: the ranks' states stay
    bit-identical, and the step equals replica_loop_step's."""
    kw = {"augment": True, "crop_from": 20, "pallas_input": True,
          "dtype": torch.float32}
    (m0, s0, n0), (m1, s1, n1) = ranks.run(td.train_steps, cfg_kw=kw,
                                           steps=2, u8=True)
    _assert_equal(s0[-1], s1[-1])
    assert n0 == n1 == 0          # the kernel's plain version on the CPU
    rm, rs = td.replica_steps(kw, 2, steps=2, u8=True)
    _assert_equal(s0[-1], rs[-1])
