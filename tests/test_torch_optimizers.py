"""Adam, AdamW and LARS in the port's trainer, against the JAX package's
``make_optimizer`` (optax 0.2.6).

1. The optimizers alone: the port's ``make_optimizer`` over a tiny
   ResNet and a classifier, and JAX's ``make_optimizer`` over the same
   variables, fed the same gradients (seeded numpy, in each package's
   layout) for four updates at the rates of a staircase with a 2-step
   warmup and a boundary at step 2 (0.025, 0.05, 0.025, 0.025); the
   classifier's gradient is zero at the third update (a classifier that
   the objective does not reach, as under pure distillation: optax
   still decays it and steps its state). Tolerance: rtol 1e-5 on every
   leaf after every update (f32 arithmetic in another order: one or two
   roundings an update), atol 1e-8 under LARS; under Adam and AdamW
   atol 1.25e-6, 1e-5 of the rates' sum: optax takes the bias
   corrections 1 - b**t in f32 and torch in f64, and at t = 1, 1 - 0.999
   is 1.3e-5 apart in the two, which moves an update of size lr by
   6.4e-6 of itself.
2. Three f32 steps of the whole train step against JAX's
   ``make_train_step`` on a one-device mesh (``tests/test_torch_trainer.py``'s
   batches and its tolerances: loss, grad_norm and learning rate rtol
   1e-4; params, classifier and BN statistics rtol 1e-4, atol 2e-6 after
   the first step and rtol 1e-3, atol 3e-4 after the third), for each
   optimizer, plain (the staircase boundary inside the steps) and with a
   non-finite batch at step 1 that every optimizer skips (Adam's bias
   correction counts the applied updates only).

   Adam's update is lr * m / (sqrt(v) + 1e-8), of size lr whatever the
   gradient's size: where the gradient is f32 rounding noise the two
   packages' signs differ and the update is +-lr. One leaf is such noise:
   the Dense bias ahead of the head's BatchNorm
   (``params/EmbeddingHead_0/Dense_0/bias``), whose gradient is zero in
   exact arithmetic (the BN removes the mean). Under Adam and AdamW its
   values are held to move at most lr a step instead; every other leaf
   keeps the tolerance above. The same normalization amplifies the
   1e-6 differences of two f32 trajectories wherever a gradient entry
   nearly cancels or a ReLU flips: after three straight AdamW steps 14
   to 31 entries of each block's kernels stood 1.6e-3 to 2.9e-3 apart
   (6% of the rate), which no elementwise tolerance absorbs. So under
   Adam and AdamW each of the three steps is taken from JAX's state
   before it (parameters, BN statistics, classifier, the moments and the
   count), as tests/test_torch_parallel_model.py does; the straight run
   still checks the skip and the counts. Even one step from the same
   state moves a few entries whose gradient is small against its leaf's
   (1e-6 to 5e-4 where the leaf's largest is 0.03 to 3): the two
   packages' gradients differ by up to 1.5e-6 of the leaf's largest
   (reductions over the batch and the map in another order), and Adam
   divides the entry's share of that by the entry's own RMS sqrt(v).
   So each parameter entry is held to the tolerance above plus the
   update that a gradient error of 1e-5 of its leaf's largest RMS
   would make there: rate * 1e-5 * max(sqrt(v)) / sqrt(v), from JAX's
   moments (5e-7 at an entry of the leaf's largest RMS).
3. LARS on a (data 1, model 2) grid of two gloo ranks, the classifier
   split over the model row. LARS's trust ratio takes each leaf's norm,
   and the classifier's leaf is the global one: its shards' squared
   norms are summed over the row. That is the norm JAX takes on a data
   mesh, where the classifier is whole on each device; JAX's step on a
   model mesh runs the optimizer inside ``shard_map`` and takes each
   shard's own norm, which changes LARS's classifier update with the
   mesh (a reference fault the port does not copy). So the two ranks are
   held to JAX on a (data 2, model 1) mesh, whose devices forward the
   same two blocks of rows, at the tolerances of 2, and the classifier's
   first update to JAX's at rtol 1e-3 of the update (the shard-norm
   update differs by ~3%).
4. Checkpoints: every optimizer's state round-trips bit for bit and the
   resumed run continues bit for bit; a resume under another optimizer
   refuses, naming both; on the (1, 2) grid the classifier's moments
   and trace are saved in the global shape and restored shard by shard.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist as td
from tests.test_torch_trainer import (
    BASE,
    STEPS,
    _assert_states_close,
    _batches,
    _jax_run,
    _jax_snapshot,
    _port_run,
)
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models.resnet import ResNet as JaxResNet
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.interop import port
from tf_face_toolbox_tpu_torch.train import optimizers
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)

OPTIMIZERS = ("adam", "adamw", "lars")
NOISE_ONLY = "params/EmbeddingHead_0/Dense_0/bias"
RATES = [0.025, 0.05, 0.025, 0.025]


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(2) as r:
        yield r


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def _init():
    """JAX variables (flat) and classifier of the tiny ResNet."""
    cfg = jt.TrainConfig(**{**BASE, "dtype": jnp.float32})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    net = JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16)
    state, _ = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    return flat, np.array(state.classifier)


def _grads(flat, cls, step):
    """Seeded gradients of every param leaf and of the classifier (zero
    at step 2)."""
    rng = np.random.default_rng(100 + step)
    g = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
         for k, v in flat.items() if k.startswith("params/")}
    gc = (np.zeros_like(cls) if step == 2 else
          rng.standard_normal(cls.shape).astype(np.float32) * 0.1)
    return g, gc


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_updates_match_optax(name):
    flat, cls = _init()
    jcfg = jt.TrainConfig(**{**BASE, "optimizer": name,
                             "dtype": jnp.float32})
    tx, sched = jt.make_optimizer(jcfg)
    tree = {"params": {k: v for k, v in port.unflatten_variables(
        flat)["params"].items()}, "classifier": jnp.asarray(cls)}
    tree = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(tree)

    cfg = TrainConfig(**{**BASE, "optimizer": name})
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    opt = state.opt_state["optimizer"]
    leaves = {k: (t, kind) for k, t, kind in port.jax_leaves(net)
              if k.startswith("params/")}
    atol = 1e-8 if name == "lars" else 1e-5 * sum(RATES)
    for step, rate in enumerate(RATES):
        assert float(sched(step)) == pytest.approx(rate)
        g, gc = _grads(flat, cls, step)
        jg = {"params": port.unflatten_variables(g)["params"],
              "classifier": gc}
        jg = jax.tree.map(jnp.asarray, jg)
        updates, opt_state = tx.update(jg, opt_state, tree)
        tree = jax.tree.map(lambda p, u: p + u, tree, updates)
        for k, (t, kind) in leaves.items():
            t.grad = port.from_jax_layout(g[k], kind)
        state.classifier.grad = torch.from_numpy(gc)
        for group in opt.param_groups:
            group["lr"] = rate
        opt.step()
        want = flatten_variables({"params": _np(tree["params"])})
        for k, (t, kind) in leaves.items():
            np.testing.assert_allclose(port.to_jax_layout(t, kind), want[k],
                                       rtol=1e-5, atol=atol,
                                       err_msg=f"{k} after {step + 1}")
        np.testing.assert_allclose(
            state.classifier.detach().numpy(), np.asarray(tree["classifier"]),
            rtol=1e-5, atol=atol, err_msg=f"classifier after {step + 1}")


def test_lars_runs_the_rate_before_the_momentum():
    """optax.lars scales by the rate, then traces: after a rate change the
    trace still carries the earlier updates at their own rate. Two updates
    of one leaf at rates 1 and 0.5 with the same gradient: the second
    moves the leaf by 0.5 u2 + 0.9 * 1.0 u1, not 0.5 (u2 + 0.9 u1)."""
    p = torch.nn.Parameter(torch.tensor([3.0, 4.0]))
    opt = optimizers.LARS([{"params": [p], "weight_decay": 0.0}], 1.0,
                          momentum=0.9)
    g = torch.tensor([0.3, 0.4])
    moves = []
    for rate in (1.0, 0.5):
        p.grad = g.clone()
        before = p.detach().clone()
        opt.param_groups[0]["lr"] = rate
        opt.step()
        moves.append(p.detach() - before)
    # trust ratio 0.001 * |p| / |g| = 0.001 * 5 / 0.5 (|p| 5 at step 1)
    u1 = -1.0 * 0.01 * g
    r2 = 0.001 * torch.linalg.vector_norm(p.detach() - moves[1]) / 0.5
    u2 = -0.5 * r2 * g
    torch.testing.assert_close(moves[0], u1)
    torch.testing.assert_close(moves[1], u2 + 0.9 * u1)


def test_lars_zero_norm_leaves_take_ratio_one():
    """A leaf at zero (a fresh bias) or with a zero update takes the ratio
    1: the plain rate-scaled update, as optax's ``scale_by_trust_ratio``."""
    b = torch.nn.Parameter(torch.zeros(3))
    opt = optimizers.LARS([{"params": [b], "weight_decay": 0.0}], 0.1)
    b.grad = torch.tensor([1.0, -2.0, 0.5])
    opt.step()
    torch.testing.assert_close(b.detach(), -0.1 * torch.tensor([1.0, -2.0,
                                                                0.5]))
    with pytest.raises(ValueError, match="every leaf"):
        b.grad = None
        opt.step()


def test_every_parameter_is_one_jax_leaf(monkeypatch):
    """LARS's norms are per JAX leaf: the port's parameters are the
    network's ``params/`` leaves one for one, none split or joined; a
    bridge that named a parameter twice or not at all is refused."""
    cfg = TrainConfig(**{**BASE, "optimizer": "lars"})
    state, net = create_train_state(cfg, 0, device="cpu")
    keys = [k for k, t, _ in port.jax_leaves(net) if k.startswith("params/")]
    assert len(keys) == len(set(keys)) == len(list(net.parameters()))
    real = port.jax_leaves
    monkeypatch.setattr(port, "jax_leaves",
                        lambda n: [*real(n), next(iter(real(n)))])
    with pytest.raises(ValueError, match="one for one"):
        make_optimizer(cfg, net, state.classifier)
    monkeypatch.setattr(port, "jax_leaves", lambda n: list(real(n))[1:])
    with pytest.raises(ValueError, match="one for one"):
        make_optimizer(cfg, net, state.classifier)


def _cases():
    return [(name, skip) for name in OPTIMIZERS for skip in (False, True)]


@functools.lru_cache(maxsize=None)
def _jax_case(name, skip):
    return _jax_run({"optimizer": name, "skip_nonfinite": skip},
                    nan_at=1 if skip else None)


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) in a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


@functools.lru_cache(maxsize=None)
def _jax_adam_case(name, skip):
    """The JAX trainer's three steps under ``name`` (adam or adamw): the
    initial (flat, classifier), the metrics, and the state before and
    after each step with the moments and count."""
    cfg = jt.TrainConfig(**{**BASE, "optimizer": name,
                            "skip_nonfinite": skip, "dtype": jnp.float32})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    net = JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16)
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    step = jt.make_train_step(net, cfg, mesh, state)

    def snap(state):
        adam = _adam_state(state.opt_state)
        out = _jax_snapshot(state)
        out["adam"] = {
            "count": int(adam.count),
            "mu": flatten_variables({"params": _np(adam.mu["params"])}),
            "nu": flatten_variables({"params": _np(adam.nu["params"])}),
            "mu_classifier": np.array(adam.mu["classifier"]),
            "nu_classifier": np.array(adam.nu["classifier"])}
        return out

    snaps, metrics = [snap(state)], []
    for x, y in _batches(1 if skip else None):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(snap(state))
    return metrics, snaps


def _port_step_from(kw, snap, x, y):
    """One port step from a JAX snapshot (with its Adam moments)."""
    cfg = TrainConfig(**{**BASE, **kw})
    state, net = create_train_state(cfg, 0, variables=snap["vars"],
                                    classifier=snap["classifier"],
                                    device="cpu")
    adam = snap["adam"]
    opt = state.opt_state["optimizer"]
    if adam["count"]:
        for n, p in state.params.items():
            key, kind = port.jax_key(n, p)
            opt.state[p] = {"step": torch.tensor(float(adam["count"])),
                            "exp_avg": port.from_jax_layout(adam["mu"][key],
                                                            kind),
                            "exp_avg_sq": port.from_jax_layout(
                                adam["nu"][key], kind)}
        opt.state[state.classifier] = {
            "step": torch.tensor(float(adam["count"])),
            "exp_avg": torch.tensor(adam["mu_classifier"]),
            "exp_avg_sq": torch.tensor(adam["nu_classifier"])}
    state.step, state.opt_state["count"] = snap["step"], adam["count"]
    state, m = make_train_step(net, cfg, state)(state, x, y)
    leaves = list(port.jax_leaves(net))
    got = {"vars": {k: port.to_jax_layout(t, kind) for k, t, kind in leaves},
           "classifier": state.classifier.detach().numpy().copy(),
           "ema": None, "step": state.step}
    return {k: float(v) for k, v in m.items()}, got


def _assert_adam_step_close(got, want, rate):
    """``got`` (one port step from JAX's state) against JAX's ``want``
    after it: parameters at rtol 1e-4, atol 2e-6 plus the update of a
    1e-5 gradient error at each entry's RMS (the module docstring); the
    rest at rtol 1e-4, atol 2e-6."""
    adam = want["adam"]
    bc2 = 1 - 0.999 ** adam["count"]

    def extra(nu):
        rms = np.sqrt(nu / bc2)
        return np.where(rms > 0, rate * 1e-5 * rms.max()
                        / np.maximum(rms, 1e-30), 0.0)

    assert got["vars"].keys() == want["vars"].keys()
    for k, w in want["vars"].items():
        tol = 2e-6 + 1e-4 * np.abs(w)
        if k in adam["nu"]:
            tol = tol + extra(adam["nu"][k])
        bad = np.abs(got["vars"][k] - w) > tol
        assert not bad.any(), (k, np.abs(got["vars"][k] - w)[bad],
                               tol[bad])
    w = want["classifier"]
    tol = 2e-6 + 1e-4 * np.abs(w) + extra(adam["nu_classifier"])
    assert np.all(np.abs(got["classifier"] - w) <= tol)
    assert got["step"] == want["step"]


def _without_noise(got, want, rate):
    """The noise-only leaf moved at most ``rate`` in each package, then
    left out of the comparison."""
    got = {**got, "vars": dict(got["vars"])}
    want = {**want, "vars": dict(want["vars"])}
    g, w = got["vars"].pop(NOISE_ONLY), want["vars"].pop(NOISE_ONLY)
    assert np.all(np.abs(g - w) <= 2 * rate + 1e-6)
    want["adam"] = {**want["adam"], "nu": {
        k: v for k, v in want["adam"]["nu"].items() if k != NOISE_ONLY}}
    return got, want


def _check_metrics(got_m, want_m):
    for g, w in zip(got_m, want_m):
        assert g.keys() == w.keys()
        for k in w:
            if np.isfinite(w[k]):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            else:
                assert not np.isfinite(g[k]), k
    np.testing.assert_allclose([m["learning_rate"] for m in got_m],
                               [0.025, 0.05, 0.025], rtol=1e-6)


@pytest.mark.parametrize("name,skip", _cases(),
                         ids=[f"{n}-{'skip' if s else 'plain'}"
                              for n, s in _cases()])
def test_three_steps_match_jax(name, skip):
    nan_at = 1 if skip else None
    kw = {"optimizer": name, "skip_nonfinite": skip}
    if name == "lars":
        flat, cls, want_m, want = _jax_case(name, skip)
    else:
        want_m, snaps = _jax_adam_case(name, skip)
        flat, cls = snaps[0]["vars"], snaps[0]["classifier"]
        want = snaps[1:]
    got_m, got, state = _port_run(kw, flat, cls, nan_at=nan_at)
    assert got[-1]["step"] == want[-1]["step"] == STEPS
    opt = state.opt_state["optimizer"]
    if skip:
        assert [m["skipped_nonfinite"] for m in got_m] == [0.0, 1.0, 0.0]
        _assert_states_close({**got[1], "step": 1}, {**got[0], "step": 1},
                             rtol=0, atol=0)
        assert state.opt_state["count"] == 2
    if name == "lars":
        _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
        _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
        _check_metrics(got_m, want_m)
        return
    # Adam's bias correction counts the applied updates only
    assert {float(opt.state[p]["step"]) for g in opt.param_groups
            for p in g["params"]} == {2.0 if skip else 3.0}
    assert [s["adam"]["count"] for s in snaps] == ([0, 1, 1, 2] if skip
                                                   else [0, 1, 2, 3])
    from_jax_m = []
    for i, (x, y) in enumerate(_batches(nan_at)):
        m, g = _port_step_from(kw, snaps[i], x, y)
        from_jax_m.append(m)
        # the rate of the update follows the applied count
        rate = RATES[snaps[i]["adam"]["count"]]
        g, w = _without_noise(g, snaps[i + 1], rate)
        _assert_adam_step_close(g, w, rate)
    _check_metrics(from_jax_m, want_m)


# ---- LARS on a model axis --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_mesh_case(data, model):
    """The JAX trainer under LARS on a (data, model) mesh of the
    data-parallel tests' 32-row batches: (flat, classifier, metrics,
    snapshots, the classifier's first update)."""
    cfg = jt.TrainConfig(**{**td.BASE, "optimizer": "lars",
                            "dtype": jnp.float32})
    mesh = create_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])
    net = JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16)
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(net, cfg, mesh, state)
    metrics, snaps = [], []
    for x, y in td.batches():
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append({"vars": flatten_variables(
            {"params": _np(state.params),
             "batch_stats": _np(state.batch_stats)}),
            "classifier": np.array(state.classifier), "ema": None,
            "step": int(state.step)})
    return flat, cls, metrics, snaps


def test_lars_on_a_model_axis_takes_the_global_leaf_norm(ranks):
    flat, cls, want_m, want = _jax_mesh_case(2, 1)
    _, cls12, _, shard_norm = _jax_mesh_case(1, 2)
    out = ranks.run(td.train_steps, cfg_kw={"optimizer": "lars"},
                    flat=flat, cls=cls, model=2)
    (m0, s0, _), (m1, s1, _) = out
    assert m0 == m1
    got = [td.join_shards([a, b]) for a, b in zip(s0, s1)]
    for g in got:
        g["ema"] = None
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    for g, w in zip(m0, want_m):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    # the classifier's first update, the trust ratio's reading
    moved = got[0]["classifier"] - cls
    np.testing.assert_allclose(moved, want[0]["classifier"] - cls,
                               rtol=1e-3, atol=1e-3 * np.abs(moved).max())
    shard_moved = shard_norm[0]["classifier"] - cls12
    assert np.abs(moved - shard_moved).max() > 0.01 * np.abs(moved).max()
    # the trace of the classifier is global once joined
    assert got[0]["opt"]["trace/classifier"].shape == cls.shape


# ---- checkpoints -----------------------------------------------------------

def _slots(state) -> dict:
    opt = state.opt_state["optimizer"]
    named = {**state.params, "classifier": state.classifier}
    return {f"{slot}/{n}": t.detach().clone()
            for n, p in named.items()
            for slot, t in opt.state.get(p, {}).items()}


def _u8(steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (8, 20, 20, 3), dtype=np.uint8),
             rng.integers(0, 6, 8)) for _ in range(steps)]


def _tiny(name, **kw):
    return TrainConfig(network="resnet_tiny", num_classes=6,
                       embedding_dim=16, image_size=16, crop_from=20,
                       global_batch=8, optimizer=name, **kw)


@pytest.mark.parametrize("name", ("sgd",) + OPTIMIZERS)
def test_checkpoint_round_trip_and_exact_resume(tmp_path, name):
    cfg = _tiny(name)
    data = _u8(4)
    state, net = create_train_state(cfg, 0, device="cpu")
    step = make_train_step(net, cfg, state)
    for x, y in data[:2]:
        state, _ = step(state, x, y)
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.maybe_save(state, force=True)
    with open(os.path.join(mgr.directory, "2", "meta.json")) as f:
        assert json.load(f)["optimizer"] == name
    fresh, fnet = create_train_state(cfg, 9, device="cpu")
    mgr.restore(fresh)
    want = _slots(state)
    got = _slots(fresh)
    assert want.keys() == got.keys() and want
    slots = {k.split("/")[0] for k in want}
    assert slots == set(optimizers.SLOTS[name])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    fstep = make_train_step(fnet, cfg, fresh)
    for x, y in data[2:]:
        state, m = step(state, x, y)
        fresh, fm = fstep(fresh, x, y)
        assert float(m["loss"]) == float(fm["loss"])
    for k, p in state.params.items():
        assert torch.equal(p, fresh.params[k]), k
    assert torch.equal(state.classifier, fresh.classifier)
    other = "lars" if name != "lars" else "adam"
    ostate, _ = create_train_state(_tiny(other), 0, device="cpu")
    with pytest.raises(ValueError, match=f"{name}.*{other}"):
        mgr.restore(ostate)


def test_checkpoint_of_a_model_axis_holds_global_slots(ranks, tmp_path):
    out = ranks.run(td.checkpoint_round_trip, train_dir=str(tmp_path / "g"),
                    model=2, cfg_kw={"optimizer": "adam"})
    for r in out:
        assert r["shapes"]["optimizer_state/exp_avg/classifier"] == (12, 16)
        for k, v in r["saved"]["opt"].items():
            np.testing.assert_array_equal(r["restored"]["opt"][k], v,
                                          err_msg=k)
    raw = CheckpointManager(str(tmp_path / "g")).restore_raw()
    joined = td.join_shards([r["saved"] for r in out])
    for slot in ("exp_avg", "exp_avg_sq"):
        np.testing.assert_array_equal(
            raw["optimizer_state"][slot]["classifier"].numpy(),
            joined["opt"][f"{slot}/classifier"])
