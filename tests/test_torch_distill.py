"""Embedding distillation in the port's trainer, against the JAX package's
``make_train_step(teacher=)`` (tests/test_distill.py's cases).

A frozen teacher (a tiny ResNet, its own JAX init) forwards the same
views in eval mode; the student minimizes alpha * mean(1 - cos) against
its embeddings, plus (1 - alpha) times the margin loss when alpha < 1.
Both packages start from the same variables, classifier and teacher
(through the flat ``.npz`` key space) and take three f32 steps on
tests/test_torch_trainer.py's batches, one device, at that file's
tolerances: loss, distill_loss, margin_loss, grad_norm rtol 1e-4;
params, classifier and BN statistics rtol 1e-4, atol 2e-6 after the
first step and rtol 1e-3, atol 3e-4 after the third.

- alpha 1: the margin head does not run (no margin_loss), the classifier
  gets a zero gradient and still decays and steps its momentum, as
  optax does (a torch optimizer skips a parameter whose gradient is
  None: the trainer gives it zeros);
- alpha 0.5: both parts reported, the loss their mix;
- the two refusals (alpha outside (0, 1]; pure distillation with a
  margin mode or an auxiliary loss that it would leave dead);
- two gloo ranks on a (data 1, model 2) grid against JAX on a (1, 2)
  mesh (the distill term over a rank's own rows, divided by the model
  size, as JAX divides it);
- convergence toward the teacher, and ``cli.train --distill_from`` with a
  teacher ``.npz`` that the JAX package wrote.
"""

import functools
import os
import subprocess
import sys

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
    _jax_snapshot,
    _np,
)
from tf_face_toolbox_tpu.interop.port import (
    flatten_variables,
    save_variables_npz,
)
from tf_face_toolbox_tpu.models import init_variables
from tf_face_toolbox_tpu.models.resnet import ResNet as JaxResNet
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.models import create_network
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    build_network,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_net():
    return JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16)


@functools.lru_cache(maxsize=None)
def _teacher():
    """(JAX net, JAX variables, flat variables) of the teacher."""
    net = _jax_net()
    v = init_variables(net, jax.random.key(7), (1, 16, 16, 3))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    return net, v, flatten_variables(jax.tree.map(np.array, v))


@functools.lru_cache(maxsize=None)
def _jax_case(alpha, data=1, model=1, rows=16, seed=7):
    cfg = jt.TrainConfig(**{**BASE, "distill_alpha": alpha,
                            "global_batch": rows, "dtype": jnp.float32})
    mesh = create_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh,
                                       net=_jax_net())
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    t_net, t_vars, _ = _teacher()
    step = jt.make_train_step(net, cfg, mesh, state, teacher=(t_net, t_vars))
    batches = (_batches() if rows == 16 else
               td.batches(rows=rows, seed=seed))
    metrics, states = [], []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_jax_snapshot(state))
    return flat, cls, metrics, states


def _port_distill(alpha, flat, cls):
    cfg = TrainConfig(**{**BASE, "distill_alpha": alpha})
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    teacher = (create_network("resnet_tiny", embedding_dim=16), _teacher()[2])
    step = make_train_step(net, cfg, state, teacher=teacher)
    metrics, snaps = [], []
    from tf_face_toolbox_tpu_torch.interop.port import jax_leaves
    from tests.test_torch_trainer import _to_jax_layout
    leaves = list(jax_leaves(net))
    for x, y in _batches():
        state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append({"vars": {k: _to_jax_layout(t, kind)
                               for k, t, kind in leaves},
                      "classifier": state.classifier.detach().numpy().copy(),
                      "ema": None, "step": state.step})
    return metrics, snaps, state


def _check(got_m, got, want_m, want):
    assert got[-1]["step"] == want[-1]["step"] == STEPS
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    for g, w in zip(got_m, want_m):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_pure_distillation_matches_jax_and_decays_the_classifier():
    flat, cls, want_m, want = _jax_case(1.0)
    got_m, got, state = _port_distill(1.0, flat, cls)
    _check(got_m, got, want_m, want)
    assert "margin_loss" not in got_m[-1]
    np.testing.assert_allclose(got_m[-1]["loss"], got_m[-1]["distill_loss"],
                               rtol=1e-6)
    # the classifier, which the objective never reaches, still decays:
    # with a zero gradient, SGD's decayed update -lr * wd * w, traced
    assert not np.array_equal(got[-1]["classifier"], cls)
    opt = state.opt_state["optimizer"]
    assert state.classifier.grad is not None
    assert not state.classifier.grad.any()
    assert "momentum_buffer" in opt.state[state.classifier]
    lr, wd, mom = (0.025, 0.05, 0.025), BASE["weight_decay"], 0.9
    w, buf = cls.astype(np.float64), np.zeros_like(cls, np.float64)
    for rate in lr:
        buf = mom * buf + wd * w
        w = w - rate * buf
    np.testing.assert_allclose(got[-1]["classifier"], w, rtol=1e-6)


def test_mixed_alpha_matches_jax_and_reports_both_parts():
    flat, cls, want_m, want = _jax_case(0.5)
    got_m, got, _ = _port_distill(0.5, flat, cls)
    _check(got_m, got, want_m, want)
    for m in got_m:
        assert np.isfinite(m["distill_loss"]) and np.isfinite(
            m["margin_loss"])
        np.testing.assert_allclose(
            m["loss"], 0.5 * m["distill_loss"] + 0.5 * m["margin_loss"],
            rtol=1e-5)


@pytest.mark.parametrize("kw,why", [
    (dict(distill_alpha=0.0), "distill_alpha must be in"),
    (dict(distill_alpha=1.5), "distill_alpha must be in"),
    (dict(margin_mode="adaface"), "pure distillation"),
    (dict(center_weight=0.1), "pure distillation"),
    (dict(triplet_weight=0.1), "pure distillation")],
    ids=["zero", "above_one", "adaface", "center", "triplet"])
def test_alpha_refusals(kw, why):
    cfg = TrainConfig(**{**BASE, **kw})
    state, net = create_train_state(cfg, 0, device="cpu")
    teacher = build_network(cfg)
    with pytest.raises(ValueError, match=why):
        make_train_step(net, cfg, state, teacher=teacher)
    jcfg = jt.TrainConfig(**{**BASE, **kw, "dtype": jnp.float32})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    jstate, jnet = jt.create_train_state(jcfg, jax.random.key(0), mesh,
                                         net=_jax_net())
    with pytest.raises(ValueError, match=why):
        jt.make_train_step(jnet, jcfg, mesh, jstate,
                           teacher=_teacher()[:2])


def test_a_distilling_student_leaves_its_teacher_and_bn_alone():
    """The teacher runs in eval mode under no_grad: its weights and
    running statistics stay as given, and none of its tensors wants a
    gradient."""
    cfg = TrainConfig(**{**BASE, "distill_alpha": 0.5})
    state, net = create_train_state(cfg, 0, device="cpu")
    teacher = create_network("resnet_tiny", embedding_dim=16)
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    load_jax_variables(teacher, _teacher()[2])
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    step = make_train_step(net, cfg, state, teacher=teacher)
    for x, y in _batches():
        state, _ = step(state, x, y)
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(2) as r:
        yield r


def test_two_ranks_on_a_model_axis_match_jax(ranks):
    """The distill term over each rank's own rows, divided by the model
    size: two ranks of one model row against JAX on a (1, 2) mesh."""
    flat, cls, want_m, want = _jax_case(0.5, 1, 2, rows=32)
    out = ranks.run(td.train_steps, cfg_kw={"distill_alpha": 0.5},
                    flat=flat, cls=cls, model=2, teacher_flat=_teacher()[2])
    (m0, s0, _), (m1, s1, _) = out
    assert m0 == m1
    got = [td.join_shards([a, b]) for a, b in zip(s0, s1)]
    for g in got:
        g["ema"] = None
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    for g, w in zip(m0, want_m):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def _learnable(rng, n):
    labels = rng.integers(0, 12, n)
    base = np.eye(3)[labels % 3] * 2.0 - 1.0
    x = 0.1 * rng.standard_normal((n, 16, 16, 3)) + base[:, None, None, :]
    return x.astype(np.float32), labels.astype(np.int32)


def test_pure_distillation_converges_toward_the_teacher():
    """15 steps of pure distillation: the distill loss falls, and a
    held-out batch's student embeddings (eval mode) turn toward the
    teacher's."""
    cfg = TrainConfig(**{**BASE, "warmup_steps": 0,
                         "lr_boundaries": (10 ** 6,)})
    state, net = create_train_state(cfg, 0, device="cpu")
    teacher = create_network("resnet_tiny", embedding_dim=16)
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    load_jax_variables(teacher, _teacher()[2]).eval()
    x_out, _ = _learnable(np.random.default_rng(999), 16)

    def held_out_cos():
        net.eval()
        with torch.no_grad():
            s = net(torch.from_numpy(x_out)).double()
            t = teacher(torch.from_numpy(x_out)).double()
        net.train()
        return torch.nn.functional.cosine_similarity(s, t).mean().item()

    before = held_out_cos()
    step = make_train_step(net, cfg, state, teacher=teacher)
    rng = np.random.default_rng(3)
    hist = []
    for _ in range(15):
        state, m = step(state, *_learnable(rng, 16))
        hist.append(float(m["distill_loss"]))
    assert np.mean(hist[-3:]) < np.mean(hist[:3]), hist
    assert held_out_cos() > before + 0.1, (before, held_out_cos())


def test_cli_distils_from_a_jax_npz(tmp_path):
    """``cli.train --distill_from`` with the JAX package's ``.npz`` of a
    teacher; a source without BN statistics exits, as JAX's does."""
    npz = str(tmp_path / "teacher.npz")
    save_variables_npz(npz, _teacher()[1])
    env = {**os.environ, "PYTHONPATH": ROOT}
    base = [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.train",
            "--device=cpu", "--network=resnet_tiny", "--embedding_dim=16",
            "--image_size=16", "--crop_from=20", "--global_batch=8",
            "--num_classes=10", "--num_steps=2", "--log_every=1",
            "--nobf16", "--distill_network=resnet_tiny"]
    r = subprocess.run([*base, f"--distill_from={npz}",
                        "--distill_alpha=1.0"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1].startswith("done: step=2")
    assert "distill_loss=" in r.stderr
    bad = str(tmp_path / "params_only.npz")
    save_variables_npz(bad, {"params": _teacher()[1]["params"]})
    r = subprocess.run([*base, f"--distill_from={bad}"], cwd=ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0 and "lacks ['batch_stats']" in r.stderr
