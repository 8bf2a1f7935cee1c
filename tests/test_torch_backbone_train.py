"""Training the port's SE-ResNet, ResNeXt, space2depth ResNet and DenseNet
vs the JAX package's ``make_train_step``, at tiny widths.

Both trainers start from the same variables (JAX init, through the flat
``.npz`` key space) and classifier and take the same f32 steps on a
one-device mesh, with tests/test_torch_trainer.py's bars: losses, grad
norms and learning rates rtol 1e-4; every leaf rtol 1e-4, atol 2e-6
after the first step and rtol 1e-3, atol 3e-4 after the third (one ReLU
that the 1e-6 differences flip moves its channel's BN bias by about
1e-4). bf16: one step, every leaf's update cosine >= 0.999.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trainer import (
    BASE,
    _NOISE_ONLY,
    _assert_states_close,
    _batches,
    _jax_snapshot,
    _np,
    _round_like_torch,
    _to_jax_layout,
)
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.interop.port import jax_leaves
from tf_face_toolbox_tpu_torch.models import create_network
from tf_face_toolbox_tpu_torch.models.layers import TrainContext
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

_D = dict(embedding_dim=16)
# family -> (registry name, tiny overrides, stem)
FAMILIES = {
    "se_resnet": ("se_resnet_50", dict(stage_sizes=(1, 1), width_per_group=8,
                                       se_reduction=4, **_D), "face"),
    "resnext": ("resnext_50", dict(stage_sizes=(1, 1), groups=4,
                                   width_per_group=4, **_D), "imagenet"),
    "space2depth": ("resnet_tiny", dict(stage_sizes=(1, 1), width_per_group=8,
                                        **_D), "space2depth"),
    "densenet": ("densenet_121", dict(stage_sizes=(2, 2), growth_rate=8,
                                      **_D), "face"),
}


def _cfg(family, jax_side, dtype, **over):
    name, _, stem = FAMILIES[family]
    kw = {**BASE, "network": name, "stem": stem, "dtype": dtype, **over}
    return jt.TrainConfig(**kw) if jax_side else TrainConfig(**kw)


def _jax_run(family, steps, dtype=jnp.float32):
    """(initial flat variables, classifier, per-step metrics, the state
    after each step as numpy) of the JAX trainer on the tiny net."""
    name, kw, stem = FAMILIES[family]
    cfg = _cfg(family, True, dtype)
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    net = jax_network(name, **kw, stem=stem, dtype=dtype)
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(net, cfg, mesh, state)
    metrics, states = [], []
    for x, y in _batches(steps=steps):
        x, y = jnp.asarray(x), jnp.asarray(y)
        if dtype == jnp.bfloat16:
            state, m = _round_like_torch(step, state, x, y)(state, x, y, {})
        else:
            state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_jax_snapshot(state))
    return flat, cls, metrics, states


@functools.lru_cache(maxsize=None)
def _jax_case(family, steps):
    return _jax_run(family, steps)


def _port_state(family, flat, cls, dtype=torch.float32, **cfg_kw):
    name, kw, stem = FAMILIES[family]
    cfg = _cfg(family, False, dtype, **cfg_kw)
    net = create_network(name, **kw, stem=stem, dtype=dtype,
                         input_size=BASE["image_size"])
    state, net = create_train_state(cfg, 0, net=net, variables=flat,
                                    classifier=cls, device="cpu")
    return cfg, state, net


def _port_run(family, flat, cls, steps, dtype=torch.float32):
    cfg, state, net = _port_state(family, flat, cls, dtype)
    step = make_train_step(net, cfg, state)
    leaves = list(jax_leaves(net))
    metrics, states = [], []
    for x, y in _batches(steps=steps):
        state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append({"vars": {k: _to_jax_layout(t, kind)
                                for k, t, kind in leaves},
                       "classifier": state.classifier.detach().numpy().copy(),
                       "ema": None, "step": state.step})
    return metrics, states


def _assert_metrics_close(got_m, want_m):
    for g, w in zip(got_m, want_m, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_one_sgd_step_matches_jax(family):
    flat, cls, want_m, want = _jax_case(family, 1)
    got_m, got = _port_run(family, flat, cls, 1)
    _assert_metrics_close(got_m, want_m)
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("family", ["se_resnet", "densenet"])
def test_three_sgd_steps_match_jax(family):
    flat, cls, want_m, want = _jax_case(family, 3)
    got_m, got = _port_run(family, flat, cls, 3)
    _assert_metrics_close(got_m, want_m)
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    np.testing.assert_allclose([m["learning_rate"] for m in got_m],
                               [0.025, 0.05, 0.025], rtol=1e-6)


def _update_cosines(got, want, flat):
    """Per leaf: the cosine of the two updates (new - old), or None
    where ``want`` did not move the leaf (``got`` must not either)."""
    out = {}
    for k in want["vars"]:
        if k == _NOISE_ONLY:
            continue
        g = (got["vars"][k] - flat[k]).ravel().astype(np.float64)
        w = (want["vars"][k] - flat[k]).ravel().astype(np.float64)
        if not w.any():
            assert not g.any(), k
            out[k] = None
            continue
        out[k] = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    return out


def test_bf16_step_tracks_jax_se_resnet():
    """bf16 compute, one SE-ResNet step (squeeze-excite rounds as flax's
    bf16 Dense does): the loss within 1e-4 of JAX's, and every leaf's
    update points the JAX update's way (cosine >= 0.999); a leaf no
    gradient reaches stays put in both."""
    flat, cls, want_m, want = _jax_run("se_resnet", 1, jnp.bfloat16)
    got_m, got = _port_run("se_resnet", flat, cls, 1, torch.bfloat16)
    np.testing.assert_allclose(got_m[0]["loss"], want_m[0]["loss"],
                               rtol=1e-4)
    cos = _update_cosines(got[-1], want[-1], flat)
    moved = [k for k, c in cos.items() if c is not None]
    assert len(moved) >= 20
    assert all(cos[k] >= 0.999 for k in moved), cos


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_step_is_as_close_to_f32_as_jax_bf16(family):
    """bf16 compute, one step, each held against the f32 JAX step from
    the same state: the port's loss error is at most twice JAX's bf16
    loss error (plus 1e-5 relative), and on every leaf the port's
    update is at most twice as far from the f32 update (1 - cosine) as
    JAX's bf16 update is (plus 1e-4). A bf16 step's rounding flips a few
    ReLUs and BN inputs wherever two sums round apart, and a DenseNet's
    BatchNorms on the concatenated stream spread each flip, so the
    port's bf16 step cannot match JAX's to the f32 bars; it must be as
    accurate."""
    flat, cls, ref_m, ref = _jax_case(family, 1)
    _, _, jax_m, jax16 = _jax_run(family, 1, jnp.bfloat16)
    got_m, got = _port_run(family, flat, cls, 1, torch.bfloat16)
    loss = ref_m[0]["loss"]
    assert abs(got_m[0]["loss"] - loss) <= \
        2 * abs(jax_m[0]["loss"] - loss) + 1e-5 * abs(loss)
    ours = _update_cosines(got[-1], ref[-1], flat)
    theirs = _update_cosines(jax16[-1], ref[-1], flat)
    assert sum(c is not None for c in ours.values()) >= 20
    for k, c in ours.items():
        if c is not None:
            assert 1 - c <= 2 * (1 - theirs[k]) + 1e-4, (k, c, theirs[k])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_weight_decay_groups_match_the_jax_mask(family):
    """Decay on every conv kernel (grouped, DenseNet's plain ones), every
    Dense kernel (squeeze-excite's too) and the classifier: the leaves
    JAX's ``decay_mask`` picks (a last path entry "kernel", and
    "classifier"); none on BN scales and biases or Dense biases."""
    flat, cls, _, _ = _jax_case(family, 1)
    _, state, net = _port_state(family, flat, cls)
    groups = state.opt_state["optimizer"].param_groups
    decayed = {id(p) for p in groups[0]["params"]}
    assert groups[0]["weight_decay"] == BASE["weight_decay"]
    assert groups[1]["weight_decay"] == 0.0
    got = {k for k, t, _ in jax_leaves(net) if id(t) in decayed}
    want = {k for k in flat if k.startswith("params/")
            and k.rsplit("/", 1)[1] == "kernel"}
    assert got == want
    assert id(state.classifier) in decayed
    if family == "se_resnet":
        assert "params/BottleneckBlock_1/SqueezeExcite_0/Dense_0/kernel" in got
    if family == "densenet":
        assert {"params/Conv_0/kernel", "params/_BNReLUConv_0/kernel",
                "params/DenseLayer_3/_BNReLUConv_1/kernel"} <= got


def test_densenet_state_survives_a_checkpoint_round_trip(tmp_path):
    """Checkpoints and EMA need no code of their own for a new family: a
    DenseNet state (EMA on) restores bit for bit."""
    flat, cls, _, _ = _jax_case("densenet", 1)
    cfg, state, net = _port_state("densenet", flat, cls, ema_decay=0.9)
    step = make_train_step(net, cfg, state)
    for x, y in _batches(steps=2):
        state, _ = step(state, x, y)
    mgr = CheckpointManager(str(tmp_path / "c"), save_every=1)
    assert mgr.maybe_save(state, force=True)
    mgr.wait()
    _, fresh, _ = _port_state("densenet", None, None, ema_decay=0.9)
    assert not torch.equal(fresh.classifier, state.classifier)
    restored = mgr.restore(fresh)
    assert restored.step == state.step == 2
    assert restored.ema_params is not None
    for name in ("params", "batch_stats", "ema_params"):
        a, b = getattr(restored, name), getattr(state, name)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(restored.classifier, state.classifier)
    opt_a = restored.opt_state["optimizer"]
    opt_b = state.opt_state["optimizer"]
    for pa, pb in zip(opt_a.param_groups[0]["params"],
                      opt_b.param_groups[0]["params"], strict=True):
        assert torch.equal(opt_a.state[pa]["momentum_buffer"],
                           opt_b.state[pb]["momentum_buffer"])
    mgr.close()


@pytest.mark.parametrize("remat", [True, "save_convs"], ids=str)
def test_remat_keeps_se_blocks_exact(remat):
    """Block remat recomputes an SE block in backward: the same gradients
    and updated running statistics as without it."""
    name, kw, stem = FAMILIES["se_resnet"]

    def grads(net):
        ctx = TrainContext()
        x = torch.randn(2, 16, 16, 3,
                        generator=torch.Generator().manual_seed(1))
        net(x, train=ctx).square().sum().backward()
        return ({n: p.grad for n, p in net.named_parameters()},
                [tuple(v) for v in ctx.stats.values()])

    base = create_network(name, **kw, stem=stem)
    net = create_network(name, **kw, stem=stem, remat=remat)
    net.load_state_dict(base.state_dict())
    (g1, s1), (g2, s2) = grads(base), grads(net)
    assert g1.keys() == g2.keys()
    assert any("SqueezeExcite_0" in k for k in g1)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=0, atol=0, msg=k)
    assert len(s1) == len(s2)
    for (m1, v1), (m2, v2) in zip(s1, s2):
        assert torch.equal(m1, m2) and torch.equal(v1, v2)


def test_cli_train_then_extract_serves_an_se_resnet_checkpoint(tmp_path,
                                                                capsys):
    """cli.train writes an se_resnet_50 checkpoint (space2depth stem);
    cli.extract --checkpoint_dir serves it through the folded engine
    (auto) within f32 rounding of the module path."""
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract
    from tf_face_toolbox_tpu_torch.cli import train as cli_train
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays

    run = str(tmp_path / "run")
    net = ["--network=se_resnet_50", "--stem=space2depth",
           "--embedding_dim=16", "--image_size=16", "--nobf16",
           "--device=cpu"]
    cli_train.main([*net, "--crop_from=20", "--global_batch=4",
                    "--num_classes=5", "--num_steps=2", "--log_every=1",
                    "--train_dir", run])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "done: step=2 loss=")
    assert CheckpointManager(run).latest_step() == 2
    shard = str(tmp_path / "f.faceshard")
    faces = np.random.default_rng(0).integers(0, 256, (6, 24, 24, 3),
                                              dtype=np.uint8)
    pack_arrays(shard, faces, list(range(6)))
    outs = {}
    for engine in ("auto", "module"):
        outs[engine] = str(tmp_path / f"{engine}.npy")
        cli_extract.main([*net, "--checkpoint_dir", run, "--data", shard,
                          "--output", outs[engine], "--crop_from", "24",
                          "--batch", "3", "--loader", "python",
                          "--engine", engine])
    got, want = np.load(outs["auto"]), np.load(outs["module"])
    assert got.shape == (6, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(SystemExit, match="space2depth is a resnet-family"):
        cli_train.main(["--network=densenet_121", "--stem=space2depth",
                        "--device=cpu"])


def _assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif a is None or isinstance(a, (int, float)):
        assert a == b, path
    else:
        assert np.array_equal(a, b), path


def test_two_gloo_ranks_train_a_densenet_as_the_replica_loop():
    """Data parallelism needs no code of its own for a new family: two
    gloo ranks take a densenet_121 step (published widths, 16 px) whose
    state equals on both ranks and equals ``replica_loop_step``'s, the
    plain version, bit for bit (tests/test_torch_parallel.py's bar)."""
    from tests import torch_dist as td

    kw = {"network": "densenet_121", "dtype": torch.float32}
    with td.Ranks(2) as ranks:
        (m0, s0, _), (m1, s1, _) = ranks.run(td.train_steps, cfg_kw=kw,
                                             steps=1)
    _assert_equal(s0[-1], s1[-1])
    rm, rs = td.replica_steps(kw, 2, steps=1)
    _assert_equal(s0[-1], rs[-1])
    assert m0 == m1 == rm and np.isfinite(m0[0]["loss"])
