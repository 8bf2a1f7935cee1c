"""Port train step vs the JAX package's ``make_train_step``.

Both start from the same variables (JAX init, through the flat ``.npz``
key space) and the same classifier, and take three steps on the same f32
batches (``augment=False``: the two packages' random streams differ) on
a one-device mesh, where the JAX step's sharded head is the plain one.
Tolerance (f32 on the CPU): loss, grad_norm and learning rate rtol
1e-4 at every step. Params, classifier, BN statistics and EMA: rtol
1e-4, atol 2e-6 after the first step (reduction orders differ: BN
statistics, conv algorithms; weight decay alone moves a kernel by
1e-5 a step here), and rtol 1e-3, atol 3e-4 after the third, where one
ReLU at the block output that the 1e-6 differences flip moves both of
its channel's BN biases by lr * |g|, about 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models.layers import ConvBN as JaxConvBN
from tf_face_toolbox_tpu.models.resnet import ResNet as JaxResNet
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.interop.port import jax_leaves
from tf_face_toolbox_tpu_torch.models import create_network, init_parameters
from tf_face_toolbox_tpu_torch.models.layers import (
    ConvBN,
    EmbeddingHead,
    TrainContext,
    dropout,
)
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

SIZE, CLASSES, BATCH, STEPS = 16, 12, 16, 3
# CosFace, momentum, weight decay, a staircase with a 2-step warmup and a
# boundary at step 2: learning rates 0.025, 0.05, 0.025
BASE = dict(network="resnet_tiny", num_classes=CLASSES, embedding_dim=16,
            image_size=SIZE, global_batch=BATCH, base_lr=0.05,
            warmup_steps=2, lr_boundaries=(2,), lr_decay=0.5,
            momentum=0.9, weight_decay=5e-3, margin_scale=16.0,
            margin_m3=0.35, augment=False)
CASES = {
    "cosface": {},
    "arcface": dict(margin_m2=0.5, margin_m3=0.0),
    "clip": dict(grad_clip_norm=1.0),
    "ema": dict(ema_decay=0.9),
    "accum2": dict(accum_steps=2),
    "skip_nonfinite": dict(skip_nonfinite=True),
}


def _batches(nan_at=None, steps=STEPS):
    rng = np.random.default_rng(7)
    out = []
    for i in range(steps):
        x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
        if i == nan_at:
            x[0, 0, 0, 0] = np.nan
        out.append((x, rng.integers(0, CLASSES, BATCH).astype(np.int32)))
    return out


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_snapshot(state):
    return {"vars": flatten_variables({"params": _np(state.params),
                                      "batch_stats": _np(state.batch_stats)}),
            "classifier": np.array(state.classifier),
            "ema": (flatten_variables({"params": _np(state.ema_params)})
                    if state.ema_params is not None else None),
            "step": int(state.step)}


def _round_like_torch(step, state, x, y):
    """The JAX step compiled without XLA's excess precision (on by
    default: the CPU backend may skip a bf16 rounding between fused
    ops), so it rounds where the port does."""
    jitted = next(c.cell_contents for c in step.__closure__
                  if hasattr(c.cell_contents, "lower"))
    return jitted.lower(state, x, y, {}).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _jax_run(kw, dtype=jnp.float32, nan_at=None, steps=STEPS):
    """(initial flat variables, classifier, per-step metrics, the state
    after each step as numpy) of the JAX trainer."""
    cfg = jt.TrainConfig(**{**BASE, **kw, "dtype": dtype})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    net = JaxResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=16,
                    dtype=dtype)
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(net, cfg, mesh, state)
    metrics, states = [], []
    for x, y in _batches(nan_at, steps):
        x, y = jnp.asarray(x), jnp.asarray(y)
        if dtype == jnp.bfloat16:
            state, m = _round_like_torch(step, state, x, y)(state, x, y, {})
        else:
            state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_jax_snapshot(state))
    return flat, cls, metrics, states


def _to_jax_layout(t, kind):
    a = t.detach().float().cpu().numpy().copy()
    if kind == "conv":
        return np.transpose(a, (2, 3, 1, 0))
    if kind == "dense":
        return a.T
    return a


def _port_run(kw, flat, cls, dtype=torch.float32, nan_at=None, steps=STEPS):
    cfg = TrainConfig(**{**BASE, **kw, "dtype": dtype})
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    step = make_train_step(net, cfg, state)
    leaves = list(jax_leaves(net))
    names = {id(p): n for n, p in net.named_parameters()}

    def snapshot():
        snap = {"vars": {k: _to_jax_layout(t, kind)
                         for k, t, kind in leaves},
                "classifier": state.classifier.detach().numpy().copy(),
                "ema": None, "step": state.step}
        if state.ema_params is not None:
            snap["ema"] = {k: _to_jax_layout(state.ema_params[names[id(t)]],
                                             kind)
                           for k, t, kind in leaves if id(t) in names}
        return snap

    metrics, states = [], []
    for x, y in _batches(nan_at, steps):
        state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(snapshot())
    return metrics, states, state


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    nan_at = 1 if name == "skip_nonfinite" else None
    return _jax_run(CASES[name], nan_at=nan_at)


def _assert_states_close(got, want, rtol, atol):
    assert got["step"] == want["step"]
    assert got["vars"].keys() == want["vars"].keys()
    for k in want["vars"]:
        np.testing.assert_allclose(got["vars"][k], want["vars"][k],
                                   rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_allclose(got["classifier"], want["classifier"],
                               rtol=rtol, atol=atol)
    assert (got["ema"] is None) == (want["ema"] is None)
    if want["ema"] is not None:
        for k in want["ema"]:
            np.testing.assert_allclose(got["ema"][k], want["ema"][k],
                                       rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_three_sgd_steps_match_jax(name):
    flat, cls, want_m, want = _jax_case(name)
    nan_at = 1 if name == "skip_nonfinite" else None
    got_m, got, _ = _port_run(CASES[name], flat, cls, nan_at=nan_at)
    assert got[-1]["step"] == want[-1]["step"] == STEPS
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    for g, w in zip(got_m, want_m):
        assert g.keys() == w.keys()
        for k in w:
            if np.isfinite(w[k]):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            else:
                assert not np.isfinite(g[k]), k
    np.testing.assert_allclose([m["learning_rate"] for m in got_m],
                               [0.025, 0.05, 0.025], rtol=1e-6)
    if name == "skip_nonfinite":
        assert [m["skipped_nonfinite"] for m in got_m] == [0.0, 1.0, 0.0]
        # the skipped step held every leaf
        _assert_states_close({**got[1], "step": 1}, {**got[0], "step": 1},
                             rtol=0, atol=0)


def test_skipped_step_holds_state_and_lr_count():
    """A NaN batch changes nothing but ``step``; the next update applies
    the learning rate of the optimizer's count (1), while the metric
    follows the step (2)."""
    flat, cls, _, _ = _jax_case("skip_nonfinite")
    _, _, state = _port_run(CASES["skip_nonfinite"], flat, cls, nan_at=1)
    assert state.step == 3 and state.opt_state["count"] == 2
    opt = state.opt_state["optimizer"]
    assert opt.param_groups[0]["lr"] == pytest.approx(0.05)


def test_first_momentum_step_is_the_gradient():
    """optax's trace starts at zero and torch's buffer at a copy of the
    first gradient: both give buf = g (+ weight decay) at step 0."""
    flat, cls, _, _ = _jax_case("cosface")
    cfg = TrainConfig(**BASE)
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_train_step(net, cfg, state)
    x, y = _batches()[0]
    step(state, x, y)
    opt = state.opt_state["optimizer"]
    for group in opt.param_groups:
        for p in group["params"]:
            if p is state.classifier:
                continue
            name = next(k for k, q in state.params.items() if q is p)
            buf = opt.state[p]["momentum_buffer"]
            want = p.grad + group["weight_decay"] * before[name]
            torch.testing.assert_close(buf, want, rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(before[name] - 0.025 * buf, p.detach(),
                                       rtol=1e-6, atol=1e-7)


# A Dense feeding a BatchNorm: its bias has no gradient in exact
# arithmetic (the BN removes the mean), so its update is rounding noise.
_NOISE_ONLY = "params/EmbeddingHead_0/Dense_0/bias"


def test_bf16_step_tracks_jax():
    """bf16 compute, one step: the loss within 1e-4, and every leaf's
    update (new - old) points the JAX update's way, cosine >= 0.999;
    leaves that no gradient reaches (the blocks' inner BNs, behind the
    zero-initialized branch scale) stay put in both."""
    flat, cls, want_m, want = _jax_run({}, dtype=jnp.bfloat16, steps=1)
    got_m, got, _ = _port_run({}, flat, cls, dtype=torch.bfloat16, steps=1)
    got, want = got[-1], want[-1]
    np.testing.assert_allclose(got_m[0]["loss"], want_m[0]["loss"],
                               rtol=1e-4)
    pairs = [(got["vars"][k] - flat[k], want["vars"][k] - flat[k], k)
             for k in want["vars"] if k != _NOISE_ONLY]
    pairs.append((got["classifier"] - cls, want["classifier"] - cls, "cls"))
    moved = 0
    for g, w, k in pairs:
        g, w = g.ravel().astype(np.float64), w.ravel().astype(np.float64)
        if not w.any():
            assert not g.any(), k
            continue
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= 0.999, (k, cos)
        moved += 1
    assert moved >= 20


def _learnable_batch(rng, n):
    """Identity k: a per-id channel bias on small noise (the pattern of
    tests/test_train.py's synthetic batch)."""
    labels = rng.integers(0, CLASSES, n)
    base = np.eye(3)[labels % 3] * 2.0 - 1.0
    noise = 0.1 * rng.standard_normal((n, SIZE, SIZE, 3))
    x = noise + base[:, None, None, :] * (labels / CLASSES)[:, None, None, None]
    return x.astype(np.float32), labels.astype(np.int32)


def test_loss_decreases_on_learnable_synthetic_data():
    cfg = TrainConfig(**{**BASE, "margin_m3": 0.0, "weight_decay": 0.0,
                         "warmup_steps": 0, "lr_boundaries": (10 ** 6,)})
    state, net = create_train_state(cfg, 0, device="cpu")
    step = make_train_step(net, cfg, state)
    rng = np.random.default_rng(100)
    losses = []
    for _ in range(12):
        state, m = step(state, *_learnable_batch(rng, BATCH))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_matches_flax(dtype):
    """ConvBN in train mode: output, updated running statistics (flax's
    biased variance, momentum 0.9) and the gradients of a weighted sum
    against the input and every parameter, vs flax ``ConvBN(train=True)``."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 9, 9, 5)) * 2 + 1).astype(np.float32)
    r = rng.standard_normal((4, 5, 5, 6)).astype(np.float32)
    jmod = JaxConvBN(6, (3, 3), strides=(2, 2), dtype=jdt)
    v = jmod.init(jax.random.key(0), jnp.asarray(x), train=False)
    v = jax.tree.map(np.array, v)
    bs = v["batch_stats"]["BatchNorm_0"]
    bs["mean"] = rng.standard_normal(6).astype(np.float32)
    bs["var"] = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    pbn = v["params"]["BatchNorm_0"]
    pbn["scale"] = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    pbn["bias"] = rng.standard_normal(6).astype(np.float32)

    def jloss(params, xx):
        y, upd = jmod.apply({"params": params, "batch_stats":
                             v["batch_stats"]}, xx, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * r), (y, upd)

    (_, (jy, jupd)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))

    tmod = ConvBN(5, 6, 3, 2, dtype=tdt)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(
            np.transpose(v["params"]["kernel"], (3, 2, 0, 1))))
        tmod.BatchNorm_0.weight.copy_(torch.from_numpy(pbn["scale"]))
        tmod.BatchNorm_0.bias.copy_(torch.from_numpy(pbn["bias"]))
        tmod.BatchNorm_0.running_mean.copy_(torch.from_numpy(bs["mean"]))
        tmod.BatchNorm_0.running_var.copy_(torch.from_numpy(bs["var"]))
    tx = torch.from_numpy(x).requires_grad_(True)
    ctx = TrainContext()
    ty = tmod(tx, train=ctx)
    (ty.float() * torch.from_numpy(r)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    assert ty.dtype == tdt
    np.testing.assert_allclose(ty.float().detach().numpy(),
                               np.asarray(jy, np.float32), **tol)
    mean, var = ctx.stats[tmod.BatchNorm_0]
    np.testing.assert_allclose(mean.numpy(), jupd["batch_stats"][
        "BatchNorm_0"]["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), jupd["batch_stats"][
        "BatchNorm_0"]["var"], rtol=1e-5, atol=1e-6)
    # the module's own statistics are untouched: the step decides
    np.testing.assert_array_equal(tmod.BatchNorm_0.running_mean.numpy(),
                                  bs["mean"])
    grads = {"x": (tx.grad, jgx),
             "kernel": (tmod.weight.grad.permute(2, 3, 1, 0),
                        jgp["kernel"]),
             "scale": (tmod.BatchNorm_0.weight.grad,
                       jgp["BatchNorm_0"]["scale"]),
             "bias": (tmod.BatchNorm_0.bias.grad,
                      jgp["BatchNorm_0"]["bias"])}
    for k, (g, w) in grads.items():
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            cos = (g * w).sum() / (np.linalg.norm(g) * np.linalg.norm(w))
            assert cos >= 0.999, (k, cos)


def test_fresh_init_follows_the_jax_initialisers():
    """Zero scale on each branch's last BN, unit scale elsewhere, unit
    running variance, zero biases; conv kernels at variance 2 / fan_out
    and Dense at 1 / fan_in, within +-2 std (truncated normal)."""
    net = create_network("resnet_v1_50", embedding_dim=512)
    init_parameters(net, seed=0)
    for key, t, kind in jax_leaves(net):
        v = t.detach()
        leaf = key.rsplit("/", 1)[1]
        if kind == "conv":
            o, _, kh, kw = v.shape
            std = np.sqrt(2.0 / (kh * kw * o)) / 0.87962566103423978
            assert v.abs().max() <= 2 * std * (1 + 1e-6), key
            if v.numel() > 10_000:
                assert abs(v.var().item() * kh * kw * o / 2.0 - 1) < 0.05, key
        elif kind == "dense":
            assert abs(v.var().item() * v.shape[1] - 1) < 0.05, key
        elif leaf == "scale":
            assert torch.all(v == (0.0 if "/ConvBN_2/" in key else 1.0)), key
        elif leaf == "var":
            assert torch.all(v == 1.0), key
        else:
            assert torch.all(v == 0.0), key
    # two seeds differ, one seed repeats
    a = dict(net.named_parameters())["ConvBN_0.weight"].detach().clone()
    init_parameters(net, seed=0)
    torch.testing.assert_close(dict(net.named_parameters())[
        "ConvBN_0.weight"].detach(), a, rtol=0, atol=0)


def test_unported_fields_raise_naming_their_item():
    """The fields of paths still to port raise naming their item; those
    of items since ported build: sampled Partial-FC (item 11), the loss
    heads (item 9: adaface, center and triplet raised here until then;
    their numbers are held against JAX in
    tests/test_torch_adaptive_trainer.py), and the space2depth stem (item
    4; held against JAX in tests/test_torch_backbone_train.py)."""
    # QAT (item 18) raised here until it was ported; its steps are held
    # against JAX in tests/test_torch_qat.py
    assert TrainConfig(quantized="qat").quantized == "qat"
    # the other optimizers (item 10c) build; their steps are held against
    # JAX in tests/test_torch_optimizers.py
    for name in ("adam", "adamw", "lars"):
        assert TrainConfig(optimizer=name).optimizer == name
    assert TrainConfig(pfc_sample_rate=0.1).pfc_sample_rate == 0.1
    assert TrainConfig(stem="space2depth").stem == "space2depth"
    heads = {"margin_mode": "adaface", "center_weight": 0.1,
             "triplet_weight": 0.1}
    for name, value in heads.items():
        assert getattr(TrainConfig(**{name: value}), name) == value
    state, _ = create_train_state(TrainConfig(**BASE, **heads), 0,
                                  device="cpu")
    assert sorted(state.head_state) == ["adaface", "centers"]
    assert state.head_state["centers"].shape == (CLASSES, 16)
    cfg = TrainConfig(**BASE)
    state, net = create_train_state(cfg, 0, device="cpu")
    # distillation (item 10c) builds; held against JAX in
    # tests/test_torch_distill.py
    teacher = create_network("resnet_tiny", embedding_dim=16)
    init_parameters(teacher, 7)
    step = make_train_step(net, cfg, state, teacher=(teacher, None))
    _, m = step(state, *_batches(steps=1)[0])
    assert np.isfinite(float(m["distill_loss"]))
    # the DCT input (item 17b) is ported: it needs the augment chain, as
    # JAX's (held against the u8 step in tests/test_torch_dct.py)
    with pytest.raises(ValueError, match="requires the augment"):
        make_train_step(net, cfg, state, input_format="dct")


def test_weight_decay_mask_matches_jax():
    """Decay on conv and Dense kernels and the classifier; none on BN
    scales and biases or Dense biases: the leaves the JAX mask
    (``make_optimizer``'s ``decay_mask``) picks, "kernel" and
    "classifier"."""
    flat, cls, _, _ = _jax_case("cosface")
    cfg = TrainConfig(**BASE)
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    groups = state.opt_state["optimizer"].param_groups
    decayed = {id(p) for p in groups[0]["params"]}
    assert groups[0]["weight_decay"] == cfg.weight_decay
    assert groups[1]["weight_decay"] == 0.0
    got = {k for k, t, _ in jax_leaves(net) if id(t) in decayed}
    want = {k for k in flat if k.startswith("params/")
            and k.endswith("/kernel")}
    assert got == want
    assert id(state.classifier) in decayed


def test_config_fields_match_jax():
    """The port's TrainConfig has the JAX one's fields and defaults
    (dtype and the adaptive-margin configs aside)."""
    want = {f.name: f.default for f in dataclasses.fields(jt.TrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert got.keys() == want.keys()
    for k in set(want) - {"dtype", "magface", "adaface"}:
        assert got[k] == want[k], k


def test_flatten_head_dropout_draws_from_the_context_generator():
    """flax nn.Dropout semantics: keep with probability 1 - rate, kept
    values divided by it, the mask from the given generator (same seed,
    same mask). The flatten head drops out in train mode only."""
    x = torch.randn(64, 3, 3, 8, generator=torch.Generator().manual_seed(0))
    y = dropout(x, 0.25, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.03
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    torch.testing.assert_close(
        dropout(x, 0.25, torch.Generator().manual_seed(5)), y, rtol=0, atol=0)

    head = EmbeddingHead(8, 4, "flatten", spatial=(3, 3), dropout_rate=0.5)
    a = head(x, train=TrainContext(torch.Generator().manual_seed(5)))
    b = head(x, train=TrainContext(torch.Generator().manual_seed(5)))
    c = head(x, train=TrainContext(torch.Generator().manual_seed(6)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    head.dropout_rate = 0.0
    d = head(x, train=TrainContext(torch.Generator().manual_seed(6)))
    assert not torch.allclose(a, d)
