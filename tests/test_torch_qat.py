"""Quantization-aware training in the port (``TrainConfig.quantized="qat"``,
``cli.train --qat``) vs the JAX package's ``make_train_step``.

As in tests/test_torch_trainer.py: the same variables, classifier and
f32 batches, three SGD steps on a one-device mesh, with its tolerances.
The QAT forward fake-quantizes each bottleneck conv's input and kernel
and the stream between blocks; its scales (max / 127, per tensor over
the rank's batch and per output channel) are JAX's to the bit, so a
quantum flips only where the fp parts' last bits do. Then the trained
weights serve through calibrate -> static int8, as
tests/test_train.py::test_qat_trains_and_serves_static_int8 holds JAX's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trainer import (
    BASE,
    STEPS,
    _NOISE_ONLY,
    _batches,
    _jax_snapshot,
    _learnable_batch,
    _np,
    _port_run,
    _round_like_torch,
)
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.interop.port import unflatten_variables
from tf_face_toolbox_tpu.models.resnet import ResNet as JaxResNet
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
from tf_face_toolbox_tpu_torch.models import calibrate_quant_stats
from tf_face_toolbox_tpu_torch.models import create_network
from tf_face_toolbox_tpu_torch.models.layers import TrainContext
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

QAT = {"quantized": "qat"}
TINY = dict(stage_sizes=(1,), width_per_group=16, embedding_dim=16)


def _trace(opt_state):
    """optax's momentum TraceState in a chain's state."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _trace(s)
            if found is not None:
                return found
    return None


@functools.lru_cache(maxsize=None)
def _jax_qat_run(dtype=jnp.float32, steps=STEPS):
    """tests/test_torch_trainer.py's JAX run with a QAT resnet_tiny: the
    initial (flat, classifier), the metrics, and the state after each
    step, with the momentum (optax's trace) of the step after the first."""
    cfg = jt.TrainConfig(**{**BASE, **QAT, "dtype": dtype})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    net = JaxResNet(**TINY, dtype=dtype, quantized="qat")
    state, net = jt.create_train_state(cfg, jax.random.key(3), mesh, net=net)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(net, cfg, mesh, state)
    metrics, states = [], []
    for x, y in _batches(None, steps):
        x, y = jnp.asarray(x), jnp.asarray(y)
        if dtype == jnp.bfloat16:
            state, m = _round_like_torch(step, state, x, y)(state, x, y, {})
        else:
            state, m = step(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        snap = _jax_snapshot(state)
        trace = _trace(state.opt_state)
        snap["trace"] = flatten_variables({"params": _np(trace["params"])})
        snap["trace_classifier"] = np.array(trace["classifier"])
        states.append(snap)
    return flat, cls, metrics, states


def _port_step_from(snap, x, y):
    """One port QAT step from a JAX snapshot (its momentum included)."""
    from tf_face_toolbox_tpu_torch.interop import port

    cfg = TrainConfig(**{**BASE, **QAT})
    state, net = create_train_state(cfg, 0, variables=snap["vars"],
                                    classifier=snap["classifier"],
                                    device="cpu")
    opt = state.opt_state["optimizer"]
    for n, p in state.params.items():
        key, kind = port.jax_key(n, p)
        opt.state[p] = {"momentum_buffer": port.from_jax_layout(
            snap["trace"][key], kind)}
    opt.state[state.classifier] = {
        "momentum_buffer": torch.tensor(snap["trace_classifier"])}
    state.step = state.opt_state["count"] = snap["step"]
    state, m = make_train_step(net, cfg, state)(state, x, y)
    got = {"vars": {k: port.to_jax_layout(t, kind)
                    for k, t, kind in port.jax_leaves(net)},
           "classifier": state.classifier.detach().numpy().copy(),
           "ema": None, "step": state.step}
    return {k: float(v) for k, v in m.items()}, got


def _assert_update_close(got, want, before, cls_before, floor):
    """Every moved leaf's update (after - before) at cosine >= ``floor``
    against JAX's; the Dense bias before the head's BatchNorm is
    rounding noise (tests/test_torch_trainer.py)."""
    moved = 0
    pairs = [(got["vars"][k] - before[k], want["vars"][k] - before[k], k)
             for k in want["vars"] if k != _NOISE_ONLY]
    pairs.append((got["classifier"] - cls_before,
                  want["classifier"] - cls_before, "classifier"))
    for g, w, k in pairs:
        g, w = g.ravel().astype(np.float64), w.ravel().astype(np.float64)
        if not w.any():
            assert not g.any(), k
            continue
        cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
        assert cos >= floor, (k, cos)
        moved += 1
    assert moved >= 20


def test_three_qat_steps_match_jax():
    """Each of three QAT steps from JAX's state before it (its momentum
    too): the loss, gradient norm and learning rate at rtol 1e-4, and
    every leaf's update at cosine >= 0.999, the bar of a bf16 step
    (tests/test_torch_trainer.py): a flipped quantum is a rounding
    difference too. The fp stem's last bits flip an input quantum or two
    of 262,144 at the first carry, which moves the embeddings by ~1e-3;
    three straight steps at margin scale 16 amplify it (update cosines
    down to 0.98 by the third), so each step starts from JAX's state."""
    flat, cls, want_m, want = _jax_qat_run()
    got_m, got, _ = _port_run(QAT, flat, cls, steps=1)
    assert got[0]["step"] == want[0]["step"] == 1
    _assert_update_close(got[0], want[0], flat, cls, 0.999)
    metrics = [got_m[0]]
    for i, (x, y) in enumerate(_batches(None, STEPS)[1:], start=1):
        m, after = _port_step_from(want[i - 1], x, y)
        assert after["step"] == want[i]["step"] == i + 1
        _assert_update_close(after, want[i], want[i - 1]["vars"],
                             want[i - 1]["classifier"], 0.999)
        metrics.append(m)
    for g, w in zip(metrics, want_m):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_qat_changes_the_step():
    """The fake quantization is in the step: from the same state and
    batch, the QAT update differs from the fp one (by more than the
    two packages differ)."""
    flat, cls, _, want = _jax_qat_run(steps=1)
    _, fp, _ = _port_run({}, flat, cls, steps=1)
    _, qat, _ = _port_run(QAT, flat, cls, steps=1)
    # the projection: the branch's own convs get no gradient at init
    # (its last BatchNorm's scale is zero)
    key = "params/BottleneckBlock_0/ConvBN_3/kernel"
    d_fp = np.abs(fp[0]["vars"][key] - want[0]["vars"][key]).max()
    d_qat = np.abs(qat[0]["vars"][key] - want[0]["vars"][key]).max()
    assert d_fp > 10 * d_qat


def test_bf16_qat_step_tracks_jax():
    """bf16 compute, one QAT step, the JAX side without excess precision:
    the loss within 1e-4, every moved leaf's update at cosine >= 0.999
    (tests/test_torch_trainer.py::test_bf16_step_tracks_jax)."""
    flat, cls, want_m, want = _jax_qat_run(jnp.bfloat16, 1)
    got_m, got, _ = _port_run(QAT, flat, cls, dtype=torch.bfloat16, steps=1)
    got, want = got[-1], want[-1]
    np.testing.assert_allclose(got_m[0]["loss"], want_m[0]["loss"],
                               rtol=1e-4)
    moved = 0
    for k in want["vars"]:
        if k == _NOISE_ONLY:
            continue
        g = (got["vars"][k] - flat[k]).ravel().astype(np.float64)
        w = (want["vars"][k] - flat[k]).ravel().astype(np.float64)
        if not w.any():
            assert not g.any(), k
            continue
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.999, k
        moved += 1
    assert moved >= 20


def test_qat_eval_is_fp_and_train_forward_quantizes():
    """Eval mode of a QAT net is the fp net; a train forward fake-quantizes
    (the straight-through gradient reaches the kernels unchanged in
    shape), as JAX's ``ConvBN(quantized="qat")``."""
    fp = create_network("resnet_tiny", **TINY, input_size=16)
    qat = create_network("resnet_tiny", **TINY, input_size=16,
                         quantized="qat")
    flat = flatten_variables(jax.tree.map(np.asarray, JaxResNet(**TINY).init(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)))))
    load_jax_variables(fp, flat)
    load_jax_variables(qat, flat)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(fp(x), qat(x))
        a = fp(x, train=TrainContext())
        b = qat(x, train=TrainContext())
    assert not torch.equal(a, b)
    jnet = JaxResNet(**TINY, quantized="qat")
    want, _ = jnet.apply(unflatten_variables(flat), jnp.asarray(x.numpy()),
                         train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(b.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def _named_flat(net):
    from tf_face_toolbox_tpu_torch.interop.port import jax_leaves, to_jax_layout

    return {k: to_jax_layout(t, kind) for k, t, kind in jax_leaves(net)}


def test_qat_trains_and_serves_static_int8():
    """QAT on learnable synthetic identities: the loss falls; the weights
    serve through calibrate -> static int8 at a per-face cosine > 0.9
    against their fp eval, not worse than an fp-trained twin's (JAX's
    test's bars), and the port's static embeddings equal JAX's static
    embeddings of the same weights and stats (cosine >= 0.9999)."""
    from tf_face_toolbox_tpu_torch.train.trainer import build_network

    kw = dict(stage_sizes=(1, 1), width_per_group=16, embedding_dim=16)
    base = {**BASE, "margin_m3": 0.0, "weight_decay": 0.0, "warmup_steps": 0,
            "lr_boundaries": (10 ** 6,), "network": "resnet_tiny"}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 16, 16, 3)).astype(np.float32))

    results = {}
    for q in ("qat", False):
        cfg = TrainConfig(**base, quantized=q)
        net = build_network(cfg, stage_sizes=(1, 1))
        state, net = create_train_state(cfg, 0, device="cpu", net=net)
        step = make_train_step(net, cfg, state)
        rng = np.random.default_rng(100)
        losses = []
        for _ in range(10):
            state, m = step(state, *_learnable_batch(rng, BASE["global_batch"]))
            losses.append(float(m["loss"]))
        if q == "qat":
            assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
        flat = _named_flat(net)
        fp_net = load_jax_variables(create_network(
            "resnet_tiny", **kw, input_size=16), flat)
        cal = calibrate_quant_stats("resnet_tiny", flat, [x], input_size=16,
                                    **kw)
        q_net = load_jax_variables(create_network(
            "resnet_tiny", **kw, input_size=16, quantized="static"), cal)
        with torch.inference_mode():
            e_fp, e_q = fp_net(x).numpy(), q_net(x).numpy()
        cos = (e_fp * e_q).sum(1) / (np.linalg.norm(e_fp, axis=1)
                                     * np.linalg.norm(e_q, axis=1))
        results[q] = cos
        if q == "qat":
            jq = JaxResNet(**kw, quantized="static")
            want = np.asarray(jax.jit(lambda v, x: jq.apply(
                v, x, train=False)).lower(unflatten_variables(cal), x.numpy())
                .compile(compiler_options={
                    "xla_allow_excess_precision": False})(
                        unflatten_variables(cal), x.numpy()))
            c = (e_q * want).sum(1) / (np.linalg.norm(e_q, axis=1)
                                      * np.linalg.norm(want, axis=1))
            assert c.min() >= 0.9999, c
    assert np.isfinite(results["qat"]).all()
    assert results["qat"].min() > 0.9, results
    assert results["qat"].mean() >= results[False].mean() - 0.02, results


def test_cli_qat_trains_exports_static_and_extracts(tmp_path, capsys):
    """``cli.train --qat`` -> ``cli.export --quant_mode static
    --calibrate_data`` -> ``cli.extract --bundle``; DenseNet refuses --qat
    with JAX's reason."""
    from tf_face_toolbox_tpu_torch.cli import export as cli_export
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract
    from tf_face_toolbox_tpu_torch.cli import train as cli_train
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays

    shard = str(tmp_path / "faces.faceshard")
    faces = np.random.default_rng(0).integers(0, 256, (16, 20, 20, 3),
                                              dtype=np.uint8)
    pack_arrays(shard, faces, [i % 4 for i in range(16)])
    run = str(tmp_path / "run")
    net = ["--network=resnet_tiny", "--embedding_dim=16", "--image_size=16"]
    cli_train.main(["--device=cpu", *net, "--crop_from=20",
                    "--global_batch=8", "--num_steps=3", "--nobf16",
                    f"--data={shard}", "--loader=python", "--qat",
                    f"--train_dir={run}", "--save_every=3"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "done: step=3 loss=")
    out = str(tmp_path / "q.bundle.npz")
    cli_export.main(["--checkpoint_dir", run, *net, "--crop_from=20",
                     "--output", out, "--quant_mode", "static",
                     "--calibrate_data", shard, "--calibrate_batch_size",
                     "8", "--device", "cpu"])
    emb = str(tmp_path / "e.npy")
    cli_extract.main(["--bundle", out, "--data", shard, "--output", emb,
                      "--nobf16", "--device", "cpu", "--batch", "8"])
    got = np.load(emb)
    assert got.shape == (16, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    with pytest.raises(SystemExit, match="--qat is a resnet-family"):
        cli_train.main(["--network=densenet_121", "--qat", "--device=cpu"])
    assert os.path.exists(out)
