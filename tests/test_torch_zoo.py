"""The port's iResNet and MobileFaceNet vs the JAX package, at their tiny
registry widths (``iresnet_tiny``: stages (1, 1), widths (8, 16);
``mobilefacenet_tiny``: two bottleneck stages of 16, stem 8, head 32).

Weights come from JAX init plus train-mode steps (non-trivial BN
statistics) through the flat ``.npz`` key space. Eval: f32
allclose(rtol=2e-4, atol=2e-4); bf16 per-face cosine >= 0.999 against
JAX's bf16 forward. Training: tests/test_torch_trainer.py's bars, three
f32 SGD steps from the same state (losses, grad norms and rates rtol
1e-4; every leaf rtol 1e-4 / atol 2e-6 after the first step, rtol 1e-3
/ atol 3e-4 after the third) and a bf16 step as close to the f32 step
as JAX's bf16 step is.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_backbones import _warm_variables
from tests.test_torch_trainer import (
    BASE,
    _assert_states_close,
    _batches,
    _jax_snapshot,
    _np,
    _round_like_torch,
    _to_jax_layout,
)
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.models import init_variables
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.serving import bundle as jax_bundle
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.interop.port import jax_leaves, load_jax_variables
from tf_face_toolbox_tpu_torch.models import (
    create_network,
    init_parameters,
    list_networks,
    random_variables,
)
from tf_face_toolbox_tpu_torch.models.iresnet import IResNet
from tf_face_toolbox_tpu_torch.models.mobilefacenet import (
    MobileFaceNet,
    gdconv,
)
from tf_face_toolbox_tpu_torch.serving import bundle
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

NETS = ("iresnet_tiny", "mobilefacenet_tiny")
FAMILY = ("iresnet_18", "iresnet_50", "iresnet_100", "iresnet_tiny",
          "mobilefacenet", "mobilefacenet_x2", "mobilefacenet_tiny")
DIM = 16


def _x(size, n=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax(name, size):
    jnet = jax_network(name, embedding_dim=DIM)
    return jnet, _warm_variables(jnet, jax.random.key(0), (4, size, size, 3))


def _port(name, size, dtype=torch.float32):
    _, variables = _jax(name, size)
    net = create_network(name, embedding_dim=DIM, dtype=dtype,
                         input_size=size)
    return load_jax_variables(net, flatten_variables(variables))


def _cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("name", NETS)
@pytest.mark.parametrize("size", [32, 27])
def test_eval_forward_matches_jax(name, size):
    """f32 allclose; bf16 per-face cosine >= 0.999 against JAX's bf16
    (an odd size: the stride-2 convs' ceil)."""
    jnet, variables = _jax(name, size)
    x = _x(size)
    want = np.asarray(jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, x))
    with torch.no_grad():
        got = _port(name, size)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, DIM)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    j16 = jax_network(name, embedding_dim=DIM, dtype=jnp.bfloat16)
    want16 = np.asarray(jax.jit(lambda v, x: j16.apply(v, x, train=False))(
        variables, x))
    with torch.no_grad():
        got16 = _port(name, size, torch.bfloat16)(torch.from_numpy(x))
    assert got16.dtype == torch.float32
    assert _cos(got16.numpy(), want16).min() >= 0.999


def _flat_shapes(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(value, "items"):
            out.update(_flat_shapes(value, path))
        else:
            out[path] = tuple(value.shape)
    return out


@pytest.mark.parametrize("name", FAMILY)
def test_random_variables_keys_and_shapes_equal_jax_init(name):
    """Every registry entry at its published widths (112 x 112): the
    port's leaves are JAX's init leaves, key for key and shape for
    shape; the random weights and a fresh init load and run."""
    jnet = jax_network(name, embedding_dim=DIM)
    shapes = jax.eval_shape(
        lambda: init_variables(jnet, jax.random.key(0), (1, 112, 112, 3)))
    want = _flat_shapes(shapes)
    net = create_network(name, embedding_dim=DIM)
    flat = random_variables(net, seed=0)
    assert {k: v.shape for k, v in flat.items()} == want
    assert name in list_networks()
    if name.endswith("tiny"):
        load_jax_variables(net, flat)
        with torch.no_grad():
            out = net(torch.from_numpy(_x(112, n=2)))
        assert torch.isfinite(out).all() and out.shape == (2, DIM)
        init_parameters(net, seed=1)
        alphas = [t for k, t, _ in jax_leaves(net) if k.endswith("/alpha")]
        assert alphas and all(bool((a == 0.25).all()) for a in alphas)


def test_structural_pins_and_int8_refuse_as_jax(caplog):
    for cls, kw, match in (
            (IResNet, dict(stem="imagenet"), "face-stem"),
            (IResNet, dict(head_variant="gap"), "flatten 'E' head"),
            (IResNet, dict(quantized="static"), "int8 serving is not"),
            (MobileFaceNet, dict(stem="face"), "conv3x3/s2"),
            (MobileFaceNet, dict(head_variant="gap"), "GDConv"),
            (MobileFaceNet, dict(quantized=True), "int8 serving is not")):
        with pytest.raises(ValueError, match=match):
            cls(**kw)
    with pytest.raises(ValueError, match="int8"):
        create_network("iresnet_tiny", quantized="static")
    # the registry's pins win over a CLI's stem/head, with JAX's warning
    with caplog.at_level(logging.WARNING):
        net = create_network("mobilefacenet_tiny", stem="face",
                             head_variant="gap", input_size=32)
        inet = create_network("iresnet_tiny", stem="face",
                              head_variant="gap", input_size=16)
    assert (net.stem, net.head_variant) == ("mobile", "gdconv")
    assert (inet.stem, inet.head_variant) == ("face", "flatten")
    assert "pins stem=mobile; ignoring stem=face" in caplog.text
    assert "pins head_variant=flatten; ignoring head_variant=gap" in \
        caplog.text
    # the DCT nets (item 17b, ported) pin their stem the same way
    with caplog.at_level(logging.WARNING):
        for name in ("dct_vit_small", "dct_resnet_50"):
            assert create_network(name, stem="face").stem == "dct"
    assert "network dct_resnet_50 pins stem=dct; ignoring stem=face" in \
        caplog.text


def test_gdconv_einsum_equals_depthwise_valid_conv():
    """einsum('nhwc,hwc->nc') equals a depthwise k x k VALID conv with a
    1 x 1 output (the paper's GDConv); bf16 rounds once, after an f32
    sum."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 7, 7, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 7, 5)).astype(np.float32))
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 0, 1)[:, None],
                   groups=5)[:, :, 0, 0]
    np.testing.assert_allclose(gdconv(x, w).numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    x16 = x.to(torch.bfloat16)
    want = np.einsum("nhwc,hwc->nc", x16.float().numpy(),
                     w.to(torch.bfloat16).float().numpy())
    got = gdconv(x16, w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        torch.from_numpy(want).to(torch.bfloat16).float().numpy())


def test_bottleneck_residual_only_at_matching_stride_1():
    net = create_network("mobilefacenet", embedding_dim=DIM)
    blocks = {name: getattr(net, name).residual for name in net.block_names}
    assert blocks["stage1_0"] is False and blocks["stage1_4"] is True
    assert blocks["stage2_0"] is False and blocks["stage3_0"] is True
    x2 = create_network("mobilefacenet_x2", embedding_dim=DIM)
    assert x2.head.gdconv.shape == (7, 7, 1024)
    assert x2.stage2_0.project.weight.shape[0] == 256


def test_a_jax_iresnet_bundle_boots_in_the_port(tmp_path):
    jnet, variables = _jax("iresnet_tiny", 16)
    meta = dict(network="iresnet_tiny", embedding_dim=DIM, image_size=16,
                crop_from=16, input_norm="fixed", quant_mode="none",
                stem="face", head_variant="flatten", step=3)
    path = str(tmp_path / "jax.bundle.npz")
    jax_bundle.write_bundle(path, variables, meta)
    got, meta_read = bundle.read_bundle(path)
    net = load_jax_variables(bundle.network_from_meta(
        meta_read, dtype=torch.float32), flatten_variables(got))
    x = _x(16)
    want = np.asarray(jnet.apply(variables, x, train=False))
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,size", [("iresnet_tiny", 16),
                                       ("mobilefacenet_tiny", 32)])
def test_cli_extract_auto_falls_back_to_the_module(tmp_path, caplog, name,
                                                   size):
    """The folded engine refuses these nets, so --engine auto serves the
    module with the log line; embeddings equal JAX's extract_shard with
    the fixed input norm. --engine folded exits."""
    from tests.test_torch_extract import _shard
    from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
    from tf_face_toolbox_tpu.extract import extract_shard as jax_extract
    from tf_face_toolbox_tpu_torch.cli import extract
    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz

    jnet, variables = _jax(name, size)
    shard = _shard(tmp_path / "faces.faceshard", n=6, size=size + 4)
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, flatten_variables(variables))
    out = str(tmp_path / "e.npy")
    argv = ["--network", name, "--embedding_dim", str(DIM), "--image_size",
            str(size), "--crop_from", str(size + 4), "--input_norm", "fixed",
            "--variables_npz", npz, "--data", shard, "--batch", "4",
            "--nobf16", "--loader", "python", "--device", "cpu"]
    with caplog.at_level(logging.INFO):
        extract.main([*argv, "--output", out])
    assert "serving engine not applicable" in caplog.text
    assert "supports the ResNet family" in caplog.text
    want = jax_extract(jnet, variables, JaxSource(shard), image_size=size,
                       crop_from=size + 4, batch=4, num_threads=1,
                       loader="python", norm="fixed")
    np.testing.assert_allclose(np.load(out), want, atol=1e-5)
    with pytest.raises(SystemExit, match="--engine folded"):
        extract.main([*argv, "--output", out, "--engine", "folded"])


# ---- training --------------------------------------------------------------


def _jax_run(name, steps, dtype=jnp.float32):
    """(initial flat variables, classifier, metrics, states) of the JAX
    trainer on the tiny net, on a one-device mesh."""
    cfg = jt.TrainConfig(**{**BASE, "network": name, "dtype": dtype})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    net = jax_network(name, embedding_dim=BASE["embedding_dim"], dtype=dtype)
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
def _jax_case(name, steps):
    return _jax_run(name, steps)


def _port_run(name, flat, cls, steps, dtype=torch.float32):
    cfg = TrainConfig(**{**BASE, "network": name, "dtype": dtype})
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
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


@pytest.mark.parametrize("name", NETS)
def test_three_sgd_steps_match_jax(name):
    flat, cls, want_m, want = _jax_case(name, 3)
    got_m, got = _port_run(name, flat, cls, 3)
    for g, w in zip(got_m, want_m, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    # the BN statistics moved, PReLU slopes and GDConv weights trained
    moved = {k for k in flat if not np.array_equal(got[-1]["vars"][k],
                                                   flat[k])}
    assert any(k.endswith("/mean") for k in moved)
    assert any(k.endswith("/alpha") for k in moved)
    if name.startswith("mobilefacenet"):
        assert "params/head/gdconv" in moved


# fc's bias sits before the features BN: its gradient is rounding noise
_NOISE_ONLY = {"params/fc/bias"}


def _update_cosines(got, want, flat):
    out = {}
    for k in want["vars"]:
        if k in _NOISE_ONLY:
            continue
        g = (got["vars"][k] - flat[k]).ravel().astype(np.float64)
        w = (want["vars"][k] - flat[k]).ravel().astype(np.float64)
        if not w.any():
            assert not g.any(), k
            continue
        out[k] = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    return out


@pytest.mark.parametrize("name", NETS)
def test_bf16_step_is_as_close_to_f32_as_jax_bf16(name):
    """One bf16 step against the f32 JAX step from the same state: the
    port's loss error at most twice JAX's bf16 loss error (plus 1e-5
    relative), and on every leaf its update at most twice as far from
    the f32 update (1 - cosine) as JAX's bf16 update (plus 1e-4)."""
    flat, cls, ref_m, ref = _jax_case(name, 1)
    _, _, jax_m, jax16 = _jax_run(name, 1, jnp.bfloat16)
    got_m, got = _port_run(name, flat, cls, 1, torch.bfloat16)
    loss = ref_m[0]["loss"]
    assert abs(got_m[0]["loss"] - loss) <= \
        2 * abs(jax_m[0]["loss"] - loss) + 1e-5 * abs(loss)
    ours = _update_cosines(got[-1], ref[-1], flat)
    theirs = _update_cosines(jax16[-1], ref[-1], flat)
    assert len(ours) >= 20
    for k, c in ours.items():
        assert 1 - c <= 2 * (1 - theirs[k]) + 1e-4, (k, c, theirs[k])


@pytest.mark.parametrize("name", ["iresnet_tiny", "mobilefacenet_tiny"])
def test_cli_train_runs(name, capsys):
    from tf_face_toolbox_tpu_torch.cli import train as cli_train

    cli_train.main(["--device", "cpu", "--network", name, "--image_size",
                    "32", "--crop_from", "36", "--global_batch", "8",
                    "--num_classes", "10", "--num_steps", "2",
                    "--log_every", "1", "--nobf16", "--input_norm", "fixed",
                    "--embedding_dim", "16"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done: step=2 loss="), out
    assert np.isfinite(float(out[-1].split("loss=")[1]))
