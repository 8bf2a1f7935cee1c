"""The port's FaceViT (the JPEG-block-token ViT family) vs the JAX
package: ``dct_vit_test`` (two blocks, width 32, two heads) at 16 x 16
and 32 x 32, the registry's published widths for shapes and counts.

Weights come from JAX init plus train-mode steps (non-trivial frequency
BN statistics) through the flat ``.npz`` key space. Eval: f32
allclose(rtol=2e-4, atol=2e-4); bf16 per-face cosine >= 0.999 against
JAX's bf16 forward. Training: tests/test_torch_trainer.py's bars at
drop path 0 (drop path matches JAX in distribution only: the masks come
from torch generators).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_backbones import _warm_variables
from tests.test_torch_trainer import (
    BASE,
    _assert_states_close,
    _batches,
    _jax_snapshot,
    _np,
    _to_jax_layout,
)
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.models import init_variables
from tf_face_toolbox_tpu.models import vit as jvit
from tf_face_toolbox_tpu.ops import dct as jdct
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.serving import bundle as jax_bundle
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.extract import flip_averaged_embeddings
from tf_face_toolbox_tpu_torch.interop.port import jax_leaves, load_jax_variables
from tf_face_toolbox_tpu_torch.models import (
    create_network,
    init_parameters,
    list_networks,
    random_variables,
)
from tf_face_toolbox_tpu_torch.models import vit
from tf_face_toolbox_tpu_torch.models.layers import TrainContext
from tf_face_toolbox_tpu_torch.ops import dct
from tf_face_toolbox_tpu_torch.serving import bundle
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

DIM = 16


def _x(size, n=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _eval(jnet):
    return jax.jit(lambda v, x: jnet.apply(v, x, train=False))


@functools.lru_cache(maxsize=None)
def _jax(size):
    jnet = jax_network("dct_vit_test", embedding_dim=DIM)
    return jnet, _warm_variables(jnet, jax.random.key(0), (4, size, size, 3))


def _port(size, dtype=torch.float32, **kw):
    _, variables = _jax(size)
    net = create_network("dct_vit_test", embedding_dim=DIM, dtype=dtype,
                         input_size=size, **kw)
    return load_jax_variables(net, flatten_variables(variables))


def _cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


@pytest.mark.parametrize("size", [16, 32])
@pytest.mark.parametrize("entry", ["pixels", "coefficients"])
def test_eval_forward_matches_jax(size, entry):
    """f32 allclose; bf16 per-face cosine >= 0.999 against JAX's bf16
    (whose pixel entry takes the DCT in bf16, as the port's does)."""
    jnet, variables = _jax(size)
    x = _x(size)
    if entry == "coefficients":
        x = np.asarray(jdct.block_dct(jnp.asarray(x)))
    want = np.asarray(_eval(jnet)(variables, x))
    with torch.no_grad():
        got = _port(size)(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, DIM)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    j16 = jax_network("dct_vit_test", embedding_dim=DIM, dtype=jnp.bfloat16)
    want16 = np.asarray(_eval(j16)(variables, x))
    with torch.no_grad():
        got16 = _port(size, torch.bfloat16)(torch.from_numpy(x))
    assert got16.dtype == torch.float32
    assert _cos(got16.numpy(), want16).min() >= 0.999


def test_pixels_coefficients_and_the_frequency_flip_agree():
    """One set of weights: pixels and their block_dct give the same
    embedding; the pixel flip equals flip_coefficients; flip-averaged
    extraction agrees on both entries."""
    net = _port(16)
    x = torch.from_numpy(_x(16))
    z = dct.block_dct(x)
    with torch.no_grad():
        torch.testing.assert_close(net(z), net(x), rtol=0, atol=1e-5)
        torch.testing.assert_close(net(dct.flip_coefficients(z)),
                                   net(x.flip(2)), rtol=0, atol=1e-5)
        torch.testing.assert_close(flip_averaged_embeddings(net, z),
                                   flip_averaged_embeddings(net, x),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(stem="face"), "structurally the 8×8 DCT blocks"),
    (dict(head_variant="flatten"), "structurally gap→FC→BN"),
    (dict(quantized="static"), "int8 serving is not supported for the ViT"),
    (dict(input_size=20), "not a multiple of 8")])
def test_structural_refusals_keep_jax_messages(kw, match):
    with pytest.raises(ValueError, match=match):
        vit.FaceViT(depth=2, width=32, num_heads=2, **kw)


def test_trailing_dim_refusal_and_registry_pins(caplog):
    with pytest.raises(ValueError, match="dct tokens want"):
        _port(16)(torch.zeros(1, 2, 2, 64))
    with pytest.raises(ValueError, match="int8"):
        create_network("dct_vit_test", quantized="static")
    with caplog.at_level(logging.WARNING):
        net = create_network("dct_vit_tiny", stem="face", head_variant="gap")
    assert net.stem == "dct" and "pins stem=dct; ignoring stem=face" in \
        caplog.text
    assert (net.depth, net.width, net.Block_0.attn.num_heads) == (12, 192, 3)


def test_attention_matches_jax_and_a_naive_oracle():
    """qkv laid out (n, t, 3, heads, dh); scores / sqrt(dh); softmax;
    the heads concatenated head-major: equal to JAX's module (f32, and
    bf16 by cosine) and to a per-head numpy softmax(QK^T / sqrt(d)) V."""
    x = np.random.default_rng(0).standard_normal((2, 5, 8)).astype(np.float32)
    jmha = jvit.MultiHeadAttention(num_heads=2)
    v = jmha.init(jax.random.key(0), jnp.asarray(x))
    mha = vit.MultiHeadAttention(8, 2)
    load_jax_variables(mha, flatten_variables(v))
    with torch.no_grad():
        got = mha(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmha.apply(v, x)), rtol=2e-5,
                               atol=2e-5)
    p = v["params"]
    qkv = (x @ np.asarray(p["qkv"]["kernel"]) + np.asarray(p["qkv"]["bias"])
           ).reshape(2, 5, 3, 2, 4)
    heads = []
    for h in range(2):
        q, k, vv = qkv[:, :, 0, h], qkv[:, :, 1, h], qkv[:, :, 2, h]
        s = q @ k.transpose(0, 2, 1) / np.sqrt(4.0)
        e = np.exp(s - s.max(-1, keepdims=True))
        heads.append((e / e.sum(-1, keepdims=True)) @ vv)
    want = (np.concatenate(heads, -1) @ np.asarray(p["out"]["kernel"])
            + np.asarray(p["out"]["bias"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    j16 = jvit.MultiHeadAttention(num_heads=2, dtype=jnp.bfloat16)
    with torch.no_grad():
        got16 = mha(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    want16 = np.asarray(j16.apply(v, jnp.asarray(x, jnp.bfloat16)), np.float32)
    assert _cos(got16.reshape(2, -1), want16.reshape(2, -1)).min() >= 0.999


def test_layer_norm_eps_and_tanh_gelu_match_jax():
    """LayerNorm's epsilon is 1e-6 (torch's default is 1e-5; rows of
    variance ~1e-6 tell them apart) with f32 statistics and a result in
    the input's dtype; the MLP's GELU is the tanh approximation (an
    encoder block against JAX's)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, 32)) * 1e-3).astype(np.float32)
    jln = jvit.LayerNormF32()
    v = jln.init(jax.random.key(0), x)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32),
                    "bias": rng.normal(0, 0.1, 32).astype(np.float32)}}
    ln = load_jax_variables(vit.LayerNormF32(32), flatten_variables(v))
    with torch.no_grad():
        got = ln(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(jln.apply(v, x)),
                                   rtol=2e-4, atol=2e-4)
        assert ln(torch.from_numpy(x).to(torch.bfloat16)).dtype == \
            torch.bfloat16
    xb = rng.standard_normal((2, 4, 32)).astype(np.float32)
    jblock = jvit.EncoderBlock(num_heads=2)
    vb = jblock.init(jax.random.key(1), xb)
    block = load_jax_variables(vit.EncoderBlock(32, 2), flatten_variables(vb))
    with torch.no_grad():
        np.testing.assert_allclose(block(torch.from_numpy(xb)).numpy(),
                                   np.asarray(jblock.apply(vb, xb)),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["dct_vit_small", "dct_vit_tiny",
                                  "dct_vit_test", "dct_resnet_50"])
def test_random_variables_keys_and_shapes_equal_jax_init(name):
    """Every new registry entry at its published widths (112 x 112): the
    port's leaves are JAX's init leaves, key for key and shape for
    shape; dct_vit_small's parameter count equals JAX's (~22M)."""
    jnet = jax_network(name, embedding_dim=DIM)
    shapes = jax.eval_shape(
        lambda: init_variables(jnet, jax.random.key(0), (1, 112, 112, 3)))
    want = {"/".join(str(getattr(p, "key", p)) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    net = create_network(name, embedding_dim=DIM)
    flat = random_variables(net, seed=0)
    assert {k: v.shape for k, v in flat.items()} == want
    assert name in list_networks()
    count = sum(int(np.prod(s)) for k, s in want.items()
                if k.startswith("params/"))
    assert sum(p.numel() for p in net.parameters()) == count
    if name == "dct_vit_small":
        assert 20e6 < count < 24e6 and want["params/pos_embedding"] == \
            (1, 196, 384)


def test_seeded_weights_and_fresh_init_follow_jax_distributions():
    """random_variables: the positional table N(0, 0.02), each block's
    attn/out and mlp2 kernels scaled down; init_parameters: Dense kernels
    variance_scaling(1, fan_in, truncated normal), the positional table
    N(0, 0.02), LayerNorm scales 1 and biases 0."""
    net = create_network("dct_vit_small", embedding_dim=DIM)
    flat = random_variables(net, seed=0)
    assert abs(flat["params/pos_embedding"].std() - 0.02) < 1e-3
    qkv = flat["params/Block_3/attn/qkv/kernel"].std() * np.sqrt(384)
    out = flat["params/Block_3/attn/out/kernel"].std() * np.sqrt(384)
    assert abs(qkv - 1.0) < 0.02 and 0.2 < out < 0.5
    init_parameters(net, seed=1)
    leaves = {k: t for k, t, _ in jax_leaves(net)}
    assert abs(leaves["params/pos_embedding"].std().item() - 0.02) < 1e-3
    w = leaves["params/Block_0/mlp1/kernel"]
    assert abs(w.std().item() * np.sqrt(384) - 1.0) < 0.02
    assert w.abs().max().item() <= 2 / 0.8796 / np.sqrt(384) + 1e-6
    for key in ("params/Block_5/ln2/scale", "params/ln_final/scale"):
        assert bool((leaves[key] == 1).all())
    for key in ("params/Block_5/ln2/bias", "params/Block_0/mlp1/bias"):
        assert bool((leaves[key] == 0).all())


@pytest.mark.parametrize("new", [(16, 16), (10, 10), (14, 14), (3, 5)])
def test_resize_pos_embedding_matches_jax(new):
    """jax.image.resize's bilinear, antialiased when the grid shrinks
    (14 -> 10 changes the weights), half-pixel when it grows; the same
    grid is exact; the resized net runs at the new size as JAX's does."""
    jnet = jax_network("dct_vit_test", embedding_dim=DIM)
    variables = _warm_variables(jnet, jax.random.key(0), (4, 112, 112, 3))
    flat = flatten_variables(variables)
    want = jvit.resize_pos_embedding(variables, new)
    got = vit.resize_pos_embedding(flat, new)
    assert flat["params/pos_embedding"].shape == (1, 196, 32)   # untouched
    np.testing.assert_allclose(got["params/pos_embedding"], np.asarray(
        want["params"]["pos_embedding"]), rtol=2e-5, atol=2e-6)
    if new == (14, 14):
        np.testing.assert_array_equal(got["params/pos_embedding"],
                                      flat["params/pos_embedding"])
    if new[0] == new[1]:
        size = 8 * new[0]
        x = _x(size, n=2)
        net = create_network("dct_vit_test", embedding_dim=DIM,
                             input_size=size)
        with torch.no_grad():
            out = load_jax_variables(net, got)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, np.asarray(_eval(jnet)(want, x)),
                                   rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="token count"):
        vit.resize_pos_embedding(flat, new, old_hw=(1, 3))


# ---- training --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_steps(steps):
    cfg = jt.TrainConfig(**{**BASE, "network": "dct_vit_test"})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    jnet = jax_network("dct_vit_test", embedding_dim=BASE["embedding_dim"])
    state, jnet = jt.create_train_state(cfg, jax.random.key(3), mesh, net=jnet)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(jnet, cfg, mesh, state)
    metrics, states = [], []
    for x, y in _batches(steps=steps):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(_jax_snapshot(state))
    return flat, cls, metrics, states


def test_three_sgd_steps_match_jax():
    """Three f32 SGD steps of dct_vit_test at 16 x 16 from JAX's state:
    metrics rtol 1e-4; leaves rtol 1e-4 / atol 2e-6 after the first
    step, rtol 1e-3 / atol 3e-4 after the third; the positional table,
    the LayerNorms and the frequency BN's statistics move."""
    flat, cls, want_m, want = _jax_steps(3)
    cfg = TrainConfig(**{**BASE, "network": "dct_vit_test"})
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    step = make_train_step(net, cfg, state)
    leaves = list(jax_leaves(net))
    got_m, got = [], []
    for x, y in _batches(steps=3):
        state, m = step(state, x, y)
        got_m.append({k: float(v) for k, v in m.items()})
        got.append({"vars": {k: _to_jax_layout(t, kind)
                             for k, t, kind in leaves},
                    "classifier": state.classifier.detach().numpy().copy(),
                    "ema": None, "step": state.step})
    for g, w in zip(got_m, want_m, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    moved = {k for k in flat if not np.array_equal(got[-1]["vars"][k],
                                                   flat[k])}
    assert {"params/pos_embedding", "params/Block_1/ln2/scale",
            "batch_stats/freq_bn/mean"} <= moved


def test_weight_decay_mask_matches_jax():
    """Decay on the Dense kernels and the classifier only: not on the
    positional table (no /kernel suffix), the LayerNorms, the biases or
    the frequency BN (JAX's decay_mask)."""
    flat, cls, _, _ = _jax_steps(1)
    cfg = TrainConfig(**{**BASE, "network": "dct_vit_test"})
    state, net = create_train_state(cfg, 0, variables=flat, classifier=cls,
                                    device="cpu")
    decayed = {id(p) for p in state.opt_state["optimizer"]
               .param_groups[0]["params"]}
    got = {k for k, t, _ in jax_leaves(net) if id(t) in decayed}
    assert got == {k for k in flat if k.startswith("params/")
                   and k.endswith("/kernel")}
    assert "params/pos_embedding" not in got and id(state.classifier) in \
        decayed


def test_drop_path_train_stochastic_eval_deterministic():
    """Train mode varies with the generator and differs from the rate-0
    net; eval mode is exactly the rate-0 net."""
    net = _port(16, drop_path_rate=0.5)
    net0 = _port(16)
    x = torch.from_numpy(_x(16, n=8))

    def train(n, seed):
        with torch.no_grad():
            return n(x, train=TrainContext(torch.Generator().manual_seed(
                seed)))

    a, b = train(net, 1), train(net, 2)
    assert not torch.allclose(a, b)
    assert not torch.allclose(a, train(net0, 1))
    with torch.no_grad():
        torch.testing.assert_close(net(x), net0(x), rtol=0, atol=0)


def test_drop_path_ramp_two_masks_a_block_and_rescale():
    """The block rate is rate * i / max(depth - 1, 1); a block with a
    rate draws two per-sample masks (one a branch; the first block, at
    rate 0, none); kept samples are y / keep in y's dtype, dropped ones
    zero."""
    net = create_network("dct_vit_small", drop_path_rate=0.1)
    np.testing.assert_allclose([b.drop_path for b in net.blocks()],
                               [0.1 * i / 11 for i in range(12)])
    small = _port(16, drop_path_rate=0.5)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        small(torch.from_numpy(_x(16, n=5)), train=TrainContext(gen))
    ref = torch.Generator().manual_seed(4)
    for _ in range(2):
        torch.rand((5, 1, 1), generator=ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    y = torch.randn(400, 3, 4).to(torch.bfloat16)
    out = vit.drop_path(y, 0.25, torch.Generator().manual_seed(0))
    kept = out.flatten(1).abs().sum(1) > 0
    keep = torch.tensor(0.75, dtype=torch.bfloat16)
    torch.testing.assert_close(out[kept], y[kept] / keep, rtol=0, atol=0)
    assert bool((out[~kept] == 0).all()) and 0.65 < kept.float().mean() < 0.85


def test_drop_path_trains_through_the_trainer_and_refuses_non_vit():
    cfg = TrainConfig(**{**BASE, "network": "dct_vit_test",
                         "drop_path_rate": 0.3})
    state, net = create_train_state(cfg, 0, device="cpu")
    assert net.Block_1.drop_path == pytest.approx(0.3)
    _, m = make_train_step(net, cfg, state)(state, *_batches(steps=1)[0])
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="ViT-family knob"):
        TrainConfig(**{**BASE, "drop_path_rate": 0.3})


def test_cli_train_drop_path(capsys):
    from tf_face_toolbox_tpu_torch.cli import train as cli_train

    cli_train.main(["--device", "cpu", "--network", "dct_vit_test",
                    "--image_size", "16", "--crop_from", "24",
                    "--global_batch", "8", "--num_classes", "10",
                    "--num_steps", "2", "--log_every", "1", "--nobf16",
                    "--embedding_dim", "16", "--drop_path", "0.1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done: step=2 loss="), out
    assert np.isfinite(float(out[-1].split("loss=")[1]))


# ---- serving ---------------------------------------------------------------


def test_a_jax_vit_bundle_boots_and_serves_through_the_module(tmp_path):
    """A JAX dct_vit_test bundle: network_from_meta builds the net at the
    bundle's size, its weights load, its forward equals JAX's; cli.serve
    --bundle (engine auto: the module path) answers /embed_batch as
    JAX's service does."""
    from tests.test_torch_serve import _call, _drain, _npy, _start_cli
    from tf_face_toolbox_tpu.serving import server as jax_server

    jnet, variables = _jax(16)
    meta = dict(network="dct_vit_test", embedding_dim=DIM, image_size=16,
                crop_from=24, input_norm="per_image", quant_mode="none",
                stem="dct", head_variant="gap", step=7)
    path = str(tmp_path / "vit.bundle.npz")
    jax_bundle.write_bundle(path, variables, meta)
    got, meta_read = bundle.read_bundle(path)
    net = load_jax_variables(bundle.network_from_meta(
        meta_read, dtype=torch.float32), flatten_variables(got))
    x = _x(16)
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x)).numpy(),
                                   np.asarray(_eval(jnet)(variables, x)),
                                   rtol=2e-4, atol=2e-4)
    imgs = np.random.default_rng(5).integers(0, 256, (3, 24, 24, 3),
                                             dtype=np.uint8)
    svc = jax_server.EmbeddingService(jnet, variables, image_size=16,
                                      crop_from=24, batch=4,
                                      dtype=jnp.float32)
    proc = _start_cli(["--bundle", path])
    try:
        status, out = _call(proc.base, "POST", "/embed_batch", _npy(imgs))
        assert status == 200
        np.testing.assert_allclose(out["embeddings"], svc.embed_batch(imgs),
                                   atol=1e-4)
        assert _call(proc.base, "GET", "/healthz")[1]["serving_step"] == 7
    finally:
        _drain(proc)


@pytest.mark.parametrize("loader", ["python", "dct_domain"])
def test_cli_extract_auto_falls_back_to_the_module(tmp_path, caplog, loader):
    """--engine auto logs the engine's refusal and serves the module;
    embeddings equal JAX's extract_shard, from decoded pixels and from
    the coefficients of a shard recoded at the model's size."""
    from tests.test_torch_dct import _recoded_shard
    from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
    from tf_face_toolbox_tpu.extract import extract_shard as jax_extract
    from tf_face_toolbox_tpu_torch.cli import extract
    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz

    jnet, variables = _jax(16)
    crop = 16 if loader == "dct_domain" else 24
    shard = _recoded_shard(tmp_path, 6, crop, src=32, gradient=False)
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, flatten_variables(variables))
    out = str(tmp_path / "e.npy")
    with caplog.at_level(logging.INFO):
        extract.main(["--network", "dct_vit_test", "--embedding_dim",
                      str(DIM), "--image_size", "16", "--crop_from",
                      str(crop), "--variables_npz", npz, "--data", shard,
                      "--batch", "4", "--nobf16", "--loader", loader,
                      "--device", "cpu", "--output", out])
    assert "serving engine not applicable" in caplog.text
    assert "supports the ResNet family" in caplog.text
    want = jax_extract(jnet, variables, JaxSource(shard), image_size=16,
                       crop_from=crop, batch=4, num_threads=1, loader=loader)
    np.testing.assert_allclose(np.load(out), want, atol=1e-5)


def test_forward_makes_no_tensor_from_host_data(monkeypatch):
    """A tensor copied from the host onto the card waits for the card's
    queue to drain; in every attention block that leaves the card idle
    while the host launches. On the meta device (standing for the card),
    a second forward of dct_vit_test (eval, and train with drop path),
    of the dct ResNet and of the DCT ops makes none: no torch.tensor or
    as_tensor onto the device, no host-to-device copy (the constants are
    made once a dtype and device)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tf_face_toolbox_tpu_torch.ops import jpeg

    made = []
    for fn in ("tensor", "as_tensor"):
        real = getattr(torch, fn)

        def wrapped(*args, _real=real, _fn=fn, **kwargs):
            out = _real(*args, **kwargs)
            if out.device.type != "cpu":
                made.append((_fn, tuple(out.shape)))
            return out
        monkeypatch.setattr(torch, fn, wrapped)

    class HostCopies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.ops.aten._to_copy.default:
                src, dst = args[0], out
            elif func is torch.ops.aten.copy_.default:
                src, dst = args[1], args[0]
            else:
                return out
            if src.device.type == "cpu" and dst.device.type != "cpu":
                made.append((str(func), tuple(src.shape)))
            return out

    vit_net = create_network("dct_vit_test", input_size=16,
                             dtype=torch.bfloat16,
                             drop_path_rate=0.5).to("meta")
    resnet = create_network("dct_resnet_50", input_size=16,
                            stage_sizes=(1,), stage_widths=(8,),
                            dct_stem_features=8).to("meta")
    x = torch.empty(2, 16, 16, 3, device="meta")
    coef = torch.empty(2, 2, 2, 3, 64, dtype=torch.int16, device="meta")
    qtab = torch.empty(2, 3, 64, dtype=torch.int32, device="meta")

    def run():
        vit_net(x)
        vit_net(x, train=TrainContext())
        resnet(x)
        jpeg.decode_dct(coef, qtab)
        dct.flip_coefficients(dct.prepare_coefficients(coef, qtab))
        dct.block_idct(dct.block_dct(x))

    run()
    made.clear()
    with HostCopies():
        run()
    assert made == []
