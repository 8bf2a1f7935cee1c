"""The port's DCT input vs the JAX package: ``ops/jpeg.py`` and
``ops/dct.py`` against ``ops/jpeg_tpu.py`` and ``ops/dct.py``, the dct
stem of the ResNet, the ``native_dct`` and ``dct_domain`` loaders, the
DCT-input train step and ``native_dct_batch_iterator``.

Inputs come from numpy seeds; JPEG coefficients from the native loader
over a ``cli.pack --recode_size`` shard. Bars: f32 rtol/atol 2e-4 (the
ops at their own f32 rounding), bf16 per-face cosine >= 0.999 against
JAX's bf16 forward, decode_dct within 1 LSB of JAX's and 2 of
libjpeg's; training: tests/test_torch_trainer.py's bars.
"""

import dataclasses
import functools
import io
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_backbones import _warm_variables
from tests.test_torch_trainer import (
    BASE,
    _assert_states_close,
    _batches,
    _jax_snapshot,
    _np,
    _to_jax_layout,
)
from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
from tf_face_toolbox_tpu.data.pipeline import (
    native_dct_batch_iterator as jax_dct_iterator,
)
from tf_face_toolbox_tpu.extract import extract_shard_to_npy as jax_to_npy
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.ops import dct as jdct
from tf_face_toolbox_tpu.ops import jpeg_tpu as jjpeg
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.train import trainer as jt
from tf_face_toolbox_tpu_torch.data import native
from tf_face_toolbox_tpu_torch.data.format import pack_image_list
from tf_face_toolbox_tpu_torch.data.pipeline import (
    FaceShardSource,
    device_prefetch,
    native_batch_iterator,
    native_dct_batch_iterator,
)
from tf_face_toolbox_tpu_torch.extract import extract_shard, extract_shard_to_npy
from tf_face_toolbox_tpu_torch.interop.port import jax_leaves, load_jax_variables
from tf_face_toolbox_tpu_torch.models import create_network
from tf_face_toolbox_tpu_torch.ops import dct, jpeg
from tf_face_toolbox_tpu_torch.serving.engine import check_servable
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

# dct_resnet_50 with its stages cut (the registry's stem and geometry)
TINY = dict(stage_sizes=(1, 1, 1), stage_widths=(8, 16, 32),
            dct_stem_features=16)
DIM = 16


def _pixels(n=2, size=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.float32)


def _gradient(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 / h, xx * 255 / w,
                     (yy + xx) * 255 / (h + w)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _recoded_shard(tmp_path, n, size, src=40, gradient=True, name="r"):
    """``cli.pack --recode_size=size`` of n JPEGs (4:4:4, size x size)."""
    lines = []
    rng = np.random.default_rng(0)
    for i in range(n):
        arr = (_gradient(src, src, i) if gradient
               else rng.integers(0, 256, (src, src, 3), dtype=np.uint8))
        Image.fromarray(arr).save(str(tmp_path / f"{name}{i}.jpg"), "JPEG",
                                  quality=95)
        lines.append(f"{name}{i}.jpg {i % 4}\n")
    (tmp_path / f"{name}.txt").write_text("".join(lines))
    out = str(tmp_path / f"{name}.faceshard")
    pack_image_list(str(tmp_path / f"{name}.txt"), out, root=str(tmp_path),
                    recode_size=size)
    return out


def _coefficients(path, n, size):
    reader = native.NativeShardReader(path, num_threads=0)
    try:
        coef, qtab = reader.dct_batch(list(range(n)), size, size)
        pix = reader.decode_batch(list(range(n)), size, size)
    finally:
        reader.close()
    return coef, qtab, pix


def _cos(a, b):
    a, b = np.asarray(a).reshape(len(a), -1), np.asarray(b).reshape(len(b), -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


# ---- the ops ---------------------------------------------------------------


def test_idct_matrix_equals_jax_and_is_orthonormal():
    a = jpeg._idct_matrix()
    np.testing.assert_array_equal(a, jjpeg._idct_matrix())
    np.testing.assert_allclose(a @ a.T, np.eye(8), atol=1e-6)


@pytest.mark.parametrize("size", [32, 112])
def test_block_dct_and_inverse_match_jax(size):
    """Per-channel orthonormal DCT in (C, 8u, 8v) order: equal to JAX's,
    invertible, energy-preserving (Parseval)."""
    x = _pixels(size=size)
    got = dct.block_dct(torch.from_numpy(x))
    want = np.asarray(jdct.block_dct(jnp.asarray(x)))
    assert got.shape == (2, size // 8, size // 8, 192)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    back = dct.block_idct(got)
    np.testing.assert_allclose(back.numpy(), np.asarray(jdct.block_idct(
        jnp.asarray(want))), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(back.numpy(), x, atol=2e-4)
    np.testing.assert_allclose(got.square().sum((1, 2, 3)).numpy(),
                               np.square(x).sum((1, 2, 3)), rtol=1e-6)
    # bf16: the DCT computed in the input's dtype, as JAX's
    got16 = dct.block_dct(torch.from_numpy(x).to(torch.bfloat16))
    want16 = np.asarray(jdct.block_dct(jnp.asarray(x, jnp.bfloat16)),
                        np.float32)
    assert got16.dtype == torch.bfloat16
    assert _cos(got16.float().numpy(), want16).min() >= 0.999


@pytest.mark.parametrize("image", ["random", "constant"])
def test_standardize_coefficients_matches_jax(image):
    """The DC shift of 8 * mean, the variance clamped at 0, the std floor
    rsqrt(pixels): a constant image standardizes to zeros, not NaN."""
    x = (_pixels(3) if image == "random"
         else np.full((1, 32, 32, 3), 77.0, np.float32))
    z = np.asarray(jdct.block_dct(jnp.asarray(x)))
    got = dct.standardize_coefficients(torch.from_numpy(z)).numpy()
    want = np.asarray(jdct.standardize_coefficients(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.isfinite(got).all()
    if image == "constant":
        np.testing.assert_allclose(dct.block_idct(torch.from_numpy(got))
                                   .numpy(), 0.0, atol=1e-3)


def test_flip_coefficients_matches_jax_and_the_pixel_flip():
    """Block columns reversed, odd horizontal frequencies negated."""
    x = _pixels()
    z = dct.block_dct(torch.from_numpy(x))
    got = dct.flip_coefficients(z)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdct.flip_coefficients(jnp.asarray(z.numpy()))))
    np.testing.assert_allclose(dct.block_idct(got).numpy(), x[:, :, ::-1],
                               atol=2e-4)


def test_decode_dct_matches_jax_and_libjpeg(tmp_path):
    """(N, bh, bw, 3, 64) int16 + (N, 3, 64) uint16 -> (N, 8bh, 8bw, 3)
    uint8: within 1 LSB of JAX's decode (rounding at .5 may fall either
    way after an f32 IDCT in another order) and 2 of libjpeg's, also on
    hard edges (the range limit before the colour conversion)."""
    path = _recoded_shard(tmp_path, 4, 32)
    coef, qtab, pix = _coefficients(path, 4, 32)
    assert coef.dtype == np.int16 and qtab.dtype == np.uint16
    got = jpeg.decode_dct(torch.from_numpy(coef), torch.from_numpy(qtab))
    assert got.dtype == torch.uint8 and got.shape == (4, 32, 32, 3)
    want = np.asarray(jjpeg.decode_dct(coef, qtab))
    d_jax = np.abs(got.numpy().astype(int) - want.astype(int))
    assert d_jax.max() <= 1 and (d_jax > 0).mean() < 0.01
    assert np.abs(got.numpy().astype(int) - pix.astype(int)).max() <= 2
    # saturated checkerboards: IDCT ringing past [0, 255]
    im = np.zeros((32, 32, 3), np.uint8)
    im[(np.mgrid[0:32, 0:32][0] // 4 + np.mgrid[0:32, 0:32][1] // 4) % 2
       == 0] = 255
    im[8:12, :, 0] = 0
    buf = io.BytesIO()
    Image.fromarray(im).save(buf, "JPEG", quality=85, subsampling=0)
    from tf_face_toolbox_tpu_torch.data.format import PAYLOAD_JPEG, write_shard
    edges = str(tmp_path / "edges.faceshard")
    write_shard(edges, [buf.getvalue()], [0], payload=PAYLOAD_JPEG)
    coef, qtab, pix = _coefficients(edges, 1, 32)
    got = jpeg.decode_dct(torch.from_numpy(coef), torch.from_numpy(qtab))
    assert np.abs(got.numpy().astype(int) - pix.astype(int)).max() <= 2
    assert np.abs(got.numpy().astype(int) - np.asarray(
        jjpeg.decode_dct(coef, qtab)).astype(int)).max() <= 1


def test_prepare_coefficients_matches_jax_and_the_pixel_chain(tmp_path):
    """The zero-decode input: equal to JAX's (f32: the energy sums over a
    face in another order), and per face
    within cosine 0.999 of block_dct of the standardized decoded pixels
    (libjpeg's range limit and rounding are all that differ)."""
    path = _recoded_shard(tmp_path, 3, 112, src=120)
    coef, qtab, pix = _coefficients(path, 3, 112)
    got = dct.prepare_coefficients(torch.from_numpy(coef),
                                   torch.from_numpy(qtab))
    assert got.shape == (3, 14, 14, 192) and got.dtype == torch.float32
    want = np.asarray(jdct.prepare_coefficients(jnp.asarray(coef),
                                                jnp.asarray(qtab)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    z_pix = dct.standardize_coefficients(dct.block_dct(
        torch.from_numpy(pix.astype(np.float32))))
    assert _cos(got.numpy(), z_pix.numpy()).min() >= 0.999


# ---- the dct stem ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_dct(size):
    jnet = jax_network("dct_resnet_50", embedding_dim=DIM, **TINY)
    return jnet, _warm_variables(jnet, jax.random.key(0), (4, size, size, 3))


def _eval(jnet):
    return jax.jit(lambda v, x: jnet.apply(v, x, train=False))


def _port_dct(size, dtype=torch.float32, **kw):
    _, variables = _jax_dct(size)
    net = create_network("dct_resnet_50", embedding_dim=DIM, dtype=dtype,
                         input_size=size, **TINY, **kw)
    return load_jax_variables(net, flatten_variables(variables))


@pytest.mark.parametrize("size", [32, 16])
@pytest.mark.parametrize("entry", ["pixels", "coefficients"])
def test_dct_resnet_matches_jax(size, entry):
    """The frequency BatchNorm (``BatchNorm_0``), ``ConvBN_0`` 192 ->
    4 * 16 and depth-to-space, stage 0 at stride 1: f32 allclose, bf16
    per-face cosine >= 0.999 against JAX's bf16, from pixels and from
    their coefficients."""
    jnet, variables = _jax_dct(size)
    x = _pixels(3, size, seed=2)
    x = (x - x.mean()) / x.std()
    if entry == "coefficients":
        x = np.asarray(jdct.block_dct(jnp.asarray(x)))
    want = np.asarray(_eval(jnet)(variables, x))
    with torch.no_grad():
        got = _port_dct(size)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    j16 = jax_network("dct_resnet_50", embedding_dim=DIM,
                      dtype=jnp.bfloat16, **TINY)
    want16 = np.asarray(_eval(j16)(variables, x))
    with torch.no_grad():
        got16 = _port_dct(size, torch.bfloat16)(torch.from_numpy(x))
    assert got16.dtype == torch.float32
    assert _cos(got16.numpy(), want16).min() >= 0.999


def test_dct_resnet_structure_and_refusals(caplog):
    """JAX's geometry (stage sizes (3, 6, 3), widths (128, 256, 512),
    the stem's 4 * 256 up-projection), the pinned stem over a CLI's
    default, the trailing-dim check, item 18's int8 refusal, and the
    serving engine's refusal with JAX's message."""
    with caplog.at_level(logging.WARNING):
        net = create_network("dct_resnet_50", stem="face")
    assert net.stem == "dct" and "pins stem=dct" in caplog.text
    assert net.ConvBN_0.weight.shape == (1024, 192, 1, 1)
    assert net.BatchNorm_0.weight.shape == (192,)
    assert net.num_blocks == 12 and net.BottleneckBlock_0.strides == 1
    assert net.BottleneckBlock_3.strides == 2
    assert net.BottleneckBlock_11.ConvBN_2.weight.shape[0] == 2048
    with pytest.raises(ValueError, match="dct stem wants"):
        net(torch.zeros(1, 14, 14, 64))
    # int8 (item 18) raised here until it was ported: the dct stem stays
    # fp and the blocks carry int8, as JAX's (tests/test_torch_int8.py)
    q = create_network("dct_resnet_50", quantized="static")
    assert q.ConvBN_0.mode is False and q.BatchNorm_0.weight.shape == (192,)
    assert q.BottleneckBlock_0.ConvBN_1.mode == "static"
    assert q.block_11_in_max.shape == ()
    with pytest.raises(ValueError, match="does not fold the dct stem"):
        check_servable(net)


def _dct_train_run(flat, cls, steps, net_kw):
    cfg = TrainConfig(**{**BASE, "network": "dct_resnet_50"})
    net = create_network("dct_resnet_50", embedding_dim=DIM,
                         input_size=BASE["image_size"], **net_kw)
    state, net = create_train_state(cfg, 0, net=net, variables=flat,
                                    classifier=cls, device="cpu")
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


def test_dct_resnet_three_sgd_steps_match_jax():
    """Three f32 SGD steps from JAX's state: the trainer's bars (rtol
    1e-4 on the metrics; leaves rtol 1e-4 / atol 2e-6 after the first
    step, rtol 1e-3 / atol 3e-4 after the third); the frequency BN's
    statistics move."""
    cfg = jt.TrainConfig(**{**BASE, "network": "dct_resnet_50"})
    mesh = create_mesh(data=1, devices=jax.devices()[:1])
    jnet = jax_network("dct_resnet_50", embedding_dim=DIM, **TINY)
    state, jnet = jt.create_train_state(cfg, jax.random.key(3), mesh,
                                        net=jnet)
    flat = flatten_variables({"params": _np(state.params),
                              "batch_stats": _np(state.batch_stats)})
    cls = np.array(state.classifier)
    step = jt.make_train_step(jnet, cfg, mesh, state)
    want_m, want = [], []
    for x, y in _batches(steps=3):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y))
        want_m.append({k: float(v) for k, v in m.items()})
        want.append(_jax_snapshot(state))
    got_m, got = _dct_train_run(flat, cls, 3, TINY)
    for g, w in zip(got_m, want_m, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    _assert_states_close(got[0], want[0], rtol=1e-4, atol=2e-6)
    _assert_states_close(got[-1], want[-1], rtol=1e-3, atol=3e-4)
    assert not np.array_equal(got[-1]["vars"]["batch_stats/BatchNorm_0/mean"],
                              flat["batch_stats/BatchNorm_0/mean"])


# ---- the loaders and the DCT-input step ------------------------------------


@pytest.mark.parametrize("loader", ["dct_domain", "native_dct"])
def test_extract_shard_to_npy_dct_loaders_match_jax(tmp_path, loader):
    """``dct_domain`` (coefficients straight into the dct net, flipped in
    the frequency domain; crop_from defaults to image_size) and
    ``native_dct`` (decode_dct on the device, then the eval chain) write
    what JAX's extract_shard_to_npy writes, and the sidecar's meta
    matches; each agrees with the pixel loader at cosine 0.999."""
    size = 32
    crop = size if loader == "dct_domain" else size + 8
    shard = _recoded_shard(tmp_path, 6, crop, gradient=False)
    jnet, variables = _jax_dct(size)
    flat = flatten_variables(variables)
    kw = dict(image_size=size, crop_from=0 if loader == "dct_domain"
              else crop, batch=4, num_threads=0, loader=loader)
    want = np.asarray(jax_to_npy(jnet, variables, JaxSource(shard),
                                 str(tmp_path / "jax.npy"), **kw))
    net = create_network("dct_resnet_50", embedding_dim=DIM,
                         input_size=size, **TINY)
    got = np.asarray(extract_shard_to_npy(
        net, flat, FaceShardSource(shard), str(tmp_path / "port.npy"),
        device="cpu", **kw))
    np.testing.assert_allclose(got, want, atol=2e-4)
    meta = json.load(open(tmp_path / "port.npy.progress.json"))
    jmeta = json.load(open(tmp_path / "jax.npy.progress.json"))
    assert meta == jmeta and meta["crop_from"] == crop
    pixel = extract_shard(net, flat, FaceShardSource(shard), image_size=size,
                          crop_from=crop, batch=4, num_threads=0,
                          loader="native", device="cpu")
    assert _cos(got, pixel).min() >= 0.999


def test_dct_domain_refusals_match_jax(tmp_path):
    shard = _recoded_shard(tmp_path, 2, 32, gradient=False)
    _, variables = _jax_dct(32)
    flat = flatten_variables(variables)
    net = create_network("dct_resnet_50", embedding_dim=DIM, input_size=32,
                         **TINY)
    src = FaceShardSource(shard)
    other = create_network("resnet_tiny", embedding_dim=DIM)
    with pytest.raises(ValueError, match="stem='dct'"):
        extract_shard(other, flat, src, image_size=32, loader="dct_domain",
                      device="cpu")
    with pytest.raises(ValueError, match="crop_from == image_size"):
        extract_shard(net, flat, src, image_size=32, crop_from=40,
                      loader="dct_domain", device="cpu")
    with pytest.raises(ValueError, match="per-image only"):
        extract_shard(net, flat, src, image_size=32, loader="dct_domain",
                      norm="fixed", device="cpu")
    # a shard of another geometry fails in the native reader
    with pytest.raises(ValueError, match="DCT extraction"):
        extract_shard(net, flat, src, image_size=24, crop_from=24,
                      loader="native_dct", device="cpu")


def test_native_dct_batch_iterator_matches_jax_and_prefetches(tmp_path):
    """The same ordering, labels and coefficients as JAX's iterator (and
    as the pixel iterator's order); device_prefetch moves the (coef,
    qtab) pair as tensors."""
    shard = _recoded_shard(tmp_path, 10, 16, src=24)
    got = native_dct_batch_iterator(FaceShardSource(shard, seed=3), 4,
                                    size=16, start_epoch=1, start_step=1)
    want = jax_dct_iterator(JaxSource(shard, seed=3), 4, size=16,
                            start_epoch=1, start_step=1)
    pixels = native_batch_iterator(FaceShardSource(shard, seed=3), 4,
                                   out_h=16, out_w=16, start_epoch=1,
                                   start_step=1)
    for _ in range(3):
        g, w, p = next(got), next(want), next(pixels)
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["label"], p["label"])
        for a, b in zip(g["image"], w["image"]):
            np.testing.assert_array_equal(a, np.asarray(b))
    moved = next(device_prefetch(iter([g]), device="cpu"))
    coef, qtab = moved["image"]
    assert isinstance(coef, torch.Tensor) and coef.dtype == torch.int16
    assert isinstance(qtab, torch.Tensor) and tuple(qtab.shape) == (4, 3, 64)
    assert isinstance(moved["label"], torch.Tensor)


def test_dct_input_step_equals_the_u8_step_on_decoded_frames(tmp_path):
    """``input_format="dct"`` decodes (coef, qtab) on the device, then
    takes the u8 step: from the same state and draws, the loss, the
    gradient norm and every leaf equal the u8 step on decode_dct of the
    same coefficients. Without the augment chain it refuses, with JAX's
    message."""
    shard = _recoded_shard(tmp_path, 8, 16, src=24)
    batch = next(native_dct_batch_iterator(FaceShardSource(shard), 8,
                                           size=16))
    cfg = TrainConfig(network="dct_vit_test", embedding_dim=8, num_classes=4,
                      image_size=16, crop_from=16, global_batch=8,
                      augment=True)
    coef, qtab = (torch.from_numpy(a) for a in batch["image"])
    frames = jpeg.decode_dct(coef, qtab)
    runs = []
    for fmt, images in (("dct", batch["image"]), ("u8", frames)):
        state, net = create_train_state(cfg, 0, device="cpu")
        step = make_train_step(net, cfg, state, input_format=fmt)
        state, m = step(state, images, batch["label"])
        runs.append((float(m["loss"]), float(m["grad_norm"]),
                     {k: v.detach().clone() for k, v in
                      net.state_dict().items()}))
    (l_dct, n_dct, w_dct), (l_u8, n_u8, w_u8) = runs
    assert np.isfinite(l_dct) and l_dct == l_u8 and n_dct == n_u8
    for k in w_u8:
        torch.testing.assert_close(w_dct[k], w_u8[k], rtol=0, atol=0)
    plain = dataclasses.replace(cfg, augment=False)
    state, net = create_train_state(plain, 0, device="cpu")
    with pytest.raises(ValueError, match="augment"):
        make_train_step(net, plain, state, input_format="dct")


def test_cli_train_native_dct_loader(tmp_path, capsys):
    """cli.train --loader=native_dct over a recoded shard: the host
    entropy-decodes, the step decodes on the device (input_format
    "dct") and trains."""
    from tf_face_toolbox_tpu_torch.cli import train as cli_train

    shard = _recoded_shard(tmp_path, 16, 24, src=32)
    cli_train.main(["--device", "cpu", "--network", "dct_vit_test",
                    "--data", shard, "--loader", "native_dct",
                    "--image_size", "16", "--crop_from", "24",
                    "--global_batch", "8", "--num_steps", "3",
                    "--log_every", "1", "--nobf16", "--embedding_dim", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("done: step=3 loss="), out
    assert np.isfinite(float(out[-1].split("loss=")[1]))
