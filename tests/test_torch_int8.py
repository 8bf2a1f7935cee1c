"""The port's int8 serving (``models/layers.py`` W8A8 convs, calibration,
the static-int8 residual carry, int8 bundles, ``cli.export``/``cli.extract``
/``cli.serve --quant_mode``) vs the JAX package on the CPU.

The JAX side of every bf16 rounding point is compiled with XLA's excess
precision off (``xla_allow_excess_precision=False``): by default XLA:CPU
skips the bf16 roundings of ``int8_conv_prequant`` that the port makes,
in f32 nets too. Single convs are then bit-equal. A whole net's fp parts
(the stem, the head, the BatchNorms) differ from XLA's in the last f32
bits, which can move an activation across a quantization step: so int8
embeddings are held at a per-face cosine >= 0.9999 against JAX's int8
embeddings (a rare flipped quantum), and >= 0.98 against fp, JAX's own
post-training-quantization gate (``tests/test_parity.py``).
"""

import functools
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.interop.port import (
    flatten_variables as jax_flatten,
    unflatten_variables as jax_unflatten,
)
from tf_face_toolbox_tpu.models import calibrate_quant_stats as jax_calibrate
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.models import layers as jl
from tf_face_toolbox_tpu.serving import bundle as jax_bundle
from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
from tf_face_toolbox_tpu_torch.models import (
    calibrate_quant_stats,
    create_network,
    random_variables,
)
from tf_face_toolbox_tpu_torch.models import layers
from tf_face_toolbox_tpu_torch.serving import bundle

torch.set_num_threads(1)

SIZE = 32


def _exact(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) \
        / np.linalg.norm(b, axis=-1)


# ---- the int8 conv --------------------------------------------------------------


def _conv_operands(k, stride, groups, seed):
    rng = np.random.default_rng(seed)
    c = o = 16
    x = (rng.standard_normal((2, 9, 10, c)) * 2).astype(np.float32)
    w = (rng.standard_normal((k, k, c // groups, o)) * 0.1).astype(np.float32)
    return x, w, torch.from_numpy(w.transpose(3, 2, 0, 1).copy())


CONVS = [(1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 2, 1), (3, 1, 4), (3, 2, 4)]


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("k,stride,groups", CONVS)
def test_int8_conv_is_bit_equal_to_jax(k, stride, groups, static):
    """``int8_conv`` (dynamic: int32 -> f32 times (xs * ks); static: the
    bf16 path) and ``int8_conv_prequant`` equal JAX's bit for bit, 1x1 and
    3x3 at strides 1 and 2 (SAME's asymmetric padding on the even width),
    dense and grouped; then as the compute dtype (f32, bf16)."""
    x, w, weight = _conv_operands(k, stride, groups, 10 * k + stride + groups)
    scale = np.float32(np.abs(x).max() * 0.7) / np.float32(127.0)
    act = jnp.asarray(scale) if static else None
    want = np.asarray(_exact(lambda x, w: jl.int8_conv(
        x, w, (stride, stride), groups, act_scale=act), x, w))
    got = layers.int8_conv(torch.from_numpy(x), weight, stride, groups,
                           act_scale=torch.tensor(scale) if static else None)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            got.to(tdt).float().numpy(),
            np.asarray(jnp.asarray(want).astype(jdt).astype(jnp.float32)))
    # the carry's consumer: an already-quantized input and its scale
    xq = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    want = np.asarray(_exact(lambda xq, w: jl.int8_conv_prequant(
        xq, jnp.asarray(scale), w, (stride, stride), groups), xq, w))
    got = layers.int8_conv_prequant(torch.from_numpy(xq),
                                    torch.tensor(scale), weight, stride,
                                    groups)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,h,w,c,k,stride,groups", [
    (2, 9, 10, 16, 1, 1, 1), (2, 9, 10, 16, 1, 2, 1),
    (2, 8, 8, 16, 3, 1, 1), (2, 8, 8, 16, 3, 2, 1),
    (1, 7, 5, 12, 3, 2, 1),          # K = 108, O = 12: padded to 8s
    (1, 3, 3, 16, 3, 1, 1),          # M = 9 <= 16: padded rows
    (2, 6, 6, 32, 3, 1, 8),          # grouped, 4 channels a group
    (2, 6, 7, 32, 3, 2, 8)])
def test_int_mm_route_equals_the_plain_version(n, h, w, c, k, stride,
                                               groups):
    """The card's route (im2col from shifted views, ``torch._int_mm``,
    zero padding, block-diagonal groups), run here on the host, equals
    the float64 plain version exactly."""
    rng = np.random.default_rng(c + k + stride)
    xq = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c), np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (c, c // groups, k, k),
                                       np.int8))
    got = layers.int8_conv2d_int_mm(xq, kq, stride, groups)
    want = layers.int8_conv2d_plain(xq, kq, stride, groups)
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == (n, -(-h // stride), -(-w // stride), c)
    assert torch.equal(got, want)
    # the wrapper, on a host tensor, is the plain version
    assert torch.equal(layers.int8_conv2d_nhwc(xq, kq, stride, groups), want)


@pytest.mark.parametrize("n,h,w,c,o,stride,groups", [
    (2, 6, 6, 32, 32, 1, 8), (2, 6, 7, 32, 64, 2, 8),
    (1, 3, 3, 96, 96, 1, 32)])
def test_bench_int8_grouped_routes_equal_the_plain_version(n, h, w, c, o,
                                                           stride, groups):
    """``bench_int8``'s other grouped routes (one ``_int_mm`` a group; an
    f32 conv of the values), run here on the host, equal the float64
    plain version; its shape lists count resnet_v1_50's 52 int8 convs and
    resnext_50's 16 grouped 3x3s."""
    from tf_face_toolbox_tpu_torch import bench_int8

    rng = np.random.default_rng(c + o + stride)
    xq = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c), np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (o, c // groups, 3, 3),
                                       np.int8))
    want = layers.int8_conv2d_plain(xq, kq, stride, groups)
    assert torch.equal(bench_int8.per_group_int_mm(xq, kq, stride, groups),
                       want)
    assert torch.equal(bench_int8.cudnn_f32(xq, kq, stride, groups), want)
    r50 = bench_int8.face_conv_shapes(*bench_int8.NETS["resnet_v1_50"])
    rx = bench_int8.face_conv_shapes(*bench_int8.NETS["resnext_50"])
    assert (len(r50), sum(sh[-1] for sh in r50)) == (24, 52)
    assert sum(sh[-1] for sh in rx if sh[5] == 32) == 16


def test_int8_sums_past_2_24_round_to_bf16_through_f32_as_xla():
    """An exact sum of 2^24 + 2^16 + 1 rounds to 2^24 in bf16 through f32
    (a direct rounding would give 2^24 + 2^17), in XLA's conv with
    ``preferred_element_type=bfloat16`` and in the port."""
    target = 2 ** 24 + 2 ** 16 + 1
    xs, ks, rem = [], [], target
    while rem > 0:
        a = min(127, rem)
        b = min(127, max(1, rem // a))
        xs.append(a)
        ks.append(b)
        rem -= a * b
    xs += [0] * (-len(xs) % 8)
    ks += [0] * (len(xs) - len(ks))
    xq = np.array(xs, np.int8).reshape(1, 1, 1, -1)
    kq = np.array(ks, np.int8).reshape(1, 1, -1, 1)

    def conv(xq, kq, out):
        return jax.lax.conv_general_dilated(
            xq, kq, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=out)

    want = float(np.asarray(_exact(functools.partial(conv, out=jnp.bfloat16),
                                   xq, kq)).astype(np.float64).ravel()[0])
    tx = torch.from_numpy(xq)
    tk = torch.from_numpy(kq.transpose(3, 2, 0, 1).copy())
    got = layers.int8_conv2d_nhwc(tx, tk, 1, out_dtype=torch.bfloat16)
    assert want == 2 ** 24 == float(got.double().item())
    assert int(layers.int8_conv2d_nhwc(tx, tk, 1).item()) == target
    assert int(np.asarray(conv(xq, kq, jnp.int32)).ravel()[0]) == target
    with pytest.raises(TypeError, match="int8 operands"):
        layers.int8_conv2d_nhwc(tx.float(), tk, 1)


def test_fake_quant_ste_grid_and_gradient_match_jax():
    """The forward is x + (q - x) (not q itself) on JAX's grid; the
    backward is the identity (tests/test_models.py)."""
    x = np.random.default_rng(3).standard_normal((64,)).astype(np.float32) * 3
    scale = np.float32(0.05)
    c = np.linspace(-1, 1, 64).astype(np.float32)
    want = np.asarray(jl.fake_quant_ste(jnp.asarray(x), scale))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jl.fake_quant_ste(v, scale) * c))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = layers.fake_quant_ste(tx, torch.tensor(scale))
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(tx.grad.numpy(), want_g)
    np.testing.assert_array_equal(want_g, c)
    assert np.unique(np.round(want / scale)).size <= 255


# ---- calibration ------------------------------------------------------------------


NETS = {
    "resnet": ("resnet_tiny", dict(stage_sizes=(2, 2), width_per_group=16)),
    "se_resnext": ("se_resnext_50", dict(stage_sizes=(1, 1), groups=8,
                                         width_per_group=4)),
    "resnext": ("resnext_50", dict(stage_sizes=(1, 1), groups=8,
                                   width_per_group=4)),
    "densenet": ("densenet_121", dict(stage_sizes=(2, 2), growth_rate=8)),
    "dct_resnet": ("dct_resnet_50", dict(stage_sizes=(1, 1, 1),
                                         stage_widths=(16, 32, 64),
                                         dct_stem_features=32)),
}


@functools.lru_cache(maxsize=None)
def _weights(key, seed=0):
    """(name, kwargs, port-seeded flat variables in the JAX key space)."""
    name, kw = NETS[key]
    kw = dict(kw, embedding_dim=16)
    net = create_network(name, input_size=SIZE, **kw)
    return name, kw, random_variables(net, seed)


def _batches(n, seed=20, scale=1.0):
    return [(np.random.default_rng(seed + i).standard_normal(
        (2, SIZE, SIZE, 3)) * scale).astype(np.float32) for i in range(n)]


def _stats(flat):
    return {k: float(v) for k, v in flat.items()
            if k.startswith("quant_stats/")}


@functools.lru_cache(maxsize=None)
def _calibrated(key):
    """(port-calibrated flat, JAX-calibrated flat) on the same weights and
    batches, f32."""
    name, kw, flat = _weights(key)
    cal = _batches(2)
    got = calibrate_quant_stats(name, flat, [torch.from_numpy(b) for b in cal],
                                input_size=SIZE, **kw)
    want = jax_flatten(jax_calibrate(name, jax_unflatten(flat),
                                     [jnp.asarray(b) for b in cal], **kw))
    return got, want


@pytest.mark.parametrize("key", ["resnet", "densenet", "dct_resnet"])
def test_calibrated_stats_match_jax(key):
    """Every ``quant_stats`` leaf (each conv's act_max, each block's
    carry max) under JAX's key, with JAX's value (f32: the fp forward's
    last bits only); the params and batch statistics untouched."""
    got, want = _calibrated(key)
    g, w = _stats(got), _stats(want)
    assert g.keys() == w.keys() and g
    if key != "densenet":
        assert "quant_stats/block_0_in_max" in g
    for k in w:
        assert g[k] == pytest.approx(w[k], rel=2e-6), k
    flat = _weights(key)[2]
    assert all(got[k] is flat[k] for k in flat)


def test_calibration_is_monotone_continues_and_refuses():
    name, kw, flat = _weights("resnet")
    small = [torch.from_numpy(b) for b in _batches(1, scale=0.1)]
    big = small + [torch.from_numpy(b) for b in _batches(1, seed=40,
                                                         scale=3.0)]
    s1 = _stats(calibrate_quant_stats(name, flat, small, input_size=SIZE,
                                      **kw))
    s2 = _stats(calibrate_quant_stats(name, flat, big, input_size=SIZE, **kw))
    assert all(s2[k] >= s1[k] for k in s1) and any(s2[k] > s1[k] for k in s1)
    # stats already present continue, as JAX's do
    first = calibrate_quant_stats(name, flat, small, input_size=SIZE, **kw)
    s3 = _stats(calibrate_quant_stats(name, first, big[1:], input_size=SIZE,
                                      **kw))
    assert s3 == s2
    with pytest.raises(ValueError, match="empty batch iterable"):
        calibrate_quant_stats(name, flat, [], **kw)
    net = create_network(name, quantized="static", input_size=SIZE, **kw)
    with pytest.raises(ValueError, match="calibrate"):
        load_jax_variables(net, flat)
    with pytest.raises(ValueError, match="calibrate"):
        net(small[0])                    # no stats loaded: the NaN buffers
    nested = calibrate_quant_stats(name, jax_unflatten(flat), small,
                                   input_size=SIZE, **kw)
    assert "act_max" in nested["quant_stats"]["BottleneckBlock_0"]["ConvBN_1"]


@pytest.mark.parametrize("key", ["resnet", "densenet"])
def test_static_refuses_scales_never_loaded_on_any_device(key):
    """A static net whose scales were written by hand, not loaded, refuses
    as JAX does without ``quant_stats``: the host flag decides, not the
    NaN (a card tensor's NaN is not read back). ``load_jax_variables``
    and ``load_state_dict`` of calibrated stats set it."""
    name, kw, flat = _weights(key)
    x = torch.from_numpy(_batches(1)[0])
    net = create_network(name, quantized="static", input_size=SIZE, **kw)
    for buf_name, buf in net.named_buffers():
        if buf_name.endswith(("act_max", "_in_max")):
            buf.fill_(1.0)                   # finite, but never loaded
    with pytest.raises(ValueError, match="calibrate"):
        net(x)
    load_jax_variables(net, _calibrated(key)[0])
    want = net(x)
    again = create_network(name, quantized="static", input_size=SIZE, **kw)
    again.load_state_dict(net.state_dict())
    assert torch.equal(again(x), want)
    partial = create_network(name, quantized="static", input_size=SIZE, **kw)
    partial.load_state_dict({k: v for k, v in net.state_dict().items()
                             if not k.endswith(("act_max", "_in_max"))},
                            strict=False)
    with pytest.raises(ValueError, match="calibrate"):
        partial(x)


# ---- whole nets ---------------------------------------------------------------------


CASES = [(key, mode) for key in NETS for mode in ("dynamic", "static")] + [
    ("resnext", "static_dense")]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("key,mode", CASES)
def test_int8_embeddings_match_jax(key, mode, dtype):
    name, kw, flat = _weights(key)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got_flat, want_flat = _calibrated(key)
    if mode == "dynamic":
        got_flat = want_flat = flat
    x = np.random.default_rng(9).standard_normal(
        (3, SIZE, SIZE, 3)).astype(np.float32)
    jnet = jax_network(name, quantized=mode, dtype=jdt, **kw)
    want = np.asarray(_exact(lambda v, x: jnet.apply(v, x, train=False),
                             jax_unflatten(want_flat), x))
    tnet = create_network(name, quantized=mode, dtype=tdt, input_size=SIZE,
                          **kw)
    with torch.inference_mode():
        got = load_jax_variables(tnet, got_flat)(torch.from_numpy(x))
        fp = load_jax_variables(create_network(
            name, input_size=SIZE, **kw), flat)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    assert np.isfinite(got.numpy()).all()
    assert _cos(got.numpy(), want).min() >= 0.9999
    assert _cos(got.numpy(), fp.numpy()).min() >= 0.98


def test_static_embeddings_are_batch_independent():
    name, kw, _ = _weights("resnet")
    got_flat, _ = _calibrated("resnet")
    net = load_jax_variables(create_network(
        name, quantized="static", input_size=SIZE, **kw), got_flat)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, SIZE, SIZE, 3)).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_allclose(net(x)[:1].numpy(), net(x[:1]).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_the_carry_reads_one_int8_tensor():
    """In static mode a block's first conv, its projection and its skip
    read the int8 carry: the dequantized skip is xq * xs in the compute
    dtype, and the convs see (xq, xs) themselves."""
    name, kw, _ = _weights("resnet")
    net = load_jax_variables(create_network(
        name, quantized="static", dtype=torch.bfloat16, input_size=SIZE,
        **kw), _calibrated("resnet")[0])
    seen = []
    block = net.BottleneckBlock_0
    for conv in (block.ConvBN_0, block.ConvBN_3, block.ConvBN_1):
        conv.register_forward_pre_hook(
            lambda m, args: seen.append((m, args[2] if len(args) > 2
                                         else None)))
    with torch.inference_mode():
        net(torch.zeros(1, SIZE, SIZE, 3))
    carries = {m: pq for m, pq in seen}
    assert carries[block.ConvBN_1] is None
    xq, xs = carries[block.ConvBN_0]
    assert carries[block.ConvBN_3][0] is xq and xq.dtype == torch.int8
    assert xs.dtype == torch.float32 and xs.shape == ()


# ---- bundles and the CLIs -------------------------------------------------------


def _shard(path, n=8, size=20, seed=2):
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays

    faces = np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                 dtype=np.uint8)
    pack_arrays(str(path), faces, list(range(n)))
    return str(path)


META = dict(network="resnet_tiny", embedding_dim=16, image_size=16,
            crop_from=20, input_norm="per_image", stem="face",
            head_variant="gap", step=5)
TINY = dict(stage_sizes=(1,), width_per_group=16)


def test_a_jax_static_bundle_boots_in_the_port(tmp_path):
    jnet = jax_network("resnet_tiny", embedding_dim=16)
    flat = random_variables(create_network("resnet_tiny", embedding_dim=16,
                                           input_size=16), 1)
    cal = [jnp.asarray(b[:, :16, :16]) for b in _batches(2)]
    v = jax_calibrate("resnet_tiny", jax_unflatten(flat), cal,
                      embedding_dim=16)
    path = str(tmp_path / "jax.int8.npz")
    jax_bundle.write_bundle(path, v, dict(META, quant_mode="static"))
    variables, meta = bundle.read_bundle(path)
    net = bundle.network_from_meta(meta, dtype=torch.float32)
    assert net.quantized == "static"
    load_jax_variables(net, variables)
    x = np.random.default_rng(4).standard_normal((3, 16, 16, 3)).astype(
        np.float32)
    want = np.asarray(_exact(lambda v, x: jax_network(
        "resnet_tiny", embedding_dim=16, quantized="static").apply(
            v, x, train=False), v, x))
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
    assert _cos(got, want).min() >= 0.9999
    del jnet
    # a static bundle without its stats is refused by both writers
    for module in (bundle, jax_bundle):
        with pytest.raises(ValueError, match="needs calibrated quant_stats"):
            module.write_bundle(str(tmp_path / "x.npz"), flat,
                                dict(META, quant_mode="static"))


def test_port_int8_bundles_boot_in_jax_and_extract(tmp_path, capsys):
    """``cli.export --quant_mode static --calibrate_data`` calibrates once
    (JAX's stats on the same shard and weights) and writes a bundle JAX
    boots; ``cli.extract --bundle`` over it serves int8, as JAX's
    ``extract_shard`` does over the same bundle; the fingerprint of a
    chunked run names the mode."""
    from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
    from tf_face_toolbox_tpu.extract import calibrate_on_shard as jax_cos
    from tf_face_toolbox_tpu.extract import extract_shard as jax_extract
    from tf_face_toolbox_tpu_torch.cli import export as cli_export
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract
    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz

    shard = _shard(tmp_path / "faces.faceshard")
    flat = random_variables(create_network("resnet_tiny", embedding_dim=16,
                                           input_size=16), 2)
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, flat)
    out = str(tmp_path / "b.npz")
    cli_export.main(["--variables_npz", npz, "--output", out, "--network",
                     "resnet_tiny", "--embedding_dim", "16", "--image_size",
                     "16", "--crop_from", "20", "--quant_mode", "static",
                     "--calibrate_data", shard, "--calibrate_batches", "2",
                     "--calibrate_batch_size", "4", "--device", "cpu"])
    assert "quant=static" in capsys.readouterr().out
    jv, meta = jax_bundle.read_bundle(out)
    assert meta["quant_mode"] == "static"
    want_stats = _stats(jax_flatten(jax_cos(
        "resnet_tiny", jax_unflatten(flat), JaxSource(shard), image_size=16,
        crop_from=20, batch=4, num_batches=2, embedding_dim=16,
        loader="python")))
    got_stats = _stats(jax_flatten(jv))
    assert got_stats.keys() == want_stats.keys()
    for k in want_stats:
        assert got_stats[k] == pytest.approx(want_stats[k], rel=1e-5), k
    jnet = jax_bundle.network_from_meta(meta, dtype=jnp.float32)
    want = jax_extract(jnet, jv, JaxSource(shard), image_size=16,
                       crop_from=20, batch=4, loader="python")
    emb = str(tmp_path / "e.npy")
    cli_extract.main(["--bundle", out, "--data", shard, "--output", emb,
                      "--nobf16", "--device", "cpu", "--loader", "python",
                      "--batch", "4"])
    got = np.load(emb)
    assert got.shape == (8, 16) and _cos(got, want).min() >= 0.9999
    with pytest.raises(SystemExit, match="serves fp"):
        cli_extract.main(["--bundle", out, "--data", shard, "--output", emb,
                          "--engine", "folded", "--device", "cpu"])
    with pytest.raises(SystemExit, match="bakes the quant mode"):
        cli_extract.main(["--bundle", out, "--data", shard, "--output", emb,
                          "--quant_mode", "dynamic", "--device", "cpu"])
    # flag-driven: the same calibration on --data, the fingerprint names q
    chunked = str(tmp_path / "c.npy")
    cli_extract.main(["--variables_npz", npz, "--data", shard, "--output",
                      chunked, "--network", "resnet_tiny", "--embedding_dim",
                      "16", "--image_size", "16", "--crop_from", "20",
                      "--nobf16", "--device", "cpu", "--loader", "python",
                      "--batch", "4", "--quant_mode", "static",
                      "--calibrate_batches", "2", "--chunk_rows", "4"])
    np.testing.assert_allclose(np.load(chunked), got, rtol=1e-6, atol=1e-6)
    import json
    with open(chunked + ".progress.json") as f:
        assert "/q=static/" in json.load(f)["fingerprint"]


def test_dynamic_int8_extraction_matches_jax(tmp_path):
    """``cli.extract --quantized`` (dynamic) on the module path against
    JAX's flax path over the same weights and shard."""
    from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
    from tf_face_toolbox_tpu.extract import extract_shard as jax_extract
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract
    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz

    shard = _shard(tmp_path / "faces.faceshard", seed=3)
    flat = random_variables(create_network("resnet_tiny", embedding_dim=16,
                                           input_size=16), 3)
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, flat)
    jnet = jax_network("resnet_tiny", embedding_dim=16, quantized=True)
    want = jax_extract(jnet, jax_unflatten(flat), JaxSource(shard),
                       image_size=16, crop_from=20, batch=4, loader="python")
    emb = str(tmp_path / "e.npy")
    cli_extract.main(["--variables_npz", npz, "--data", shard, "--output",
                      emb, "--network", "resnet_tiny", "--embedding_dim",
                      "16", "--image_size", "16", "--crop_from", "20",
                      "--nobf16", "--device", "cpu", "--loader", "python",
                      "--batch", "4", "--quantized"])
    assert _cos(np.load(emb), want).min() >= 0.9999


# ---- the daemon ---------------------------------------------------------------


def test_cli_serve_static_int8_answers_as_jax_and_recalibrates_on_reload(
        tmp_path):
    """``cli.serve --quant_mode=static --calibrate_data`` over a port train
    dir: one scripted request sequence gets JAX's daemon's status codes,
    keys and embeddings (its service on the same weights, calibrated by
    JAX on the same shard); ``--engine folded`` refuses int8; a hot
    reload to a new step calibrates again and serves that step's int8
    embeddings."""
    from tests.test_torch_bundle import _train_dir
    from tests.test_torch_serve import _call, _drain, _images, _npy, _start_cli
    from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
    from tf_face_toolbox_tpu.extract import calibrate_on_shard as jax_cos
    from tf_face_toolbox_tpu.serving import server as jax_server
    from tf_face_toolbox_tpu.serving.gallery import DeviceGallery as JaxGallery
    from tf_face_toolbox_tpu_torch.cli import serve as cli_serve
    from tf_face_toolbox_tpu_torch.extract import calibrate_on_shard
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.pretrained import load_variables
    from tf_face_toolbox_tpu_torch.serving.server import EmbeddingService

    run = _train_dir(str(tmp_path))
    shard = _shard(tmp_path / "cal.faceshard", n=8, seed=4)
    live = tmp_path / "live"
    live.mkdir()
    shutil.copytree(f"{run}/2", live / "2")
    net_flags = ["--network", "resnet_tiny", "--stem", "imagenet",
                 "--embedding_dim", "16", "--image_size", "16",
                 "--crop_from", "20"]
    with pytest.raises(SystemExit, match="serves fp"):
        cli_serve.main(["--checkpoint_dir", str(live), *net_flags,
                        "--quant_mode", "static", "--calibrate_data", shard,
                        "--engine", "folded", "--device", "cpu"])
    imgs = _images(5, seed=21)
    steps = [("GET", "/healthz", None), ("POST", "/embed", _npy(imgs[0])),
             ("POST", "/embed_batch", _npy(imgs[:3])),
             *[("POST", f"/enroll?label={i}", _npy(imgs[i])) for i in range(4)],
             ("POST", "/identify?k=2", _npy(imgs[1])),
             ("POST", "/identify?k=3", _npy(imgs[4]))]

    _, flat2 = load_variables(run, "resnet_tiny", 16, 16, torch.float32,
                              stem="imagenet", step=2)
    jv = jax_cos("resnet_tiny", jax_unflatten(flat2), JaxSource(shard),
                 image_size=16, crop_from=20, batch=4, num_batches=4,
                 embedding_dim=16, loader="python", stem="imagenet")
    jsvc = jax_server.EmbeddingService(
        jax_network("resnet_tiny", embedding_dim=16, stem="imagenet",
                    quantized="static"), jv, image_size=16, crop_from=20,
        batch=4, dtype=jnp.float32)
    jsvc.warmup()
    batcher = jax_server.DynamicBatcher(jsvc, max_wait_ms=1.0)
    server = jax_server.serve(batcher, port=0, gallery=JaxGallery(16))
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        want = [_call(base, m, p, b) for m, p, b in steps]
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()

    proc = _start_cli(["--checkpoint_dir", str(live), *net_flags,
                       "--quant_mode", "static", "--calibrate_data", shard,
                       "--gallery", str(tmp_path / "g.npz"),
                       "--watch_interval", "0.2"])
    try:
        got = [_call(proc.base, m, p, b) for m, p, b in steps]
        for (m, p, _), g, w in zip(steps, got, want):
            assert g[0] == w[0] == 200, (p, g, w)
            assert g[1].keys() == w[1].keys(), p
            for key in ("embedding", "embeddings"):
                if key in w[1]:
                    assert _cos(g[1][key], w[1][key]).min() >= 0.9999, p
            if "matches" in w[1]:
                assert [x["label"] for x in g[1]["matches"]] == \
                    [x["label"] for x in w[1]["matches"]], p
        shutil.copytree(f"{run}/3", live / ".3.tmp")
        os.rename(live / ".3.tmp", live / "3")
        deadline = time.monotonic() + 60
        while (_call(proc.base, "GET", "/healthz")[1]["serving_step"] != 3
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert _call(proc.base, "GET", "/stats")[1]["reloads"] == 1
        net, flat3 = load_variables(run, "resnet_tiny", 16, 16,
                                    torch.float32, stem="imagenet",
                                    quantized="static", step=3)
        flat3 = calibrate_on_shard(
            "resnet_tiny", flat3, FaceShardSource(shard), image_size=16,
            crop_from=20, batch=4, device="cpu", embedding_dim=16,
            stem="imagenet", input_size=16)
        svc = EmbeddingService(net, flat3, image_size=16, crop_from=20,
                               batch=4, dtype=torch.float32, device="cpu")
        out = _call(proc.base, "POST", "/embed_batch", _npy(imgs[:2]))[1]
        np.testing.assert_allclose(out["embeddings"],
                                   svc.embed_batch(imgs[:2]), atol=1e-6)
    finally:
        _drain(proc)
    log = proc.stderr.read()
    assert log.count("calibrating static-int8 scales") == 2, log[-2000:]
