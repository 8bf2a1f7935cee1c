"""Deployment bundles (``serving/bundle.py``, ``cli.export``,
``cli.extract --bundle``) in the port vs the JAX package.

A bundle written by either package boots in the other with equal
variables and meta; both refuse the same malformed artifacts; the
export CLI selects and averages the weights it is asked for; and
``cli.extract --bundle`` equals the flag-driven extraction of the same
weights.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from tests.test_serving import _warm_variables
from tf_face_toolbox_tpu.interop.port import flatten_variables as jax_flatten
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.serving import bundle as jax_bundle
from tf_face_toolbox_tpu_torch.interop.port import (
    flatten_variables, load_jax_variables, named_to_flat, save_variables_npz)
from tf_face_toolbox_tpu_torch.serving import bundle

torch.set_num_threads(1)

META = dict(network="resnet_tiny", embedding_dim=16, image_size=16,
            crop_from=20, input_norm="per_image", quant_mode="none",
            stem="imagenet", head_variant="gap", step=7)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    jnet = jax_network("resnet_tiny", stem="imagenet", embedding_dim=16)
    return jnet, _warm_variables(jnet, jax.random.key(0), (4, 16, 16, 3))


def _faces(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 16, 16, 3)).astype(np.float32)


def _assert_same_flat(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_a_jax_bundle_boots_in_the_port(tmp_path):
    jnet, variables = _jax_weights()
    path = str(tmp_path / "jax.bundle.npz")
    jax_bundle.write_bundle(path, variables, META)
    got, meta = bundle.read_bundle(path)
    assert meta == jax_bundle.read_bundle(path)[1]
    assert meta["format_version"] == bundle.FORMAT_VERSION
    _assert_same_flat(flatten_variables(got), jax_flatten(variables))
    net = load_jax_variables(bundle.network_from_meta(
        meta, dtype=torch.float32), flatten_variables(got))
    x = _faces()
    want = np.asarray(jnet.apply(variables, x, train=False))
    with torch.no_grad():
        out = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_a_port_bundle_boots_in_jax(tmp_path):
    jnet, variables = _jax_weights()
    path = str(tmp_path / "port.bundle.npz")
    bundle.write_bundle(path, jax_flatten(variables), META)
    got, meta = jax_bundle.read_bundle(path)
    assert meta == bundle.read_bundle(path)[1]
    _assert_same_flat(jax_flatten(got), jax_flatten(variables))
    rebuilt = jax_bundle.network_from_meta(meta, dtype=jax.numpy.float32)
    x = _faces()
    np.testing.assert_array_equal(
        np.asarray(rebuilt.apply(got, x, train=False)),
        np.asarray(jnet.apply(variables, x, train=False)))


def _rewrite_meta(path: str, **changes) -> None:
    data = dict(np.load(path))
    meta = json.loads(str(data["__bundle_meta__"]))
    meta.update(changes)
    for key in [k for k, v in changes.items() if v is None]:
        del meta[key]
    data["__bundle_meta__"] = np.array(json.dumps(meta))
    np.savez(path, **data)


@pytest.mark.parametrize("case", ["no_meta", "version", "missing", "static"])
def test_both_packages_refuse_the_same_artifacts(tmp_path, case):
    _, variables = _jax_weights()
    flat = jax_flatten(variables)
    path = str(tmp_path / "b.npz")
    if case == "static":
        for module, tree in ((bundle, flat), (jax_bundle, variables)):
            with pytest.raises(ValueError, match="quant_stats"):
                module.write_bundle(path, tree, dict(META,
                                                     quant_mode="static"))
        return
    if case == "no_meta":
        save_variables_npz(path, flat)
        match = "not a deployment bundle"
    else:
        bundle.write_bundle(path, flat, META)
        if case == "version":
            _rewrite_meta(path, format_version=bundle.FORMAT_VERSION + 1)
            match = "format_version"
        else:
            _rewrite_meta(path, input_norm=None)
            match = "missing"
    for module in (bundle, jax_bundle):
        with pytest.raises(ValueError, match=match):
            module.read_bundle(path)


# the DCT nets (item 17b) and int8 bundles (item 18) refused until they
# were ported: their bundles now boot (a JAX dct_vit_test bundle served:
# tests/test_torch_vit.py; int8 bundles both ways: tests/test_torch_int8.py).
# The ids keep the items that once refused.
@pytest.mark.parametrize("change,item", [
    ({"quant_mode": "dynamic"}, "item 18"),
    ({"quant_mode": "static"}, "item 18"),
    pytest.param({"network": "dct_vit_small", "stem": None}, None,
                 id="change2-item 17"),
    pytest.param({"network": "dct_resnet_50", "stem": None}, None,
                 id="change3-item 17")])
def test_network_from_meta_refuses_what_the_port_lacks(change, item):
    if item is None:
        net = bundle.network_from_meta(dict(META, **change),
                                       dtype=torch.float32)
        assert net.stem == "dct" and not net.training
        if change["network"] == "dct_resnet_50":
            q = bundle.network_from_meta(
                dict(META, **change, quant_mode="static"),
                dtype=torch.float32)
            assert q.quantized == "static" and q.stem == "dct"
            assert q.BottleneckBlock_0.ConvBN_0.act_max.shape == ()
        else:
            # JAX has no int8 ViT: the port refuses with its words
            with pytest.raises(ValueError, match="not supported for the "
                               "ViT family"):
                bundle.network_from_meta(
                    dict(META, **change, quant_mode="static"),
                    dtype=torch.float32)
        return
    net = bundle.network_from_meta(dict(META, **change), dtype=torch.float32)
    mode = change["quant_mode"]
    assert net.quantized == mode and not net.training
    assert hasattr(net, "block_0_in_max") == (mode == "static")
    assert net.ConvBN_0.quantized is False       # the stem stays fp


@functools.lru_cache(maxsize=None)
def _train_dir(root: str) -> str:
    """A port train dir: resnet_tiny (imagenet stem, 16-d), EMA, a
    checkpoint at each of steps 1, 2 and 3."""
    from tf_face_toolbox_tpu_torch.train.loop import train_loop
    from tf_face_toolbox_tpu_torch.train.trainer import TrainConfig

    cfg = TrainConfig(network="resnet_tiny", stem="imagenet", num_classes=7,
                      embedding_dim=16, image_size=16, crop_from=20,
                      global_batch=8, ema_decay=0.5)
    rng = np.random.default_rng(0)
    batches = ({"image": rng.integers(0, 256, (8, 20, 20, 3), np.uint8),
                "label": rng.integers(0, 7, 8)} for _ in range(3))
    run = f"{root}/run"
    train_loop(cfg, batches, num_steps=3, train_dir=run, save_every=1,
               log_every=0, device="cpu")
    return run


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    return _train_dir(str(tmp_path_factory.mktemp("bundle_run")))


_NET = ["--network", "resnet_tiny", "--stem", "imagenet", "--embedding_dim",
        "16", "--image_size", "16", "--crop_from", "20"]


def _selected(run: str, step: int, use_ema: bool) -> dict:
    from tf_face_toolbox_tpu_torch.pretrained import load_variables

    return load_variables(run, "resnet_tiny", 16, 16, torch.float32,
                          use_ema=use_ema, stem="imagenet", step=step)[1]


@pytest.mark.parametrize("flags,step,averaged", [
    ([], 3, None), (["--use_ema"], 3, None), (["--step", "2"], 2, None),
    (["--average_last", "2"], 3, [2, 3]),
    (["--average_last", "5", "--use_ema", "--step", "2"], 2, [1, 2])])
def test_cli_export_selects_the_weights(tmp_path, capsys, run_dir, flags,
                                        step, averaged):
    from tf_face_toolbox_tpu_torch.cli import export

    out = str(tmp_path / "b.npz")
    export.main(["--checkpoint_dir", run_dir, "--output", out, *_NET, *flags])
    assert capsys.readouterr().out.startswith(
        f"exported resnet_tiny (step={step}, quant=none, "
        f"ema={'--use_ema' in flags}")
    got, meta = bundle.read_bundle(out)
    assert meta["step"] == step and meta["averaged_steps"] == averaged
    assert (meta["stem"], meta["head_variant"]) == ("imagenet", "gap")
    assert meta["use_ema"] == ("--use_ema" in flags)
    use_ema = "--use_ema" in flags
    want = _selected(run_dir, step, use_ema)
    if averaged:
        trees = [_selected(run_dir, s, use_ema) for s in averaged]
        for key in want:
            if key.startswith("params/"):
                want[key] = np.mean(np.stack(
                    [t[key].astype(np.float64) for t in trees]), 0
                ).astype(np.float32)
    _assert_same_flat(flatten_variables(got), want)
    assert meta == jax_bundle.read_bundle(out)[1]


def test_cli_export_from_variables_npz_and_refusals(tmp_path, capsys):
    from tf_face_toolbox_tpu_torch.cli import export

    _, variables = _jax_weights()
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, jax_flatten(variables))
    out = str(tmp_path / "b.npz")
    export.main(["--variables_npz", npz, "--output", out, *_NET,
                 "--input_norm", "fixed"])
    assert "(step=None, quant=none, ema=False" in capsys.readouterr().out
    got, meta = jax_bundle.read_bundle(out)
    assert meta["input_norm"] == "fixed" and meta["crop_from"] == 20
    _assert_same_flat(jax_flatten(got), jax_flatten(variables))
    # int8 (item 18, refused until ported): dynamic bakes its mode in;
    # static calibrates here and so needs a shard (a calibrated bundle is
    # held against JAX's in tests/test_torch_int8.py)
    export.main(["--variables_npz", npz, "--output", out, *_NET,
                 "--quant_mode", "dynamic"])
    got, meta = jax_bundle.read_bundle(out)
    assert meta["quant_mode"] == "dynamic" and "quant_stats" not in got
    _assert_same_flat(jax_flatten(got), jax_flatten(variables))
    for argv, match in (
            (["--variables_npz", npz, "--quant_mode", "static"],
             "needs --calibrate_data"),
            (["--variables_npz", npz, "--checkpoint_dir", str(tmp_path)],
             "exactly one"),
            (["--variables_npz", npz, "--step", "2"], "don't apply")):
        with pytest.raises(SystemExit, match=match):
            export.main([*argv, "--output", out])


def _shard(path, n=10):
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays

    faces = np.random.default_rng(2).integers(0, 256, (n, 24, 24, 3),
                                              dtype=np.uint8)
    pack_arrays(str(path), faces, list(range(n)))
    return str(path)


@pytest.mark.parametrize("engine", ["module", "folded"])
def test_cli_extract_bundle_equals_variables_npz(tmp_path, capsys, engine):
    """A JAX-written bundle through the port's cli.extract equals
    --variables_npz with the matching flags, and JAX's extract_shard."""
    from tests.test_torch_extract import _jax_embeddings
    from tf_face_toolbox_tpu_torch.cli import extract

    _, variables = _jax_weights()
    shard = _shard(tmp_path / "faces.faceshard")
    path = str(tmp_path / "jax.bundle.npz")
    jax_bundle.write_bundle(path, variables, META)
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, jax_flatten(variables))
    common = ["--data", shard, "--batch", "4", "--nobf16", "--engine", engine,
              "--loader", "python", "--device", "cpu"]
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    # the bundle's record overrides these flags
    extract.main([*common, "--bundle", path, "--output", a, "--network",
                  "resnet_v1_50", "--image_size", "112"])
    extract.main([*common, "--variables_npz", npz, "--output", b, *_NET])
    got = np.load(a)
    assert got.shape == (10, 16)
    np.testing.assert_array_equal(got, np.load(b))
    np.testing.assert_allclose(got, _jax_embeddings(shard), atol=1e-4)
    with pytest.raises(SystemExit, match="self-contained"):
        extract.main([*common, "--bundle", path, "--variables_npz", npz,
                      "--output", a])


def test_cli_export_then_extract_bundle_equals_the_checkpoint(tmp_path,
                                                              run_dir):
    from tf_face_toolbox_tpu_torch.cli import export, extract

    shard = _shard(tmp_path / "faces.faceshard")
    path = str(tmp_path / "run.bundle.npz")
    export.main(["--checkpoint_dir", run_dir, "--output", path, *_NET,
                 "--use_ema"])
    common = ["--data", shard, "--batch", "4", "--nobf16", "--loader",
              "python", "--device", "cpu", "--engine", "fused"]
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    extract.main([*common, "--bundle", path, "--output", a])
    extract.main([*common, "--checkpoint_dir", run_dir, "--use_ema",
                  "--output", b, *_NET])
    np.testing.assert_array_equal(np.load(a), np.load(b))


def test_named_weights_survive_the_round_trip(tmp_path, run_dir):
    """A port checkpoint's state-dict names -> bundle -> a JAX net: the
    JAX forward of the bundle equals the port module's forward."""
    from tf_face_toolbox_tpu_torch.pretrained import load_variables

    net, flat = load_variables(run_dir, "resnet_tiny", 16, 16, torch.float32,
                               stem="imagenet")
    assert sorted(named_to_flat(net.state_dict())) == sorted(flat)
    path = str(tmp_path / "b.npz")
    bundle.write_bundle(path, flat, META)
    got, meta = jax_bundle.read_bundle(path)
    jnet = jax_bundle.network_from_meta(meta, dtype=jax.numpy.float32)
    x = _faces()
    with torch.no_grad():
        want = net(torch.from_numpy(x)).numpy()
    # raw (unnormalized) embeddings of magnitude ~100: f32 rounding
    np.testing.assert_allclose(np.asarray(jnet.apply(got, x, train=False)),
                               want, rtol=1e-5, atol=1e-5)
