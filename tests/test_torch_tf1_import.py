"""The port's TF1 and Keras importers (interop/tf1.py,
interop/keras_mirror.py, interop/port.py's keras_to_jax / jax_to_keras,
cli.import_tf1, cli.import_keras) vs the JAX package's.

Fixtures are built in-process as the JAX tests build them: genuine
Saver-V2 checkpoints (``tests/test_tf1_import.py::_write_ckpt``) with EMA
shadows, optimizer slots, a missing variable, an unused one and a Dense
stored as a 1x1 conv; Keras mirrors with TF-born weights and moved BN
statistics (``tests/test_tf_crossparity.py``). Tolerances: name maps,
``.npz`` files and the importers' reports are equal to JAX's (arrays
bit-equal; under ``skip_missing`` the leaves left at init differ by
design, the two packages' init draws differ, so only the imported leaves
are held); the port's f32 module path on the imported weights against
the Keras mirror's forward: per-face cosine >= 0.999 and allclose at
rtol/atol 2e-3 (``test_tf_crossparity.py``'s bar).
"""

import functools
import json

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_tf1_import import _write_ckpt  # noqa: E402
from tf_face_toolbox_tpu.interop import keras_to_jax as jax_keras_to_jax  # noqa: E402
from tf_face_toolbox_tpu.interop import port as jax_port  # noqa: E402
from tf_face_toolbox_tpu.interop import tf1 as jax_tf1  # noqa: E402
from tf_face_toolbox_tpu.models import create_network as jax_network  # noqa: E402
from tf_face_toolbox_tpu.models import init_variables  # noqa: E402
from tf_face_toolbox_tpu_torch.interop import (  # noqa: E402
    build_keras_resnet, jax_to_keras, keras_to_jax, port, tf1)
from tf_face_toolbox_tpu_torch.models import create_network  # noqa: E402
from tf_face_toolbox_tpu_torch.models.resnet import ResNet  # noqa: E402

torch.set_num_threads(1)


def _jax_template(network, **kw):
    """JAX's structure-only template (``jax.eval_shape`` of ``init``)."""
    net = jax_network(network, dtype=jnp.float32, **kw)
    return jax.eval_shape(lambda: net.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))


def _port_template(network, **kw):
    return port.jax_variables(create_network(network, input_size=32, **kw))


@pytest.mark.parametrize("network, kw", [
    ("resnet_v1_50", {}),
    ("se_resnext_50", {}),
    ("resnet_v1_50", {"stem": "space2depth"}),
    ("resnet_tiny", {"head_variant": "flatten"}),
])
def test_slim_name_map_is_jax_s(network, kw):
    stages = tf1.network_stage_sizes(network)
    assert stages == jax_tf1.network_stage_sizes(network)
    got = tf1.slim_name_map(_port_template(network, **kw),
                            stage_sizes=stages, scope=network)
    want = jax_tf1.slim_name_map(_jax_template(network, **kw),
                                 stage_sizes=stages, scope=network)
    assert got == want
    assert len(set(got.values())) == len(got)
    over = {"params/ConvBN_0/kernel": "net/stem/weights"}
    assert tf1.slim_name_map(_port_template(network, **kw),
                             stage_sizes=stages, scope="", head_scope="emb",
                             overrides=over) == jax_tf1.slim_name_map(
        _jax_template(network, **kw), stage_sizes=stages, scope="",
        head_scope="emb", overrides=over)
    with pytest.raises(ValueError, match="override keys"):
        tf1.slim_name_map(_port_template(network, **kw), stage_sizes=stages,
                          scope="", overrides={"params/nowhere": "x"})


def test_coerce_is_jax_s():
    w = np.arange(12, dtype=np.float32).reshape(1, 1, 3, 4)
    assert np.array_equal(tf1._coerce(w, (3, 4)), jax_tf1._coerce(w, (3, 4)))
    with pytest.raises(ValueError, match="shape mismatch"):
        tf1._coerce(w, (4, 3))


@pytest.fixture(scope="module")
def saver_ckpt(tmp_path_factory):
    """A resnet_tiny Saver checkpoint: every leaf (BN variances
    positive), EMA shadows of the params offset by 1, a momentum slot,
    global_step, one unused variable, the head's Dense kernel stored as a
    1x1 conv, and the head's BN beta left out."""
    template = _port_template("resnet_tiny", embedding_dim=8)
    name_map = tf1.slim_name_map(template, stage_sizes=(1,),
                                 scope="resnet_tiny")
    rng = np.random.default_rng(3)
    flat = port.flatten_variables(template)
    base = {}
    for k, v in flat.items():
        x = (0.1 * rng.normal(size=np.shape(v))).astype(np.float32)
        base[name_map[k]] = np.abs(x) + 1.0 if k.endswith("/var") else x
    tensors = dict(base)
    for k in flat:
        if k.startswith("params/"):
            tensors[name_map[k] + "/ExponentialMovingAverage"] = (
                base[name_map[k]] + 1.0)
    dense = name_map["params/EmbeddingHead_0/Dense_0/kernel"]
    tensors[dense] = tensors[dense].reshape(1, 1, *tensors[dense].shape)
    tensors["resnet_tiny/conv1/weights/Momentum"] = np.zeros_like(
        base["resnet_tiny/conv1/weights"])
    tensors["global_step"] = np.int64(90000)
    tensors["resnet_tiny/logits/weights"] = np.zeros((8, 4), np.float32)
    dropped = "params/EmbeddingHead_0/BatchNorm_0/bias"
    del tensors[name_map[dropped]]
    del tensors[name_map[dropped] + "/ExponentialMovingAverage"]
    tmp = tmp_path_factory.mktemp("tf1")
    return _write_ckpt(str(tmp / "model.ckpt-90000"), tensors), dropped


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's CLI template: ``init_variables`` of resnet_tiny (8-d)."""
    net = jax_network("resnet_tiny", dtype=jnp.float32, embedding_dim=8)
    return init_variables(net, jax.random.key(0), (1, 32, 32, 3))


def _jax_import(prefix, **kw):
    template = _jax_init()
    name_map = jax_tf1.slim_name_map(template, stage_sizes=(1,),
                                     scope="resnet_tiny")
    return jax_tf1.import_tf1_checkpoint(prefix, template, name_map, **kw)


@pytest.mark.parametrize("use_ema", [False, True])
def test_import_and_report_are_jax_s(saver_ckpt, use_ema):
    prefix, dropped = saver_ckpt
    template = _port_template("resnet_tiny", embedding_dim=8)
    name_map = tf1.slim_name_map(template, stage_sizes=(1,),
                                 scope="resnet_tiny")
    with pytest.raises(KeyError, match="absent") as got_err:
        tf1.import_tf1_checkpoint(prefix, template, name_map,
                                  use_ema=use_ema)
    with pytest.raises(KeyError) as want_err:
        _jax_import(prefix, use_ema=use_ema)
    assert str(got_err.value) == str(want_err.value)

    got, report = tf1.import_tf1_checkpoint(
        prefix, template, name_map, use_ema=use_ema, skip_missing=True)
    want, want_report = _jax_import(prefix, use_ema=use_ema,
                                    skip_missing=True)
    assert report == want_report
    assert report["unused"] == ["resnet_tiny/logits/weights"]
    assert len(report["missing"]) == 1 and dropped in report["missing"][0]
    assert report["ema_used"] == (18 if use_ema else 0)
    got, want = port.flatten_variables(got), jax_port.flatten_variables(want)
    assert sorted(got) == sorted(want)
    for k in got:
        if k != dropped:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.mid
def test_cli_import_tf1_skip_missing_holds_the_imported_leaves(
        saver_ckpt, tmp_path, capsys):
    """cli.import_tf1 --skip_missing --use_ema (its main, in this
    process: TensorFlow is already imported here): the .npz holds JAX's
    imported leaves, the missing one at the port's init, and prints the
    JAX CLI's report lines."""
    from tf_face_toolbox_tpu_torch.cli import import_tf1
    from tf_face_toolbox_tpu_torch.models import init_parameters

    prefix, dropped = saver_ckpt
    out = str(tmp_path / "imported.npz")
    args = [f"--checkpoint={prefix}", f"--output={out}",
            "--network=resnet_tiny", "--embedding_dim=8", "--image_size=32"]
    with pytest.raises(KeyError, match="absent"):
        import_tf1.main(args)
    import_tf1.main(args + ["--skip_missing", "--use_ema"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"imported 30 variables (18 from EMA shadows) into {out}"
    assert lines[1].startswith(f"missing (1): {dropped} (wanted ")
    assert lines[2] == "unused (1): resnet_tiny/logits/weights"
    got = port.flatten_variables(port.load_variables_npz(out))
    want = jax_port.flatten_variables(_jax_import(
        prefix, use_ema=True, skip_missing=True)[0])
    assert sorted(got) == sorted(want)
    for k in got:
        if k != dropped:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    init = port.flatten_variables(port.jax_variables(init_parameters(
        create_network("resnet_tiny", embedding_dim=8, input_size=32), 0)))
    np.testing.assert_array_equal(got[dropped], init[dropped])

    # --name_map_json renames a leaf; --scope sets the outer scope
    names = tmp_path / "names.json"
    names.write_text(json.dumps({dropped: "resnet_tiny/logits/weights"}))
    with pytest.raises(ValueError, match="shape mismatch"):
        import_tf1.main(args + [f"--name_map_json={names}"])


# ---- the Keras mirror ----------------------------------------------------


def _keras_case(kw: dict, image_size: int, seed: int):
    """A Keras mirror with TF-born weights and its own BN statistics."""
    tf.keras.utils.set_random_seed(seed)
    model = build_keras_resnet(image_size=image_size, **kw)
    rng = np.random.default_rng(seed)
    for layer in model.layers:
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            gamma, beta, mean, var = layer.get_weights()
            layer.set_weights([
                rng.uniform(0.5, 1.5, gamma.shape).astype(np.float32),
                rng.normal(0, 0.1, beta.shape).astype(np.float32),
                rng.normal(0, 0.5, mean.shape).astype(np.float32),
                rng.uniform(0.5, 2.0, var.shape).astype(np.float32)])
    return model


KERAS_CASES = {
    "face": dict(stage_sizes=(1, 1), width_per_group=16, embedding_dim=24,
                 stem="face"),
    "se_resnext": dict(stage_sizes=(1, 1), width_per_group=8, groups=4,
                       expansion=2, se_reduction=4, embedding_dim=16,
                       stem="face"),
    "space2depth": dict(stage_sizes=(1,), width_per_group=16,
                        embedding_dim=16, stem="space2depth"),
    "flatten": dict(stage_sizes=(1,), width_per_group=16, embedding_dim=16,
                    stem="face", head_variant="flatten"),
}


def _cosine_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("case", sorted(KERAS_CASES))
def test_keras_import_is_jax_s_and_serves(case):
    kw = KERAS_CASES[case]
    model = _keras_case(kw, 16, seed=len(case))
    net = ResNet(input_size=16, **kw).eval()
    got = keras_to_jax(model, port.jax_variables(net))
    jax_template = jax_port.unflatten_variables(port.flatten_variables(
        port.jax_variables(net)))
    want = jax_keras_to_jax(model, jax_template)
    got_flat = port.flatten_variables(got)
    want_flat = jax_port.flatten_variables(want)
    assert sorted(got_flat) == sorted(want_flat)
    for k in got_flat:
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)

    port.load_jax_variables(net, got_flat)
    x = np.random.default_rng(7).normal(size=(6, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        emb = net(torch.from_numpy(x)).numpy()
    emb_tf = model.predict(x, verbose=0)
    assert _cosine_rows(emb, emb_tf).min() >= 0.999
    np.testing.assert_allclose(emb, emb_tf, rtol=2e-3, atol=2e-3)

    # and back: the port's jax_to_keras fills a fresh mirror losslessly
    twin = build_keras_resnet(image_size=16, **kw)
    jax_to_keras(got, twin)
    for a, b in zip(model.get_weights(), twin.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_keras_port_refuses_architecture_drift():
    wrong = build_keras_resnet(stage_sizes=(1, 1), width_per_group=16,
                               embedding_dim=24, stem="face", image_size=16)
    net = ResNet(stage_sizes=(1,), width_per_group=16, embedding_dim=24,
                 input_size=16)
    with pytest.raises((AssertionError, KeyError)):
        jax_to_keras(port.jax_variables(net), wrong)
    with pytest.raises((AssertionError, KeyError)):
        keras_to_jax(wrong, port.jax_variables(net))


@pytest.mark.mid
def test_cli_import_keras_is_jax_s(tmp_path, capsys):
    """A .keras file through cli.import_keras (its main, in this
    process) writes JAX's keras_to_jax of the same model, and prints the
    JAX CLI's line."""
    from tf_face_toolbox_tpu_torch.cli import import_keras

    kw = dict(stage_sizes=(1,), width_per_group=16, embedding_dim=16,
              stem="face")
    model = _keras_case(kw, 12, seed=5)
    path = str(tmp_path / "tiny.keras")
    model.save(path)
    out = str(tmp_path / "ported.npz")
    import_keras.main([f"--keras_model={path}", f"--output={out}",
                       "--network=resnet_tiny", "--embedding_dim=16",
                       "--image_size=12"])
    assert capsys.readouterr().out.strip() == (
        f"imported 12,176 weights from {path} into {out}")
    got = port.flatten_variables(port.load_variables_npz(out))
    template = port.jax_variables(create_network(
        "resnet_tiny", embedding_dim=16, input_size=12))
    want = jax_port.flatten_variables(jax_keras_to_jax(
        model, jax_port.unflatten_variables(port.flatten_variables(template))))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
