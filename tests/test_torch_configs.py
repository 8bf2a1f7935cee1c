"""The port's presets (``configs.py``) against the JAX package's.

Mirrors tests/test_configs.py: all eight presets exist; the eval-only
dicts are the JAX ones; each train preset has the JAX TrainConfig's
field values (bf16 compute); the single-GPU preset builds and trains a
step at a cut size; the data-parallel and Partial-FC presets are served
with their batch a device times the ranks; the AdaFace preset builds
and trains a step at a cut size; no preset raises at import.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu import configs as jax_configs
from tf_face_toolbox_tpu_torch import configs
from tf_face_toolbox_tpu_torch.models import list_networks
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)

torch.set_num_threads(1)

EVAL = ["extract_verify_cpu", "se_resnet_extract", "variant_backbones",
        "accuracy_serving_bf16"]
TRAIN = ["casia_single_chip", "v5e8_data_parallel", "large_id_pfc_v5e8",
         "adaface_noisy_data"]
# presets whose path was to port -> the item their refusal named, until
# it was ported: item 11 (the Partial-FC head), item 9 (the loss heads)
REFUSED = {"large_id_pfc_v5e8": "11", "adaface_noisy_data": "9"}
SERVED = {"large_id_pfc_v5e8", "adaface_noisy_data"}


def test_all_presets_present():
    assert configs.list_configs() == jax_configs.list_configs()
    assert len(configs.list_configs()) == 8
    assert sorted(EVAL + TRAIN) == configs.list_configs()


@pytest.mark.parametrize("name", EVAL)
def test_eval_presets_are_the_jax_dicts(name):
    assert configs.get_config(name) == jax_configs.get_config(name)


@pytest.mark.parametrize("name", TRAIN)
def test_train_presets_have_the_jax_field_values(name):
    """Every field the preset sets, and every default it leaves, equals
    the JAX preset's (the MagFace and AdaFace sub-configs field by
    field); the compute dtype is bf16 on both sides."""
    want = jax_configs.get_config(name)
    kwargs = configs.TRAIN_PRESETS[name]
    for field in dataclasses.fields(TrainConfig):
        if field.name == "dtype":
            continue
        value = kwargs.get(field.name, field.default)
        if field.name in ("magface", "adaface"):
            assert dataclasses.asdict(value) == dataclasses.asdict(
                getattr(want, field.name)), field.name
        else:
            assert value == getattr(want, field.name), field.name
    assert want.dtype == jnp.bfloat16
    assert kwargs.get("network") in list_networks()


def test_the_single_gpu_preset_builds_in_bf16():
    cfg = configs.get_config("casia_single_chip")
    assert isinstance(cfg, TrainConfig)
    assert cfg.dtype == torch.bfloat16
    assert (cfg.num_classes, cfg.global_batch, cfg.margin_m3,
            cfg.warmup_steps) == (10_572, 256, 0.35, 2_000)


def test_the_single_gpu_preset_trains_a_step():
    """Its schedule, margin, decay and bf16 settings as they are; only
    the extents that do not change the program (depth, widths of the
    input, identity count, batch) cut for the CPU."""
    preset = configs.get_config("casia_single_chip")
    cfg = dataclasses.replace(preset, network="resnet_tiny",
                              embedding_dim=16, num_classes=24,
                              image_size=12, crop_from=16, global_batch=8)
    state, net = create_train_state(cfg, 0, device="cpu")
    step_fn = make_train_step(net, cfg, state)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (8, 16, 16, 3), np.uint8)
    state, m = step_fn(state, images, np.arange(8) % 24)
    assert np.isfinite(float(m["loss"])) and state.step == 1
    # warmup from 0: the first update's rate is base_lr * 0 / warmup
    assert float(m["learning_rate"]) < preset.base_lr * 0.01


def test_the_data_parallel_preset_is_served():
    """Config 5: the published 2048 over 8 devices, or 256 a rank times
    the ranks of the run; every other field as published."""
    published = configs.get_config("v5e8_data_parallel")
    assert isinstance(published, TrainConfig)
    assert published.dtype == torch.bfloat16
    assert published.global_batch == 2048
    for world in (1, 2, 8):
        cfg = configs.get_config("v5e8_data_parallel", world=world)
        assert cfg == dataclasses.replace(published, global_batch=256 * world)
    # a one-device preset keeps its batch whatever the ranks
    assert configs.get_config("casia_single_chip",
                              world=4).global_batch == 256


def test_the_data_parallel_preset_trains_a_step_on_one_rank():
    """At one rank, cut for the CPU as the single-GPU preset is."""
    from tf_face_toolbox_tpu_torch.parallel.mesh import create_topology

    preset = configs.get_config("v5e8_data_parallel", world=1)
    cfg = dataclasses.replace(preset, network="resnet_tiny",
                              embedding_dim=16, num_classes=24,
                              image_size=12, crop_from=16, global_batch=8)
    topo = create_topology(1)
    state, net = create_train_state(cfg, 0, mesh=topo, device="cpu")
    step_fn = make_train_step(net, cfg, state, mesh=topo)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (8, 16, 16, 3), np.uint8)
    state, m = step_fn(state, images, np.arange(8) % 24)
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert float(m["learning_rate"]) < preset.base_lr * 0.01


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_presets_raise_naming_their_item(name):
    """A preset whose path is still to port raises naming its item; one
    whose item has landed builds instead: config 7 (item 11) at 256 rows
    a device times the ranks, every other field as published; preset 8
    (item 9: AdaFace on CosFace's 0.35, 3 sub-centers, random erase,
    cosine LR) at its published batch, whose head state a cut-size step
    moves."""
    if name not in SERVED:
        with pytest.raises(NotImplementedError,
                           match=f"item {REFUSED[name]}"):
            configs.get_config(name)
        return
    if name == "adaface_noisy_data":
        preset = configs.get_config(name, world=4)
        assert preset.dtype == torch.bfloat16
        assert (preset.margin_mode, preset.margin_m3, preset.subcenters,
                preset.random_erase, preset.lr_schedule,
                preset.global_batch) == ("adaface", 0.35, 3, 0.25, "cosine",
                                         256)
        cfg = dataclasses.replace(preset, network="resnet_tiny",
                                  embedding_dim=16, num_classes=24,
                                  image_size=12, crop_from=16, global_batch=8)
        state, net = create_train_state(cfg, 0, device="cpu")
        assert state.classifier.shape == (72, 16)
        images = np.random.default_rng(0).integers(0, 256, (8, 16, 16, 3),
                                                   np.uint8)
        state, m = make_train_step(net, cfg, state)(state, images,
                                                    np.arange(8) % 24)
        assert np.isfinite(float(m["loss"]))
        assert float(m["adaface_norm_mean"]) != 20.0
        return
    published = configs.get_config(name)
    assert published.global_batch == 2048 and published.dtype == torch.bfloat16
    assert (published.num_classes, published.pfc_sample_rate) == (93_431, 0.1)
    for world in (1, 4, 8):
        assert configs.get_config(name, world=world) == dataclasses.replace(
            published, global_batch=256 * world)


def test_unknown_config_raises():
    with pytest.raises(ValueError, match="unknown config"):
        configs.get_config("nope")


def test_presets_import_without_raising_or_jax():
    code = ("import sys\n"
            "from tf_face_toolbox_tpu_torch import configs\n"
            "assert len(configs.list_configs()) == 8\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tf_face_toolbox_tpu')]\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
