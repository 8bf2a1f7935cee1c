"""Named presets: the five BASELINE.json milestone configs and three more.

Counterpart of ``tf_face_toolbox_tpu/configs.py``, with its names and
values. The eval-only presets are dicts, as there. A train preset is
kept as the keyword arguments of the port's ``TrainConfig`` (bf16
compute) and built when asked for: a refusal of ``TrainConfig``'s
(naming a ROADMAP.md item) would come then, never at import. All four
train presets build.

The presets published for 8 devices (config 5, data-parallel; config 7,
the class-sharded Partial-FC head on a 2 x 4 mesh) are served at the
ranks of the run: ``get_config(name, world=W)`` keeps their batch a
device (256) and makes the global batch 256 * W; without ``world`` it is
the published 2048 over 8. The run's model axis (``--mesh_model``) is
the run's choice, as in the JAX CLI.
"""

from __future__ import annotations

from typing import Any

import torch

# BASELINE.json configs[0]: "ResNet-50 single-image embedding + LFW pair
# verification, batch 32, CPU": an extraction/eval recipe, not training.
CONFIG_1_EXTRACT_VERIFY_CPU: dict[str, Any] = dict(
    network="resnet_v1_50",
    embedding_dim=512,
    image_size=112,
    batch=32,
    platform="cpu",
    flip_average=True,
    verification="lfw_10fold",
)

# configs[1]: "SE-ResNet-50 backbone with flip-averaged 512-d embeddings"
CONFIG_2_SE_RESNET_EXTRACT: dict[str, Any] = dict(
    network="se_resnet_50",
    embedding_dim=512,
    image_size=112,
    batch=256,
    flip_average=True,
)

# configs[2]: "DenseNet / ResNeXt backbone variants under the same
# extraction API"
CONFIG_3_VARIANT_BACKBONES: dict[str, Any] = dict(
    networks=("densenet_121", "resnext_50"),
    embedding_dim=512,
    image_size=112,
    batch=256,
    flip_average=True,
)

# configs[3]: "Margin-softmax (CosFace/ArcFace-style) training on
# CASIA-WebFace, single chip"
CONFIG_4_CASIA_SINGLE_CHIP: dict[str, Any] = dict(
    network="resnet_v1_50",
    embedding_dim=512,
    num_classes=10_572,            # CASIA-WebFace identities
    image_size=112,
    crop_from=120,
    global_batch=256,
    base_lr=0.1,
    lr_boundaries=(100_000, 160_000, 220_000),
    warmup_steps=2_000,
    weight_decay=5e-4,
    margin_scale=64.0,
    margin_m3=0.35,                # CosFace
    augment=True,
)

# configs[4]: "Data-parallel large-batch training on a v5e-8 mesh with
# psum gradient exchange": 8 devices on the data axis
CONFIG_5_V5E8_DATA_PARALLEL: dict[str, Any] = dict(
    network="resnet_v1_50",
    embedding_dim=512,
    num_classes=10_572,
    image_size=112,
    crop_from=120,
    global_batch=2048,             # 256 a device over 8
    base_lr=0.4,                   # linear-scaled with batch
    lr_boundaries=(60_000, 100_000, 140_000),
    warmup_steps=5_000,
    weight_decay=5e-4,
    margin_scale=64.0,
    margin_m3=0.35,
    augment=True,
)

# The bf16 accuracy-class serving preset: JPEG-domain backbone,
# zero-decode input (the DCT family: item 17b).
CONFIG_6_ACCURACY_SERVING_BF16: dict[str, Any] = dict(
    network="dct_resnet_50",
    embedding_dim=512,
    image_size=112,
    batch=256,
    flip_average=True,
    loader="dct_domain",        # cli.pack --recode_size=112 shards
    bf16=True,
)

# Large-identity-count training: class-sharded head over the model axis
# with sampled Partial-FC (An et al. 2021), MS1MV3-sized.
CONFIG_7_LARGE_ID_PFC_V5E8: dict[str, Any] = dict(
    network="resnet_v1_50",
    embedding_dim=512,
    num_classes=93_431,            # MS1MV3 identity count
    image_size=112,
    crop_from=120,
    global_batch=2048,
    base_lr=0.4,
    lr_boundaries=(60_000, 100_000, 140_000),
    warmup_steps=5_000,
    weight_decay=5e-4,
    margin_scale=64.0,
    margin_m3=0.35,
    augment=True,
    pfc_sample_rate=0.1,
)

# Modern-recipe training: AdaFace margins, sub-centers for label noise,
# random erasing, cosine LR, at CONFIG_4's scale.
CONFIG_8_ADAFACE_NOISY_DATA: dict[str, Any] = dict(
    network="resnet_v1_50",
    embedding_dim=512,
    num_classes=10_572,
    image_size=112,
    crop_from=120,
    global_batch=256,
    base_lr=0.1,
    lr_schedule="cosine",
    lr_total_steps=220_000,
    warmup_steps=2_000,
    weight_decay=5e-4,
    margin_scale=64.0,
    margin_mode="adaface",
    subcenters=3,
    random_erase=0.25,
    augment=True,
)

TRAIN_PRESETS = {
    "casia_single_chip": CONFIG_4_CASIA_SINGLE_CHIP,
    "v5e8_data_parallel": CONFIG_5_V5E8_DATA_PARALLEL,
    "large_id_pfc_v5e8": CONFIG_7_LARGE_ID_PFC_V5E8,
    "adaface_noisy_data": CONFIG_8_ADAFACE_NOISY_DATA,
}
# train presets published for several devices: name -> their count
_DEVICES = {"v5e8_data_parallel": 8, "large_id_pfc_v5e8": 8}

_REGISTRY = {
    "extract_verify_cpu": CONFIG_1_EXTRACT_VERIFY_CPU,
    "se_resnet_extract": CONFIG_2_SE_RESNET_EXTRACT,
    "variant_backbones": CONFIG_3_VARIANT_BACKBONES,
    "accuracy_serving_bf16": CONFIG_6_ACCURACY_SERVING_BF16,
    **TRAIN_PRESETS,
}


def get_config(name: str, *, world: int | None = None):
    """A train preset as a ``TrainConfig`` (bf16), an eval preset as its
    dict. ``world``: the ranks of the run; a preset published for several
    devices gets its batch a device times ``world`` as its global batch
    (other train presets keep theirs)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown config '{name}'; have {sorted(_REGISTRY)}")
    if name not in TRAIN_PRESETS:
        return _REGISTRY[name]
    from tf_face_toolbox_tpu_torch.train.trainer import TrainConfig

    kwargs = dict(TRAIN_PRESETS[name])
    if name in _DEVICES and world is not None:
        kwargs["global_batch"] = (kwargs["global_batch"] // _DEVICES[name]
                                  * world)
    return TrainConfig(**kwargs, dtype=torch.bfloat16)


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
