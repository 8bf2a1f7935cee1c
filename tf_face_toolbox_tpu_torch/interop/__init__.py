"""Weights across frameworks: the JAX ``.npz`` key space <-> torch
(``port``), InsightFace iResNet ``state_dict`` files
(``torch_iresnet``), TF1 Saver checkpoints (``tf1``) and the Keras
mirror of the ResNet family (``keras_mirror``).

Imports are lazy: TensorFlow is heavyweight and only needed by the
TF1/Keras importers, never by the training/serving paths.
"""

from __future__ import annotations

__all__ = [
    "build_keras_resnet",
    "jax_to_keras",
    "keras_to_jax",
]


def __getattr__(name):
    if name == "build_keras_resnet":
        from tf_face_toolbox_tpu_torch.interop.keras_mirror import (
            build_keras_resnet)
        return build_keras_resnet
    if name in ("jax_to_keras", "keras_to_jax"):
        from tf_face_toolbox_tpu_torch.interop import port
        return getattr(port, name)
    raise AttributeError(name)
