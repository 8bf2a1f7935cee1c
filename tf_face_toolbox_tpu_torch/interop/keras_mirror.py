"""Keras mirror of the ResNet family, layer-named for porting.

Counterpart of ``tf_face_toolbox_tpu/interop/keras_mirror.py`` (TF
only; copied as it is). Every Keras layer that owns weights is named
with the EXACT module path of its counterpart in the ``.npz`` key space
(dots instead of slashes), so ``interop.port``'s ``keras_to_jax`` and
``jax_to_keras`` map weights mechanically:

    key    params/BottleneckBlock_3/ConvBN_1/kernel
    keras  model.get_layer("BottleneckBlock_3.ConvBN_1")          # Conv2D
    key    params/BottleneckBlock_3/ConvBN_1/BatchNorm_0/scale
    keras  model.get_layer("BottleneckBlock_3.ConvBN_1.BatchNorm_0")

Semantics that line up with ``models/resnet.py`` and
``models/layers.py``:

- NHWC, HWIO kernels in the key space: no transposition on this side.
- "SAME" padding: Keras ``padding="same"`` is TF's asymmetric padding,
  as the port's convs pad.
- Conv is bias-free (BN shift subsumes it) on both sides.
- BatchNorm: momentum 0.9, epsilon 1e-5 on both sides; inference uses
  moving statistics.
- SE gate: GAP(keepdims) -> Dense(max(C/r, 8)) -> relu -> Dense(C)
  -> sigmoid -> channel scale.
- Heads: "gap" = GAP -> Dense(dim) -> BN; "flatten" = BN -> flatten ->
  Dense(dim) -> BN (dropout is inference-inert and omitted).
"""

from __future__ import annotations

from typing import Sequence


def _conv_bn(x, features, kernel_size, strides, *, groups=1, relu=True,
             name):
    from tensorflow import keras

    x = keras.layers.Conv2D(
        features, kernel_size, strides=strides, padding="same",
        use_bias=False, groups=groups, name=name)(x)
    x = keras.layers.BatchNormalization(
        momentum=0.9, epsilon=1e-5, name=f"{name}.BatchNorm_0")(x)
    if relu:
        x = keras.layers.ReLU()(x)
    return x


def _squeeze_excite(x, reduction, *, name):
    from tensorflow import keras

    c = x.shape[-1]
    s = keras.layers.GlobalAveragePooling2D(keepdims=True)(x)
    s = keras.layers.Dense(max(c // reduction, 8), activation="relu",
                           name=f"{name}.Dense_0")(s)
    s = keras.layers.Dense(c, activation="sigmoid",
                           name=f"{name}.Dense_1")(s)
    return keras.layers.Multiply()([x, s])


def _bottleneck(x, features, strides, *, groups, se_reduction, expansion,
                name):
    from tensorflow import keras

    out_features = features * expansion
    residual = x
    y = _conv_bn(x, features, 1, 1, name=f"{name}.ConvBN_0")
    y = _conv_bn(y, features, 3, strides, groups=groups,
                 name=f"{name}.ConvBN_1")
    y = _conv_bn(y, out_features, 1, 1, relu=False,
                 name=f"{name}.ConvBN_2")
    if se_reduction > 0:
        y = _squeeze_excite(y, se_reduction, name=f"{name}.SqueezeExcite_0")
    if residual.shape[-1] != out_features or strides != 1:
        residual = _conv_bn(residual, out_features, 1, strides, relu=False,
                            name=f"{name}.ConvBN_3")
    y = keras.layers.Add()([residual, y])
    return keras.layers.ReLU()(y)


def build_keras_resnet(
        *,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        width_per_group: int = 64,
        groups: int = 1,
        se_reduction: int = 0,
        expansion: int = 4,
        embedding_dim: int = 512,
        stem: str = "face",
        head_variant: str = "gap",
        image_size: int = 112):
    """Build the TF/Keras twin of models.resnet.ResNet (inference graph).

    Accepts the same architecture knobs as the module; returns a
    ``keras.Model`` mapping standardized (N, S, S, 3) f32 pixels to
    (N, embedding_dim) f32 embeddings.
    """
    import tensorflow as tf
    from tensorflow import keras

    inp = keras.Input((image_size, image_size, 3), dtype="float32")
    if stem == "face":
        x = _conv_bn(inp, 64, 3, 1, name="ConvBN_0")
    elif stem == "imagenet":
        x = _conv_bn(inp, 64, 7, 2, name="ConvBN_0")
        x = keras.layers.MaxPool2D(3, 2, padding="same")(x)
    elif stem == "space2depth":
        x = keras.layers.Lambda(
            lambda t: tf.nn.space_to_depth(t, 2))(inp)
        x = _conv_bn(x, 64, 3, 1, name="ConvBN_0")
    else:
        raise ValueError(f"unknown stem: {stem}")

    block_counter = 0
    for stage_idx, num_blocks in enumerate(stage_sizes):
        features = width_per_group * groups * (2 ** stage_idx)
        for block_idx in range(num_blocks):
            first = block_idx == 0
            strides = 2 if first and (stage_idx > 0 or stem == "face") else 1
            x = _bottleneck(
                x, features, strides, groups=groups,
                se_reduction=se_reduction, expansion=expansion,
                name=f"BottleneckBlock_{block_counter}")
            block_counter += 1

    head = "EmbeddingHead_0"
    if head_variant == "gap":
        x = keras.layers.GlobalAveragePooling2D()(x)
        x = keras.layers.Dense(embedding_dim, name=f"{head}.Dense_0")(x)
        x = keras.layers.BatchNormalization(
            momentum=0.9, epsilon=1e-5, name=f"{head}.BatchNorm_0")(x)
    elif head_variant == "flatten":
        x = keras.layers.BatchNormalization(
            momentum=0.9, epsilon=1e-5, name=f"{head}.BatchNorm_0")(x)
        x = keras.layers.Flatten()(x)
        x = keras.layers.Dense(embedding_dim, name=f"{head}.Dense_0")(x)
        x = keras.layers.BatchNormalization(
            momentum=0.9, epsilon=1e-5, name=f"{head}.BatchNorm_1")(x)
    else:
        raise ValueError(f"unknown head variant: {head_variant}")
    return keras.Model(inp, x)


# space2depth (models/resnet.py) is a reshape/transpose re-layout of 2x2
# pixel blocks; tf.nn.space_to_depth uses the identical block-row-major
# channel order (tests/test_torch_tf1_import.py holds the two).
