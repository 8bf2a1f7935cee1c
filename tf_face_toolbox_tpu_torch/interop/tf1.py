"""TF1 (``tf.train.Saver``) checkpoint importer.

Counterpart of ``tf_face_toolbox_tpu/interop/tf1.py``. The reference is
a TF-1.x toolbox: its training output is a Saver-V2 checkpoint whose
variable names follow the era's slim-style scoping
(``<net>/conv1/weights``,
``<net>/block3/unit_2/bottleneck_v1/conv2/BatchNorm/gamma``, ...). This
module reads such checkpoints directly (``tf.train.load_checkpoint``
parses the tensor bundle; TensorFlow is imported only there) and fills
a variables tree in the ``.npz`` key space, so an upstream user serves
their trained weights through the port:

    python -m tf_face_toolbox_tpu_torch.cli.import_tf1 \
        --checkpoint=/models/face_r50.ckpt-90000 --output=/models/r50.npz
    python -m tf_face_toolbox_tpu_torch.cli.extract --variables_npz=/models/r50.npz ...

Two pieces:

- :func:`slim_name_map`: mechanical key → slim-name translation for the
  ResNet/SE-ResNet/ResNeXt families. Every leaf gets a deterministic
  candidate name; anything the upstream named differently is fixed
  point-wise with a JSON override (``--name_map_json``). The head scope
  (the one genuinely repo-specific name) is a parameter.
- :func:`import_tf1_checkpoint`: total-consumption port with shape
  checks, optional EMA-shadow preference (era extract scripts served
  ``<var>/ExponentialMovingAverage``), and a leftover report so silent
  partial imports are impossible.

The template is a nested variables tree (``interop.port.
unflatten_variables`` of a network's keys; ``cli.import_tf1`` builds it
from ``create_network`` and ``jax_leaves``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from tf_face_toolbox_tpu_torch.interop.port import (
    _get,
    _leaf_paths,
    _set,
    _to_mutable,
)

# leaf-name translation inside / outside a BatchNorm scope
_BN_LEAF = {"scale": "gamma", "bias": "beta",
            "mean": "moving_mean", "var": "moving_variance"}
_DENSE_LEAF = {"kernel": "weights", "bias": "biases"}

# optimizer/bookkeeping slot suffixes ignored by the leftover report
_SLOT_MARKERS = ("/Momentum", "/Adam", "/RMSProp", "/Adagrad",
                 "/ExponentialMovingAverage", "global_step",
                 "beta1_power", "beta2_power", "save_counter")


def _unit_scope(flat_index: int, stage_sizes) -> str:
    """BottleneckBlock_<i> (flat, stage-major) → block<k>/unit_<u>."""
    i = flat_index
    for stage, n in enumerate(stage_sizes, start=1):
        if i < n:
            return f"block{stage}/unit_{i + 1}"
        i -= n
    raise ValueError(
        f"block index {flat_index} out of range for stages {stage_sizes}")


def _translate(parts: tuple[str, ...], stage_sizes,
               head_scope: str) -> str:
    """One key path (collection stripped) → slim-style name."""
    out: list[str] = []
    i = 0
    in_bn = False
    while i < len(parts):
        seg = parts[i]
        is_leaf = i == len(parts) - 1
        if is_leaf:
            if in_bn:
                out.append(_BN_LEAF[seg])
            else:
                out.append(_DENSE_LEAF.get(seg, seg))
        elif seg.startswith("BottleneckBlock_"):
            idx = int(seg.rsplit("_", 1)[1])
            out.append(_unit_scope(idx, stage_sizes))
            out.append("bottleneck_v1")
        elif seg.startswith("ConvBN_"):
            idx = int(seg.rsplit("_", 1)[1])
            if not out:                       # top level: the stem
                out.append(f"conv{idx + 1}")
            elif idx == 3:                    # 4th conv in a block
                out.append("shortcut")
            else:
                out.append(f"conv{idx + 1}")
        elif seg.startswith("BatchNorm_"):
            idx = int(seg.rsplit("_", 1)[1])
            out.append("BatchNorm" if idx == 0 else f"BatchNorm_{idx}")
            in_bn = True
        elif seg == "SqueezeExcite_0":
            out.append("se")
        elif seg.startswith("Dense_"):
            idx = int(seg.rsplit("_", 1)[1])
            if out and out[-1] == "se":
                out.append(f"fc{idx + 1}")
            elif not is_leaf and idx == 0 and out and out[-1] == head_scope:
                pass                          # head dense sits in-scope
            else:
                out.append(f"fc{idx + 1}")
        elif seg == "EmbeddingHead_0":
            out.append(head_scope)
        else:
            out.append(seg)                   # deterministic passthrough
        i += 1
    return "/".join(out)


def slim_name_map(template: dict, *, stage_sizes, scope: str,
                  head_scope: str = "embedding",
                  overrides: dict[str, str] | None = None
                  ) -> dict[str, str]:
    """Flat key (``collection/a/b/leaf``) → TF1 variable name.

    ``scope`` is the network's outermost variable scope (slim
    convention: the net name, e.g. ``resnet_v1_50``); ``head_scope``
    the embedding layer's scope, the one name the era repos each chose
    differently. ``overrides`` patches individual entries for upstream
    quirks without rebuilding the map.
    """
    # structure-only traversal: the leaves' values are not read
    name_map: dict[str, str] = {}
    for coll, tree in template.items():
        for path in _leaf_paths(_to_mutable(tree)):
            key = "/".join((coll,) + path)
            name = _translate(path, stage_sizes, head_scope)
            name_map[key] = f"{scope}/{name}" if scope else name
    if overrides:
        unknown = set(overrides) - set(name_map)
        if unknown:
            raise ValueError(
                f"override keys not in the variables tree: "
                f"{sorted(unknown)[:5]}")
        name_map.update(overrides)
    return name_map


def _coerce(arr: np.ndarray, target_shape) -> np.ndarray:
    """Accept the era's layout variants: slim ``fully_connected``
    sometimes stored as a 1x1 conv (1,1,I,O) where the key space wants
    (I,O)."""
    if tuple(arr.shape) == tuple(target_shape):
        return arr
    if (arr.ndim == 4 and len(target_shape) == 2
            and arr.shape[:2] == (1, 1)
            and arr.shape[2:] == tuple(target_shape)):
        return arr.reshape(target_shape)
    raise ValueError(
        f"shape mismatch: checkpoint {arr.shape} vs flax "
        f"{tuple(target_shape)}")


def import_tf1_checkpoint(ckpt_path: str, template: dict,
                          name_map: dict[str, str], *,
                          use_ema: bool = False,
                          skip_missing: bool = False
                          ) -> tuple[dict, dict[str, Any]]:
    """Fill ``template`` from a Saver checkpoint via ``name_map``.

    Returns ``(variables, report)``; report keys: ``imported`` (count),
    ``missing`` (keys left at template values — only allowed with
    ``skip_missing``), ``unused`` (checkpoint variables no leaf
    consumed, optimizer slots excluded), ``ema_used`` (count of leaves
    read from EMA shadows).
    """
    import tensorflow as tf

    reader = tf.train.load_checkpoint(ckpt_path)
    available = set(reader.get_variable_to_shape_map())

    out = {coll: _to_mutable(tree) for coll, tree in template.items()}
    missing: list[str] = []
    used: set[str] = set()
    ema_used = 0
    for flat_key, tf_name in sorted(name_map.items()):
        coll, *path = flat_key.split("/")
        src = tf_name
        if use_ema and coll == "params":
            shadow = tf_name + "/ExponentialMovingAverage"
            if shadow in available:
                src = shadow
                ema_used += 1
        if src not in available:
            missing.append(f"{flat_key} (wanted {src})")
            continue
        target = _get(out[coll], path)
        value = _coerce(np.asarray(reader.get_tensor(src)),
                        np.shape(target))
        _set(out[coll], path, value.astype(
            np.asarray(target).dtype, copy=False))
        used.add(src)
        used.add(tf_name)
    if missing and not skip_missing:
        raise KeyError(
            f"{len(missing)} variables absent from {ckpt_path} "
            f"(pass skip_missing to keep init values), e.g. "
            f"{missing[:4]}")
    unused = sorted(
        name for name in available - used
        if not any(m in name for m in _SLOT_MARKERS)
        and not name.endswith("/ExponentialMovingAverage"))
    report = {"imported": len(name_map) - len(missing),
              "missing": missing, "unused": unused,
              "ema_used": ema_used}
    return out, report


def network_stage_sizes(network: str):
    """Stage sizes for a registry entry (needed by the name map)."""
    from tf_face_toolbox_tpu_torch.models import _REGISTRY
    return _REGISTRY[network][1].get("stage_sizes", ())
