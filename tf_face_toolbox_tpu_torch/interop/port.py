"""Weights across the two packages: the JAX ``.npz`` key space <-> torch.

The JAX package hands weights over as a flat ``.npz`` of
``"collection/Module_i/.../leaf"`` keys (``flatten_variables``,
``tf_face_toolbox_tpu/interop/port.py:149-180``). The port's modules
carry the flax auto-names, so every key maps to one torch tensor:

    params/P/kernel (a conv)        HWIO  -> P.weight  OIHW
    params/P/kernel (Dense)         (in, out) -> P.weight (out, in)
    params/P/bias   (Dense)         -> P.bias
    params/P/scale, params/P/bias   (BatchNorm) -> P.weight, P.bias
    batch_stats/P/mean, .../var     -> P.running_mean, P.running_var
    quant_stats/P/act_max           -> P.act_max (an int8 conv's scale)
    quant_stats/block_<i>_in_max    -> block_<i>_in_max (the int8 carry's)

A conv is a ConvBN's kernel, a grouped one ((kh, kw, cin / groups,
cout) <-> (cout, cin / groups, kh, kw)) included, a depthwise one
((3, 3, 1, C) <-> (C, 1, 3, 3)) among them, or the kernel of a
bias-free plain conv that sits on its module itself (DenseNet's
``Conv_0`` and ``_BNReLUConv_i``, iResNet's and MobileFaceNet's convs).
PReLU's ``alpha``, the GDConv head's (h, w, c) ``gdconv`` and the
ViT's (1, T, W) ``pos_embedding`` (a parameter of the network itself,
``params/pos_embedding``) keep their names and layouts; a LayerNorm's
``scale`` and ``bias`` map as a BatchNorm's do. The ``quant_stats``
collection (static-int8 calibration) maps onto the calibrated modes'
0-d buffers. Loading is total both ways: every key is consumed and
every parameter and buffer is set, or it raises.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn


def _to_mutable(tree):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _to_mutable(v) for k, v in tree.items()}
    return tree


def _leaf_paths(tree: dict, prefix=()) -> list[tuple[str, ...]]:
    out = []
    for key, value in tree.items():
        if isinstance(value, dict):
            out.extend(_leaf_paths(value, prefix + (key,)))
        else:
            out.append(prefix + (key,))
    return out


def _get(tree: dict, path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def flatten_variables(variables: dict) -> dict[str, np.ndarray]:
    """Nested variables tree -> {"collection/a/b/leaf": array} flat dict
    (the .npz key space)."""
    flat = {}
    for collection, tree in variables.items():
        for path in _leaf_paths(_to_mutable(tree)):
            flat["/".join((collection,) + path)] = np.asarray(
                _get(tree, list(path)))
    return flat


def unflatten_variables(flat: dict) -> dict:
    out: dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return out


def save_variables_npz(path: str, variables: dict) -> None:
    """Write a variables tree (nested or flat) as one portable .npz."""
    flat = variables if all(isinstance(v, np.ndarray) or torch.is_tensor(v)
                            for v in variables.values()) \
        else flatten_variables(variables)
    np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})


def load_variables_npz(path: str) -> dict:
    with np.load(path) as data:
        return unflatten_variables({k: data[k] for k in data.files})


# state_dict leaf name -> (collection, JAX leaf) for the rank-free ones
# (PReLU's alpha, MobileFaceNet's (h, w, c) GDConv weight and the ViT's
# positional table keep their flax names and layouts)
_JAX_LEAF = {"bias": ("params", "bias"),
             "alpha": ("params", "alpha"),
             "gdconv": ("params", "gdconv"),
             "pos_embedding": ("params", "pos_embedding"),
             "running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var"),
             "act_max": ("quant_stats", "act_max")}


def _is_carry_stat(leaf: str) -> bool:
    """The int8 carry's ``block_<i>_in_max``, a buffer of the ResNet."""
    return (leaf.startswith("block_") and leaf.endswith("_in_max")
            and leaf[6:-7].isdigit())


def jax_key(name: str, tensor: torch.Tensor) -> tuple[str, str]:
    """(JAX key, kind) of a port network's ``state_dict`` entry, from its
    name and rank alone: a 4-d ``weight`` is a conv kernel, a 2-d one a
    Dense kernel, a 1-d one a BN scale. The one name -> key mapping:
    ``jax_leaves`` names a network's tensors through it, and a saved
    state (no network at hand) is named through it too."""
    path, _, leaf = name.rpartition(".")
    # a leaf of the network itself (the ViT's pos_embedding) has no path
    path = path.replace(".", "/") + "/" if path else ""
    if leaf == "weight":
        kind = {4: "conv", 2: "dense"}.get(tensor.dim(), "plain")
        jleaf = "scale" if kind == "plain" else "kernel"
        return f"params/{path}{jleaf}", kind
    if _is_carry_stat(leaf):
        return f"quant_stats/{path}{leaf}", "plain"
    collection, jleaf = _JAX_LEAF[leaf]
    return f"{collection}/{path}{jleaf}", "plain"


def jax_leaves(net: nn.Module) -> Iterator[tuple[str, torch.Tensor, str]]:
    """(JAX key, torch tensor, kind) for every parameter and buffer of
    ``net``, each named where its module holds it, in module order; kind
    is "conv" (HWIO<->OIHW), "dense" ((in,out)<->(out,in)) or "plain"."""
    for name, mod in net.named_modules():
        prefix = f"{name}." if name else ""
        for leaf, t in (*mod.named_parameters(recurse=False),
                        *mod.named_buffers(recurse=False)):
            key, kind = jax_key(prefix + leaf, t)
            yield key, t, kind


def jax_shape(tensor: torch.Tensor, kind: str) -> tuple[int, ...]:
    """Shape of ``tensor`` in the JAX layout."""
    s = tuple(tensor.shape)
    if kind == "conv":
        return (s[2], s[3], s[1], s[0])
    if kind == "dense":
        return (s[1], s[0])
    return s


def _to_torch_layout(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":
        return np.transpose(arr, (3, 2, 0, 1))
    if kind == "dense":
        return arr.T
    return arr


def to_jax_layout(tensor: torch.Tensor, kind: str) -> np.ndarray:
    """A host f32 copy of ``tensor`` in the JAX layout."""
    arr = tensor.detach().to("cpu", torch.float32).numpy()
    if kind == "conv":
        arr = np.transpose(arr, (2, 3, 1, 0))
    elif kind == "dense":
        arr = arr.T
    # (np.ascontiguousarray makes a 0-d array 1-d)
    return np.ascontiguousarray(arr) if arr.ndim else arr.copy()


def from_jax_layout(arr, kind: str) -> torch.Tensor:
    """A JAX-layout array as a torch-layout f32 tensor (a copy)."""
    return torch.tensor(_to_torch_layout(np.asarray(arr, np.float32), kind))


def named_to_flat(named: dict) -> dict[str, np.ndarray]:
    """``{state_dict name: tensor}`` -> the flat JAX-key dict in JAX
    layouts (the ``.npz`` key space)."""
    out = {}
    for name, t in named.items():
        key, kind = jax_key(name, t)
        out[key] = to_jax_layout(t, kind)
    return out


def load_jax_variables(net: nn.Module, flat: dict) -> nn.Module:
    """Copy a flat JAX-key dict (or a nested variables tree) into
    ``net`` in place; raises on any missing, extra or misshapen key and
    on any parameter or buffer left unset. Returns ``net``."""
    if any(isinstance(v, dict) for v in flat.values()):
        flat = flatten_variables(flat)
    leaves = list(jax_leaves(net))
    expected = {key for key, _, _ in leaves}
    if any(k.startswith("quant_stats/") for k in expected) and not any(
            k.startswith("quant_stats/") for k in flat):
        from tf_face_toolbox_tpu_torch.models.layers import STATIC_NEEDS_STATS
        raise ValueError(STATIC_NEEDS_STATS)
    missing = sorted(expected - flat.keys())
    extra = sorted(flat.keys() - expected)
    if missing or extra:
        raise ValueError(f"variables do not match the network: "
                         f"{len(missing)} missing (e.g. {missing[:3]}), "
                         f"{len(extra)} unused (e.g. {extra[:3]})")
    written = set()
    with torch.no_grad():
        for key, tensor, kind in leaves:
            arr = np.asarray(flat[key], np.float32)
            if arr.shape != jax_shape(tensor, kind):
                raise ValueError(f"{key}: variables have {arr.shape}, the "
                                 f"network wants {jax_shape(tensor, kind)}")
            tensor.copy_(from_jax_layout(arr, kind))
            written.add(id(tensor))
    unset = [name for name, t in (*net.named_parameters(),
                                  *net.named_buffers())
             if id(t) not in written]
    if unset:
        raise ValueError(f"{len(unset)} network tensors have no JAX key, "
                         f"e.g. {unset[:3]}")
    for module in net.modules():
        if getattr(module, "stat_names", ()):
            module.stats_loaded = True
    return net
