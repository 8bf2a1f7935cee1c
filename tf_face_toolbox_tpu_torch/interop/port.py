"""Weights across the two packages: the JAX ``.npz`` key space <-> torch.

The JAX package hands weights over as a flat ``.npz`` of
``"collection/Module_i/.../leaf"`` keys (``flatten_variables``,
``tf_face_toolbox_tpu/interop/port.py:149-180``). The port's modules
carry the flax auto-names, so every key maps to one torch tensor:

    params/P/kernel (ConvBN)        HWIO  -> P.weight  OIHW
    params/P/kernel (Dense)         (in, out) -> P.weight (out, in)
    params/P/bias   (Dense)         -> P.bias
    params/P/scale, params/P/bias   (BatchNorm) -> P.weight, P.bias
    batch_stats/P/mean, .../var     -> P.running_mean, P.running_var

Loading is total both ways: every key is consumed and every parameter
and buffer is set, or it raises.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn

from tf_face_toolbox_tpu_torch.models.layers import BatchNorm, ConvBN


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


def jax_leaves(net: nn.Module) -> Iterator[tuple[str, torch.Tensor, str]]:
    """(JAX key, torch tensor, kind) for every tensor of ``net``; kind
    is "conv" (HWIO<->OIHW), "dense" ((in,out)<->(out,in)) or "plain"."""
    for name, mod in net.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, ConvBN):
            yield f"params/{path}/kernel", mod.weight, "conv"
        elif isinstance(mod, nn.Linear):
            yield f"params/{path}/kernel", mod.weight, "dense"
            yield f"params/{path}/bias", mod.bias, "plain"
        elif isinstance(mod, BatchNorm):
            yield f"params/{path}/scale", mod.weight, "plain"
            yield f"params/{path}/bias", mod.bias, "plain"
            yield f"batch_stats/{path}/mean", mod.running_mean, "plain"
            yield f"batch_stats/{path}/var", mod.running_var, "plain"


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


def load_jax_variables(net: nn.Module, flat: dict) -> nn.Module:
    """Copy a flat JAX-key dict (or a nested variables tree) into
    ``net`` in place; raises on any missing, extra or misshapen key and
    on any parameter or buffer left unset. Returns ``net``."""
    if any(isinstance(v, dict) for v in flat.values()):
        flat = flatten_variables(flat)
    leaves = list(jax_leaves(net))
    expected = {key for key, _, _ in leaves}
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
            tensor.copy_(torch.tensor(_to_torch_layout(arr, kind)))
            written.add(id(tensor))
    unset = [name for name, t in (*net.named_parameters(),
                                  *net.named_buffers())
             if id(t) not in written]
    if unset:
        raise ValueError(f"{len(unset)} network tensors have no JAX key, "
                         f"e.g. {unset[:3]}")
    return net
