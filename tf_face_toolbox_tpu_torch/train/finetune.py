"""Warm-start (fine-tune) initialization for training runs.

Counterpart of ``tf_face_toolbox_tpu/train/finetune.py``:
:func:`warm_start_state` grafts backbone params and BN statistics from
a source into a fresh :class:`TrainState`, leaf by leaf, keeping

- the classifier fresh (new identity set),
- the optimizer state fresh (momentum from the old task is noise),
- step = 0 (the LR schedule restarts).

Sources: a port train directory (restored raw, so an architecture
change is a graft-time skip, not a restore error), or a flat ``.npz``
of the JAX key space (``interop.port.save_variables_npz``), the same
hand-off the JAX package writes: one graft takes a JAX-trained model and
a port-trained one. Grafting runs in that key space and layout, so the
restored and skipped leaves carry the JAX package's names; a leaf whose
key or shape does not match is skipped and reported.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.interop.port import (
    flatten_variables,
    from_jax_layout,
    jax_key,
    named_to_flat,
    unflatten_variables,
)
from tf_face_toolbox_tpu_torch.train.state import TrainState


def _host_array(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def graft_tree(dst: Any, src: Any, *, path: tuple = (),
               restored: list | None = None,
               skipped: list | None = None):
    """Copy ``src`` leaves into the structure of ``dst`` wherever the path
    exists in both AND the leaf shapes match; keep the ``dst`` leaf
    otherwise. Leaves are numpy arrays or tensors; a grafted leaf takes
    the ``dst`` leaf's dtype (and device). Keys are walked in sorted
    order, as JAX walks its pytrees' dicts, so the paths come in the
    JAX package's order. Returns (new_tree, restored_paths,
    skipped_paths)."""
    restored = [] if restored is None else restored
    skipped = [] if skipped is None else skipped
    if isinstance(dst, Mapping):
        src_map = src if isinstance(src, Mapping) else {}
        out = {}
        for k, v in sorted(dst.items()):
            out[k], _, _ = graft_tree(
                v, src_map.get(k), path=path + (k,),
                restored=restored, skipped=skipped)
        return out, restored, skipped
    name = "/".join(str(p) for p in path)
    if src is None:
        skipped.append(name)
        return dst, restored, skipped
    src_arr = _host_array(src)
    if src_arr.shape != tuple(getattr(dst, "shape", ())):
        skipped.append(f"{name} (shape {src_arr.shape} != "
                       f"{tuple(getattr(dst, 'shape', ()))})")
        return dst, restored, skipped
    restored.append(name)
    if torch.is_tensor(dst):
        return (torch.from_numpy(np.array(src_arr)).to(dst.device, dst.dtype),
                restored, skipped)
    return src_arr.astype(dst.dtype), restored, skipped


def load_pretrained_variables(source: str, *,
                              use_ema: bool = False) -> dict:
    """``source`` -> ``{"params": ..., "batch_stats": ...}``: nested
    trees of numpy arrays in the JAX key space and layouts.

    ``source``: a port train directory (the latest step, restored raw;
    ``use_ema`` takes its EMA weight set) or a ``.npz`` of flat JAX
    keys.
    """
    if source.endswith(".npz"):
        from tf_face_toolbox_tpu_torch.interop.port import load_variables_npz

        if use_ema:
            raise ValueError(
                ".npz sources hold one weight set; --finetune_use_ema "
                "only applies to train-dir sources")
        return load_variables_npz(source)
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager

    raw = CheckpointManager(source).restore_raw()
    params = raw["params"]
    if use_ema:
        params = raw.get("ema_params")
        if not params:
            raise ValueError(
                "--finetune_use_ema: the source checkpoint has no EMA")
    tree = unflatten_variables(named_to_flat({**params,
                                              **raw["batch_stats"]}))
    return {"params": tree.get("params", {}),
            "batch_stats": tree.get("batch_stats", {})}


def warm_start_state(state: TrainState, variables: dict,
                     *, log=None) -> TrainState:
    """Graft pretrained ``variables`` (JAX key space, as
    :func:`load_pretrained_variables` returns them) into a fresh
    ``state``, in place, and return it.

    EMA (when the new run trains with it) restarts FROM the grafted
    weights: the fine-tune run's moving average should track the
    fine-tuned model, not average in the random init it replaced.
    """
    named = {**state.params, **state.batch_stats}
    keys = {name: jax_key(name, t) for name, t in named.items()}
    dst = unflatten_variables(named_to_flat(named))
    params, restored, skipped = graft_tree(
        dst.get("params", {}), variables.get("params", {}))
    batch_stats, _, _ = graft_tree(
        dst.get("batch_stats", {}), variables.get("batch_stats", {}),
        restored=restored, skipped=skipped)
    if not restored:
        raise ValueError(
            "warm start restored nothing: the source does not look "
            f"like this network's tree (skipped: {skipped[:5]}...)")
    if log is not None:
        log("warm start: %d leaves restored, %d kept fresh%s",
            len(restored), len(skipped),
            (" (" + ", ".join(skipped[:8]) + ")") if skipped else "")
    flat = flatten_variables({"params": params, "batch_stats": batch_stats})
    with torch.no_grad():
        for name, t in named.items():
            key, kind = keys[name]
            t.copy_(from_jax_layout(flat[key], kind))
        if state.ema_params is not None:
            for name, e in state.ema_params.items():
                e.copy_(state.params[name])
    return state
