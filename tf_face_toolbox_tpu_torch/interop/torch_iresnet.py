"""Import PyTorch iresnet ``state_dict`` checkpoints into the ``.npz``
key space, and export back.

Counterpart of ``tf_face_toolbox_tpu/interop/torch_iresnet.py``. The
InsightFace ecosystem (arcface_torch and its forks) publishes trained
face models as torch ``state_dict`` files over the iresnet
architecture (``models/iresnet.py`` carries its flax module names).
This module maps such a state_dict, given as ``{name: np.ndarray}``,
onto the variables tree whose flat form is the ``.npz`` key space
(``params/layer1_0/conv1/kernel``, ...) that ``interop.port``'s
``load_jax_variables`` loads:

- conv ``weight (O, I, kh, kw)`` → ``kernel (kh, kw, I, O)``;
- BatchNorm ``weight/bias/running_mean/running_var`` →
  ``scale/bias`` (params) + ``mean/var`` (batch_stats);
- ``prelu.weight (C,)`` → per-channel ``alpha``;
- ``fc.weight (D, C·h·w)``: torch flattens NCHW, the key space
  flattens NHWC, so the kernel is un-flattened, permuted CHW→HWC and
  re-flattened (the one layout-sensitive leaf);
- ``module.`` prefixes (DataParallel saves) are stripped, fp16 leaves
  are cast to f32.

Serve imported models with the fixed InsightFace input normalization
(``cli.extract --input_norm fixed``): they were not trained with the
reference's per-image standardization.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "iresnet_state_dict_to_variables",
    "load_torch_state_dict",
    "variables_to_iresnet_state_dict",
]


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a ``.pt``/``.pth`` state_dict file as numpy arrays.

    Accepts either a bare state_dict or a training-checkpoint dict with
    a ``state_dict`` entry.
    """
    import torch

    obj = torch.load(path, map_location="cpu")
    if hasattr(obj, "state_dict"):  # a saved Module
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj \
            and not any(k.endswith(".weight") for k in obj):
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _conv(sd: dict, name: str) -> np.ndarray:
    w = sd.pop(name + ".weight")  # (O, I, kh, kw)
    return _f32(w.transpose(2, 3, 1, 0))


def _bn(sd: dict, name: str) -> tuple[dict, dict]:
    params = {"scale": _f32(sd.pop(name + ".weight")),
              "bias": _f32(sd.pop(name + ".bias"))}
    stats = {"mean": _f32(sd.pop(name + ".running_mean")),
             "var": _f32(sd.pop(name + ".running_var"))}
    sd.pop(name + ".num_batches_tracked", None)
    return params, stats


def iresnet_state_dict_to_variables(
        state_dict: dict[str, np.ndarray], *,
        stage_sizes: tuple[int, ...] = (3, 4, 14, 3),
        strict: bool = True) -> dict:
    """Map an iresnet state_dict onto a ``models.iresnet.IResNet``
    variables tree (nested; ``interop.port.flatten_variables`` gives its
    ``.npz`` keys).

    ``stage_sizes`` must match the checkpoint (iresnet_18 (2,2,2,2),
    iresnet_50 (3,4,14,3), iresnet_100 (3,13,30,3) — cli.import_torch
    derives it from ``--network``). Stage widths, the embedding dim and
    the fc spatial extent are read off the tensors themselves.

    ``strict``: unconsumed state_dict entries raise (catches a
    mismatched ``stage_sizes`` or a non-iresnet checkpoint) — pass
    False to ignore extras like a bundled classifier head.
    """
    sd = {k.removeprefix("module."): np.asarray(v)
          for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}

    params["conv1"] = {"kernel": _conv(sd, "conv1")}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    params["prelu"] = {"alpha": _f32(sd.pop("prelu.weight"))}

    for stage_idx, num_blocks in enumerate(stage_sizes):
        for block_idx in range(num_blocks):
            t = f"layer{stage_idx + 1}.{block_idx}"     # torch name
            f = f"layer{stage_idx + 1}_{block_idx}"     # key-space name
            blk: dict = {}
            blk_stats: dict = {}
            blk["bn1"], blk_stats["bn1"] = _bn(sd, t + ".bn1")
            blk["conv1"] = {"kernel": _conv(sd, t + ".conv1")}
            blk["bn2"], blk_stats["bn2"] = _bn(sd, t + ".bn2")
            blk["prelu"] = {"alpha": _f32(sd.pop(t + ".prelu.weight"))}
            blk["conv2"] = {"kernel": _conv(sd, t + ".conv2")}
            blk["bn3"], blk_stats["bn3"] = _bn(sd, t + ".bn3")
            if t + ".downsample.0.weight" in sd:
                blk["downsample_conv"] = {
                    "kernel": _conv(sd, t + ".downsample.0")}
                blk["downsample_bn"], blk_stats["downsample_bn"] = \
                    _bn(sd, t + ".downsample.1")
            params[f] = blk
            stats[f] = blk_stats

    params["bn2"], stats["bn2"] = _bn(sd, "bn2")

    # fc: the layout-sensitive leaf. torch flattened (C, h, w); the
    # key space flattens (h, w, C).
    w = sd.pop("fc.weight")                      # (D, C*h*w)
    dim, flat = w.shape
    c = params["bn2"]["scale"].shape[0]
    hw = flat // c
    h = int(math.isqrt(hw))
    if c * h * h != flat:
        raise ValueError(f"fc.weight in-dim {flat} is not C*h*h for "
                         f"C={c} channels — not an iresnet head?")
    kernel = w.reshape(dim, c, h, h).transpose(2, 3, 1, 0)
    params["fc"] = {"kernel": _f32(kernel.reshape(h * h * c, dim)),
                    "bias": _f32(sd.pop("fc.bias"))}
    params["features"], stats["features"] = _bn(sd, "features")

    if strict and sd:
        raise ValueError(
            f"{len(sd)} unconsumed state_dict entries (first few: "
            f"{sorted(sd)[:4]}); wrong stage_sizes or not an iresnet "
            "checkpoint — pass strict=False to ignore extras")
    return {"params": params, "batch_stats": stats}


def _conv_out(kernel: np.ndarray) -> np.ndarray:
    # key space (kh, kw, I, O) → torch (O, I, kh, kw)
    return _f32(np.asarray(kernel).transpose(3, 2, 0, 1))


def _bn_out(sd: dict, name: str, params: dict, stats: dict) -> None:
    sd[name + ".weight"] = _f32(np.asarray(params["scale"]))
    sd[name + ".bias"] = _f32(np.asarray(params["bias"]))
    sd[name + ".running_mean"] = _f32(np.asarray(stats["mean"]))
    sd[name + ".running_var"] = _f32(np.asarray(stats["var"]))
    # torch BatchNorm tracks this buffer; torch_model.load_state_dict
    # with strict=True requires it to be present.
    sd[name + ".num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def variables_to_iresnet_state_dict(
        variables: dict, *,
        stage_sizes: tuple[int, ...] = (3, 4, 14, 3)) -> dict:
    """Exact inverse of :func:`iresnet_state_dict_to_variables`.

    Maps a ``models.iresnet.IResNet`` variables tree (params +
    batch_stats, nested, e.g. a checkpoint trained or fine-tuned here)
    back onto the InsightFace/arcface_torch ``state_dict`` key layout,
    so a model trained here can be handed to a torch-serving fleet (or
    compared leaf-by-leaf against its torch ancestor). All the layout notes in
    the importer docstring apply mirrored — in particular ``fc.weight``
    is re-flattened NHWC→NCHW. Returns ``{name: np.ndarray}``; save it
    with ``torch.save({k: torch.from_numpy(v) ...})`` or via
    ``cli.export_torch``.
    """
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: dict = {}

    sd["conv1.weight"] = _conv_out(params["conv1"]["kernel"])
    _bn_out(sd, "bn1", params["bn1"], stats["bn1"])
    sd["prelu.weight"] = _f32(np.asarray(params["prelu"]["alpha"]))

    for stage_idx, num_blocks in enumerate(stage_sizes):
        for block_idx in range(num_blocks):
            t = f"layer{stage_idx + 1}.{block_idx}"
            f = f"layer{stage_idx + 1}_{block_idx}"
            blk, blk_stats = params[f], stats[f]
            _bn_out(sd, t + ".bn1", blk["bn1"], blk_stats["bn1"])
            sd[t + ".conv1.weight"] = _conv_out(blk["conv1"]["kernel"])
            _bn_out(sd, t + ".bn2", blk["bn2"], blk_stats["bn2"])
            sd[t + ".prelu.weight"] = _f32(
                np.asarray(blk["prelu"]["alpha"]))
            sd[t + ".conv2.weight"] = _conv_out(blk["conv2"]["kernel"])
            _bn_out(sd, t + ".bn3", blk["bn3"], blk_stats["bn3"])
            if "downsample_conv" in blk:
                sd[t + ".downsample.0.weight"] = _conv_out(
                    blk["downsample_conv"]["kernel"])
                _bn_out(sd, t + ".downsample.1",
                        blk["downsample_bn"], blk_stats["downsample_bn"])

    _bn_out(sd, "bn2", params["bn2"], stats["bn2"])

    # fc: un-flatten (h, w, C) → permute → re-flatten (C, h, w).
    kernel = np.asarray(params["fc"]["kernel"])    # (h*w*C, D)
    flat, dim = kernel.shape
    c = np.asarray(params["bn2"]["scale"]).shape[0]
    hw = flat // c
    h = int(math.isqrt(hw))
    if c * h * h != flat:
        raise ValueError(f"fc kernel in-dim {flat} is not h*h*C for "
                         f"C={c} channels — not an iresnet head?")
    w = kernel.reshape(h, h, c, dim).transpose(3, 2, 0, 1)
    sd["fc.weight"] = _f32(w.reshape(dim, c * h * h))
    sd["fc.bias"] = _f32(np.asarray(params["fc"]["bias"]))
    _bn_out(sd, "features", params["features"], stats["features"])
    return sd
