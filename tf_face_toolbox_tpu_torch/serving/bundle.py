"""Deployment bundles: one-file serving artifacts.

Counterpart of ``tf_face_toolbox_tpu/serving/bundle.py``, in the same
format: ``cli.export`` collapses a train checkpoint and its flags into
ONE ``.npz`` that ``cli.serve --bundle`` and ``cli.extract --bundle``
boot from alone, with no flag bookkeeping between training and
deployment (a daemon booted with the wrong ``--stem`` or
``--input_norm`` serves embeddings that look valid and are not).

Format: flat ``collection/path/leaf -> array`` keys in the JAX key
space and layouts (``interop.port.flatten_variables``, the ``.npz``
hand-off) plus one ``__bundle_meta__`` key holding the JSON config
(network, embedding dim, stem/head, input geometry, input norm, quant
mode, training step). So a bundle written by either package boots in
the other, an int8 one too: a "static" bundle carries its frozen
``quant_stats``, so serving hosts need no calibration shard.
``format_version`` gates forward compatibility: readers refuse versions
they do not know.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.interop.port import (
    flatten_variables,
    unflatten_variables,
)

META_KEY = "__bundle_meta__"
FORMAT_VERSION = 1

# Meta fields every bundle must carry (writers fill them; readers check).
REQUIRED_META = ("format_version", "network", "embedding_dim",
                 "image_size", "input_norm", "quant_mode")


def write_bundle(path: str, variables: dict, meta: dict[str, Any]) -> None:
    """Write variables (a nested tree or the flat JAX-key dict) and the
    config as one .npz deployment artifact.

    ``meta`` must contain REQUIRED_META minus format_version (added
    here). A quant_mode of "static" requires the calibrated
    ``quant_stats`` collection to be present: refused otherwise, so a
    bundle can never promise int8 it cannot serve.
    """
    meta = dict(meta, format_version=FORMAT_VERSION)
    missing = [k for k in REQUIRED_META if k not in meta]
    if missing:
        raise ValueError(f"bundle meta is missing {missing}")
    if any(isinstance(v, dict) for v in variables.values()):
        flat = flatten_variables(variables)
    else:
        flat = {k: np.asarray(v) for k, v in variables.items()}
    if meta["quant_mode"] == "static" and not any(
            k.startswith("quant_stats/") for k in flat):
        raise ValueError(
            "quant_mode='static' bundle needs calibrated quant_stats "
            "(run the calibration pass before exporting)")
    if META_KEY in flat:
        raise ValueError(f"variables tree collides with {META_KEY}")
    flat[META_KEY] = np.array(json.dumps(meta))
    np.savez(path, **flat)


def read_bundle(path: str) -> tuple[dict, dict[str, Any]]:
    """Load a bundle -> (nested variables tree, meta dict). Refuses
    artifacts without a meta record (a plain variables .npz is not a
    bundle) and format versions this reader does not know."""
    with np.load(path) as data:
        files = set(data.files)
        if META_KEY not in files:
            raise ValueError(
                f"{path} has no {META_KEY} record — not a deployment "
                "bundle (for raw variable trees use --variables_npz)")
        meta = json.loads(str(data[META_KEY]))
        flat = {k: data[k] for k in files if k != META_KEY}
    version = meta.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(f"bundle format_version {version} is not "
                         f"supported (reader knows {FORMAT_VERSION})")
    missing = [k for k in REQUIRED_META if k not in meta]
    if missing:
        raise ValueError(f"bundle meta is missing {missing}")
    return unflatten_variables(flat), meta


def network_from_meta(meta: dict[str, Any], *, dtype: torch.dtype):
    """The exact backbone a bundle was exported for (eval mode, on the
    host, weights not loaded).

    stem/head_variant are the resolved module attributes recorded at
    export. ``dtype`` is the serving-side compute choice (the bundle's
    params are f32). An int8 bundle (``quant_mode`` "dynamic" or "static",
    the latter with its calibrated ``quant_stats``) builds the net in that
    mode.
    """
    from tf_face_toolbox_tpu_torch.models import create_network

    kwargs = {}
    for key in ("stem", "head_variant"):
        if meta.get(key) is not None:
            kwargs[key] = meta[key]
    quant = meta.get("quant_mode", "none")
    if quant and quant != "none":
        kwargs["quantized"] = quant
    return create_network(meta["network"],
                          embedding_dim=int(meta["embedding_dim"]),
                          dtype=dtype, input_size=int(meta["image_size"]),
                          **kwargs)
