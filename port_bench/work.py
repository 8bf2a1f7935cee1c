"""Operations and bytes, counted from a configuration's shapes.

2 operations per multiply-add. A forward pass counts its convs and
Denses (``arch.layers_of``); BatchNorm, activations, pooling and the
residual adds are not counted, as a model-FLOPs count leaves them out.
Kernel 3's bytes are what a search has to read once: the store, its
tombstone bias and the probes, and the results it writes.
"""

from __future__ import annotations

import functools
import json
import os

from port_bench import arch

_HERE = os.path.dirname(os.path.abspath(__file__))


def forward_flops(cfg: dict) -> float:
    """Operations of one image's forward pass."""
    layers, _ = arch.layers_of(cfg)
    return 2.0 * sum(layer.macs for layer in layers)


def face_flops(cfg: dict) -> float:
    """Operations of one face's flip-averaged embedding: two images."""
    return 2.0 * forward_flops(cfg)


STORE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def topk_bytes(rows: int, dim: int, store: str, batch: int, k: int) -> int:
    """Bytes one kernel 3 (or 4) search must move: the store's rows, the
    f32 tombstone bias (4 bytes a row), an int8 store's f32 row scales,
    the f32 probes, and the (score, row) pairs it returns (4 + 4 bytes
    each)."""
    scales = rows * 4 if store == "int8" else 0
    return (rows * dim * STORE_BYTES[store] + rows * 4 + scales
            + batch * dim * 4 + batch * k * 8)


def topk_flops(rows: int, dim: int, batch: int) -> float:
    """Operations of one search's scores."""
    return 2.0 * rows * dim * batch


@functools.lru_cache(maxsize=None)
def _peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)


def peaks(device_kind: str) -> dict | None:
    """The published peaks of a card by its name, or None for a card the
    table does not hold (its shares are then not reported)."""
    return _peaks().get(device_kind)

