"""Embedding files: .npy / .npz / .mat / .bin (TFFB raw f32).

``save_embeddings`` and ``load_embeddings`` from
``tf_face_toolbox_tpu/train/checkpoint.py``, which imports orbax at its
top; the formats are the same byte for byte.
"""

from __future__ import annotations

import os

_EMB_BIN_MAGIC = b"TFFB"


def save_embeddings(path: str, embeddings, names=None) -> None:
    """Write extracted features to disk; format routed by extension.

    Rebuild of the reference's feature dump (ref: upstream features.py
    output [UPSTREAM-K] — the era wrote .npy/.mat/binary for offline
    MATLAB/numpy verification):

    - ``.npy`` (default) / ``.npz`` (when ``names`` is given)
    - ``.mat`` — MATLAB v5 via scipy.io, variables ``embeddings``
      (+ ``names``): drop-in for MATLAB-side LFW/megaface scripts
    - ``.bin`` — little-endian raw: 4-byte magic ``TFFB``, int32 n,
      int32 d, then n*d float32 row-major (names not stored)
    """
    import numpy as np
    embeddings = np.asarray(embeddings)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mat":
        from scipy.io import savemat
        data = {"embeddings": embeddings}
        if names is not None:
            data["names"] = np.asarray(names)
        savemat(path, data)
    elif ext == ".bin":
        n, d = embeddings.shape
        with open(path, "wb") as f:
            f.write(_EMB_BIN_MAGIC)
            f.write(np.asarray([n, d], "<i4").tobytes())
            f.write(np.ascontiguousarray(embeddings, "<f4").tobytes())
    elif ext == ".npz" or names is not None:
        data = {"embeddings": embeddings}
        if names is not None:
            data["names"] = np.asarray(names)
        np.savez(path, **data)
    else:
        np.save(path, embeddings)


def load_embeddings(path: str):
    """Inverse of :func:`save_embeddings` → (embeddings, names|None)."""
    import numpy as np
    ext = os.path.splitext(path)[1].lower()
    if ext == ".mat":
        from scipy.io import loadmat
        data = loadmat(path)
        names = data.get("names")
        if names is not None:
            names = np.asarray([str(s).strip() for s in names.ravel()])
        return np.asarray(data["embeddings"]), names
    if ext == ".bin":
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != _EMB_BIN_MAGIC:
                raise ValueError(
                    f"{path}: not a TFFB embedding file (magic {magic!r})")
            n, d = np.frombuffer(f.read(8), "<i4")
            emb = np.frombuffer(f.read(int(n) * int(d) * 4), "<f4")
            if emb.size != n * d:
                raise ValueError(f"{path}: truncated ({emb.size} of "
                                 f"{n * d} values)")
        return emb.reshape(int(n), int(d)).copy(), None
    data = np.load(path, allow_pickle=False)
    if hasattr(data, "files"):
        names = data["names"] if "names" in data.files else None
        return data["embeddings"], names
    return data, None
