"""InsightFace verification-set (.bin) importer.

Carried across from ``tf_face_toolbox_tpu/data/binpairs.py`` (it
imports no JAX); the shard is written by the port's ``data/format.py``.

The public face-verification benchmarks of the reference's era ship in
the InsightFace packaging as pickled ``.bin`` files — ``lfw.bin``,
``cfp_fp.bin``, ``agedb_30.bin`` — each a 2-tuple
``(bins, issame_list)`` where ``bins`` is a flat list of 2N encoded
images (pair *i* is entries ``2i`` and ``2i+1``) and ``issame_list``
is N booleans. The reference consumed LFW via pairs.txt + an image
tree (SURVEY.md §3.3); a user migrating from the InsightFace ecosystem
lands here with a .bin in hand, so the toolbox owes the matching
importer (the eval-set analogue of ``data/recordio.py``'s train-set
importer).

The import target is the toolbox's own primitives, not a parallel eval
path: the images become a FaceShard (so ``cli.extract`` — flip-averaged
L2 embeddings, any loader — runs unchanged) and the pair structure
becomes an index-format pairs file (``idx1 idx2 label``) that
``cli.eval_lfw`` already accepts.

Pickle safety: a .bin is an untrusted artifact and ``pickle.load`` is
arbitrary code execution. :class:`_BinUnpickler` whitelists the only
constructors the format legitimately needs (numpy array rebuilding and
builtin containers) and rejects everything else loudly, so a malicious
"benchmark" file cannot run code here.
"""

from __future__ import annotations

import io
import pickle
from typing import BinaryIO

import numpy as np

# constructors a legitimate (bins, issame) pickle can reference:
# numpy's array-rebuild machinery plus plain builtin containers.
_SAFE = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy", "bool_"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
    # protocol-2 pickles (what ships) route bytes through _codecs.encode
    ("_codecs", "encode"),
    ("builtins", "bytes"),
    ("builtins", "bytearray"),
    ("builtins", "list"),
    ("builtins", "tuple"),
    ("builtins", "bool"),
    ("builtins", "int"),
    ("builtins", "float"),
}


class _BinUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _SAFE:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: a verification .bin "
            "only contains image bytes and booleans; this file asks for "
            "code outside that set and is not trusted")


def load_bin(path_or_file) -> tuple[list[bytes], np.ndarray]:
    """Read a .bin → (encoded image blobs, issame bool array).

    Accepts the two encodings seen in the wild for each image entry:
    ``bytes``/``bytearray``, or a 1-D uint8 numpy array wrapping the
    same encoded stream (mx.nd-free repackagings). Validates
    ``len(bins) == 2 * len(issame)``.
    """
    f: BinaryIO
    if hasattr(path_or_file, "read"):
        f = path_or_file
        obj = _BinUnpickler(f, encoding="bytes").load()
    else:
        with open(path_or_file, "rb") as f:
            obj = _BinUnpickler(f, encoding="bytes").load()
    if not (isinstance(obj, (tuple, list)) and len(obj) == 2):
        raise ValueError("not a verification .bin: expected a "
                         "(bins, issame_list) 2-tuple")
    raw_bins, issame = obj
    blobs: list[bytes] = []
    for i, b in enumerate(raw_bins):
        if isinstance(b, (bytes, bytearray)):
            blobs.append(bytes(b))
        elif isinstance(b, np.ndarray) and b.dtype == np.uint8 and b.ndim == 1:
            blobs.append(b.tobytes())
        else:
            raise ValueError(
                f"bins[{i}] is {type(b).__name__}; expected encoded "
                "image bytes (bytes or 1-D uint8 array)")
    same = np.asarray([bool(s) for s in issame], bool)
    if len(blobs) != 2 * len(same):
        raise ValueError(
            f"{len(blobs)} images for {len(same)} pairs; a .bin stores "
            "exactly two images per pair")
    return blobs, same


def _ensure_jpeg(blob: bytes) -> tuple[bytes, bool]:
    """Pass JPEG through verbatim; transcode anything else (some bins
    carry PNG) so every toolbox loader — native libjpeg, DCT-domain,
    Python — can read the shard. Returns (blob, transcoded?)."""
    if blob[:2] == b"\xff\xd8":
        return blob, False
    from PIL import Image

    img = Image.open(io.BytesIO(blob)).convert("RGB")
    out = io.BytesIO()
    img.save(out, "JPEG", quality=100, subsampling=0)
    return out.getvalue(), True


def convert_bin_to_faceshard(bin_path: str, out_path: str, *,
                             pairs_path: str | None = None,
                             log=None) -> tuple[int, int, int]:
    """``lfw.bin``-style file → FaceShard + index-format pairs file.

    Images are written in bin order (pair *i* → rows 2i, 2i+1); each
    row's FaceShard label is its own index (identities are unknown in
    this format and unused by extraction). The pairs file
    (``<out>.pairs.txt`` unless ``pairs_path``) holds ``idx1 idx2
    label`` lines in the exact format ``cli.eval_lfw`` consumes.

    Returns (num_images, num_pairs, num_transcoded).
    """
    from tf_face_toolbox_tpu_torch.data.format import ShardWriter

    blobs, same = load_bin(bin_path)
    transcoded = 0
    with ShardWriter(out_path) as w:
        for i, blob in enumerate(blobs):
            jpeg, did = _ensure_jpeg(blob)
            transcoded += did
            w.add(jpeg, i)
    pairs = pairs_path or out_path + ".pairs.txt"
    tmp = pairs + ".tmp"
    with open(tmp, "w") as f:
        f.write("# idx1 idx2 label — generated from "
                f"{bin_path} by data.binpairs\n")
        for i, s in enumerate(same):
            f.write(f"{2 * i} {2 * i + 1} {int(s)}\n")
    import os

    os.replace(tmp, pairs)
    if transcoded and log:
        log("transcoded %d non-JPEG image(s) to JPEG q100/4:4:4",
            transcoded)
    return len(blobs), len(same), transcoded
