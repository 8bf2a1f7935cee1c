"""FaceShard: the framework's packed training-data format.

Rebuild of the reference's dataset-packing step (ref: upstream
data/convert_*.py [UPSTREAM-K LOW]; TFRecord-era equivalent) with a
format designed for TPU-input needs instead of TF's stream-oriented
TFRecord:

- **mmap-friendly**: one contiguous index (offsets + labels) up front,
  then raw payload bytes. Random access is O(1) → global shuffling
  without reading payloads, and per-host sharding is just index
  arithmetic.
- **language-neutral**: fixed little-endian layout, trivially parsed
  from C++ (native/faceshard loader) and Python (this module).
- payloads are either JPEG blobs (``PAYLOAD_JPEG``) or raw fixed-shape
  uint8 tensors (``PAYLOAD_RAW``, for synthetic data and golden tests).

Layout (little-endian):

    magic    u32  = 0x45434146 ("FACE")
    version  u32  = 1
    payload  u32  (0=jpeg, 1=raw u8)
    height   u32  (raw only, else 0)
    width    u32  (raw only, else 0)
    channels u32  (raw only, else 0)
    count    u64
    offsets  u64[count+1]   payload byte offsets relative to data start
    labels   i32[count]
    data     bytes
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Iterable, Sequence

import numpy as np

MAGIC = 0x45434146
VERSION = 1
PAYLOAD_JPEG = 0
PAYLOAD_RAW = 1

_HEADER = struct.Struct("<IIIIIIQ")


@dataclasses.dataclass
class ShardIndex:
    path: str
    payload: int
    shape: tuple[int, int, int] | None   # raw payload shape, else None
    offsets: np.ndarray                  # (count+1,) u64
    labels: np.ndarray                   # (count,) i32
    data_start: int

    @property
    def count(self) -> int:
        return len(self.labels)


def write_shard(path: str, blobs: Iterable[bytes], labels: Sequence[int],
                *, payload: int = PAYLOAD_JPEG,
                shape: tuple[int, int, int] | None = None) -> int:
    """Write a FaceShard file; returns record count."""
    blobs = list(blobs)
    labels = np.asarray(labels, np.int32)
    if len(blobs) != len(labels):
        raise ValueError(f"{len(blobs)} blobs vs {len(labels)} labels")
    if payload == PAYLOAD_RAW and shape is None:
        raise ValueError("raw payload requires shape")
    sizes = np.fromiter((len(b) for b in blobs), np.uint64, len(blobs))
    offsets = np.zeros(len(blobs) + 1, np.uint64)
    np.cumsum(sizes, out=offsets[1:])
    h, w, c = shape if shape else (0, 0, 0)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, VERSION, payload, h, w, c, len(blobs)))
        f.write(offsets.tobytes())
        f.write(labels.tobytes())
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)  # atomic
    return len(blobs)


class ShardWriter:
    """Streaming FaceShard writer: O(1) memory in the dataset size.

    Payload bytes stream to a temp file while sizes/labels accumulate;
    ``close()`` writes header+index and splices the payload in — so
    converting an MS1M-scale dataset never holds the images in RAM.
    """

    def __init__(self, path: str, *, payload: int = PAYLOAD_JPEG,
                 shape: tuple[int, int, int] | None = None):
        if payload == PAYLOAD_RAW and shape is None:
            raise ValueError("raw payload requires shape")
        self._path = path
        self._payload = payload
        self._shape = shape
        self._data_tmp = path + ".data.tmp"
        self._data = open(self._data_tmp, "wb")
        self._sizes: list[int] = []
        self._labels: list[int] = []

    @property
    def count(self) -> int:
        return len(self._labels)

    def add(self, blob: bytes, label: int) -> None:
        self._data.write(blob)
        self._sizes.append(len(blob))
        self._labels.append(int(label))

    def add_block(self, data, sizes, labels) -> None:
        """Bulk append: one contiguous payload region (bytes/memoryview,
        the concatenation of ``len(sizes)`` records) + its per-record
        sizes and labels — the fast path merge_shards uses to splice a
        whole input shard without per-record Python round trips."""
        if len(sizes) != len(labels):
            raise ValueError(f"{len(sizes)} sizes vs {len(labels)} labels")
        if int(np.sum(sizes, dtype=np.uint64)) != len(data):
            raise ValueError("payload region does not match sizes")
        self._data.write(data)
        self._sizes.extend(int(s) for s in sizes)
        self._labels.extend(int(l) for l in labels)

    def close(self) -> int:
        self._data.close()
        offsets = np.zeros(len(self._sizes) + 1, np.uint64)
        np.cumsum(np.asarray(self._sizes, np.uint64), out=offsets[1:])
        h, w, c = self._shape if self._shape else (0, 0, 0)
        tmp = self._path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(_HEADER.pack(MAGIC, VERSION, self._payload,
                                     h, w, c, len(self._labels)))
                f.write(offsets.tobytes())
                f.write(np.asarray(self._labels, np.int32).tobytes())
                with open(self._data_tmp, "rb") as data:
                    while chunk := data.read(1 << 22):
                        f.write(chunk)
        except BaseException:
            # a failed splice (ENOSPC mid-copy) must not leave a
            # dataset-sized .tmp on an already-full disk
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        os.replace(tmp, self._path)
        os.unlink(self._data_tmp)
        return len(self._labels)

    def abort(self) -> None:
        """Discard the in-progress shard; leaves no temp litter
        (both the payload temp and any partial close() output)."""
        self._data.close()
        for p in (self._data_tmp, self._path + ".tmp"):
            if os.path.exists(p):
                os.unlink(p)

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # leave no temp litter on failure
            self.abort()


def read_index(path: str) -> ShardIndex:
    """Read the index (offsets+labels) without touching payloads."""
    with open(path, "rb") as f:
        hdr = f.read(_HEADER.size)
        magic, version, payload, h, w, c, count = _HEADER.unpack(hdr)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad magic {magic:#x}")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        offsets = np.frombuffer(f.read(8 * (count + 1)), np.uint64).copy()
        labels = np.frombuffer(f.read(4 * count), np.int32).copy()
        data_start = f.tell()
    shape = (h, w, c) if payload == PAYLOAD_RAW else None
    return ShardIndex(path=path, payload=payload, shape=shape,
                      offsets=offsets, labels=labels, data_start=data_start)


class ShardReader:
    """Random-access payload reader over an mmap'd FaceShard."""

    def __init__(self, index: ShardIndex):
        self.index = index
        self._mm = np.memmap(index.path, np.uint8, "r")

    def blob(self, i: int) -> bytes:
        s = self.index.data_start + int(self.index.offsets[i])
        e = self.index.data_start + int(self.index.offsets[i + 1])
        return bytes(self._mm[s:e])

    def raw(self, i: int) -> np.ndarray:
        if self.index.payload != PAYLOAD_RAW:
            raise ValueError("not a raw shard")
        return np.frombuffer(self.blob(i), np.uint8).reshape(self.index.shape)

    def label(self, i: int) -> int:
        return int(self.index.labels[i])


def load_labels(path: str) -> np.ndarray:
    """Labels from a pack list file (``image_path label`` per line).

    Same parse as cli.pack (rsplit on the LAST space), so paths
    containing spaces resolve identically in both tools. Shared,
    flag-free home for every consumer (cli.eval_identification,
    cli.search — one binary per entry point, so CLI modules must not
    import each other's flag namespaces)."""
    labels = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            _, _, lab = line.rpartition(" ")
            try:
                labels.append(int(lab))
            except ValueError:
                raise ValueError(
                    f"{path}: line {len(labels) + 1} has no trailing "
                    f"integer label: {line!r}") from None
    return np.asarray(labels)


def pack_image_list(list_path: str, out_path: str, *, root: str = "",
                    recode_size: int = 0,
                    recode_quality: int = 95,
                    landmarks_path: str = "",
                    align_size: int = 112) -> int:
    """Pack an ``image_path label`` list file (the reference's input
    convention [TF1-IDIOM]) into a FaceShard of JPEG payloads.
    Streams through ShardWriter — O(1) memory at MS1M scale.

    ``recode_size`` > 0 re-encodes every image to that square geometry
    as a 4:4:4 JPEG (bilinear resize, ``recode_quality``). This is the
    uniform-geometry shard the DCT input path requires (the native
    loader's entropy-decode-only ``dct_batch`` + on-TPU IDCT,
    ops/jpeg_tpu.py); plain shards keep the original bytes untouched.
    ``recode_size`` should be the training pipeline's ``crop_from``.

    ``landmarks_path``: align WHILE packing — a file parallel to the
    list with 10 floats per line (x1 y1 .. x5 y5: eyes, nose, mouth
    corners in source-image coordinates). Each face is similarity-
    aligned to the ArcFace template at ``align_size``² (ops/align) and
    re-encoded 4:4:4, producing an aligned uniform shard in one step
    (the external MTCNN-era alignment stage the reference assumed,
    folded into the packer). Mutually exclusive with ``recode_size``
    (alignment already fixes the geometry; pass align_size instead)."""
    if landmarks_path and recode_size:
        raise ValueError("landmarks alignment already recodes to "
                         "align_size²; drop recode_size")
    align_rows = None
    if landmarks_path:
        if align_size % 8:
            raise ValueError("align_size must be a multiple of 8 "
                             "(JPEG block granularity, DCT path)")
        align_rows = []
        with open(landmarks_path) as f:
            for ln, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                vals = [float(v) for v in line.replace(",", " ").split()]
                if len(vals) != 10:
                    raise ValueError(
                        f"{landmarks_path}:{ln + 1}: expected 10 floats "
                        f"(x1 y1 .. x5 y5), got {len(vals)}")
                align_rows.append(
                    np.asarray(vals, np.float64).reshape(5, 2))
    recode = None
    if recode_size:
        if recode_size % 8:
            raise ValueError("recode_size must be a multiple of 8 "
                             "(JPEG block granularity, DCT path)")
        import io

        from PIL import Image

        def recode(blob: bytes) -> bytes:
            # resize with the PIPELINE's half-pixel bilinear
            # (_resize_u8), NOT PIL's antialiased Image.BILINEAR —
            # recoded shards must match the pixels a plain shard
            # produces at load time, or mixing the two skews train/eval
            from tf_face_toolbox_tpu_torch.data.pipeline import _resize_u8

            img = Image.open(io.BytesIO(blob)).convert("RGB")
            arr = np.asarray(img, np.uint8)
            if arr.shape[:2] != (recode_size, recode_size):
                arr = _resize_u8(arr, recode_size, recode_size)
            buf = io.BytesIO()
            # subsampling=0 → 4:4:4: uniform block grid across Y/Cb/Cr
            Image.fromarray(arr).save(buf, "JPEG",
                                      quality=recode_quality,
                                      subsampling=0)
            return buf.getvalue()

    if align_rows is not None:
        import io

        from PIL import Image

        from tf_face_toolbox_tpu_torch.ops.align import align_face

        def aligned(blob: bytes, idx: int) -> bytes:
            img = Image.open(io.BytesIO(blob)).convert("RGB")
            arr = align_face(np.asarray(img, np.uint8),
                             align_rows[idx], size=align_size)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, "JPEG",
                                      quality=recode_quality,
                                      subsampling=0)
            return buf.getvalue()

    with ShardWriter(out_path, payload=PAYLOAD_JPEG) as writer:
        with open(list_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                p, lab = line.rsplit(" ", 1)
                with open(os.path.join(root, p), "rb") as img:
                    blob = img.read()
                if align_rows is not None:
                    if writer.count >= len(align_rows):
                        raise ValueError(
                            f"landmarks file has {len(align_rows)} "
                            "lines but the list has more images")
                    blob = aligned(blob, writer.count)
                elif recode:
                    blob = recode(blob)
                writer.add(blob, int(lab))
        if align_rows is not None and writer.count != len(align_rows):
            raise ValueError(
                f"landmarks file has {len(align_rows)} lines for "
                f"{writer.count} packed images — they must be parallel")
        return writer.count


def pack_arrays(out_path: str, images: np.ndarray,
                labels: Sequence[int]) -> int:
    """Pack pre-decoded uint8 images (N,H,W,C) as a raw shard."""
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    return write_shard(out_path, [images[i].tobytes() for i in range(n)],
                       labels, payload=PAYLOAD_RAW, shape=(h, w, c))


def merge_shards(paths: Sequence[str], out_path: str, *,
                 relabel: bool = False) -> int:
    """Concatenate FaceShards into one (streaming, O(1) memory).

    Enables parallel packing workflows: pack per-chunk shards
    concurrently, merge once (cli.merge). All inputs must share the
    payload type (and shape, for raw shards). ``relabel=True`` offsets
    each input's labels by the running max+1 so per-chunk identity
    numbering (every chunk starting at 0) stays disjoint; default keeps
    labels as-is for chunks that already share a global id space.
    """
    if not paths:
        raise ValueError("merge_shards: no input shards")
    indexes = [read_index(p) for p in paths]
    first = indexes[0]
    writer = ShardWriter(out_path, payload=first.payload,
                         shape=first.shape)
    next_label = 0
    try:
        for path, idx in zip(paths, indexes):
            if idx.payload != first.payload or idx.shape != first.shape:
                raise ValueError(
                    f"{path}: payload/shape mismatch vs {paths[0]} "
                    f"({idx.payload}/{idx.shape} != "
                    f"{first.payload}/{first.shape})")
            base = next_label if relabel else 0
            # bulk splice: each input's payload region is contiguous —
            # copy it as one block (no per-record Python round trips)
            mm = np.memmap(path, np.uint8, "r")
            lo = idx.data_start + int(idx.offsets[0])
            hi = idx.data_start + int(idx.offsets[-1])
            writer.add_block(memoryview(mm[lo:hi]),
                             np.diff(idx.offsets),
                             idx.labels.astype(np.int64) + base)
            if relabel and idx.count:
                next_label = base + int(idx.labels.max()) + 1
        return writer.close()
    except Exception:
        writer.abort()
        raise
