"""MXNet RecordIO (.rec) reader + InsightFace dataset importer.

Carried across from ``tf_face_toolbox_tpu/data/recordio.py`` (it
imports no JAX); the shard is written by the port's ``data/format.py``.

The big public face-recognition training sets of the reference's era
(MS1M-ArcFace, Glint360K, CASIA packaged by InsightFace) ship as MXNet
``train.rec``/``train.idx`` pairs, not as image trees or TFRecords. A
user migrating from the reference ecosystem lands here with a .rec in
hand, so the toolbox owes a native importer to FaceShard (the same
role ``cli.convert_tfrecord`` plays for the reference's own format
[TF1-IDIOM]).

Format, reimplemented from the published MXNet container layout (no
mxnet dependency):

- RecordIO framing: per record ``uint32 magic (0xced7230a)``,
  ``uint32 lrec`` where ``cflag = lrec >> 29`` and
  ``length = lrec & 0x1fffffff``, then ``length`` payload bytes padded
  to a 4-byte boundary. ``cflag`` 0 = complete record; 1/2/3 =
  start/middle/end of a split record (reassembled here).
- IRHeader payload prefix: little-endian ``uint32 flag, float32 label,
  uint64 id, uint64 id2`` (24 bytes). ``flag > 0`` means the scalar
  label field is replaced by ``flag`` float32 values FOLLOWING the
  header; the image bytes come after.
- InsightFace layout: record key 0 is a meta record (empty content,
  label = [identity_start, identity_end)); records with empty content
  in that range map identities to image-record spans. Image records
  carry their identity in the first label float, so the importer only
  needs to skip empty-content records.
"""

from __future__ import annotations

import json
import struct
from typing import Iterator

import numpy as np

RECORDIO_MAGIC = 0xCED7230A
_LENGTH_MASK = (1 << 29) - 1
_HEADER = struct.Struct("<IfQQ")


def read_records(path: str) -> Iterator[bytes]:
    """Yield each record's payload (IRHeader + content), reassembling
    split records. Raises on a corrupt magic/truncated frame."""
    with open(path, "rb") as f:
        parts: list[bytes] = []
        while True:
            frame = f.read(8)
            if not frame:
                if parts:
                    raise ValueError(f"{path}: truncated split record")
                return
            if len(frame) < 8:
                raise ValueError(f"{path}: truncated frame header")
            magic, lrec = struct.unpack("<II", frame)
            if magic != RECORDIO_MAGIC:
                raise ValueError(
                    f"{path}: bad RecordIO magic {magic:#x} "
                    f"(not an MXNet .rec file?)")
            cflag, length = lrec >> 29, lrec & _LENGTH_MASK
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated record payload")
            pad = (4 - length % 4) % 4
            if pad:
                f.seek(pad, 1)
            if cflag == 0:              # complete
                if parts:
                    raise ValueError(f"{path}: split record not closed")
                yield data
            elif cflag == 1:            # start
                parts = [data]
            elif cflag == 2:            # middle
                if not parts:
                    raise ValueError(f"{path}: middle without start")
                parts.append(data)
            elif cflag == 3:            # end
                if not parts:
                    raise ValueError(f"{path}: end without start")
                parts.append(data)
                yield b"".join(parts)
                parts = []
            else:                       # cflag is 3 bits; 4..7 unused
                raise ValueError(
                    f"{path}: unknown RecordIO cflag {cflag} "
                    "(corrupt or not an MXNet .rec file)")


def unpack_record(payload: bytes) -> tuple[np.ndarray, bytes]:
    """IRHeader payload → (label float vector, content bytes)."""
    if len(payload) < _HEADER.size:
        raise ValueError("record shorter than its IRHeader")
    flag, label, _id, _id2 = _HEADER.unpack_from(payload)
    if flag == 0:
        return np.array([label], np.float32), payload[_HEADER.size:]
    end = _HEADER.size + 4 * flag
    if len(payload) < end:
        raise ValueError(f"record label block truncated (flag={flag})")
    labels = np.frombuffer(payload[_HEADER.size:end], "<f4")
    return labels, payload[end:]


def convert_rec_to_faceshard(rec_path: str, out_path: str, *,
                             relabel: bool = True,
                             label_map_path: str | None = None,
                             log_every: int = 0,
                             log=None) -> tuple[int, int]:
    """``train.rec`` → FaceShard. Returns (num_images, num_classes).

    Meta/identity-index records (empty content) are skipped; each image
    record's identity is its first label float. ``relabel`` (default)
    maps identities to dense 0..K-1 in first-seen order — FaceShard
    labels feed ``--num_classes`` directly — and writes the original→
    dense mapping next to the shard (``<out>.labels.json``, or
    ``label_map_path``) so embeddings stay traceable to source ids.
    """
    from tf_face_toolbox_tpu_torch.data.format import ShardWriter

    mapping: dict[int, int] = {}
    seen: set[int] = set()  # relabel=False: count only, no dead mapping
    n = 0
    with ShardWriter(out_path) as w:
        for payload in read_records(rec_path):
            labels, content = unpack_record(payload)
            if not content:             # InsightFace meta/identity row
                continue
            ident = int(labels[0])
            if relabel:
                label = mapping.setdefault(ident, len(mapping))
            else:
                label = ident
                seen.add(ident)
            w.add(content, label)
            n += 1
            if log_every and log and n % log_every == 0:
                log("imported %d images (%d identities)", n,
                    len(mapping) if relabel else len(seen))
    if relabel:
        path = label_map_path or out_path + ".labels.json"
        with open(path, "w") as f:
            json.dump({str(k): v for k, v in mapping.items()}, f)
    return n, len(mapping) if relabel else len(seen)
