"""TFRecord ingestion: read the reference ecosystem's dataset format.

Carried across from ``tf_face_toolbox_tpu/data/tfrecord.py`` (it
imports no JAX); the shard is written by the port's ``data/format.py``.

The reference's training data lives in TFRecords of tf.train.Example
protos [TF1-IDIOM]; this module reads them WITHOUT TensorFlow — a
40-line wire-format reader (TFRecord framing is trivial) plus a minimal
protobuf wire parser for the three-field Example schema. Used by
cli/convert_tfrecord.py to migrate datasets to FaceShard.

TFRecord framing (tensorflow/core/io/record_writer.h):
    u64 length | u32 masked_crc(length) | data | u32 masked_crc(data)
Both CRCs are verified by default (masked CRC32C, Castagnoli): a
truncated-but-framing-valid record is caught at read time instead of
surfacing later as a cryptic JPEG decode failure. Uses the installed
google_crc32c C extension when present, else a pure-Python table.
"""

from __future__ import annotations

import struct
from typing import Iterator

# ---------------------------------------------------------------------------
# masked CRC32C (the TFRecord checksum)
# ---------------------------------------------------------------------------

try:
    from google_crc32c import value as _crc32c  # C extension, fast
except ImportError:                              # pure-Python fallback
    _CRC32C_TABLE = []
    for _i in range(256):
        _c = _i
        for _ in range(8):
            _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
        _CRC32C_TABLE.append(_c)

    def _crc32c(data: bytes) -> int:
        crc = 0xFFFFFFFF
        for b in data:
            crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
        return crc ^ 0xFFFFFFFF


_MASK_DELTA = 0xA282EAD8


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked checksum: rotate-right-15 then add a constant
    (record_writer.h MaskedCrc) so CRCs of CRCs stay well distributed."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def iter_tfrecords(path: str, *, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file.

    ``verify_crc`` (default on) checks both the length CRC and the data
    CRC; pass False only for speed on trusted local files.
    """
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            if verify_crc:
                (length_crc,) = struct.unpack("<I", header[8:12])
                if masked_crc32c(header[:8]) != length_crc:
                    raise ValueError(f"{path}: corrupt record length CRC")
            data = f.read(length)
            if len(data) < length:
                raise ValueError(f"{path}: truncated record")
            footer = f.read(4)
            if verify_crc:
                if len(footer) < 4:
                    raise ValueError(f"{path}: truncated record footer")
                (data_crc,) = struct.unpack("<I", footer)
                if masked_crc32c(data) != data_crc:
                    raise ValueError(f"{path}: corrupt record data CRC")
            yield data


# ---------------------------------------------------------------------------
# minimal protobuf wire parsing (just enough for tf.train.Example)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _to_int64(v: int) -> int:
    # proto int64 varints are two's-complement: sign-extend (a -1 label
    # otherwise comes back as 2^64-1).
    return v - (1 << 64) if v >= (1 << 63) else v


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                    # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        elif wire == 1:                    # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def parse_example(raw: bytes) -> dict[str, list]:
    """tf.train.Example → {feature_name: [values...]}.

    Values are bytes (BytesList), float (FloatList) or int (Int64List).
    """
    out: dict[str, list] = {}
    for field, _, features_buf in _iter_fields(raw):
        if field != 1:                     # Example.features
            continue
        for f2, _, entry in _iter_fields(features_buf):
            if f2 != 1:                    # Features.feature map entry
                continue
            name, values = None, []
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:                # key
                    name = v.decode()
                elif f3 == 2:              # value: Feature
                    for f4, _, lst in _iter_fields(v):
                        if f4 == 1:        # BytesList
                            for f5, _, b in _iter_fields(lst):
                                if f5 == 1:
                                    values.append(b)
                        elif f4 == 2:      # FloatList (packed or not)
                            for f5, w5, fl in _iter_fields(lst):
                                if f5 != 1:
                                    continue
                                if w5 == 2:  # packed
                                    values.extend(struct.unpack(
                                        f"<{len(fl)//4}f", fl))
                                else:
                                    values.append(
                                        struct.unpack("<f", fl)[0])
                        elif f4 == 3:      # Int64List (packed or not)
                            for f5, w5, iv in _iter_fields(lst):
                                if f5 != 1:
                                    continue
                                if w5 == 2:  # packed varints
                                    pos = 0
                                    while pos < len(iv):
                                        n, pos = _read_varint(iv, pos)
                                        values.append(_to_int64(n))
                                else:
                                    values.append(_to_int64(iv))
            if name is not None:
                out[name] = values
    return out


def iter_arrayrecords(path: str) -> Iterator[bytes]:
    """Yield raw record payloads from an ArrayRecord file (the modern
    JAX-ecosystem successor to TFRecord). Needs the optional
    ``array_record`` package, imported here and only here."""
    try:
        from array_record.python.array_record_module import (
            ArrayRecordReader)
    except ImportError as e:
        raise ImportError(
            f"{path}: reading ArrayRecord files needs the 'array_record' "
            "package, which is not installed; convert TFRecord files "
            "instead") from e

    reader = ArrayRecordReader(path)
    try:
        n = reader.num_records()
        # read in chunks to bound memory
        for lo in range(0, n, 1024):
            for rec in reader.read(list(range(lo, min(lo + 1024, n)))):
                yield rec
    finally:
        reader.close()


def convert_tfrecords_to_faceshard(
        record_paths: list[str], out_path: str, *,
        image_key: str = "image/encoded",
        label_key: str = "image/label") -> int:
    """Migrate TFRecord/ArrayRecord face data into a FaceShard.

    Records must be tf.train.Example protos; files ending in
    ``.array_record``/``.arrayrecord`` are read with the ArrayRecord
    reader, anything else as TFRecord framing.
    """
    from tf_face_toolbox_tpu_torch.data.format import PAYLOAD_JPEG, ShardWriter

    with ShardWriter(out_path, payload=PAYLOAD_JPEG) as writer:
        for path in record_paths:
            it = (iter_arrayrecords(path)
                  if path.endswith((".array_record", ".arrayrecord"))
                  else iter_tfrecords(path))
            for raw in it:
                ex = parse_example(raw)
                if image_key not in ex or label_key not in ex:
                    keys = sorted(ex)
                    raise KeyError(
                        f"record missing '{image_key}'/'{label_key}'; "
                        f"found features {keys}")
                writer.add(bytes(ex[image_key][0]),
                           int(ex[label_key][0]))
        return writer.count
