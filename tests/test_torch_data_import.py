"""The port's data layer (importers, pack, merge, the torch dataset) vs
the JAX package's.

The same input file goes through the JAX importer and the port's, and
the FaceShards must come out equal record for record (payload bytes and
labels) and byte for byte; the port's CLIs run as subprocesses and
print the JAX CLIs' lines.
"""

import functools
import io
import json
import os
import pickle
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_binpairs import _write_bin
from tests.test_recordio import _frame, _insightface_rec, _ir
from tf_face_toolbox_tpu.data import binpairs as jax_binpairs
from tf_face_toolbox_tpu.data import recordio as jax_recordio
from tf_face_toolbox_tpu.data import tfrecord as jax_tfrecord
from tf_face_toolbox_tpu.data.format import merge_shards as jax_merge
from tf_face_toolbox_tpu.data.format import pack_image_list as jax_pack
from tf_face_toolbox_tpu.data.grain_adapter import (
    FaceShardDataSource as JaxDataSource)
from tf_face_toolbox_tpu_torch.data import binpairs, recordio, tfrecord
from tf_face_toolbox_tpu_torch.data.format import (
    ShardReader, merge_shards, pack_image_list, read_index)
from tf_face_toolbox_tpu_torch.data.grain_adapter import (
    FaceShardDataSource, make_grain_dataset)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_run = functools.partial(
    subprocess.run, cwd=ROOT, capture_output=True, text=True, timeout=300,
    env={**os.environ, "OMP_NUM_THREADS": "1"})


def _records(path: str) -> list:
    reader = ShardReader(read_index(path))
    return [(reader.blob(i), reader.label(i))
            for i in range(reader.index.count)]


def _assert_same_shard(got: str, want: str) -> None:
    """Record for record (payload bytes, labels), then byte for byte."""
    assert _records(got) == _records(want)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def _jpeg(seed: int, size: int = 16) -> bytes:
    from PIL import Image

    arr = np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=95)
    return buf.getvalue()


# ---- tf.train.Example and TFRecord framing, written by hand ------------


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                 # int64 two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _example(feats: dict, packed: bool = True) -> bytes:
    """A tf.train.Example: bytes, int (Int64List, packed or not) and
    float (FloatList) features."""
    entries = b""
    for name, value in feats.items():
        if isinstance(value, bytes):
            feature = _field(1, _field(1, value))
        elif isinstance(value, int):
            if packed:
                feature = _field(3, _field(1, _varint(value)))
            else:
                feature = _field(3, _varint(1 << 3) + _varint(value))
        else:
            feature = _field(2, _field(1, struct.pack("<f", value)))
        entries += _field(1, _field(1, name.encode()) + _field(2, feature))
    return _field(1, entries)


def _tfrecord(path, examples) -> str:
    crc = jax_tfrecord.masked_crc32c
    with open(path, "wb") as f:
        for raw in examples:
            length = struct.pack("<Q", len(raw))
            f.write(length + struct.pack("<I", crc(length)) + raw
                    + struct.pack("<I", crc(raw)))
    return str(path)


def _face_examples(n: int, seed: int = 0, packed: bool = True) -> list:
    return [_example({"image/encoded": _jpeg(seed + i),
                      "image/label": 7 * i - 3, "score": 0.5 * i},
                     packed=packed) for i in range(n)]


# ---- .rec --------------------------------------------------------------


@pytest.mark.parametrize("relabel", [True, False])
def test_rec_import_matches_jax(tmp_path, relabel):
    rec, _ = _insightface_rec(tmp_path)
    want, got = str(tmp_path / "jax.faceshard"), str(tmp_path / "port.faceshard")
    assert (recordio.convert_rec_to_faceshard(rec, got, relabel=relabel)
            == jax_recordio.convert_rec_to_faceshard(rec, want,
                                                     relabel=relabel))
    _assert_same_shard(got, want)
    if relabel:
        with open(got + ".labels.json") as a, open(want + ".labels.json") as b:
            assert json.load(a) == json.load(b)


def test_rec_reader_matches_jax_on_split_and_corrupt_records(tmp_path):
    p = tmp_path / "split.rec"
    p.write_bytes(_frame(b"one", 0) + _frame(b"he", 1) + _frame(b"ll", 2)
                  + _frame(b"o!", 3) + _frame(b"two", 0)
                  + _frame(_ir(2, [5.0, 1.0], b"xy"), 0))
    got = list(recordio.read_records(str(p)))
    assert got == list(jax_recordio.read_records(str(p)))
    labels, content = recordio.unpack_record(got[-1])
    want_labels, want_content = jax_recordio.unpack_record(got[-1])
    np.testing.assert_array_equal(labels, want_labels)
    assert content == want_content == b"xy"
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"\x00" * 8)
    with pytest.raises(ValueError, match="bad RecordIO magic"):
        list(recordio.read_records(str(bad)))


# ---- TFRecord ------------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False])
def test_tfrecord_import_matches_jax(tmp_path, packed):
    paths = [_tfrecord(tmp_path / f"d{i}.tfrecord",
                       _face_examples(3, seed=10 * i, packed=packed))
             for i in range(2)]
    raw = next(tfrecord.iter_tfrecords(paths[0]))
    assert tfrecord.parse_example(raw) == jax_tfrecord.parse_example(raw)
    assert tfrecord.parse_example(raw)["image/label"] == [-3]
    want, got = str(tmp_path / "jax.faceshard"), str(tmp_path / "port.faceshard")
    assert (tfrecord.convert_tfrecords_to_faceshard(paths, got)
            == jax_tfrecord.convert_tfrecords_to_faceshard(paths, want) == 6)
    _assert_same_shard(got, want)


@pytest.mark.parametrize("where,match", [(14, "data CRC"),
                                         (1, "length CRC")])
def test_tfrecord_corrupt_crc_refused(tmp_path, where, match):
    p = _tfrecord(tmp_path / "c.tfrecord", _face_examples(1))
    blob = bytearray(open(p, "rb").read())
    blob[where] ^= 0x01
    open(p, "wb").write(bytes(blob))
    for module in (tfrecord, jax_tfrecord):
        with pytest.raises(ValueError, match=match):
            module.convert_tfrecords_to_faceshard(
                [p], str(tmp_path / "o.faceshard"))


def test_tfrecord_crc_fallback_matches_the_c_extension():
    """The port's pure-Python CRC32C (its module reloaded with
    google_crc32c hidden) against the C extension and the JAX package's
    masked CRC."""
    import importlib

    from google_crc32c import value as c_ext

    sys.modules["google_crc32c"] = None      # makes the import raise
    try:
        importlib.reload(tfrecord)
        assert tfrecord._CRC32C_TABLE, "fallback branch did not run"
        for blob in [b"", b"a", b"123456789", bytes(range(256)) * 3]:
            assert tfrecord._crc32c(blob) == c_ext(blob)
            assert (tfrecord.masked_crc32c(blob)
                    == jax_tfrecord.masked_crc32c(blob))
        assert tfrecord._crc32c(b"123456789") == 0xE3069283
    finally:
        del sys.modules["google_crc32c"]
        importlib.reload(tfrecord)


def test_arrayrecord_without_its_package_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "array_record", None)
    with pytest.raises(ImportError, match="array_record"):
        list(tfrecord.iter_arrayrecords(str(tmp_path / "d.array_record")))


# ---- verification .bin ----------------------------------------------------


def test_bin_import_matches_jax(tmp_path):
    path, _, _ = _write_bin(tmp_path, n_pairs=5, png_at=3)
    want, got = str(tmp_path / "jax.faceshard"), str(tmp_path / "port.faceshard")
    n = binpairs.convert_bin_to_faceshard(path, got)
    assert n == jax_binpairs.convert_bin_to_faceshard(path, want) == (10, 5, 1)
    _assert_same_shard(got, want)
    with open(got + ".pairs.txt") as a, open(want + ".pairs.txt") as b:
        # the header names the writing module's source path: skip it
        assert a.read().splitlines()[1:] == b.read().splitlines()[1:]
    assert all(blob[:2] == b"\xff\xd8" for blob, _ in _records(got))


def test_bin_unpickler_refuses_code(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    path = tmp_path / "evil.bin"
    path.write_bytes(pickle.dumps(([Evil()], [True]), protocol=2))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        binpairs.load_bin(str(path))


# ---- pack and merge ---------------------------------------------------------


def _image_tree(tmp_path, n: int = 6, size: int = 20) -> tuple[str, str]:
    root = tmp_path / "imgs"
    root.mkdir()
    lines = []
    for i in range(n):
        (root / f"{i}.jpg").write_bytes(_jpeg(i, size))
        lines.append(f"{i}.jpg {i % 3}")
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(lines) + "\n")
    return str(listing), str(root)


@pytest.mark.parametrize("recode_size", [0, 16])
def test_pack_matches_jax(tmp_path, recode_size):
    listing, root = _image_tree(tmp_path)
    want, got = str(tmp_path / "jax.faceshard"), str(tmp_path / "port.faceshard")
    assert (pack_image_list(listing, got, root=root, recode_size=recode_size)
            == jax_pack(listing, want, root=root, recode_size=recode_size)
            == 6)
    _assert_same_shard(got, want)


@pytest.mark.parametrize("relabel", [True, False])
def test_merge_matches_jax(tmp_path, relabel):
    listing, root = _image_tree(tmp_path)
    parts = []
    for i in range(2):
        parts.append(str(tmp_path / f"part{i}.faceshard"))
        pack_image_list(listing, parts[-1], root=root)
    want, got = str(tmp_path / "jax.faceshard"), str(tmp_path / "port.faceshard")
    assert (merge_shards(parts, got, relabel=relabel)
            == jax_merge(parts, want, relabel=relabel) == 12)
    _assert_same_shard(got, want)


# ---- the CLIs ------------------------------------------------------------------


def _cli_case(name: str, tmp_path) -> tuple[list, str, str]:
    """(port CLI arguments, the line the JAX CLI prints, the shard the
    JAX converter writes from the same input)."""
    out = str(tmp_path / "port.faceshard")
    want = str(tmp_path / "jax.faceshard")
    if name == "pack":
        listing, root = _image_tree(tmp_path)
        n = jax_pack(listing, want, root=root, recode_size=16)
        return (["--list", listing, "--root", root, "--output", out,
                 "--recode_size", "16"],
                f"packed {n} records into {out}", want)
    if name == "merge":
        listing, root = _image_tree(tmp_path)
        parts = [str(tmp_path / f"p{i}.faceshard") for i in range(2)]
        for p in parts:
            jax_pack(listing, p, root=root)
        n = jax_merge(parts, want, relabel=True)
        return (["--inputs", ",".join(parts), "--output", out, "--relabel"],
                f"merged 2 shards ({n} records) into {out}", want)
    if name == "import_bin":
        path, _, _ = _write_bin(tmp_path, png_at=1)
        n, pairs, transcoded = jax_binpairs.convert_bin_to_faceshard(
            path, want)
        return (["--bin", path, "--output", out],
                f"imported {n} images / {pairs} pairs into {out} "
                f"({transcoded} transcoded to JPEG)", want)
    if name == "import_rec":
        rec, _ = _insightface_rec(tmp_path)
        n, k = jax_recordio.convert_rec_to_faceshard(rec, want)
        return (["--rec", rec, "--output", out],
                f"imported {n} images / {k} identities into {out}", want)
    paths = [_tfrecord(tmp_path / f"d{i}.tfrecord", _face_examples(2, 5 * i))
             for i in range(2)]
    n = jax_tfrecord.convert_tfrecords_to_faceshard(paths, want)
    return (["--tfrecords", ",".join(paths), "--output", out],
            f"converted {n} records into {out}", want)


@pytest.mark.parametrize("name", ["pack", "merge", "import_bin", "import_rec",
                                  "convert_tfrecord"])
def test_cli_prints_the_jax_line(tmp_path, name):
    args, line, want = _cli_case(name, tmp_path)
    proc = _run([sys.executable, "-m", f"tf_face_toolbox_tpu_torch.cli.{name}",
                 *args])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == line
    _assert_same_shard(str(tmp_path / "port.faceshard"), want)


def test_cli_pack_landmarks_refuses_naming_item_19(tmp_path):
    listing, root = _image_tree(tmp_path, n=2)
    marks = tmp_path / "marks.txt"
    marks.write_text("1 2 3 4 5 6 7 8 9 10\n" * 2)
    proc = _run([sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.pack",
                 "--list", listing, "--root", root, "--landmarks", str(marks),
                 "--output", str(tmp_path / "o.faceshard")])
    assert proc.returncode != 0
    assert "item 19" in proc.stderr and "Traceback" not in proc.stderr


# ---- the torch dataset ---------------------------------------------------------


def test_dataset_yields_the_jax_records(tmp_path):
    listing, root = _image_tree(tmp_path)
    shard = str(tmp_path / "d.faceshard")
    pack_image_list(listing, shard, root=root)
    got, want = FaceShardDataSource(shard), JaxDataSource(shard)
    assert len(got) == len(want) == 6
    for i in range(6):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["label"] == b["label"] and a["label"].dtype == np.int32


def test_seeded_loader_gives_the_same_order_twice(tmp_path):
    listing, root = _image_tree(tmp_path, n=10)
    shard = str(tmp_path / "d.faceshard")
    pack_image_list(listing, shard, root=root)

    def batches(seed):
        return [(b["image"].clone(), b["label"].clone())
                for b in make_grain_dataset(shard, batch_size=4, seed=seed)]

    first, again, other = batches(3), batches(3), batches(4)
    assert len(first) == 2                       # drop-remainder: 10 // 4
    assert first[0][0].shape == (4, 20, 20, 3)
    assert first[0][0].dtype == torch.uint8
    assert first[0][1].dtype == torch.int32
    for (xa, la), (xb, lb) in zip(first, again):
        assert torch.equal(xa, xb) and torch.equal(la, lb)
    assert any(not torch.equal(xa, xb)
               for (xa, _), (xb, _) in zip(first, other))
