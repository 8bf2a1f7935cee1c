"""Host-side input for extraction: record source, resize, decode pool.

The part of ``tf_face_toolbox_tpu/data/pipeline.py`` that extraction
uses. Everything here runs on the host in numpy; the training
iterators and the device prefetch come with the training slice.
"""

from __future__ import annotations

import io
import queue
import threading

import numpy as np

from tf_face_toolbox_tpu_torch.data.format import (
    PAYLOAD_RAW,
    ShardReader,
    read_index,
)


def _decode_jpeg(blob: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(blob))
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


class FaceShardSource:
    """Deterministic, shardable record source over one FaceShard file."""

    def __init__(self, path: str, *, seed: int = 0,
                 host_index: int = 0, host_count: int = 1):
        self.index = read_index(path)
        self.reader = ShardReader(self.index)
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        ids = np.arange(self.index.count)
        self._host_ids = ids[ids % host_count == host_index]

    @property
    def num_records(self) -> int:
        return len(self._host_ids)

    @property
    def num_classes(self) -> int:
        return int(self.index.labels.max()) + 1 if self.index.count else 0

    def epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(self._host_ids)

    def record(self, rid: int) -> tuple[np.ndarray, int]:
        if self.index.payload == PAYLOAD_RAW:
            img = self.reader.raw(rid)
        else:
            img = _decode_jpeg(self.reader.blob(rid))
        return img, self.reader.label(rid)


def _resize_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Half-pixel bilinear resize with the same matrices as the device
    resize (ops/preprocess) and the native C++ loader, so the loader
    choice never changes pixels. (PIL's BILINEAR antialiases on
    downscale and diverges; don't substitute it.)"""
    if img.shape[0] == h and img.shape[1] == w:
        return img
    from tf_face_toolbox_tpu_torch.ops.preprocess import _bilinear_matrix
    rh = _bilinear_matrix(h, img.shape[0])          # (h, H)
    rw = _bilinear_matrix(w, img.shape[1])          # (w, W)
    out = np.einsum("oh,hwc->owc", rh, img.astype(np.float32))
    out = np.einsum("pw,owc->opc", rw, out)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


class _DecodePool:
    """Fixed thread pool that decodes a batch of record ids in parallel."""

    def __init__(self, source: FaceShardSource, num_threads: int):
        self.source = source
        self._in: queue.Queue = queue.Queue()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            slot, rid, out, done, transform = item
            # A raising record (corrupt JPEG, bad id) must not kill the
            # worker silently: decode() would then wait forever.
            try:
                img, lab = self.source.record(rid)
                if transform is not None:
                    img = transform(img)
                out[slot] = (img, lab)
                done.put((slot, None))
            except Exception as e:  # noqa: BLE001 — reraised in decode()
                done.put((slot, e))

    def decode(self, ids, transform=None) -> list:
        out = [None] * len(ids)
        done: queue.Queue = queue.Queue()
        for i, rid in enumerate(ids):
            self._in.put((i, int(rid), out, done, transform))
        error = None
        for _ in ids:
            _, err = done.get()
            error = error or err
        if error is not None:
            raise error
        return out

    def close(self):
        for _ in self._threads:
            self._in.put(None)
