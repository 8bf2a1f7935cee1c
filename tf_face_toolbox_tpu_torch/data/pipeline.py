"""Host-side input: record source, resize, decode pool, the training
iterators, and prefetch to the host and the device.

Counterpart of ``tf_face_toolbox_tpu/data/pipeline.py``: an epoch is a
seeded permutation of record ids (exact resume from (epoch, step)),
decode runs on host threads or in the native C++ loader, and
augmentation is left to the train step on the device. Several shards
train as one weighted mixture (``mixed_batch_iterator``); P identities
of K images each make a batch for the metric losses
(``balanced_batch_iterator``).
"""

from __future__ import annotations

import collections
import io
import queue
import threading
from typing import Iterator

import numpy as np
import torch

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


def batch_iterator(source: FaceShardSource, batch_size: int, *,
                   start_epoch: int = 0, start_step: int = 0,
                   num_threads: int = 4,
                   resize_to: tuple[int, int] | None = None
                   ) -> Iterator[dict]:
    """Infinite (epoch-cycling) iterator of {'image', 'label', 'epoch',
    'step'} numpy batches; a partial last batch of an epoch is dropped.

    Resume: pass the (epoch, step within the epoch) to continue where a
    run left off. ``resize_to=(h, w)``: resize decodes to one geometry
    (needed for mixed-size JPEG shards; the native loader's pixels).
    """
    steps_per_epoch = source.num_records // batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"dataset has {source.num_records} records (per host) — "
            f"smaller than one batch of {batch_size}")
    epoch, step = start_epoch, start_step
    transform = ((lambda im: _resize_u8(im, *resize_to))
                 if resize_to is not None else None)
    pool = _DecodePool(source, num_threads) if num_threads > 1 else None
    try:
        while True:
            order = source.epoch_order(epoch)
            while step < steps_per_epoch:
                ids = order[step * batch_size:(step + 1) * batch_size]
                if pool is not None:
                    records = pool.decode(ids, transform)
                else:
                    records = [source.record(int(i)) for i in ids]
                    if transform is not None:
                        records = [(transform(img), lab)
                                   for img, lab in records]
                yield {"image": np.stack([r[0] for r in records]),
                       "label": np.asarray([r[1] for r in records],
                                           np.int32),
                       "epoch": epoch, "step": step}
                step += 1
            epoch, step = epoch + 1, 0
    finally:
        if pool is not None:
            pool.close()


def balanced_batch_iterator(source: FaceShardSource, *,
                            ids_per_batch: int, images_per_id: int,
                            start_step: int = 0, num_threads: int = 4,
                            resize_to: tuple[int, int] | None = None
                            ) -> Iterator[dict]:
    """P x K identity-balanced batches (P identities, K images of each),
    so the triplet and center losses always see positives.

    Step s draws from ``np.random.default_rng((source.seed, s))``: P of
    the identities with at least K of this host's records, then K of
    each one's records, in the JAX sampler's calls and order, so the
    record ids are the JAX package's for the same shard and host. It is
    resumed by ``start_step`` alone (no epochs: ``'epoch'`` is 0).
    ``resize_to=(h, w)``: ``batch_iterator``'s decode geometry.
    """
    labels = source.index.labels
    host_set = set(source._host_ids.tolist())
    by_id: dict[int, list] = {}
    for rid, lab in enumerate(labels):
        if rid in host_set:
            by_id.setdefault(int(lab), []).append(rid)
    eligible = [lab for lab, rids in by_id.items()
                if len(rids) >= images_per_id]
    if len(eligible) < ids_per_batch:
        raise ValueError(
            f"only {len(eligible)} identities have >= {images_per_id} "
            f"images; need {ids_per_batch}")
    eligible = np.asarray(sorted(eligible))
    id_arrays = {lab: np.asarray(by_id[lab]) for lab in eligible}
    transform = ((lambda im: _resize_u8(im, *resize_to))
                 if resize_to is not None else None)
    pool = _DecodePool(source, num_threads) if num_threads > 1 else None
    step = start_step
    try:
        while True:
            rng = np.random.default_rng((source.seed, step))
            chosen = rng.choice(eligible, ids_per_batch, replace=False)
            ids = np.concatenate([
                rng.choice(id_arrays[lab], images_per_id, replace=False)
                for lab in chosen])
            if pool is not None:
                records = pool.decode(ids, transform)
            else:
                records = [source.record(int(i)) for i in ids]
                if transform is not None:
                    records = [(transform(img), lab)
                               for img, lab in records]
            yield {"image": np.stack([r[0] for r in records]),
                   "label": np.asarray([r[1] for r in records], np.int32),
                   "epoch": 0, "step": step}
            step += 1
    finally:
        if pool is not None:
            pool.close()


def _native_epoch_batches(source: FaceShardSource, batch_size: int, *,
                          start_epoch: int, start_step: int,
                          num_threads: int, fetch) -> Iterator[dict]:
    """The native-loader iterators' epoch, ordering and resume loop (the
    same as ``batch_iterator``'s); ``fetch(reader, ids)`` makes the
    batch's images. Pages in the next batch's records while this one
    decodes."""
    from tf_face_toolbox_tpu_torch.data.native import NativeShardReader

    reader = NativeShardReader(source.index.path, num_threads=num_threads)
    steps_per_epoch = source.num_records // batch_size
    if steps_per_epoch == 0:
        reader.close()
        raise ValueError(
            f"dataset has {source.num_records} records (per host) — "
            f"smaller than one batch of {batch_size}")
    epoch, step = start_epoch, start_step
    try:
        while True:
            order = source.epoch_order(epoch)
            while step < steps_per_epoch:
                ids = order[step * batch_size:(step + 1) * batch_size]
                if step + 1 < steps_per_epoch:
                    reader.prefetch(order[(step + 1) * batch_size:
                                          (step + 2) * batch_size])
                yield {"image": fetch(reader, ids),
                       "label": reader.labels[ids],
                       "epoch": epoch, "step": step}
                step += 1
            epoch, step = epoch + 1, 0
    finally:
        reader.close()


def native_batch_iterator(source: FaceShardSource, batch_size: int, *,
                          out_h: int, out_w: int,
                          start_epoch: int = 0, start_step: int = 0,
                          num_threads: int = 4) -> Iterator[dict]:
    """``batch_iterator`` with decode and resize in the native C++
    loader: the same ordering, labels and resume; images are (batch,
    out_h, out_w, 3) uint8."""
    return _native_epoch_batches(
        source, batch_size, start_epoch=start_epoch,
        start_step=start_step, num_threads=num_threads,
        fetch=lambda reader, ids: reader.decode_batch(ids, out_h, out_w))


def native_dct_batch_iterator(source: FaceShardSource, batch_size: int, *,
                              size: int, start_epoch: int = 0,
                              start_step: int = 0,
                              num_threads: int = 4) -> Iterator[dict]:
    """``native_batch_iterator`` with entropy decode only on the host:
    ``image`` is the (coef, qtab) pair of ``NativeShardReader.dct_batch``
    for the train step to finish on the device (``input_format="dct"``,
    ``ops/jpeg.decode_dct``). Needs a uniform 4:4:4 shard of exactly
    ``size`` x ``size`` faces (``cli.pack --recode_size``, size =
    crop_from). The same ordering, labels and resume."""
    return _native_epoch_batches(
        source, batch_size, start_epoch=start_epoch,
        start_step=start_step, num_threads=num_threads,
        fetch=lambda reader, ids: reader.dct_batch(ids, size, size))


def mixture_sources(paths, *, seed: int = 0, host_index: int = 0,
                    host_count: int = 1) -> list[FaceShardSource]:
    """The readers of a shard mixture, source i shuffled with seed ``seed
    + 9973 * i`` (decorrelated permutations), each over this host's
    records. Pass them back to ``mixed_batch_iterator`` (``sources=``)
    so each index is opened once."""
    return [FaceShardSource(p, seed=seed + 9973 * i, host_index=host_index,
                            host_count=host_count)
            for i, p in enumerate(paths)]


def mixed_batch_iterator(paths, batch_size: int, *, weights=None,
                         seed: int = 0, start_step: int = 0,
                         resize_to: tuple[int, int] | None = None,
                         num_threads: int = 4, host_index: int = 0,
                         host_count: int = 1,
                         sources: list[FaceShardSource] | None = None,
                         ) -> Iterator[dict]:
    """Weighted online mixture over several FaceShards, as the JAX
    package's: each step draws its whole batch from one source, picked
    by ``weights`` from one choice stream seeded (seed, 0x313E), the
    same on every host. Identity spaces are disjoint: source i's labels
    are offset by the summed ``num_classes`` of the sources before it,
    and training uses their sum.

    Resume: pass the global step; the choice stream's first
    ``start_step`` draws are replayed and each source's iterator resumes
    at the (epoch, step) of the batches it has given. A plain function
    (not a generator), so argument errors raise at the call. Yields
    {'image', 'label', 'source', 'step'}.
    """
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]
    n = len(paths)
    if n < 2:
        raise ValueError("mixed_batch_iterator needs >= 2 shards; "
                         "use batch_iterator for one")
    w = np.asarray([1.0] * n if weights is None else weights, np.float64)
    if len(w) != n or (w <= 0).any():
        raise ValueError(f"need {n} positive weights, got {list(w)}")
    cum = np.cumsum(w / w.sum())
    if sources is None:
        sources = mixture_sources(paths, seed=seed, host_index=host_index,
                                  host_count=host_count)
    offsets = np.concatenate(
        [[0], np.cumsum([s.num_classes for s in sources])[:-1]]
    ).astype(np.int64)

    choice_rng = np.random.default_rng((seed, 0x313E))
    consumed = [0] * n
    if start_step:
        prefix = np.searchsorted(cum, choice_rng.random(start_step),
                                 side="right").clip(0, n - 1)
        for i in range(n):
            consumed[i] = int((prefix == i).sum())

    iters = []
    for i, s in enumerate(sources):
        spe = s.num_records // batch_size
        if spe == 0:
            raise ValueError(f"{paths[i]}: {s.num_records} records (per "
                             f"host), smaller than one batch of {batch_size}")
        iters.append(batch_iterator(
            s, batch_size, start_epoch=consumed[i] // spe,
            start_step=consumed[i] % spe, num_threads=num_threads,
            resize_to=resize_to))

    def gen():
        t = start_step
        while True:
            i = int(np.searchsorted(cum, choice_rng.random(),
                                    side="right").clip(0, n - 1))
            b = next(iters[i])
            yield {"image": b["image"],
                   "label": (b["label"].astype(np.int64)
                             + offsets[i]).astype(np.int32),
                   "source": i, "step": t}
            t += 1

    return gen()


def host_prefetch(it: Iterator[dict], *, depth: int = 2) -> Iterator[dict]:
    """Run ``it`` (decode and batch) in a background thread, keeping
    ``depth`` batches ready. Exceptions reach the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def producer():
        try:
            for item in it:
                q.put(item)
        except Exception as e:  # noqa: BLE001 — reraised below
            q.put(e)
            return
        q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, Exception):
            raise item
        yield item


def device_prefetch(it: Iterator[dict], *, depth: int = 2,
                    device="cuda") -> Iterator[dict]:
    """Keep ``depth`` batches on ``device`` ahead of the consumer.

    On a CUDA device each batch's arrays go through pinned memory and
    are copied on a side stream; the consumer's stream waits on the
    copy's event before the batch is yielded. Elsewhere the arrays
    become tensors on ``device``. A tuple of arrays (the DCT loader's
    (coef, qtab)) moves array by array.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    buf: collections.deque = collections.deque()

    def move(v):
        if isinstance(v, tuple) and all(isinstance(a, np.ndarray)
                                        for a in v):
            return tuple(move(a) for a in v)
        if not isinstance(v, np.ndarray):
            return v
        t = torch.from_numpy(v)
        if not cuda:
            return t.to(device)
        with torch.cuda.stream(stream):
            return t.pin_memory().to(device, non_blocking=True)

    def put(item):
        out = {k: move(v) for k, v in item.items()}
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def ready(entry):
        out, event = entry
        if event is not None:
            main = torch.cuda.current_stream(device)
            main.wait_event(event)
            for v in out.values():
                for t in (v if isinstance(v, tuple) else (v,)):
                    if isinstance(t, torch.Tensor):
                        t.record_stream(main)
        return out

    for item in it:
        buf.append(put(item))
        if len(buf) >= depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())
