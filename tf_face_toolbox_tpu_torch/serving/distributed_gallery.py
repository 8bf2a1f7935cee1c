"""Sharded enrollment gallery: the daemon's 1:N store at N times one
device's memory.

Counterpart of ``tf_face_toolbox_tpu/serving/distributed_gallery.py``,
with the surface of :class:`~tf_face_toolbox_tpu_torch.serving.gallery.
DeviceGallery` (the daemon duck-types between the two). The JAX store
takes a mesh's ``data`` axis; this one takes ``devices``, one
``torch.device`` per shard, in one process. A device may repeat: the
tests run ``[cpu] * n`` and a one-GPU host ``[cuda:0] * 4``.

- **Striped layout.** Global row ``g`` lives on shard ``s = g % n`` at
  local slot ``g // n``, so shard ``s`` holds ceil((fill - s) / n)
  rows: the ``n_valid`` of its top-k kernel.
- **Per-shard stores.** Each shard keeps a (local_cap, width) store of
  the gallery's dtype (rows padded to 16 bytes, as ``DeviceGallery``
  pads them), int8 row scales and a tombstone bias. Capacity grows in
  ``block`` rows a shard. Enrolls append at each shard's own fill; a
  block-boundary growth copies on the device up to
  ``grow_on_device_max`` bytes a shard and re-uploads from the host past
  it.
- **Search.** Each shard runs kernel 3 (f32/bf16, ``ops/topk.
  cosine_topk``) or kernel 4 (the int8 coarse stage, ``cosine_topk_q``)
  over its rows, all shards launched before any is read; the (B, k)
  candidates of each go to the first shard's device, indices mapped to
  global rows, and a stable top-k over the shard-major concatenation
  merges them. That is JAX's ``lax.top_k`` over its all-gathered
  candidates: equal scores rank by (shard, local slot), not by global
  row. int8 keeps the two stages: the merged coarse candidates, in
  merged order, go through ``serving.gallery._rescore``. A CPU store
  runs the kernels' plain versions; ``use_kernels = False`` selects them
  on the card too (never automatically).
- **Capacity.** ``hbm_limit_gb`` bounds each shard (0 = unbounded);
  past it enrolls raise :class:`GalleryCapacityError` (the daemon's
  507). ``overflow`` is always "refuse".
- **Host master, tombstones, snapshots** as ``DeviceGallery``: the f32
  master and labels in host order, O(1) ``remove`` through the bias,
  compaction past ``compact_frac``, and the same ``.npz``.
"""

from __future__ import annotations

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.ops import topk
from tf_face_toolbox_tpu_torch.serving.gallery import (
    _DTYPES,
    _TOMB,
    GalleryCapacityError,
    _pad_cols,
    _quantize_rows,
    _ReadersWriterGate,
    _rescore,
    append_host,
    compact_host,
    row_width,
    save_snapshot,
    scan_chunk,
    search_store,
    store_rows,
)


def default_devices() -> list[torch.device]:
    """Every visible CUDA device."""
    n = torch.cuda.device_count()
    if not n:
        raise RuntimeError("no CUDA device is visible: pass devices=, e.g. "
                           "[torch.device('cpu')] * 4")
    return [torch.device("cuda", i) for i in range(n)]


class DistributedGallery:
    """Enroll/identify store with rows striped over ``devices``.

    ``devices``: one torch device per shard (default: every visible
    CUDA device); repeats are allowed. ``block``: per-shard capacity
    granularity (rows). ``hbm_limit_gb``: per-shard store bound.
    """

    overflow = "refuse"

    def __init__(self, dim: int, *, devices=None, block: int = 1024,
                 dtype: str = "float32", hbm_limit_gb: float = 8.0):
        if dim < 1 or block < 1:
            raise ValueError(f"bad dim={dim} / block={block}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32|bfloat16|int8, "
                             f"got {dtype!r}")
        devices = default_devices() if devices is None else devices
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("devices is empty")
        self.n_dev = len(self.devices)
        self.dim = int(dim)
        self.block = int(block)
        self.dtype = dtype
        self.itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
        self._width = row_width(self.dim, self.itemsize)
        self.rescore_expand = 4
        self.hbm_limit_gb = float(hbm_limit_gb)
        # per-shard bytes past which growth re-uploads from the host
        self.grow_on_device_max = 2_000_000_000
        # past this (B, local_cap) f32 score footprint the plain programs
        # search a shard in row chunks (DeviceGallery.scan_sims_bytes)
        self.scan_sims_bytes = 3 << 30
        # False: the kernels' plain PyTorch versions (never automatic)
        self.use_kernels = True
        self.compact_frac = 0.25
        self._tomb = 0
        self._gate = _ReadersWriterGate()
        self._host = np.zeros((0, dim), np.float32)
        self._lab = np.zeros((0,), np.int64)
        self._bias = np.zeros((0,), np.float32)
        self._n = 0                         # fill (live + tombstoned rows)
        self._dev = [None] * self.n_dev     # (local_cap, _width) a shard
        self._dev_scale = [None] * self.n_dev   # (local_cap,) f32, int8
        self._dev_bias = [None] * self.n_dev    # (local_cap,) f32

    # ------------------------------------------------------------ sizing

    def __len__(self) -> int:
        """LIVE enrollment count (fill minus tombstones)."""
        with self._gate.cond:
            return self._n - self._tomb

    @property
    def streaming(self) -> bool:
        return False

    def _local_cap_for(self, n: int) -> int:
        fill = -(-max(n, 1) // self.n_dev)      # the fullest shard's rows
        return -(-fill // self.block) * self.block

    def _shard_rows(self, n: int, s: int) -> int:
        """Rows of shard ``s`` at fill ``n``: ceil((n - s) / n_dev)."""
        return max(0, (n - s + self.n_dev - 1) // self.n_dev)

    def _bytes_for(self, n: int) -> int:
        """Per-shard store bytes at fill ``n`` (rows and int8 scales;
        the tombstone bias is not counted, as in DeviceGallery)."""
        per_row = self.dim * self.itemsize
        if self.dtype == "int8":
            per_row += 4
        return self._local_cap_for(n) * per_row

    def device_bytes(self, rows: int | None = None) -> int:
        """All shards' footprint at ``rows`` fill (default: the current
        fill, tombstoned rows included)."""
        with self._gate.cond:
            n = self._n if rows is None else rows
        return self._bytes_for(n) * self.n_dev

    # ----------------------------------------------------------- enroll

    def enroll(self, embeddings: np.ndarray, labels) -> int:
        """Append embeddings (N, D) with int labels (N,); → new live
        size. Raises :class:`GalleryCapacityError` when a shard's grown
        store would exceed ``hbm_limit_gb`` (after reclaiming any
        tombstoned rows by compaction)."""
        embeddings = np.asarray(embeddings, np.float32)
        if embeddings.ndim == 1:
            embeddings = embeddings[None]
        labels = np.atleast_1d(np.asarray(labels, np.int64))
        if embeddings.shape != (labels.shape[0], self.dim):
            raise ValueError(
                f"embeddings {embeddings.shape} vs labels "
                f"{labels.shape} / dim {self.dim}")
        with self._gate.write():
            new_n = self._n + embeddings.shape[0]
            need = self._bytes_for(new_n)
            over = self.hbm_limit_gb and need > self.hbm_limit_gb * 1e9
            if over and self._tomb:
                self._compact_locked()      # reclaim before refusing
                new_n = self._n + embeddings.shape[0]
                need = self._bytes_for(new_n)
                over = need > self.hbm_limit_gb * 1e9
            if over:
                total = need * self.n_dev / 1e9
                raise GalleryCapacityError(
                    f"enrolling {embeddings.shape[0]} rows would grow "
                    f"each of the {self.n_dev} shards to "
                    f"{need / 1e9:.3g} GB (total {total:.3g} GB) > "
                    f"hbm_limit_gb={self.hbm_limit_gb:g}/device at "
                    f"dtype={self.dtype}. Options: dtype='bfloat16' "
                    f"(2x rows) or 'int8' (~4x, exact-rescored), a "
                    f"bigger mesh, raise hbm_limit_gb, or shard "
                    f"offline with cli.search")
            offset = append_host(self, embeddings, labels,
                                 self.block * self.n_dev)
            self._sync_locked(new_rows=embeddings, offset=offset)
            return self._n - self._tomb

    def _free_device(self) -> None:
        self._dev = [None] * self.n_dev
        self._dev_scale = [None] * self.n_dev
        self._dev_bias = [None] * self.n_dev

    def _sync_locked(self, new_rows: np.ndarray | None = None,
                     offset: int = 0) -> None:
        """Bring every shard's store up to date. ``new_rows`` (global
        rows ``offset`` on) enables the incremental path: an in-place
        append at each shard's fill, or a grow on the device; None
        forces a full upload from the host master (compaction, past
        ``grow_on_device_max``). Caller holds the write gate."""
        n = self._n
        local_cap = self._local_cap_for(n)
        cur = self._dev[0].shape[0] if self._dev[0] is not None else -1
        if new_rows is not None and self._dev[0] is not None:
            per_shard = local_cap * self.dim * self.itemsize
            if local_cap == cur or per_shard <= self.grow_on_device_max:
                for s in range(self.n_dev):
                    self._append_shard(s, new_rows, offset, local_cap)
                return
        # full upload, shard by shard in ~0.5 GB slabs, the outgoing
        # stores freed first
        self._free_device()
        if n == 0:
            return
        slab = max(self.block, (1 << 29) // (self.dim * 4))
        for s, dev in enumerate(self.devices):
            rows_s = self._shard_rows(n, s)
            store = torch.zeros((local_cap, self._width),
                                dtype=_DTYPES[self.dtype], device=dev)
            scale = (torch.zeros((local_cap,), dtype=torch.float32,
                                 device=dev)
                     if self.dtype == "int8" else None)
            for i in range(0, rows_s, slab):
                j = min(i + slab, rows_s)
                # global rows (i..j) * n_dev + s: a strided host view
                rows, sc = store_rows(
                    self._host[i * self.n_dev + s:(j - 1) * self.n_dev
                               + s + 1:self.n_dev],
                    self.dtype, self._width, dev)
                store[i:j].copy_(rows)
                if sc is not None:
                    scale[i:j].copy_(sc)
            bias = np.zeros((local_cap,), np.float32)
            bias[:rows_s] = self._bias[s:n:self.n_dev]
            self._dev[s] = store
            self._dev_scale[s] = scale
            self._dev_bias[s] = torch.from_numpy(bias).to(dev)

    def _append_shard(self, s: int, new_rows: np.ndarray, offset: int,
                      local_cap: int) -> None:
        """Write the rows of ``new_rows`` (global rows ``offset`` on)
        that land on shard ``s`` at its own fill, growing its store on
        the device when ``local_cap`` passed its capacity."""
        m = new_rows.shape[0]
        off = self._shard_rows(offset, s)           # shard s's old fill
        end = self._shard_rows(offset + m, s)
        dev = self.devices[s]
        rows = scale = None
        if end > off:
            first = off * self.n_dev + s - offset   # its first new row
            rows, scale = store_rows(new_rows[first::self.n_dev],
                                     self.dtype, self._width, dev)
        if local_cap != self._dev[s].shape[0]:
            old = self._dev[s].shape[0]
            grown = torch.zeros((local_cap, self._width),
                                dtype=_DTYPES[self.dtype], device=dev)
            grown[:old].copy_(self._dev[s])
            self._dev[s] = grown
            if self.dtype == "int8":
                gs = torch.zeros((local_cap,), dtype=torch.float32,
                                 device=dev)
                gs[:old].copy_(self._dev_scale[s])
                self._dev_scale[s] = gs
            gb = torch.zeros((local_cap,), dtype=torch.float32, device=dev)
            gb[:old].copy_(self._dev_bias[s])
            self._dev_bias[s] = gb
        if rows is not None:
            # in place: the write gate has drained every search; fresh
            # rows' bias is already 0
            self._dev[s][off:end].copy_(rows)
            if scale is not None:
                self._dev_scale[s][off:end].copy_(scale)

    # ----------------------------------------------------------- search

    def search(self, embeddings: np.ndarray, k: int = 5):
        """Top-``k`` matches per probe → (labels (B, k) int64, scores
        (B, k) f32), exact at any fill; equal scores in JAX's
        shard-major order. Probes and gallery are assumed
        L2-normalized; ``k`` clamps to the live size."""
        with self._gate.read():
            n = self._n
            n_live = self._n - self._tomb
            labels = self._lab[:n]
            host = self._host
            bias = self._bias
            shards = list(zip(self._dev, self._dev_scale, self._dev_bias))
            if n_live == 0:
                raise ValueError("gallery is empty — enroll first")
            k = min(int(k), n_live)
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            e = np.asarray(embeddings, np.float32)
            if e.ndim == 1:
                e = e[None]
            if e.shape[1] != self.dim:
                raise ValueError(
                    f"probe dim {e.shape[1]} != {self.dim}")
            if self.dtype == "int8":
                kc = min(k * self.rescore_expand, n_live)
                _, cand = self._merged_topk(shards, n, kc, e)
                idx, scores = _rescore(host, n, e, cand, k, bias)
            else:
                scores, idx = self._merged_topk(shards, n, k, e)
            return labels[idx], np.asarray(scores)

    def _merged_topk(self, shards: list, n: int, k: int, e: np.ndarray):
        """Each shard's top-min(k, local_cap), launched on every shard
        before any is read, then merged on the first shard's device: a
        stable top-``k`` over the shard-major candidates. → host
        (scores (B, k) f32, global rows (B, k) int64)."""
        q8 = self.dtype == "int8"
        if q8:
            pq, ps = _quantize_rows(e)
            host_p = _pad_cols(pq, self._width)
        else:
            host_p = _pad_cols(e, self._width)
        probes = {}
        parts = []
        for s, (store, scale, sbias) in enumerate(shards):
            dev = self.devices[s]
            if dev not in probes:
                probes[dev] = torch.from_numpy(host_p).to(dev)
            k_local = min(k, store.shape[0])
            n_valid = self._shard_rows(n, s)
            sc, ix = search_store(self, store, sbias, n_valid, k_local,
                                  probes[dev], scale,
                                  torch.from_numpy(ps) if q8 else None)
            parts.append((sc, ix.to(torch.int64) * self.n_dev + s))
        dev0 = self.devices[0]
        scores = torch.cat([sc.to(dev0) for sc, _ in parts], dim=1)
        rows = torch.cat([ix.to(dev0) for _, ix in parts], dim=1)
        top, pos = topk.stable_topk(scores, k)
        picked = torch.gather(rows, 1, pos.to(torch.int64))
        return top.cpu().numpy(), picked.cpu().numpy()

    def _scan_chunk(self, batch: int, cap: int) -> int:
        return scan_chunk(self, batch, cap)

    # ----------------------------------------------------------- remove

    def remove(self, label: int) -> int:
        """Drop every enrollment of ``label``; → rows removed. O(removed):
        marks the rows in each shard's tombstone bias; compaction (a full
        re-upload) waits until tombstones pass ``compact_frac`` of the
        fill or the store empties."""
        with self._gate.write():
            fill = self._n
            hit = ((self._lab[:fill] == int(label))
                   & (self._bias[:fill] == 0.0))
            removed = int(hit.sum())
            if not removed:
                return 0
            idx = np.nonzero(hit)[0]
            self._bias[idx] = _TOMB
            self._tomb += removed
            if (fill == self._tomb
                    or self._tomb >= max(self.block,
                                         self.compact_frac * fill)):
                self._compact_locked()
            elif self._dev_bias[0] is not None:
                for s, dev in enumerate(self.devices):
                    slots = idx[idx % self.n_dev == s] // self.n_dev
                    if len(slots):
                        self._dev_bias[s][torch.from_numpy(slots).to(dev)] \
                            = _TOMB
            return removed

    def _compact_locked(self) -> int:
        """Rebuild without tombstoned rows (in place on the host: the
        write gate drained every reader) and re-upload every shard."""
        kept = compact_host(self)
        self._sync_locked()
        return kept

    # ------------------------------------------------------ persistence

    def save(self, path: str) -> int:
        """Atomic snapshot (live rows only) → .npz, DeviceGallery's
        format; returns the row count written."""
        return save_snapshot(self, path)

    @classmethod
    def load(cls, path: str, *, devices=None, block: int = 1024,
             dtype: str = "float32",
             hbm_limit_gb: float = 8.0) -> "DistributedGallery":
        data = np.load(path, allow_pickle=False)
        emb = np.asarray(data["embeddings"], np.float32)
        g = cls(emb.shape[1], devices=devices, block=block, dtype=dtype,
                hbm_limit_gb=hbm_limit_gb)
        if emb.shape[0]:
            g.enroll(emb, data["labels"])
        return g
