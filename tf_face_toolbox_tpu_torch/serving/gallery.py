"""Device-resident enrollment gallery: 1:N identification.

Counterpart of ``tf_face_toolbox_tpu/serving/gallery.py``. Enrolled
embeddings live on the device as one (capacity, D) tensor padded in
``block``-row steps; searches mask the padded tail, so scores are exact
at any fill. The host keeps the f32 master copy (exact save/reload, the
int8 rescore) in doubling-capacity buffers.

- **Stores.** ``dtype`` "float32", "bfloat16" (half the bytes; scores
  still accumulate in f32) or "int8" (per-row symmetric scales, a
  quarter of the bytes). int8 search is two-stage: a coarse top
  ``k * rescore_expand`` on the quantized store, then an exact f32
  rescore of only those rows against the host master (``_rescore``).
- **Search.** On a CUDA store every search, resident or streamed, runs
  kernel 3 (f32/bf16, ``ops/topk.cosine_topk``) or kernel 4 (int8
  coarse stage, ``cosine_topk_q``). The kernels take any capacity,
  batch and k. ``use_kernels=False`` selects their plain PyTorch
  versions (chunked past ``scan_sims_bytes``, like the JAX scan
  program); it is never chosen automatically. A CPU store runs the
  plain versions.
- **Any row width.** The device store and each probe batch are
  zero-padded to a row of a multiple of 16 bytes (the kernels' row
  unit), on every device: the zeros add exactly nothing to a dot, and
  to an int8 row's max|x| and quantized values. The capacity bound
  counts ``dim`` columns, as the JAX gallery does.
- **Incremental sync.** Enrolling appends only the new rows: within
  capacity an in-place ``copy_`` into the store under the write gate,
  at a block boundary a new allocation plus copy. A CUDA store receives
  f32 rows and casts or quantizes them on the card (``store_rows``);
  the host master's copies and gathers run on every core.
- **Capacity bound.** ``hbm_limit_gb`` (default 8, 0 = unbounded)
  refuses enrollments whose store would outgrow it with
  :class:`GalleryCapacityError`, or with ``overflow="stream"`` frees the
  store and streams the host master through the device in slabs of
  ``stream_slab_bytes``, merging the per-slab winners on the host.
- **O(1) deenroll.** ``remove()`` marks rows in a per-row f32 bias (0
  live, -2e9 dead) that every search adds before selecting; compaction
  is deferred until tombstones pass ``compact_frac`` of the fill.
- **Concurrency.** Searches hold the read side of a write-preferring
  gate and finish their device work inside it; every mutation holds
  the write side, so no search reads a store that is being rewritten.
- **Snapshots** are the JAX package's ``.npz`` (live rows only), so a
  snapshot from either package loads in the other.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from tf_face_toolbox_tpu_torch.ops import topk


class GalleryCapacityError(RuntimeError):
    """Enrollment would grow the device store past ``hbm_limit_gb``."""


# tombstoned-row score bias; matches the padding mask value, so dead
# rows lose to every live row (cosines are >= -1) in every program
_TOMB = -2e9

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


class _ReadersWriterGate:
    """Write-preferring readers/writer gate.

    ``read()``: searches capture references and run concurrently.
    ``write()``: waits for in-flight readers to drain (new readers
    queue behind any waiting writer, so writers never starve), then
    holds exclusive access for the whole mutation — which makes the
    donated in-place device appends and the in-place host compaction
    safe: no captured reference can be live when a buffer is donated
    or rewritten."""

    def __init__(self):
        self.cond = threading.Condition()
        self._readers = 0
        self._writers_waiting = 0

    @contextlib.contextmanager
    def read(self):
        with self.cond:
            while self._writers_waiting:
                self.cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self.cond:
                self._readers -= 1
                if not self._readers:
                    self.cond.notify_all()

    @contextlib.contextmanager
    def write(self):
        with self.cond:
            self._writers_waiting += 1
            try:
                while self._readers:
                    self.cond.wait()
                yield
            finally:
                self._writers_waiting -= 1
                self.cond.notify_all()


def _rescore(host: np.ndarray, n: int, probes: np.ndarray,
             cand: np.ndarray, k: int, bias: np.ndarray | None = None):
    """Exact f32 rescore of the int8 coarse candidates: gather the
    (B, kc) candidate rows from the host master, one small einsum,
    keep the true top-k. Final scores are exact f32 cosines.
    ``bias`` (the host tombstone vector) re-applies the dead-row mask
    — the coarse stage already excludes tombstones, but when kc
    exceeds the live count its padding candidates must not be
    resurrected by their (real, exact) host scores."""
    invalid = (cand < 0) | (cand >= n)     # belt-and-braces: masked
    cidx = np.clip(cand, 0, n - 1)         # winners can't surface, but
    gathered = host[cidx]                  # never index past the fill
    exact = np.einsum("bd,bkd->bk", probes, gathered,
                      optimize=True).astype(np.float32)
    if bias is not None:
        exact = exact + bias[cidx]
    exact[invalid] = -2e9
    rows = np.arange(exact.shape[0])[:, None]
    order = np.argsort(-exact, axis=1, kind="stable")[:, :k]
    return cidx[rows, order], exact[rows, order]


def _pad_cols(rows: np.ndarray, width: int) -> np.ndarray:
    """``rows`` with zero columns up to ``width``."""
    if rows.shape[1] == width:
        return np.ascontiguousarray(rows)
    out = np.zeros((rows.shape[0], width), rows.dtype)
    out[:, :rows.shape[1]] = rows
    return out


def row_width(dim: int, itemsize: int) -> int:
    """A store's row width: ``dim`` padded to a multiple of 16 bytes."""
    return -(-dim * itemsize // 16) * 16 // itemsize


def copy_rows(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` for host masters: torch's CPU copy runs on
    every core (a 10^7-row f32 master is 20 GB; numpy copies on one)."""
    if src.flags.writeable:
        torch.from_numpy(dst).copy_(torch.from_numpy(src))
    else:
        dst[...] = src


def take_rows(rows: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """``rows[keep]`` (a boolean row mask) as a new array, gathered on
    every core."""
    idx = torch.from_numpy(np.nonzero(keep)[0])
    return torch.from_numpy(rows).index_select(0, idx).numpy()


def append_host(gallery, embeddings: np.ndarray, labels: np.ndarray,
                min_cap: int) -> int:
    """Append rows to a store's host master (f32 rows, labels and the
    tombstone bias, in doubling buffers of at least ``min_cap`` rows);
    → the first new row's index. The caller holds the write gate."""
    n = gallery._n
    new_n = n + embeddings.shape[0]
    if new_n > gallery._host.shape[0]:
        new_cap = max(min_cap, 2 * gallery._host.shape[0], new_n)
        grown = np.zeros((new_cap, gallery.dim), np.float32)
        copy_rows(grown[:n], gallery._host[:n])
        gallery._host = grown
        glab = np.zeros((new_cap,), np.int64)
        glab[:n] = gallery._lab[:n]
        gallery._lab = glab
        gbias = np.zeros((new_cap,), np.float32)
        gbias[:n] = gallery._bias[:n]
        gallery._bias = gbias
    copy_rows(gallery._host[n:new_n], embeddings)
    gallery._lab[n:new_n] = labels
    gallery._bias[n:new_n] = 0.0
    gallery._n = new_n
    return n


def compact_host(gallery) -> int:
    """Drop the tombstoned rows of a store's host master, in place (the
    write gate has drained every reader); → the live count."""
    fill = gallery._n
    live = gallery._bias[:fill] == 0.0
    kept = int(live.sum())
    if kept != fill:
        copy_rows(gallery._host[:kept], take_rows(gallery._host[:fill], live))
        gallery._lab[:kept] = gallery._lab[:fill][live]
    gallery._bias[:fill] = 0.0
    gallery._n = kept
    gallery._tomb = 0
    return kept


def save_snapshot(gallery, path: str) -> int:
    """A store's live rows → an atomic ``.npz`` (embeddings, labels);
    → the row count written."""
    with gallery._gate.read():
        n = gallery._n
        live = gallery._bias[:n] == 0.0
        emb = take_rows(gallery._host[:n], live)
        labels = gallery._lab[:n][live]
    tmp = path + ".tmp.npz"
    np.savez(tmp, embeddings=emb, labels=labels)
    os.replace(tmp, path)
    return emb.shape[0]


def store_rows(rows: np.ndarray, dtype: str, width: int,
               device: torch.device):
    """Host f32 rows (a strided view is fine) → (store-dtype rows padded
    to ``width``, int8 scales or None) on ``device``. A CUDA store gets
    the f32 rows and casts or quantizes them on the card (bf16's
    round-to-nearest-even, and ``_quantize_rows``' f32 divisions and
    round-half-even, give the host's values bit for bit); a CPU store
    casts or quantizes on the host (never truncating to int8)."""
    device = torch.device(device)
    if device.type == "cuda":
        t = torch.from_numpy(rows).to(device)
        if width != t.shape[1]:
            t = F.pad(t, (0, width - t.shape[1]))
        if dtype != "int8":
            return t.to(_DTYPES[dtype]), None
        # a tensor divisor: torch turns division by a host scalar into a
        # product with its reciprocal, which rounds otherwise
        amax = t.abs().amax(dim=1)
        scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)
        q = torch.round(t / scale[:, None]).clamp_(-127, 127)
        return q.to(torch.int8), scale
    if dtype == "int8":
        q, scale = _quantize_rows(rows)
        return (torch.from_numpy(_pad_cols(q, width)).to(device),
                torch.from_numpy(scale).to(device))
    t = torch.from_numpy(_pad_cols(rows, width))
    return t.to(_DTYPES[dtype]).to(device), None


def _quantize_rows(rows: np.ndarray):
    """Per-row symmetric int8: scale = max|x|/127 (f32), q = x/scale.
    Unit embeddings quantize at ~1e-2 worst-case cosine error — the
    coarse stage of the int8 store; exactness comes from the f32
    rescore of the candidates (see DeviceGallery docstring)."""
    scale = np.abs(rows).max(axis=1) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.rint(rows / scale[:, None]), -127, 127)
    return q.astype(np.int8), scale


def scan_chunk(gallery, batch: int, cap: int) -> int:
    """Chunk rows for a chunked plain search of a (batch, cap) store, or
    0 for one pass: the per-step (B, chunk) scores stay near
    ``gallery.scan_sims_bytes``; chunking only pays off once the full
    (B, cap) scores would exceed that budget."""
    if batch * cap * 4 <= gallery.scan_sims_bytes:
        return 0
    r = max(gallery.block,
            min(gallery.scan_sims_bytes // (4 * batch), 1 << 21))
    r = (r // gallery.block) * gallery.block
    return r if cap > r else 0


def search_store(gallery, store, store_bias, n_valid: int, k: int, probes,
                 store_scale=None, probe_scale=None):
    """One search of a store, left on its device: kernel 3 or 4 (their
    plain versions on a CPU store), or with ``gallery.use_kernels``
    False the plain versions, in row chunks past ``scan_sims_bytes``.
    ``probes``: (B, width) on the store's device; int8 probes with
    their (B,) scales. → (scores (B, k) f32, rows (B, k) int32)."""
    if gallery.use_kernels:
        if store_scale is None:
            return topk.cosine_topk(store, probes, n_valid, k,
                                    bias=store_bias)
        return topk.cosine_topk_q(store, store_scale, probes, probe_scale,
                                  n_valid, k, bias=store_bias)
    chunk = scan_chunk(gallery, probes.shape[0], store.shape[0]) or \
        store.shape[0]
    if store_scale is None:
        return topk.cosine_topk_reference(store, probes, n_valid, k,
                                          bias=store_bias, chunk_rows=chunk)
    return topk.cosine_topk_q_reference(store, store_scale, probes,
                                        probe_scale, n_valid, k,
                                        bias=store_bias, chunk_rows=chunk)


class DeviceGallery:
    """Enroll/identify store over L2-normalized embeddings.

    ``block``: device capacity granularity (rows). ``dtype``:
    "float32" | "bfloat16" | "int8" device store (the host master stays
    f32; int8 searches are two-stage exact-rescored). ``hbm_limit_gb``:
    device-footprint bound (0 = unbounded); past it enrollments refuse
    (``overflow="refuse"``) or switch to streamed search
    (``overflow="stream"``). ``device``: where the store lives; a CUDA
    store searches through the top-k kernels.
    """

    def __init__(self, dim: int, *, block: int = 1024,
                 dtype: str = "float32", hbm_limit_gb: float = 8.0,
                 overflow: str = "refuse", device: str | torch.device = "cuda"):
        if dim < 1 or block < 1:
            raise ValueError(f"bad dim={dim} / block={block}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32|bfloat16|int8, "
                             f"got {dtype!r}")
        if overflow not in ("refuse", "stream"):
            raise ValueError(f"overflow must be refuse|stream, "
                             f"got {overflow!r}")
        self.dim = int(dim)
        self.block = int(block)
        self.dtype = dtype
        self.device = torch.device(device)
        self.itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
        # device row width: dim padded to a multiple of 16 bytes
        self._width = row_width(self.dim, self.itemsize)
        # int8 search: coarse top-(k * rescore_expand) on the device,
        # then the exact f32 rescore of only those rows on the host
        self.rescore_expand = 4
        self.hbm_limit_gb = float(hbm_limit_gb)
        self.overflow = overflow
        self._streaming = False
        # past this store size, block-boundary growth re-uploads from
        # the host instead of copying on the device (no 2x peak)
        self.grow_on_device_max = 2_000_000_000
        # streamed-search slab footprint (bytes of store dtype); tests
        # shrink it to exercise the multi-slab merge
        self.stream_slab_bytes = 1 << 29
        # past this (B, capacity) f32 score footprint the plain programs
        # (use_kernels=False) search in row chunks: a memory guard
        self.scan_sims_bytes = 3 << 30
        # False: the kernels' plain PyTorch versions (never automatic)
        self.use_kernels = True
        self.compact_frac = 0.25
        self._tomb = 0
        self._gate = _ReadersWriterGate()
        self._host = np.zeros((0, dim), np.float32)
        self._lab = np.zeros((0,), np.int64)
        self._bias = np.zeros((0,), np.float32)
        self._n = 0                 # fill (live + tombstoned rows)
        self._dev = None            # (capacity, _width) device tensor
        self._dev_scale = None      # (capacity,) f32, int8 store only
        self._dev_bias = None       # (capacity,) f32 tombstone bias

    def __len__(self) -> int:
        """LIVE enrollment count (fill minus tombstones)."""
        with self._gate.cond:
            return self._n - self._tomb

    def _capacity_for(self, n: int) -> int:
        return -(-max(n, 1) // self.block) * self.block

    def device_bytes(self, rows: int | None = None) -> int:
        """Device footprint at ``rows`` (default: current fill,
        INCLUDING tombstoned rows — they occupy memory until compaction)."""
        with self._gate.cond:
            n = self._n if rows is None else rows
        return self._bytes_for(n)

    def _bytes_for(self, n: int) -> int:
        # store rows (+ the int8 per-row scale); the tombstone bias and
        # transient score matrices are not counted
        per_row = self.dim * self.itemsize
        if self.dtype == "int8":
            per_row += 4
        return self._capacity_for(n) * per_row

    def enroll(self, embeddings: np.ndarray, labels) -> int:
        """Append embeddings (N, D) with int labels (N,); → new live
        size.

        Raises :class:`GalleryCapacityError` when the grown device
        store would exceed ``hbm_limit_gb`` (after reclaiming any
        tombstoned rows via compaction)."""
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
                # reclaim dead rows before refusing/streaming
                self._compact_locked()
                new_n = self._n + embeddings.shape[0]
                need = self._bytes_for(new_n)
                over = need > self.hbm_limit_gb * 1e9
            if over:
                if self.overflow == "stream":
                    if not self._streaming:
                        self._streaming = True
                        self._free_device()
                else:
                    raise GalleryCapacityError(
                        f"enrolling {embeddings.shape[0]} rows would "
                        f"grow the device store to {need / 1e9:.2f} GB "
                        f"> hbm_limit_gb={self.hbm_limit_gb:g} at "
                        f"dtype={self.dtype}. Options: "
                        f"dtype='bfloat16' (2x rows) or 'int8' (~4x, "
                        f"exact-rescored), overflow='stream' (exact "
                        f"streamed search), raise hbm_limit_gb, or "
                        f"search offline with cli.search")
            offset = append_host(self, embeddings, labels, self.block)
            if not self._streaming:
                self._sync_locked(new_rows=embeddings, offset=offset)
            return self._n - self._tomb

    @property
    def streaming(self) -> bool:
        """True once the store has overflowed into streamed search."""
        with self._gate.cond:
            return self._streaming

    def _free_device(self) -> None:
        self._dev = None
        self._dev_scale = None
        self._dev_bias = None

    def _store_rows(self, rows: np.ndarray):
        return store_rows(rows, self.dtype, self._width, self.device)

    def _sync_locked(self, new_rows: np.ndarray | None = None,
                     offset: int = 0) -> None:
        """Bring the device store up to date. ``new_rows`` enables the
        incremental path (append in place, or grow); None forces a full
        upload from the host master (first sync, compaction, load).
        Caller holds the write gate."""
        dt = _DTYPES[self.dtype]
        q8 = self.dtype == "int8"
        n = self._n
        cap = self._capacity_for(n)
        cap_bytes = cap * self.dim * self.itemsize
        cur_cap = self._dev.shape[0] if self._dev is not None else -1
        if new_rows is not None and self._dev is not None:
            rows, scale = self._store_rows(new_rows)
            end = offset + rows.shape[0]
            if cap == cur_cap:
                # in place: the write gate has drained every search
                self._dev[offset:end].copy_(rows)
                if q8:
                    self._dev_scale[offset:end].copy_(scale)
                # fresh rows' bias is already 0 (tombstones live below
                # the old fill)
                return
            if cap > cur_cap and cap_bytes <= self.grow_on_device_max:
                grown = torch.zeros((cap, self._width), dtype=dt,
                                    device=self.device)
                grown[:cur_cap].copy_(self._dev)
                grown[offset:end].copy_(rows)
                self._dev = grown
                if q8:
                    gs = torch.zeros((cap,), dtype=torch.float32,
                                     device=self.device)
                    gs[:cur_cap].copy_(self._dev_scale)
                    gs[offset:end].copy_(scale)
                    self._dev_scale = gs
                gb = torch.zeros((cap,), dtype=torch.float32,
                                 device=self.device)
                gb[:cur_cap].copy_(self._dev_bias)
                self._dev_bias = gb
                return
        # full upload in ~0.5 GB slabs into a store allocated on the
        # device; the outgoing store is freed first
        self._free_device()
        dev = torch.zeros((cap, self._width), dtype=dt, device=self.device)
        dscale = (torch.zeros((cap,), dtype=torch.float32, device=self.device)
                  if q8 else None)
        slab = max(self.block, (1 << 29) // (self.dim * 4))
        for i in range(0, n, slab):
            j = min(i + slab, n)
            rows, scale = self._store_rows(self._host[i:j])
            dev[i:j].copy_(rows)
            if q8:
                dscale[i:j].copy_(scale)
        bias = np.zeros((cap,), np.float32)
        bias[:n] = self._bias[:n]
        self._dev = dev
        self._dev_scale = dscale
        self._dev_bias = torch.from_numpy(bias).to(self.device)

    def search(self, embeddings: np.ndarray, k: int = 5):
        """Top-``k`` matches per probe → (labels (B,k) int64,
        scores (B,k) f32). Probes and gallery are assumed
        L2-normalized (the extractor's output); ``k`` clamps to the
        current live size."""
        with self._gate.read():
            n = self._n
            n_live = self._n - self._tomb
            dev = self._dev
            dev_scale = self._dev_scale
            dev_bias = self._dev_bias
            streaming = self._streaming
            labels = self._lab[:n]
            host = self._host
            bias = self._bias
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
                # two-stage: coarse over the quantized store, then the
                # exact f32 rescore of only the candidate rows
                kc = min(k * self.rescore_expand, n_live)
                if streaming:
                    cand, _ = self._stream_search(host, bias, n, e, kc)
                else:
                    pq, ps = _quantize_rows(e)
                    _, cand = self._topk(dev, dev_bias, n, kc, pq,
                                         dev_scale, ps)
                idx, scores = _rescore(host, n, e, cand, k, bias)
            elif streaming:
                idx, scores = self._stream_search(host, bias, n, e, k)
            else:
                scores, idx = self._topk(dev, dev_bias, n, k, e)
            return labels[idx], np.asarray(scores)

    def _topk(self, store, store_bias, n: int, k: int, probes: np.ndarray,
              store_scale=None, probe_scale=None):
        """One search of a device store → host (scores, int64 idx).
        Finishes on the device before returning, inside the caller's
        read gate."""
        p = torch.from_numpy(_pad_cols(probes, store.shape[1])).to(self.device)
        s, i = search_store(
            self, store, store_bias, n, k, p, store_scale,
            None if probe_scale is None else torch.from_numpy(probe_scale))
        return s.cpu().numpy(), i.cpu().numpy().astype(np.int64)

    def _scan_chunk(self, batch: int, cap: int) -> int:
        return scan_chunk(self, batch, cap)

    def _slab_rows(self) -> int:
        """Streaming slab size: ~0.5 GB of store dtype, block-aligned."""
        r = max(self.block,
                self.stream_slab_bytes // (self.dim * self.itemsize))
        return -(-r // self.block) * self.block

    def _stream_search(self, host: np.ndarray, bias: np.ndarray,
                       n: int, probes: np.ndarray, k: int):
        """Exact top-k over a store larger than the device bound: each
        slab of the host master goes to the device and through the same
        search as the resident store; the per-slab winners merge on the
        host in (score desc, index asc) order. Device memory peak = one
        slab + its search's workspace."""
        slab = self._slab_rows()
        q8 = self.dtype == "int8"
        if q8:
            pq, ps = _quantize_rows(probes)
        parts_s, parts_i = [], []
        for i in range(0, n, slab):
            j = min(i + slab, n)
            rows, scale = self._store_rows(host[i:j])
            sbias = torch.from_numpy(bias[i:j]).to(self.device)
            # a slab can't contribute more rows than it has
            ks = min(k, j - i)
            if q8:
                s, ix = self._topk(rows, sbias, j - i, ks, pq, scale, ps)
            else:
                s, ix = self._topk(rows, sbias, j - i, ks, probes)
            parts_s.append(s)
            parts_i.append(ix + i)
        all_s = np.concatenate(parts_s, axis=1)
        all_i = np.concatenate(parts_i, axis=1)
        # parts are in row order and each is sorted with ties to the
        # smaller row, so a stable sort keeps the global tie order
        order = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
        rows_ = np.arange(all_s.shape[0])[:, None]
        return all_i[rows_, order], all_s[rows_, order]

    def remove(self, label: int) -> int:
        """Drop every enrollment of ``label``; → rows removed.

        O(removed): marks the rows in the tombstone bias (host + one
        small device scatter) — every search masks them, so results are
        exact immediately. The full rebuild (compaction) is deferred
        until tombstones exceed ``compact_frac`` of the fill, the store
        empties, or a streaming store shrinks back under the bound."""
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
            n_live = fill - self._tomb
            live_bytes = self._bytes_for(n_live)
            fits = (not self.hbm_limit_gb
                    or live_bytes <= self.hbm_limit_gb * 1e9)
            if (n_live == 0
                    or (self._streaming and fits)
                    or self._tomb >= max(self.block,
                                         self.compact_frac * fill)):
                self._compact_locked()
            elif self._dev_bias is not None:
                self._dev_bias[torch.from_numpy(idx).to(self.device)] = _TOMB
            return removed

    def _compact_locked(self) -> int:
        """Rebuild without tombstoned rows; → live count. In place on
        the host buffers (the write gate drained all readers), full
        device upload with the old store freed first. A streaming store
        that now fits the bound resumes residency."""
        kept = compact_host(self)
        self._free_device()
        if self._streaming:
            need = self._bytes_for(kept)
            if (not self.hbm_limit_gb
                    or need <= self.hbm_limit_gb * 1e9):
                self._streaming = False     # residency resumes
        if kept and not self._streaming:
            self._sync_locked()
        return kept

    # ------------------------------------------------------ persistence

    def save(self, path: str) -> int:
        """Atomic snapshot (live rows only) → .npz; returns the row
        count written."""
        return save_snapshot(self, path)

    @classmethod
    def load(cls, path: str, *, block: int = 1024,
             dtype: str = "float32", hbm_limit_gb: float = 8.0,
             overflow: str = "refuse",
             device: str | torch.device = "cuda") -> "DeviceGallery":
        data = np.load(path, allow_pickle=False)
        emb = np.asarray(data["embeddings"], np.float32)
        g = cls(emb.shape[1], block=block, dtype=dtype,
                hbm_limit_gb=hbm_limit_gb, overflow=overflow, device=device)
        if emb.shape[0]:
            g.enroll(emb, data["labels"])
        return g
