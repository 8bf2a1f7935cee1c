"""Cosine scores + exact top-k for 1:N search: kernels 3 and 4.

Counterpart of ``tf_face_toolbox_tpu/ops/pallas_topk.py`` and of the
XLA search programs of ``serving/gallery.py`` (``_search_fn``,
``_search_q_fn``, ``_search_scan_fn``). A CUDA store goes through the
hand-written kernels in ``csrc/topk.cu``; a CPU store goes through the
plain PyTorch versions, ``cosine_topk_reference`` and
``cosine_topk_q_reference``, which the tests hold against the JAX
package and the kernels against on the card.

The contract, shared by all four:

- probes are cast to the store's dtype; products accumulate in f32
  (bf16 operands are exact in f32), or exactly in int32 for int8;
- int8 scores are ``float(acc) * pscale[:, None] * gscale[None, :]``,
  each product rounded, in that order;
- then ``+ bias`` (per row; -2e9 marks a tombstone), then rows at or
  past ``n_valid`` score -2e9;
- the result is the top ``k`` per probe, scores descending, ties to
  the smallest row index (``lax.top_k``'s order), as (B, k) f32
  scores and (B, k) int32 row indices.
"""

from __future__ import annotations

import torch

MASKED = -2e9        # masked / tombstoned row score (the JAX programs')
_LOW32 = 0xFFFFFFFF


def _keys(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One int64 per (score, index) that orders as (score desc, index
    asc) does: the f32 bits made order-preserving in the high word,
    the complement of the index in the low word. Keys are unique, so
    ``torch.topk`` over them has no ties to leave unordered."""
    bits = (scores.float() + 0.0).view(torch.int32).to(torch.int64)  # -0 -> +0
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits << 32) | (_LOW32 - idx.to(torch.int64))


def _decode(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    idx = (_LOW32 - (keys & _LOW32)).to(torch.int32)
    bits = keys >> 32
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return bits.to(torch.int32).view(torch.float32), idx


def stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``k`` along the last dim of a (B, N) f32 matrix, descending,
    ties to the smallest index (``lax.top_k``'s order; ``torch.topk``
    leaves tie order unspecified). Returns (scores, int32 indices)."""
    n = scores.shape[-1]
    idx = torch.arange(n, device=scores.device)
    keys = torch.topk(_keys(scores, idx), k, dim=-1).values
    return _decode(keys)


def _check_k(k: int, cap: int) -> int:
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if k > cap:
        raise ValueError(f"k={k} exceeds the store's {cap} rows")
    return k


def _check_store(store: torch.Tensor, probes: torch.Tensor, bias,
                 dtypes: tuple) -> None:
    if store.ndim != 2 or probes.ndim != 2:
        raise ValueError(f"store (cap, D) and probes (B, D) must be 2-D, got "
                         f"{tuple(store.shape)} and {tuple(probes.shape)}")
    if store.dtype not in dtypes:
        raise ValueError(f"store dtype must be one of {dtypes}, "
                         f"got {store.dtype}")
    if probes.shape[1] != store.shape[1]:
        raise ValueError(f"probe dim {probes.shape[1]} != store dim "
                         f"{store.shape[1]}")
    if bias is not None and tuple(bias.shape) != (store.shape[0],):
        raise ValueError(f"bias must be ({store.shape[0]},), got "
                         f"{tuple(bias.shape)}")


def _check_tf32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain top-k needs exact f32 products: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _default_chunk(batch: int, d: int) -> int:
    """Rows per chunk of the plain version: keeps the (B, chunk) scores
    and keys and the f32 copy of the chunk to a few hundred MB."""
    return max(1024, min((1 << 26) // max(batch, 1), (1 << 29) // (4 * d)))


def _chunked_topk(score_fn, cap: int, batch: int, n_valid: int, k: int,
                  bias, chunk_rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the store in row chunks: each chunk's keys go
    through ``torch.topk`` and merge with the running best. Keys carry
    the global row index, so the merge keeps the tie order exact."""
    best = None
    for start in range(0, cap, chunk_rows):
        stop = min(start + chunk_rows, cap)
        s = score_fn(start, stop)                       # (B, rows) f32
        if bias is not None:
            s = s + bias[start:stop].to(device=device, dtype=torch.float32)
        row = torch.arange(start, stop, device=device)
        s = torch.where(row[None, :] < n_valid, s, MASKED)
        keys = torch.topk(_keys(s, row), min(k, stop - start), dim=1).values
        if best is not None:
            keys = torch.topk(torch.cat([best, keys], dim=1), min(
                k, best.shape[1] + keys.shape[1]), dim=1).values
        best = keys
    return _decode(best)


def cosine_topk_reference(gallery: torch.Tensor, probes: torch.Tensor,
                          n_valid: int, k: int, bias=None,
                          chunk_rows: int | None = None):
    """Plain PyTorch version of kernel 3 (f32 or bf16 store): the
    twin of ``_search_fn`` and, with ``chunk_rows``, of the chunked
    ``_search_scan_fn``. Any device; on a CUDA device TF32 must be off."""
    _check_store(gallery, probes, bias, (torch.float32, torch.bfloat16))
    cap, d = gallery.shape
    k = _check_k(k, cap)
    _check_tf32(gallery)
    dev = gallery.device
    # cast to the store dtype (as the kernel does), then exact in f32
    p = probes.to(device=dev, dtype=gallery.dtype).to(torch.float32)

    def score(start, stop):
        return p @ gallery[start:stop].to(torch.float32).T

    return _chunked_topk(score, cap, p.shape[0], min(int(n_valid), cap), k,
                         bias, chunk_rows or _default_chunk(p.shape[0], d), dev)


def cosine_topk_q_reference(gallery_q: torch.Tensor, gallery_scale: torch.Tensor,
                            probes_q: torch.Tensor, probe_scale: torch.Tensor,
                            n_valid: int, k: int, bias=None,
                            chunk_rows: int | None = None):
    """Plain PyTorch version of kernel 4 (int8 store, per-row scales):
    the twin of ``_search_q_fn``. The int8 dot runs as an f32 matrix
    product, which is exact here: every partial sum is an integer of at
    most D * 127^2 < 2^24 for D <= 1040 (``int8 @ int8`` in torch would
    return int8 and wrap)."""
    _check_store(gallery_q, probes_q, bias, (torch.int8,))
    cap, d = gallery_q.shape
    if d > 1040:
        raise ValueError(f"int8 dim {d} > 1040: the f32 dot is no longer exact")
    k = _check_k(k, cap)
    _check_tf32(gallery_q)
    dev = gallery_q.device
    pq = probes_q.to(device=dev, dtype=torch.int8).to(torch.float32)
    ps = probe_scale.to(device=dev, dtype=torch.float32)[:, None]
    gs = gallery_scale.to(device=dev, dtype=torch.float32)

    def score(start, stop):
        acc = pq @ gallery_q[start:stop].to(torch.float32).T
        return acc * ps * gs[None, start:stop]

    return _chunked_topk(score, cap, pq.shape[0], min(int(n_valid), cap), k,
                         bias, chunk_rows or _default_chunk(pq.shape[0], d), dev)


# kernels 3 and 4 (csrc/topk.cu topk_stream_kernel): a 256-row tile;
# each ring stage holds a 128-byte column chunk of the tile's rows and
# of the probe slots at a 144-byte row stride, and the tile's row
# scales and bias (2 x 256 f32); the score tile is (slots, 260) f32 with
# 8 bytes of flags a slot; an int8 CTA keeps its probe scales (slots
# f32); each probe's running list is k x (f32, int32), in shared memory
# or in the workspace
STREAM_ROWS = 256
_RING_ROW_BYTES = 144
_STAGE_SIDE_BYTES = 2 * STREAM_ROWS * 4
_SCORE_STRIDE = STREAM_ROWS + 4
_MAX_STAGES = 4
SMEM_BYTES = 232448      # an H100 block's dynamic shared memory
_F32_SLOTS = (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64)
_MMA_SLOTS = (8, 16, 32, 64)     # bf16 and int8: the n8 mma tile
_WARPS = 8                       # one probe a warp in the selection pass


def stream_smem_bytes(slots: int, stages: int, per_cta: int, k: int,
                      int8: bool = False, shared_lists: bool = True) -> int:
    """The stream kernel's shared memory: the ring, the score tile and
    its flags, the int8 probe scales, and the running lists when they
    live there."""
    return (stages * ((STREAM_ROWS + slots) * _RING_ROW_BYTES
                      + _STAGE_SIDE_BYTES)
            + slots * (_SCORE_STRIDE * 4 + 8) + (slots * 4 if int8 else 0)
            + (per_cta * k * 8 if shared_lists else 0))


def launch_plan(batch: int, cap: int, k: int, n_sms: int,
                dtype: torch.dtype = torch.float32) -> dict:
    """How the stream kernel cuts a search of an f32, bf16 or int8
    store, from one shared-memory budget:

    - probes per CTA: the most, from min(batch, 64) down to
      min(batch, 8) (one a warp), whose probe slots, 3-stage ring, score
      tile and running lists fit ``SMEM_BYTES``; past that k the lists
      live in the workspace and a CTA takes min(batch, 8) probes;
    - a fourth ring stage where it also fits;
    - about one CTA per SM in all, and no slice shorter than k rows (so
      the workspace stays within slices x B x k <= cap x B entries);
    - the merge loads every slice's list into shared memory when two
      copies fit (16 x slices x k bytes), else folds them one at a time
      with three lists (k x 24 bytes) in shared memory while they fit,
      else in a global scratch (``merge_scratch``).
    """
    int8 = dtype == torch.int8
    slot_set = _F32_SLOTS if dtype == torch.float32 else _MMA_SLOTS

    def smem(per_cta: int, stages: int, shared: bool) -> tuple[int, int]:
        slots = min(s for s in slot_set if s >= per_cta)
        return slots, stream_smem_bytes(slots, stages, per_cta, k, int8,
                                        shared)

    for most in (64, 32, 16, _WARPS):
        per_cta, shared = min(batch, most), True
        if smem(per_cta, 3, shared)[1] <= SMEM_BYTES:
            break
    else:
        per_cta, shared = min(batch, _WARPS), False
    slots = smem(per_cta, 3, shared)[0]
    stages = max(s for s in range(3, _MAX_STAGES + 1)
                 if smem(per_cta, s, shared)[1] <= SMEM_BYTES)
    n_ptiles = -(-batch // per_cta)
    tiles = -(-cap // STREAM_ROWS)
    slices = max(1, min(n_sms // n_ptiles, tiles, cap // k))
    slice_rows = -(-tiles // slices) * STREAM_ROWS
    slices = -(-cap // slice_rows)
    return {"per_cta": per_cta, "slots": slots, "stages": stages,
            "slice_rows": slice_rows, "slices": slices,
            "smem": smem(per_cta, stages, shared)[1], "shared_lists": shared,
            "merge_scratch": min(16 * slices, 24) * k > SMEM_BYTES}


def _device_args(t: torch.Tensor, dtype, what: str) -> torch.Tensor:
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor, got "
                         f"{t.dtype}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")
    return t


def _bias_ptr(bias, dev: torch.device):
    if bias is None:
        return None
    bias = _device_args(bias, torch.float32, "bias")
    if bias.device != dev:
        raise ValueError(f"bias on {bias.device}, store on {dev}")
    return bias.data_ptr()


def _launch(name: str, head: list, store: torch.Tensor, batch: int, k: int,
            dtype: torch.dtype) -> tuple:
    """Plan the search, allocate the outputs, the (slices, B, k)
    workspace and the merge scratch, and call one C entry point with
    ``head`` (its pointers and sizes) and the plan's arguments."""
    from tf_face_toolbox_tpu_torch.kernels.build import check, load_library

    cap, d = store.shape
    if (d * store.element_size()) % 16:
        raise ValueError(f"the top-k kernels take rows of a multiple of 16 "
                         f"bytes, got D={d} x {store.element_size()} B")
    dev = store.device
    pl = launch_plan(batch, cap, k, _n_sms(dev), dtype=dtype)
    part_s = torch.empty((pl["slices"], batch, k), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((pl["slices"], batch, k), dtype=torch.int32,
                         device=dev)
    scratch = (torch.empty((batch, 6 * k), dtype=torch.int32, device=dev)
               if pl["merge_scratch"] else None)
    out_s = torch.empty((batch, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((batch, k), dtype=torch.int32, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = getattr(lib, name)(
        *head, pl["per_cta"], pl["slots"], pl["stages"], pl["slice_rows"],
        pl["slices"], pl["smem"], int(pl["shared_lists"]), part_s.data_ptr(),
        part_i.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), dev.index or 0, stream)
    check(lib, status, name)
    return out_s, out_i


def _n_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def cosine_topk(gallery: torch.Tensor, probes: torch.Tensor, n_valid: int,
                k: int, bias=None):
    """Top-``k`` cosine matches of ``probes`` (B, D) against ``gallery``
    (cap, D) f32/bf16, rows >= ``n_valid`` masked, ``bias`` (cap,) f32
    or None added per row. Returns (scores (B, k) f32, idx (B, k)
    int32). Any capacity, batch, fill and ``k`` up to the capacity. A
    CPU store runs the plain version; a CUDA store runs kernel 3, whose
    rows must be a multiple of 16 bytes (``DeviceGallery`` pads them)."""
    _check_store(gallery, probes, bias, (torch.float32, torch.bfloat16))
    k = _check_k(k, gallery.shape[0])
    if gallery.device.type == "cpu":
        return cosine_topk_reference(gallery, probes, n_valid, k, bias=bias)
    if gallery.device.type != "cuda":
        raise ValueError(f"no kernel for device {gallery.device}")
    store = _device_args(gallery, gallery.dtype, "gallery")
    p = probes.to(device=store.device, dtype=store.dtype).contiguous()
    cap, d = store.shape
    batch = p.shape[0]
    out = _launch("tfft_topk", [
        store.data_ptr(), p.data_ptr(), _bias_ptr(bias, store.device),
        min(int(n_valid), cap), cap, d, batch, k,
        int(store.dtype == torch.bfloat16)], store, batch, k, store.dtype)
    cosine_topk.launches += 1
    return out


cosine_topk.launches = 0


def cosine_topk_q(gallery_q: torch.Tensor, gallery_scale: torch.Tensor,
                  probes_q: torch.Tensor, probe_scale: torch.Tensor,
                  n_valid: int, k: int, bias=None):
    """int8-store twin of :func:`cosine_topk`, the coarse stage of the
    gallery's two-stage int8 search: ``gallery_q`` (cap, D) int8 with
    ``gallery_scale`` (cap,) f32, ``probes_q`` (B, D) int8 with
    ``probe_scale`` (B,) f32. A CUDA store runs kernel 4, the same
    stream kernel with int8 mma."""
    _check_store(gallery_q, probes_q, bias, (torch.int8,))
    k = _check_k(k, gallery_q.shape[0])
    if gallery_q.device.type == "cpu":
        return cosine_topk_q_reference(gallery_q, gallery_scale, probes_q,
                                       probe_scale, n_valid, k, bias=bias)
    if gallery_q.device.type != "cuda":
        raise ValueError(f"no kernel for device {gallery_q.device}")
    dev = gallery_q.device
    store = _device_args(gallery_q, torch.int8, "gallery_q")
    gs = _device_args(gallery_scale, torch.float32, "gallery_scale")
    if tuple(gs.shape) != (store.shape[0],) or gs.device != dev:
        raise ValueError(f"gallery_scale must be ({store.shape[0]},) on {dev}")
    pq = probes_q.to(device=dev, dtype=torch.int8).contiguous()
    ps = probe_scale.to(device=dev, dtype=torch.float32).contiguous()
    if tuple(ps.shape) != (pq.shape[0],):
        raise ValueError(f"probe_scale must be ({pq.shape[0]},)")
    cap, d = store.shape
    batch = pq.shape[0]
    out = _launch("tfft_topk_q", [
        store.data_ptr(), gs.data_ptr(), pq.data_ptr(), ps.data_ptr(),
        _bias_ptr(bias, dev), min(int(n_valid), cap), cap, d, batch, k],
        store, batch, k, torch.int8)
    cosine_topk_q.launches += 1
    return out


cosine_topk_q.launches = 0
