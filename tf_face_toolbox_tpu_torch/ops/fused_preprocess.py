"""Fused input kernel: u8 -> resize -> flip -> standardize, one pass.

Counterpart of ``tf_face_toolbox_tpu/ops/pallas_preprocess.py``. A
CUDA tensor goes through the hand-written kernel in
``csrc/preprocess.cu``; a CPU tensor goes through
``fused_preprocess_reference``, the plain PyTorch version (explicit f32
matrix products with the ``_bilinear_matrix`` weights) that the tests
hold against the JAX package and the kernel against on the card.

The kernel's launch plan is decided here (``launch_plan``) and passed
to ``tfft_preprocess``, which only checks it: a cluster of 1, 2 or 4
CTAs shares one image, each CTA a band of output rows; a CTA stages the
source rows its band's taps read in shared memory (``segs``: maximal
runs of rows, in ``chunks`` that fit), each thread owns fixed output
columns (an RGB pixel, or one value of a row) and holds their resized
values in registers (``vals`` a thread) for both standardization
passes and the write, and a persisting plan walks several images a
CTA.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.ops.preprocess import _bilinear_matrix

SMEM_MAX = 232448          # a CTA's most shared memory on an H100
RESERVED = 512             # reduction scratch, cluster slots, the mbarrier
CLUSTERS = (1, 2, 4)       # CTAs an image
# the kernel's instances: (values a thread holds, most threads a CTA
# (its register cap), values a column (3: an RGB pixel, 1: a value),
# more than one column a thread). The pixel instances hold 28 and 14
# rows: a 112-row output's quarter and eighth at 4 and 8 thread rows.
INSTANCES = ((84, 448, 3, False), (42, 896, 3, False), (96, 448, 1, False),
             (48, 896, 1, False), (16, 1024, 1, True))
THREADS_PER_SM = 2048
# how a CTA copies its source rows into shared memory, and the address
# alignment each needs of the u8 tensor's base and size
COPY_MODES = {"bulk": 0, "async4": 1, "bytes": 2}
COPY_ALIGN = {"bulk": 16, "async4": 4, "bytes": 1}
LEAD = 8                   # ints of a band's lead (see launch_plan)


def _check_args(images: torch.Tensor, flip_mask: torch.Tensor | None,
                out_dtype):
    if images.ndim != 4:
        raise ValueError(f"images must be (N, H, W, C), got {tuple(images.shape)}")
    if flip_mask is not None and tuple(flip_mask.shape) != (images.shape[0],):
        raise ValueError(f"flip_mask must be ({images.shape[0]},), got "
                         f"{tuple(flip_mask.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def fused_preprocess_reference(images: torch.Tensor, flip_mask: torch.Tensor,
                               *, out_h: int, out_w: int,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same math and rounding points."""
    _check_args(images, flip_mask, out_dtype)
    n, h, w, c = images.shape
    dev = images.device
    rh = torch.from_numpy(_bilinear_matrix(out_h, h)).to(dev)
    rw = torch.from_numpy(_bilinear_matrix(out_w, w)).to(dev)
    y = torch.einsum("oh,nhwc->nowc", rh, images.to(torch.float32))
    flip = flip_mask.to(device=dev, dtype=torch.bool).reshape(n, 1, 1)
    rw_sel = torch.where(flip, rw.flip(0), rw)                # (N, W', W)
    y = torch.einsum("npw,nowc->nopc", rw_sel, y)
    mean = y.mean(dim=(1, 2, 3), keepdim=True)
    var = torch.square(y - mean).mean(dim=(1, 2, 3), keepdim=True)
    adjusted = torch.clamp_min(torch.sqrt(var),
                               1.0 / np.sqrt(out_h * out_w * c))
    return ((y - mean) / adjusted).to(out_dtype)


@functools.lru_cache(maxsize=64)
def _taps_np(out_size: int, in_size: int) -> tuple[np.ndarray, np.ndarray]:
    m = _bilinear_matrix(out_size, in_size)
    idx = np.zeros((out_size, 2), np.int32)
    wt = np.zeros((out_size, 2), np.float32)
    for o in range(out_size):
        nz = np.nonzero(m[o])[0]
        if not 1 <= len(nz) <= 2:
            raise AssertionError(f"bilinear row {o} has {len(nz)} taps")
        idx[o, :] = nz[0]
        idx[o, :len(nz)] = nz
        wt[o, :len(nz)] = m[o, nz]
    return idx, wt


@functools.lru_cache(maxsize=16)
def _taps(out_size: int, in_size: int, device: torch.device):
    """The nonzeros of each _bilinear_matrix row as two taps:
    (out, 2) int32 source indices and (out, 2) f32 weights on device.
    A row with one nonzero (clamped border, or no resize) gets a second
    tap of weight 0 at the same index. The two indices are equal or
    adjacent."""
    idx, wt = _taps_np(out_size, in_size)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device))


def _slot_bytes(rows: int, row_bytes: int) -> int:
    """Shared memory a run of source rows takes: its bytes, rounded out
    to 16 at both ends, in a 16-byte-aligned slot."""
    return -(-(rows * row_bytes + 30) // 16) * 16


def _stage_band(lo_rows: np.ndarray, hi_rows: np.ndarray, o_lo: int,
                o_hi: int, row_bytes: int, budget: int):
    """Chunks, runs and row entries of one band of output rows.

    Walks the band's rows in order; a row whose taps start past the
    current run's last source row + 1 opens a run; a row whose run
    would take the chunk's staged bytes past ``budget`` opens a chunk.
    Returns (chunks [(o_lo, o_hi, first run, end run)], runs [(first
    source row, rows, shared-memory offset)] with run indices local to
    the band, rows [(run, byte offset of the first tap's row in its
    run, byte step to the second tap's row)], the largest chunk's
    staged bytes), or None when one output row's two rows do not fit.
    """
    chunks, runs, rows = [], [], []
    c_lo, c_runs, c_bytes, most = o_lo, 0, 0, 0

    def close(o):
        nonlocal c_lo, c_runs, c_bytes, most
        chunks.append((c_lo, o, c_runs, len(runs)))
        most = max(most, c_bytes)
        c_lo, c_runs, c_bytes = o, len(runs), 0

    for o in range(o_lo, o_hi):
        lo, hi = int(lo_rows[o]), int(hi_rows[o])
        if len(runs) > c_runs and lo <= runs[-1][0] + runs[-1][1]:
            first, n_rows, off = runs[-1]
            grown = max(n_rows, hi - first + 1)
            extra = (_slot_bytes(grown, row_bytes)
                     - _slot_bytes(n_rows, row_bytes))
            if c_bytes + extra <= budget:
                runs[-1] = (first, grown, off)
                c_bytes += extra
                rows.append((len(runs) - 1, (lo - first) * row_bytes,
                             (hi - lo) * row_bytes))
                continue
            close(o)
        elif (len(runs) > c_runs
              and c_bytes + _slot_bytes(hi - lo + 1, row_bytes) > budget):
            close(o)
        need = _slot_bytes(hi - lo + 1, row_bytes)
        if need > budget:
            return None
        runs.append((lo, hi - lo + 1, c_bytes))
        c_bytes += need
        rows.append((len(runs) - 1, 0, (hi - lo) * row_bytes))
    if o_hi > o_lo:
        close(o_hi)
    return chunks, runs, rows, most


def _reg_cap(maxt: int) -> int:
    """Registers a thread of an instance may use (ptxas allocates 8 at
    a time, at most 255)."""
    return min(255, 65536 // maxt // 8 * 8)


def _layout(ncols: int, band: int, inst: tuple, threads: int | None):
    """(tc, tr, jc, threads) of one instance for a band of ``band`` rows
    of ``ncols`` output columns, or None. Thread t holds column t % tc
    (and + tc, ... when jc > 1) of rows t // tc + k * tr; a row wider
    than the instance's threads takes the wide instance (jc > 1)."""
    vals, maxt, cw, wide = inst
    vals //= cw
    if wide != (ncols > maxt):
        return None
    if wide:
        jc = -(-ncols // maxt)
        tc = -(-ncols // jc)
        t = -(-tc // 32) * 32
        if jc * band > vals or (threads is not None and t != threads):
            return None
        return tc, 1, jc, t
    for tr in range(1, maxt // ncols + 1):
        t = -(-ncols * tr // 32) * 32
        if t > maxt:
            break
        if (threads is None or t == threads) and -(-band // tr) <= vals:
            return ncols, tr, 1, t
    return None


def _out_stage_bytes(band: int, row_out: int, bf16: bool) -> int:
    """Shared memory of a band's staged output: its bytes, placed at the
    global address's offset in 16 bytes, in 16-byte pieces."""
    return -(-(band * row_out * (2 if bf16 else 4) + 15) // 16) * 16


def _plan(n, h, w, c, out_h, out_w, bf16, cluster, inst, threads, copy,
          persist):
    """The plan at one cluster size and instance, or (None, reason)."""
    row_bytes, row_out = w * c, out_w * c
    ncols = out_w if inst[2] == 3 else row_out
    band = -(-out_h // cluster)
    lay = _layout(ncols, band, inst, threads)
    if lay is None:
        return None, (f"a band of {band} rows x {row_out} values does not fit "
                      f"{inst[1]} threads x {inst[0]} values at cluster "
                      f"{cluster}")
    tc, tr, jc, t = lay
    out_stage = _out_stage_bytes(band, row_out, bf16)
    budget = SMEM_MAX - band * 16 - out_stage - RESERVED
    budget -= budget % 16
    idx, wt = _taps_np(out_h, h)
    bands = []
    for r in range(cluster):
        o_lo, o_hi = min(out_h, r * band), min(out_h, (r + 1) * band)
        got = _stage_band(idx[:, 0], idx[:, 1], o_lo, o_hi, row_bytes, budget)
        if got is None:
            return None, (f"two source rows of {row_bytes} bytes do not fit "
                          f"in shared memory beside a band of {band} rows")
        bands.append(got)
    stage = max(b[3] for b in bands)
    chunks, segs, rows, band_tab, lead = [], [], [0] * out_h, [], []
    wbits = wt.view(np.int32)
    for r, (b_chunks, b_runs, b_rows, _) in enumerate(bands):
        base, c0 = len(segs), len(chunks)
        band_tab.append((c0, c0 + len(b_chunks)))
        chunks += [(lo, hi, base + a, base + e) for lo, hi, a, e in b_chunks]
        segs += b_runs
        o_lo = min(out_h, r * band)
        for o, (k, off, step) in enumerate(b_rows, start=o_lo):
            first, _, soff = b_runs[k]
            assert step == (row_bytes if wbits[o, 1] else 0)
            rows[o] = (first * row_bytes, soff + off, int(wbits[o, 0]),
                       int(wbits[o, 1]))
        if b_chunks:
            lo, hi, a, e = chunks[c0]
            lead.append((c0, c0 + len(b_chunks), lo, hi, a, e, *segs[a][:2]))
        else:
            lead.append((c0, c0, 0, 0, 0, 0, 0, 0))
    # persisting (a CTA walks several images, the next one's band copied
    # into a second buffer): one chunk a band, bulk copies, and images a
    # whole number of 16 bytes (a run's offset in 16 bytes, and so the
    # row taps, the same in every image)
    can = (len(chunks) <= cluster and copy == "bulk" and h * w * c % 16 == 0
           and 2 * stage + band * 16 + out_stage + RESERVED <= SMEM_MAX)
    if persist and not can:
        return None, ("the plan cannot persist: a band in several chunks, "
                      "copies other than bulk, images not a whole number of "
                      "16 bytes, or two staging buffers that do not fit")
    persist = can if persist is None else persist
    smem = stage * (2 if persist else 1) + band * 16 + out_stage + RESERVED
    ctas = min(THREADS_PER_SM // t, 65536 // (t * _reg_cap(inst[1])),
               (SMEM_MAX + 1024) // (smem + 1024))
    return {"cluster": cluster, "band_rows": band, "threads": t, "tc": tc,
            "tr": tr, "jc": jc, "vals": inst[0], "maxt": inst[1],
            "cw": inst[2], "wide": inst[3], "ctas_an_sm": ctas,
            "copy": copy, "persist": persist, "stage_bytes": stage,
            "out_stage_bytes": out_stage, "smem_bytes": smem,
            "grid": n * cluster, "bands": band_tab, "chunks": chunks,
            "segs": segs, "rows": rows, "lead": lead}, None


@functools.lru_cache(maxsize=64)
def _launch_plan(n, h, w, c, out_h, out_w, bf16, cluster, threads, vals,
                 copy, persist):
    total = n * h * w * c
    if copy is None:
        copy = next(m for m in COPY_MODES if total % COPY_ALIGN[m] == 0)
    elif copy not in COPY_MODES:
        raise ValueError(f"copy must be one of {sorted(COPY_MODES)}, got {copy!r}")
    elif total % COPY_ALIGN[copy]:
        raise ValueError(f"copy {copy!r} needs the images' {total} bytes to be "
                         f"a multiple of {COPY_ALIGN[copy]}")
    reasons, best = [], None
    for cl in ((cluster,) if cluster is not None else CLUSTERS):
        if cluster is None and cl > 1 and (cl - 1) * -(-out_h // cl) >= out_h:
            continue                    # a band would be empty
        for inst in INSTANCES:
            if (vals is not None and inst[0] != vals) or (inst[2] == 3
                                                          and c != 3):
                continue
            plan, why = _plan(n, h, w, c, out_h, out_w, bf16, cl, inst,
                              threads, copy, persist)
            if plan is None:
                reasons.append(why)
                continue
            # the most threads resident an SM, then the fewest chunks
            # (a band staged at once), then the smaller cluster
            key = (-plan["threads"] * plan["ctas_an_sm"], len(plan["chunks"]),
                   cl)
            if best is None or key < best[0]:
                best = (key, plan)
    if best is None:
        raise ValueError(f"no launch plan for ({n},{h},{w},{c}) -> "
                         f"{out_h}x{out_w}: " + "; ".join(dict.fromkeys(reasons)))
    return best[1]


def launch_plan(n: int, h: int, w: int, c: int, out_h: int, out_w: int,
                out_dtype=torch.bfloat16, *, cluster: int | None = None,
                threads: int | None = None, vals: int | None = None,
                copy: str | None = None, persist: bool | None = None) -> dict:
    """How the preprocess kernel cuts (N, H, W, C) u8 -> (N, out_h,
    out_w, C).

    - ``cluster`` CTAs share an image, rank r taking output rows [r *
      band_rows, (r + 1) * band_rows). ``grid``: N x cluster CTAs.
    - ``threads`` a CTA: thread t owns output column t % ``tc`` (an
      RGB pixel where ``cw`` is 3, else one value of a row) and, when
      ``jc`` > 1, the ``jc`` - 1 columns ``tc`` apart after it, in the
      band's rows t // tc, + ``tr``, ...; it holds their resized values
      in registers (up to ``vals``, the kernel instance whose register
      cap is for ``maxt`` threads; ``wide`` for jc > 1).
      ``ctas_an_sm``: how many such CTAs an SM holds.
    - Each band's rows read source rows in ``segs`` (first row, rows,
      shared-memory offset: maximal runs of the rows its taps read,
      each rounded out to the copy's alignment), grouped in ``chunks``
      (output rows [lo, hi), runs [a, e)) that each fit in
      ``stage_bytes``; ``bands`` gives each band's chunk range and
      ``lead`` each band's first chunk and first run (chunk range, rows,
      runs, first source row, rows), which go to the kernel by value so
      that its copy starts at once. ``rows`` gives each output row's
      taps: the byte offset of its run's first source row in the
      image, its first tap's staged offset, and the two tap weights (as
      int32 bits; the second tap's row is the next one where its
      weight is not 0).
    - ``copy``: ``bulk`` (one cp.async.bulk a run, an mbarrier) where
      the tensor's base and size are multiples of 16 bytes, else
      ``async4`` (4-byte cp.async), else ``bytes`` (loads).
    - ``persist``: the kernel launches no more CTAs than the card holds
      at once, each walking images gridDim / cluster apart and copying
      the next image's band into a second staging buffer
      (``stage_bytes`` twice) while it computes this one's; where every
      band is one chunk, the copy is ``bulk`` and an image is a whole
      number of 16 bytes.
    - ``smem_bytes``: staged rows, the band's row taps (16 bytes a row),
      its staged output (``out_stage_bytes``: written out in 16-byte
      pieces) and ``RESERVED``.
    - Among the clusters and instances that hold the shape, the plan
      takes the most threads resident an SM (``ctas_an_sm``), then the
      fewest chunks, then the smaller cluster.

    ``cluster``, ``threads``, ``vals``, ``copy`` and ``persist`` force a
    choice (tests, bench). Raises ValueError with the reason when no
    plan holds the shape.
    """
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}, got {cluster}")
    if threads is not None and (threads % 32 or not 32 <= threads <= 1024):
        raise ValueError(f"threads must be a multiple of 32 up to 1024, "
                         f"got {threads}")
    return _launch_plan(n, h, w, c, out_h, out_w, out_dtype == torch.bfloat16,
                        cluster, threads, vals, copy, persist)


_LAUNCH_INTS = ("cluster", "band_rows", "threads", "tc", "tr", "jc", "vals",
                "maxt", "cw", "wide", "copy", "persist", "n_chunks", "n_segs",
                "stage_bytes", "out_stage_bytes", "smem_bytes")


class _Launch(ctypes.Structure):
    """PreLaunch of csrc/preprocess.cu: one plan's launch, the same
    fields in the same order."""
    _fields_ = ([(k, ctypes.c_void_p) for k in ("w_idx", "w_wt", "tables")]
                + [(k, ctypes.c_int) for k in ("n", "in_h", "in_w", "ch",
                                               "out_h", "out_w", "out_bf16")]
                + [("inv_sqrt_n", ctypes.c_float)]
                + [(k, ctypes.c_int) for k in _LAUNCH_INTS]
                + [("lead", ctypes.c_int * (4 * LEAD))])


class _Prepared:
    """What a launch of one plan needs besides the tensors: the plan,
    its tables and column taps on the device, and the launch structure
    that points at them."""

    def __init__(self, key: tuple, device: torch.device):
        n, h, w, c, out_h, out_w, bf16 = key[:7]
        self.plan = plan = _launch_plan(*key)
        # runs padded to 4 ints, so that the rows table's 16-byte
        # entries start 16-byte aligned
        flat = ([v for entry in plan["chunks"] for v in entry]
                + [v for entry in plan["segs"] for v in (*entry, 0)]
                + [v for entry in plan["rows"] for v in entry])
        self.tables = torch.tensor(flat, dtype=torch.int32, device=device)
        self.w_idx, self.w_wt = _taps(out_w, w, device)
        fields = dict(plan, copy=COPY_MODES[plan["copy"]],
                      n_chunks=len(plan["chunks"]), n_segs=len(plan["segs"]))
        lead = [v for entry in plan["lead"] for v in entry]
        self.launch = _Launch(
            self.w_idx.data_ptr(), self.w_wt.data_ptr(),
            self.tables.data_ptr(), n, h, w, c, out_h, out_w, int(bf16),
            float(1.0 / np.sqrt(out_h * out_w * c)),
            *(int(fields[k]) for k in _LAUNCH_INTS),
            (ctypes.c_int * (4 * LEAD))(*lead, *[0] * (4 * LEAD - len(lead))))
        self.ref = ctypes.addressof(self.launch)


@functools.lru_cache(maxsize=64)
def _prepared(key: tuple, device: torch.device) -> _Prepared:
    return _Prepared(key, device)


def _launch(images: torch.Tensor, flip_mask: torch.Tensor | None,
            out_h: int, out_w: int, out_dtype, force: dict) -> torch.Tensor:
    if images.device.type != "cuda":
        raise ValueError(f"no kernel for device {images.device}")
    if images.dtype != torch.uint8:
        raise ValueError(f"the kernel takes uint8 images, got {images.dtype}")
    from tf_face_toolbox_tpu_torch.kernels.build import check, load_library

    lib = load_library()
    n, h, w, c = images.shape
    images = images.contiguous()
    if images.data_ptr() % 16:
        images = images.clone()     # the copy modes align to the base
    if force:
        launch_plan(n, h, w, c, out_h, out_w, out_dtype, **force)  # checks
    prep = _prepared((n, h, w, c, out_h, out_w, out_dtype == torch.bfloat16,
                      *(force.get(k) for k in ("cluster", "threads", "vals",
                                               "copy", "persist"))),
                     images.device)
    flips = None
    if flip_mask is not None:
        flips = flip_mask.to(device=images.device, dtype=torch.int32).contiguous()
    out = torch.empty((n, out_h, out_w, c), dtype=out_dtype,
                      device=images.device)
    status = lib.tfft_preprocess(
        prep.ref, images.data_ptr(),
        None if flips is None else flips.data_ptr(), out.data_ptr(),
        images.device.index or 0,
        torch.cuda.current_stream(images.device).cuda_stream)
    if status == -2:
        plan = prep.plan
        raise RuntimeError(
            f"tfft_preprocess refused the plan (cluster {plan['cluster']}, "
            f"band {plan['band_rows']} rows, {plan['threads']} threads x "
            f"{plan['vals']} values, copy {plan['copy']}, "
            f"{plan['smem_bytes']} bytes of shared memory): it does not fit, "
            "its sum is not its own, its copy mode does not suit the "
            "tensors' alignment, it cannot persist, or its cluster cannot "
            "be resident")
    check(lib, status, "tfft_preprocess")
    fused_preprocess.launches += 1
    return out


def fused_preprocess(images: torch.Tensor, flip_mask: torch.Tensor, *,
                     out_h: int, out_w: int,
                     out_dtype=torch.float32, **force) -> torch.Tensor:
    """Fused resize -> flip -> standardize for a batch of images.

    Args:
      images: (N, H, W, C) uint8 aligned face crops (the kernel takes
        uint8; the CPU path takes any castable dtype).
      flip_mask: (N,) bool/int, per-image horizontal flip.
      out_h/out_w: output resolution.
      out_dtype: torch.float32 or torch.bfloat16.
      force: ``launch_plan`` overrides (tests, bench).

    Returns (N, out_h, out_w, C) standardized pixels in ``out_dtype``.
    A CPU tensor runs the plain version; a CUDA tensor runs the kernel.
    """
    _check_args(images, flip_mask, out_dtype)
    if images.device.type == "cpu":
        return fused_preprocess_reference(images, flip_mask, out_h=out_h,
                                          out_w=out_w, out_dtype=out_dtype)
    return _launch(images, flip_mask, out_h, out_w, out_dtype, force)


fused_preprocess.launches = 0


def fused_eval_preprocess(images: torch.Tensor, out_h: int, out_w: int,
                          out_dtype=torch.float32, **force) -> torch.Tensor:
    """Eval chain: resize + standardize, no flip. On the card one
    launch: the kernel takes no flip mask (no image flipped)."""
    _check_args(images, None, out_dtype)
    if images.device.type == "cpu":
        zeros = torch.zeros((images.shape[0],), dtype=torch.int32)
        return fused_preprocess_reference(images, zeros, out_h=out_h,
                                          out_w=out_w, out_dtype=out_dtype)
    return _launch(images, None, out_h, out_w, out_dtype, force)
