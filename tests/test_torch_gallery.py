"""Port DeviceGallery vs the JAX DeviceGallery, on the CPU.

Both packages enroll the same numpy embeddings and answer the same
probes: the JAX store through its XLA search programs, the port's CPU
store through the plain versions of the top-k kernels. Labels must be
equal and scores within f32 rounding, for all three store dtypes,
through growth, tombstones, compaction, streaming and snapshots.
"""

import threading

import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.serving import gallery as jgal
from tf_face_toolbox_tpu_torch.ops import topk as ttk
from tf_face_toolbox_tpu_torch.serving import gallery as tgal

torch.set_num_threads(1)

DIM = 64
DTYPES = ["float32", "bfloat16", "int8"]


def _unit(n, seed=0):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, DIM)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _pair(**kw):
    return jgal.DeviceGallery(DIM, **kw), tgal.DeviceGallery(DIM, device="cpu",
                                                             **kw)


def _same(jg, tg, probes, k, atol=1e-6):
    jl, js = jg.search(probes, k=k)
    tl, ts = tg.search(probes, k=k)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, atol=atol, rtol=0)
    assert tl.dtype == np.int64 and ts.dtype == np.float32
    return tl, ts


def test_host_helpers_are_the_jax_ones():
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(20, DIM)).astype(np.float32)
    rows[3] = 0.0
    rows[4, :2] = [1.5 * 127 / 127, -0.5]         # ties at .5 round to even
    for got, want in zip(tgal._quantize_rows(rows), jgal._quantize_rows(rows)):
        np.testing.assert_array_equal(got, want)
    host = _unit(30, seed=2)
    probes = _unit(4, seed=3)
    cand = rng.integers(-1, 32, size=(4, 9))
    bias = np.zeros(30, np.float32)
    bias[[2, 5]] = -2e9
    for got, want in zip(tgal._rescore(host, 30, probes, cand, 5, bias),
                         jgal._rescore(host, 30, probes, cand, 5, bias)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_enroll_growth_and_search_match_jax(dtype):
    jg, tg = _pair(block=4, dtype=dtype)
    base = _unit(6)
    assert jg.enroll(base, np.arange(6)) == tg.enroll(base, np.arange(6)) == 6
    _same(jg, tg, base[2], 3, atol=5e-6)
    more = _unit(5, seed=1)
    jg.enroll(more, 100 + np.arange(5))
    tg.enroll(more, 100 + np.arange(5))
    assert len(tg) == 11 and tg.device_bytes() == jg.device_bytes()
    assert tuple(tg._dev.shape) == (12, DIM)
    labs, scores = _same(jg, tg, base[0], 99, atol=5e-6)   # k clamps to 11
    assert labs.shape == (1, 11) and np.all(np.diff(scores[0]) <= 0)
    with pytest.raises(ValueError, match="dim"):
        tg.search(np.zeros((1, DIM + 1), np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_incremental_matches_bulk(dtype):
    e = _unit(23, seed=5)
    jbulk = jgal.DeviceGallery(DIM, block=8, dtype=dtype)
    jbulk.enroll(e, np.arange(23))
    inc = tgal.DeviceGallery(DIM, block=8, dtype=dtype, device="cpu")
    for i in range(0, 23, 3):                 # in place + two grows
        inc.enroll(e[i:i + 3], np.arange(i, min(i + 3, 23)))
    bulk = tgal.DeviceGallery(DIM, block=8, dtype=dtype, device="cpu")
    bulk.enroll(e, np.arange(23))
    assert torch.equal(inc._dev, bulk._dev)
    if dtype == "int8":
        assert torch.equal(inc._dev_scale, bulk._dev_scale)
    _same(jbulk, inc, e[[0, 11, 22]], 5, atol=5e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tombstones_below_threshold_match_jax(dtype):
    e = _unit(40)
    probes = _unit(6, seed=1)
    jg, tg = _pair(block=32, dtype=dtype)
    for g in (jg, tg):
        g.enroll(e, np.arange(40))
    dev_before = tg._dev
    for lab in (7, 7, 23):
        assert tg.remove(lab) == jg.remove(lab)
    assert tg._tomb == 2 and tg._n == 40
    assert tg._dev is dev_before              # O(1): store not re-synced
    assert tg._dev_bias[[7, 23]].eq(-2e9).all()
    _same(jg, tg, probes, 5, atol=5e-6)
    labs, _ = tg.search(e[7], k=38)
    assert 7 not in labs


def test_compaction_above_threshold_matches_jax():
    e = _unit(40, seed=6)
    jg, tg = _pair(block=4)
    for g in (jg, tg):
        g.enroll(e, np.arange(40))
    for lab in range(9):                      # threshold max(4, 10) = 10
        jg.remove(lab)
        tg.remove(lab)
    assert tg._tomb == 9 and tg._n == 40
    jg.remove(9)
    tg.remove(9)                              # 10th crosses → compacts
    assert tg._tomb == 0 and tg._n == 30 and len(tg) == 30
    assert tuple(tg._dev.shape) == (32, DIM)
    _same(jg, tg, e[15:18], 5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_scan_guard_chunks_and_equals_one_pass(dtype):
    """use_kernels=False past scan_sims_bytes: the plain version runs in
    row chunks (JAX: the lax.scan program) with identical results."""
    e = _unit(37, seed=3)
    jg = jgal.DeviceGallery(DIM, block=8, dtype=dtype)
    jg.scan_sims_bytes = 8 * 4
    tg = tgal.DeviceGallery(DIM, block=8, dtype=dtype, device="cpu")
    tg.scan_sims_bytes = 8 * 4
    tg.use_kernels = False
    one = tgal.DeviceGallery(DIM, block=8, dtype=dtype, device="cpu")
    one.use_kernels = False
    for g in (jg, tg, one):
        g.enroll(e, np.arange(37))
        g.compact_frac = 0.9
        g.remove(12)
    assert tg._scan_chunk(4, 40) == jg._scan_chunk(4, 40) == 8
    assert one._scan_chunk(4, 40) == 0
    for probe in (e[0], e[:6], e[13:14]):
        tl, ts = _same(jg, tg, probe, 5)
        ol, os_ = one.search(probe, k=5)
        np.testing.assert_array_equal(tl, ol)
        np.testing.assert_array_equal(ts, os_)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_wrapper_path_equals_plain_path(dtype):
    e = _unit(50, seed=12)
    a = tgal.DeviceGallery(DIM, block=16, dtype=dtype, device="cpu")
    b = tgal.DeviceGallery(DIM, block=16, dtype=dtype, device="cpu")
    b.use_kernels = False
    for g in (a, b):
        g.enroll(e, np.arange(50))
        g.remove(4)
    for x, y in zip(a.search(e[:7], k=6), b.search(e[:7], k=6)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("dtype", DTYPES)
def test_streaming_overflow_matches_jax(dtype):
    """overflow='stream': past the bound the store is freed and searches
    stream host slabs; results equal the JAX gallery's; removals that
    shrink the store under the bound resume residency."""
    e = _unit(40, seed=9)
    per_row = DIM * {"float32": 4, "bfloat16": 2, "int8": 1}[dtype] + \
        (4 if dtype == "int8" else 0)
    limit = 8 * per_row / 1e9                  # one 8-row block
    jg, tg = _pair(block=8, dtype=dtype, hbm_limit_gb=limit,
                   overflow="stream")
    for g in (jg, tg):
        g.stream_slab_bytes = 8 * (per_row - (4 if dtype == "int8" else 0))
        g.enroll(e[:8], np.arange(8))
        assert not g.streaming
        g.enroll(e[8:], np.arange(8, 40))
        assert g.streaming and g._dev is None
        g.remove(3)
        g.remove(38)
    assert tg._slab_rows() == jg._slab_rows() == 8
    for probe in (e[0], e[19], e[39], e[:6]):
        _same(jg, tg, probe, 5, atol=5e-6)
    for lab in range(8, 38):
        jg.remove(lab)
        tg.remove(lab)
    assert not tg.streaming and len(tg) == 8 and tg._dev is not None
    _same(jg, tg, e[:8], 3, atol=5e-6)


def test_capacity_refusal_and_reclaim():
    limit = 8 * DIM * 4 / 1e9                  # exactly one 8-row block
    g = tgal.DeviceGallery(DIM, block=8, hbm_limit_gb=limit, device="cpu")
    e = _unit(9, seed=7)
    g.enroll(e[:8], np.arange(8))
    with pytest.raises(tgal.GalleryCapacityError, match="bfloat16"):
        g.enroll(e[8:], [100])
    assert len(g) == 8                         # refused enroll left no rows
    g.remove(2)                                # tombstone (threshold 8)
    assert g._tomb == 1
    g.enroll(e[8:], [100])                     # compacts, then fits
    assert g._tomb == 0 and len(g) == 8
    labs, _ = g.search(e[8], k=1)
    assert labs[0, 0] == 100
    with pytest.raises(tgal.GalleryCapacityError, match="stream"):
        g.enroll(_unit(1, seed=8), [101])
    g16 = tgal.DeviceGallery(DIM, block=8, dtype="bfloat16",
                             hbm_limit_gb=limit, device="cpu")
    g16.enroll(e[:8], np.arange(8))
    g16.enroll(e[:8], 100 + np.arange(8))
    assert len(g16) == 16
    with pytest.raises(ValueError, match="overflow"):
        tgal.DeviceGallery(DIM, overflow="spill", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tgal.DeviceGallery(DIM, dtype="f8", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tgal.DeviceGallery(DIM, device="cpu").search(e[:1])


def test_int8_two_stage_labels_equal_f32_store():
    e = _unit(50, seed=11)
    f32 = tgal.DeviceGallery(DIM, block=8, device="cpu")
    q8 = tgal.DeviceGallery(DIM, block=8, dtype="int8", device="cpu")
    f32.enroll(e, np.arange(50))
    q8.enroll(e[:20], np.arange(20))
    q8.enroll(e[20:], np.arange(20, 50))       # growth path
    assert q8.device_bytes() == 56 * (DIM + 4)
    for probe in (e[0], e[17], e[:5]):
        lf, sf = f32.search(probe, k=4)
        l8, s8 = q8.search(probe, k=4)
        np.testing.assert_array_equal(l8, lf)
        np.testing.assert_allclose(s8, sf, atol=1e-6)
    q8.remove(17)
    labs, _ = q8.search(e[17:19], k=3)
    assert 17 not in labs and labs[1, 0] == 18


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_loads_in_both_packages(tmp_path, writer):
    e = _unit(12, seed=9)
    src = (jgal.DeviceGallery(DIM, block=32) if writer == "jax"
           else tgal.DeviceGallery(DIM, block=32, device="cpu"))
    src.enroll(e, 10 + np.arange(12))
    src.remove(15)
    path = str(tmp_path / "g.npz")
    assert src.save(path) == 11
    jg = jgal.DeviceGallery.load(path, block=8)
    tg = tgal.DeviceGallery.load(path, block=8, device="cpu")
    assert len(tg) == len(jg) == 11
    labs, _ = _same(jg, tg, e, 11)
    assert 15 not in labs


def test_concurrent_search_enroll_remove():
    """Searches racing enrolls (in-place and growing appends) and
    removes (tombstones and compactions) stay exact for the rows they
    can see."""
    e = _unit(400, seed=11)
    g = tgal.DeviceGallery(DIM, block=16, device="cpu")
    g.enroll(e[:64], np.arange(64))
    errors = []
    stop = threading.Event()

    def searcher():
        try:
            rng = np.random.default_rng()
            while not stop.is_set():
                i = int(rng.integers(0, 32))
                labs, scores = g.search(e[i], k=1)
                assert labs[0, 0] == i, (labs, i)
                assert scores[0, 0] == pytest.approx(1.0, abs=1e-5)
        except Exception as exc:    # noqa: BLE001 - collected for assert
            errors.append(exc)

    def writer():
        try:
            nxt = 64
            for i in range(40):
                g.enroll(e[nxt:nxt + 4], np.arange(nxt, nxt + 4))
                nxt += 4
                if i % 3 == 2:
                    g.remove(nxt - 2)
        except Exception as exc:    # noqa: BLE001
            errors.append(exc)
        finally:
            stop.set()

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    labs, _ = g.search(e[0], k=1)
    assert labs[0, 0] == 0


def _same_near_ties(jg, tg, probes, k, tol=2e-6):
    """Scores within ``tol`` of the JAX gallery's; labels equal except
    where the JAX scores around a position are within ``tol`` of each
    other (two f32 dot programs may order such rows either way)."""
    jl, js = jg.search(probes, k=k + 1)
    tl, ts = tg.search(probes, k=k)
    np.testing.assert_allclose(ts, js[:, :k], atol=tol, rtol=0)
    gap = np.diff(-js, axis=1) <= tol
    near = np.zeros(tl.shape, bool)
    near[:, 1:] |= gap[:, :k - 1]
    near[:, :] |= gap[:, :k]
    np.testing.assert_array_equal(tl[~near], jl[:, :k][~near])
    assert np.all(np.diff(ts, axis=1) <= 0)


@pytest.mark.parametrize("dtype,dim,k", [
    ("float32", 100, 5), ("bfloat16", 100, 5), ("int8", 100, 5),
    ("float32", 5, 5), ("float32", 128, 1100), ("bfloat16", 100, 1100),
    ("int8", 100, 300)])
def test_any_width_and_k_match_jax(dtype, dim, k):
    """Row widths that are not a multiple of 16 bytes (the device store
    and the probes are zero-padded to one) and k past 1024 (int8: a
    coarse stage of 4k = 1200 rows), against the JAX gallery."""
    rng = np.random.default_rng(dim + k)
    e = rng.normal(size=(3000, dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    probes = e[[3, 500, 2999]] + 0.05 * rng.normal(size=(3, dim)).astype(
        np.float32)
    jg = jgal.DeviceGallery(dim, block=512, dtype=dtype)
    tg = tgal.DeviceGallery(dim, block=512, dtype=dtype, device="cpu")
    for g in (jg, tg):
        g.enroll(e[:1700], np.arange(1700))
        g.enroll(e[1700:], np.arange(1700, 3000))
        g.remove(500)
    width = tg._dev.shape[1]
    assert width >= dim and (width * tg.itemsize) % 16 == 0
    assert width * tg.itemsize - dim * tg.itemsize < 16
    assert tg.device_bytes() == jg.device_bytes()
    assert not tg._dev[:, dim:].float().any()        # the pad is zeros
    if dtype == "int8":
        _same(jg, tg, probes, k)          # the coarse stage is exact
    else:
        _same_near_ties(jg, tg, probes, k)
    labels, _ = tg.search(probes, k=k)
    assert 500 not in labels and labels.shape == (3, k)


def test_non_cuda_store_has_no_kernel():
    store = torch.zeros((8, DIM), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ttk.cosine_topk(store, torch.zeros((1, DIM), device="meta"), 8, 1)
