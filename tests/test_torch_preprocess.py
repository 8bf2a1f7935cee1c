"""Port preprocessing and the fused input kernel vs the JAX package.

The same numpy inputs go through tf_face_toolbox_tpu (the reference;
its Pallas kernel in interpret mode) and tf_face_toolbox_tpu_torch (on
the CPU, the kernel's plain PyTorch version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.ops import pallas_preprocess as jpp
from tf_face_toolbox_tpu.ops import preprocess as jpre
from tf_face_toolbox_tpu_torch.ops import fused_preprocess as tpp
from tf_face_toolbox_tpu_torch.ops import preprocess as tpre

torch.set_num_threads(1)


def _u8(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at x (8 significant bits)."""
    _, exp = np.frexp(np.asarray(x, np.float32))
    return np.ldexp(1.0, exp - 8)


@pytest.mark.parametrize("out_size,in_size",
                         [(112, 120), (12, 20), (16, 10), (14, 14), (7, 120)])
def test_bilinear_matrix_identical(out_size, in_size):
    np.testing.assert_array_equal(tpre._bilinear_matrix(out_size, in_size),
                                  jpre._bilinear_matrix(out_size, in_size))


_CHAINS = {
    "resize_bilinear": (lambda x: jpre.resize_bilinear(x, 12, 10),
                        lambda x: tpre.resize_bilinear(x, 12, 10)),
    "per_image_standardization": (jpre.per_image_standardization,
                                  tpre.per_image_standardization),
    "fixed_standardization": (jpre.fixed_standardization,
                              tpre.fixed_standardization),
    "preprocess_eval": (lambda x: jpre.preprocess_eval(x, 14, 14),
                        lambda x: tpre.preprocess_eval(x, 14, 14)),
    "preprocess_eval_resize": (lambda x: jpre.preprocess_eval_resize(x, 12, 12),
                               lambda x: tpre.preprocess_eval_resize(x, 12, 12)),
}


@pytest.mark.parametrize("name", sorted(_CHAINS))
def test_preprocess_ops_match_jax(name):
    jfn, tfn = _CHAINS[name]
    x = _u8((3, 18, 16, 3), seed=4)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # rtol: resized values reach 255, where one f32 step is 1.5e-5
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_flip_ops_match_jax():
    x = _u8((4, 6, 5, 3), seed=5)
    mask = np.array([1, 0, 0, 1], bool)
    np.testing.assert_array_equal(
        tpre.apply_flip_mask(torch.from_numpy(x), torch.from_numpy(mask)),
        np.asarray(jpre.apply_flip_mask(jnp.asarray(x), jnp.asarray(mask))))
    np.testing.assert_array_equal(
        tpre.flip_left_right(torch.from_numpy(x)),
        np.asarray(jpre.flip_left_right(jnp.asarray(x))))


def test_crop_at_per_image_offsets_match_jax():
    x = _u8((3, 10, 9, 3), seed=6)
    offs = np.array([[0, 0], [2, 1], [3, 4]], np.int32)
    np.testing.assert_array_equal(
        tpre.crop_at(torch.from_numpy(x), offs, 6, 5),
        np.asarray(jpre.crop_at(jnp.asarray(x), jnp.asarray(offs), 6, 5)))


# (images shape, flip mask, out_h, out_w, out dtype) — the sizes of
# tests/test_pallas_preprocess.py
_FUSED_CASES = {
    "no_flip_20x16_to_12": ((4, 20, 16, 3), [0, 0, 0, 0], 12, 12, "f32"),
    "mixed_flip_14": ((6, 14, 14, 3), [1, 0, 1, 1, 0, 0], 14, 14, "f32"),
    "upscale_rect_16x12": ((2, 10, 8, 3), [0, 1], 16, 12, "f32"),
    "bf16_out_16_to_12": ((3, 16, 16, 3), [0, 1, 0], 12, 12, "bf16"),
    "main_path_120_to_112": ((2, 120, 120, 3), [0, 1], 112, 112, "bf16"),
}


@pytest.mark.parametrize("case", sorted(_FUSED_CASES))
def test_fused_preprocess_matches_jax_kernel(case):
    shape, mask, out_h, out_w, dt = _FUSED_CASES[case]
    x = _u8(shape, seed=len(case))
    mask = np.asarray(mask, np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jpp.fused_preprocess(
        jnp.asarray(x), jnp.asarray(mask), out_h=out_h, out_w=out_w,
        out_dtype=jdt, interpret=True), np.float32)
    got = tpp.fused_preprocess(torch.from_numpy(x), torch.from_numpy(mask),
                               out_h=out_h, out_w=out_w, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        # one bf16 step, beyond the f32 tolerance: near zero (y - mean)
        # cancels and only the absolute f32 error means anything
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-5).all()


def test_constant_image_hits_the_std_floor():
    x = np.full((2, 12, 12, 3), 9, np.uint8)
    want = np.asarray(jpp.fused_eval_preprocess(jnp.asarray(x), 12, 12,
                                                interpret=True))
    got = tpp.fused_eval_preprocess(torch.from_numpy(x), 12, 12).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, 0.0, atol=1e-5)


def test_taps_reproduce_the_bilinear_matrix():
    """The kernel's 2-tap tables are the nonzeros of each matrix row."""
    for out_size, in_size in ((112, 120), (16, 10), (14, 14), (5, 64)):
        idx, wt = tpp._taps(out_size, in_size, torch.device("cpu"))
        m = np.zeros((out_size, in_size), np.float32)
        for o in range(out_size):
            for t in range(2):
                m[o, idx[o, t]] += wt[o, t].item()
        np.testing.assert_array_equal(
            m, tpre._bilinear_matrix(out_size, in_size))


def test_fused_preprocess_rejects_bad_inputs():
    x = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="flip_mask"):
        tpp.fused_preprocess(x, torch.zeros(3), out_h=4, out_w=4)
    with pytest.raises(ValueError, match="out_dtype"):
        tpp.fused_preprocess(x, torch.zeros(2), out_h=4, out_w=4,
                             out_dtype=torch.float16)


# ---- the kernel's launch plan (decided by launch_plan, checked by the
# C entry point). Shapes: the _FUSED_CASES, the main path at 256
# images, large frames, unaligned 14x14 images (588 bytes) at an odd N,
# 5x5 images whose tensor is not a multiple of 4 bytes, a tall upscale
# whose bands hold many rows, and output rows wider than a CTA.
_PLAN_SHAPES = sorted({(*s, oh, ow) for s, _, oh, ow, _ in _FUSED_CASES.values()}
                      | {(256, 120, 120, 3, 112, 112), (2, 512, 512, 3, 112, 112),
                         (2, 1024, 1024, 3, 112, 112), (5, 14, 14, 3, 14, 14),
                         (3, 5, 5, 3, 4, 4), (2, 30, 20, 1, 200, 24),
                         (2, 2048, 2048, 3, 112, 112), (2, 4, 300, 3, 4, 1000)})


def _plan_rows(plan, out_h):
    """Output rows of each band, and of each chunk of each band."""
    band = plan["band_rows"]
    for r, (c_first, c_end) in enumerate(plan["bands"]):
        lo, hi = min(out_h, r * band), min(out_h, (r + 1) * band)
        yield range(lo, hi), [plan["chunks"][i] for i in range(c_first, c_end)]


def _wbits(x) -> int:
    return int(np.float32(x).view(np.int32))


@pytest.mark.parametrize("shape", _PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_launch_plan_covers_and_fits(shape, dt):
    """Bands cover every output row once, their chunks partition them;
    each row's two tap rows lie in a run of its chunk, at the staged
    offset and with the weights its rows entry gives; a chunk's runs
    sit in disjoint 16-byte slots inside stage_bytes; each band's lead
    is its first chunk and run; the shared-memory sum is the formula's
    and fits; registers hold the band."""
    n, h, w, c, out_h, out_w = shape
    plan = tpp.launch_plan(*shape, dt)
    assert plan["cluster"] in (1, 2, 4) and plan["grid"] == n * plan["cluster"]
    assert plan["smem_bytes"] <= 232448
    elem = 2 if dt == torch.bfloat16 else 4
    assert plan["out_stage_bytes"] >= plan["band_rows"] * out_w * c * elem + 15
    assert plan["smem_bytes"] == (plan["stage_bytes"] * (2 if plan["persist"] else 1)
                                  + plan["band_rows"] * 16
                                  + plan["out_stage_bytes"] + tpp.RESERVED)
    twice = (2 * plan["stage_bytes"] + plan["band_rows"] * 16
             + plan["out_stage_bytes"] + tpp.RESERVED)
    assert plan["persist"] == (len(plan["chunks"]) <= plan["cluster"]
                               and plan["copy"] == "bulk" and h * w * c % 16 == 0
                               and twice <= 232448)
    assert (plan["jc"] * -(-plan["band_rows"] // plan["tr"]) * plan["cw"]
            <= plan["vals"])
    row_bytes = w * c
    idx, wt = tpp._taps_np(out_h, h)
    seen = []
    for r, (band_rows, chunks) in enumerate(_plan_rows(plan, out_h)):
        assert [o for lo, hi, _, _ in chunks for o in range(lo, hi)] == list(band_rows)
        lead = plan["lead"][r]
        assert tuple(lead[:2]) == tuple(plan["bands"][r])
        if chunks:
            assert tuple(lead[2:6]) == tuple(chunks[0])
            assert tuple(lead[6:]) == tuple(plan["segs"][chunks[0][2]][:2])
        for lo, hi, a, e in chunks:
            slots = sorted((off, tpp._slot_bytes(rows, row_bytes))
                           for _, rows, off in plan["segs"][a:e])
            assert slots[0][0] == 0 and all(off % 16 == 0 for off, _ in slots)
            assert all(x[0] + x[1] <= y[0] for x, y in zip(slots, slots[1:]))
            assert slots[-1][0] + slots[-1][1] <= plan["stage_bytes"]
            for o in range(lo, hi):
                run_byte, staged, w0, w1 = plan["rows"][o]
                assert (w0, w1) == (_wbits(wt[o, 0]), _wbits(wt[o, 1]))
                k = next(k for k in range(a, e)
                         if plan["segs"][k][0] * row_bytes == run_byte)
                first, rows, off = plan["segs"][k]
                assert staged == off + (idx[o, 0] - first) * row_bytes
                assert idx[o, 1] == idx[o, 0] + (1 if w1 else 0)
                assert first <= idx[o, 0] and idx[o, 1] < first + rows
        seen += list(band_rows)
    assert seen == list(range(out_h))


@pytest.mark.parametrize("shape", _PLAN_SHAPES, ids=str)
def test_launch_plan_copy_mode_follows_alignment(shape):
    """bulk only where the tensor's bytes are a multiple
    of 16 (the wrapper gives the kernel a 16-byte-aligned base), else
    async4 where a multiple of 4, else bytes; a forced mode holds or
    raises."""
    total = int(np.prod(shape[:4]))
    plan = tpp.launch_plan(*shape)
    want = "bulk" if total % 16 == 0 else "async4" if total % 4 == 0 else "bytes"
    assert plan["copy"] == want
    for mode, align in tpp.COPY_ALIGN.items():
        if total % align == 0:
            assert tpp.launch_plan(*shape, copy=mode)["copy"] == mode
        else:
            with pytest.raises(ValueError, match="multiple"):
                tpp.launch_plan(*shape, copy=mode)


@pytest.mark.parametrize("shape", _PLAN_SHAPES, ids=str)
def test_launch_plan_threads_own_each_value_once(shape):
    """Thread t's slots (column t % tc + i * tc for i < jc, rows t // tc
    + k * tr of the band; a column is an RGB pixel where cw is 3) cover
    every value of a band once; the threads fit the instance and its
    registers, and lanes hold consecutive columns."""
    plan = tpp.launch_plan(*shape)
    cw = plan["cw"]
    assert cw == (3 if shape[3] == 3 and not plan["wide"] else 1)
    ncols = shape[5] * shape[3] // cw
    band, tc, tr, jc = (plan[k] for k in ("band_rows", "tc", "tr", "jc"))
    assert (plan["vals"], plan["maxt"], cw, plan["wide"]) in tpp.INSTANCES
    assert tc * tr <= plan["threads"] <= plan["maxt"] and plan["threads"] % 32 == 0
    assert tc <= ncols <= tc * jc and (jc > 1) == plan["wide"]
    owned = np.zeros((band, ncols), np.int32)
    for t in range(plan["threads"]):
        g, col = divmod(t, tc)
        if g >= tr:
            continue
        slots = [(row, col + i * tc) for row in range(g, band, tr)
                 for i in range(jc) if col + i * tc < ncols]
        assert len(slots) * cw <= plan["vals"]
        for row, j in slots:
            owned[row, j] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("shape", [(256, 120, 120, 3, 112, 112),
                                   (2, 512, 512, 3, 112, 112),
                                   (6, 14, 14, 3, 14, 14)], ids=str)
def test_launch_plan_force_cluster(shape, cluster):
    plan = tpp.launch_plan(*shape, cluster=cluster)
    assert plan["cluster"] == cluster and len(plan["bands"]) == cluster
    assert plan["band_rows"] == -(-shape[4] // cluster)


def test_launch_plan_main_path():
    """256 x 120x120x3 u8 -> bf16 112: one CTA an image (cluster 1), 896
    threads (eight rows of 112 pixels) of 14 pixels (42 values), one CTA
    an SM, one bulk copy of one run an image in, persisting (two staging
    buffers of 43,232 bytes), the image's 75,264 output bytes staged; f32
    stages twice the bytes; forced clusters, instances and persistence
    hold."""
    plan = tpp.launch_plan(256, 120, 120, 3, 112, 112, torch.bfloat16)
    got = {k: plan[k] for k in ("cluster", "band_rows", "threads", "tc", "tr",
                                "jc", "vals", "cw", "ctas_an_sm", "copy",
                                "grid", "out_stage_bytes", "persist",
                                "stage_bytes", "smem_bytes")}
    assert got == {"cluster": 1, "band_rows": 112, "threads": 896, "tc": 112,
                   "tr": 8, "jc": 1, "vals": 42, "cw": 3, "ctas_an_sm": 1,
                   "copy": "bulk", "grid": 256, "out_stage_bytes": 75280,
                   "persist": True, "stage_bytes": 43232,
                   "smem_bytes": 2 * 43232 + 112 * 16 + 75280 + 512}
    assert len(plan["chunks"]) == 1 and len(plan["segs"]) == 1
    once = tpp.launch_plan(256, 120, 120, 3, 112, 112, persist=False)
    assert not once["persist"] and once["smem_bytes"] == got["smem_bytes"] - 43232
    f32 = tpp.launch_plan(256, 120, 120, 3, 112, 112, torch.float32, cluster=2)
    assert f32["out_stage_bytes"] == 56 * 336 * 4 + 16
    forced = tpp.launch_plan(256, 120, 120, 3, 112, 112, cluster=2)
    assert (forced["threads"], forced["tr"], forced["ctas_an_sm"]) == (448, 4, 2)
    forced = tpp.launch_plan(256, 120, 120, 3, 112, 112, cluster=4, vals=84)
    assert (forced["threads"], forced["ctas_an_sm"]) == (128, 3)
    forced = tpp.launch_plan(256, 120, 120, 3, 112, 112, cluster=4, vals=42,
                             threads=448)
    assert (forced["tr"], forced["maxt"]) == (4, 896)


def test_launch_plan_refuses_a_forced_persist_it_cannot_hold():
    """Five 14x14 images (588 bytes each, 4-byte copies) cannot persist."""
    assert not tpp.launch_plan(5, 14, 14, 3, 14, 14)["persist"]
    with pytest.raises(ValueError, match="cannot persist"):
        tpp.launch_plan(5, 14, 14, 3, 14, 14, persist=True)


@pytest.mark.parametrize("shape,match", [
    ((1, 8, 8, 3, 1024, 1024), "does not fit 448 threads x 84 values"),
    ((1, 4, 40000, 3, 3, 8), "do not fit in shared memory")], ids=str)
def test_launch_plan_refuses_what_no_plan_holds(shape, match):
    with pytest.raises(ValueError, match=match):
        tpp.launch_plan(*shape)


def _emulate(x: np.ndarray, flips, plan, out_h, out_w) -> np.ndarray:
    """The kernel's reads, in numpy: each band's lead run and each
    chunk's runs copied from the flat tensor rounded out to the copy's
    alignment into a poisoned staging area, each row's taps from its
    rows entry, each thread's column taps from its column; then the
    standardization. f32 out."""
    n, h, w, c = x.shape
    flat = x.reshape(-1)
    row_bytes, row_out = w * c, out_w * c
    align = tpp.COPY_ALIGN[plan["copy"]]
    w_idx, w_wt = tpp._taps_np(out_w, w)
    out = np.zeros((n, out_h, row_out), np.float32)
    band, tc, tr, jc = (plan[k] for k in ("band_rows", "tc", "tr", "jc"))

    def copy(stage, img_off, first, rows, off):
        start = img_off + first * row_bytes
        frm = start - start % align
        to = -(-(start + rows * row_bytes) // align) * align
        assert 0 <= frm and to <= flat.size
        stage[off:off + to - frm] = flat[frm:to]

    for img in range(n):
        img_off = img * h * w * c
        for r, lead in enumerate(plan["lead"]):
            c_first, c_end = lead[:2]
            for ci in range(c_first, c_end):
                lo, hi, a, e = plan["chunks"][ci]
                stage = np.full(plan["stage_bytes"], 255, np.uint8)
                if ci == c_first:
                    assert (lo, hi, a, e) == tuple(lead[2:6])
                    copy(stage, img_off, lead[6], lead[7], 0)
                    a += 1
                for first, rows, off in plan["segs"][a:e]:
                    copy(stage, img_off, first, rows, off)
                cw = plan["cw"]
                for t in range(plan["threads"]):
                    g, col0 = divmod(t, tc)
                    if g >= tr:
                        continue
                    for row in range(g, min(band, out_h - r * band), tr):
                        o = r * band + row
                        if not lo <= o < hi:
                            continue
                        run_byte, staged, w0, w1 = plan["rows"][o]
                        r0 = staged + (img_off + run_byte) % align
                        r1 = r0 + (row_bytes if w1 else 0)
                        a0, a1 = np.array([w0, w1], np.int32).view(np.float32)
                        for i, ch3 in ((i, ch3) for i in range(jc)
                                       for ch3 in range(cw)):
                            j = (col0 + i * tc) * cw + ch3
                            if j >= row_out:
                                continue
                            wo, ch = divmod(j, c)
                            ws = out_w - 1 - wo if flips is not None and flips[img] else wo
                            x0, x1 = w_idx[ws] * c + ch
                            b0, b1 = w_wt[ws]
                            s0 = stage[r0:].astype(np.float32)
                            s1 = stage[r1:].astype(np.float32)
                            y0 = a0 * s0[x0] + a1 * s1[x0]
                            y1 = a0 * s0[x1] + a1 * s1[x1]
                            out[img, o, j] = b0 * y0 + b1 * y1
    mean = out.mean(axis=(1, 2), keepdims=True)
    var = np.square(out - mean).mean(axis=(1, 2), keepdims=True)
    adj = np.maximum(np.sqrt(var), 1.0 / np.sqrt(out_h * out_w * c))
    return ((out - mean) / adj).reshape(n, out_h, out_w, c)


# (images shape, out_h, out_w, launch_plan overrides)
_EMULATED = {
    "main_path_c4": ((2, 120, 120, 3), 112, 112, {"cluster": 4}),
    "main_path_c2": ((2, 120, 120, 3), 112, 112, {"cluster": 2}),
    "main_path_c1": ((2, 120, 120, 3), 112, 112, {"cluster": 1}),
    "unaligned_14_async4": ((5, 14, 14, 3), 14, 14, {}),
    "unaligned_5x5_bytes": ((3, 5, 5, 3), 4, 4, {}),
    "upscale_10x8_to_16x12": ((2, 10, 8, 3), 16, 12, {}),
    "frame_512_to_112": ((2, 512, 512, 3), 112, 112, {}),
    "frame_2048_chunked": ((1, 2048, 2048, 3), 112, 112, {}),
    "gray_tall_upscale": ((2, 30, 20, 1), 200, 24, {"copy": "async4"}),
    "wide_rows": ((2, 4, 300, 3), 4, 1000, {}),
}


@pytest.mark.parametrize("case", sorted(_EMULATED))
def test_plan_tables_reproduce_the_plain_version(case):
    """Through the plan's tables, as the kernel reads them, the staged
    source gives the plain version's output (flips mixed)."""
    shape, out_h, out_w, force = _EMULATED[case]
    x = _u8(shape, seed=len(case))
    flips = np.arange(shape[0]) % 2
    plan = tpp.launch_plan(*shape, out_h, out_w, **force)
    got = _emulate(x, flips, plan, out_h, out_w)
    want = tpp.fused_preprocess_reference(
        torch.from_numpy(x), torch.from_numpy(flips), out_h=out_h,
        out_w=out_w).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,out_h,out_w,dt", [
    ((3, 20, 16, 3), 12, 12, "f32"), ((2, 120, 120, 3), 112, 112, "bf16"),
    ((2, 10, 8, 3), 16, 12, "f32")], ids=str)
def test_eval_preprocess_without_mask(shape, out_h, out_w, dt):
    """No mask is the zero mask, and matches the JAX eval chain."""
    x = _u8(shape, seed=out_h)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    got = tpp.fused_eval_preprocess(torch.from_numpy(x), out_h, out_w,
                                    out_dtype=tdt)
    zero = tpp.fused_preprocess(torch.from_numpy(x), torch.zeros(shape[0]),
                                out_h=out_h, out_w=out_w, out_dtype=tdt)
    assert torch.equal(got, zero)
    want = np.asarray(jpp.fused_eval_preprocess(
        jnp.asarray(x), out_h, out_w, out_dtype=jdt, interpret=True), np.float32)
    got = got.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want) + 1e-5).all()


@pytest.mark.parametrize("shape,size", [((3, 120, 120, 3), 112),
                                        ((2, 10, 8, 3), 16)], ids=str)
def test_library_route_computes_the_plain_version(shape, size):
    """The bench's library route (F.interpolate bilinear, no antialias)
    is the kernel's function up to f32 rounding of the source
    coordinate, which PyTorch computes in f32 (one step at 107.7 is
    7.6e-6, times a 255-level pixel step, over a std near 74: ~3e-5),
    so it is held to the card tests' 1e-4."""
    from tf_face_toolbox_tpu_torch.bench_preprocess import library_route

    x = torch.from_numpy(_u8(shape, seed=size))
    flips = torch.tensor([1, 0, 1][:shape[0]])
    got = library_route(x, flips, size, dtype=torch.float32)
    want = tpp.fused_preprocess_reference(x, flips, out_h=size, out_w=size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
