"""Port top-k (plain versions of kernels 3 and 4) vs the JAX package.

The same numpy stores and probes go through tf_face_toolbox_tpu's
Pallas kernels (interpret mode on the CPU, as tests/test_pallas_topk.py
runs them) and tf_face_toolbox_tpu_torch's wrappers, which on a CPU
tensor run the plain PyTorch versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_face_toolbox_tpu.ops.pallas_topk import (
    cosine_topk_impl,
    cosine_topk_q_impl,
)
from tf_face_toolbox_tpu.serving.gallery import (
    _quantize_rows,
    _search_fn,
    _search_q_fn,
)
from tf_face_toolbox_tpu_torch.ops import topk as ttk

torch.set_num_threads(1)

DIM = 512


def _unit(rng, n, dim=DIM):
    e = rng.normal(size=(n, dim)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_topk_close(got, want_s, want_i, ref_next=None, tol=1e-5):
    """Scores within ``tol``; indices equal except at positions whose
    reference score is within ``tol`` of a neighbour's (the k-th and
    (k+1)-th included, via ``ref_next``: the top k+1 scores)."""
    gs, gi = (np.asarray(t) for t in got)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(gs, want_s, atol=tol, rtol=0)
    ref = want_s if ref_next is None else np.asarray(ref_next)
    gap = np.diff(-ref, axis=1) <= tol
    k = want_s.shape[1]
    near = np.zeros(want_i.shape, bool)
    near[:, 1:] |= gap[:, :k - 1]
    near[:, :gap.shape[1]] |= gap[:, :k]
    np.testing.assert_array_equal(gi[~near], want_i[~near])


@pytest.mark.parametrize("batch", [1, 7, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_topk_matches_jax_kernel(batch, dtype):
    rng = np.random.default_rng(3)
    cap, n, k = 3072, 2500, 5
    g = np.zeros((cap, DIM), np.float32)
    g[:n] = _unit(rng, n)
    p = g[:n][rng.integers(0, n, batch)]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    js, ji = cosine_topk_impl(jnp.asarray(g, jdt), jnp.asarray(p), n, k + 1,
                              interpret=True)
    got = ttk.cosine_topk(_t(g).to(tdt), _t(p), n, k)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    assert tuple(got[0].shape) == (batch, k)
    assert_topk_close(got, np.asarray(js)[:, :k], np.asarray(ji)[:, :k],
                      ref_next=js)
    assert np.all(np.diff(got[0].numpy(), axis=1) <= 0)


def test_cosine_topk_masks_partial_fill_and_ties():
    rng = np.random.default_rng(4)
    cap, n = 2048, 1100                  # tail block half-masked
    g = np.zeros((cap, DIM), np.float32)
    g[:n] = _unit(rng, n)
    g[7] = g[1040]                       # exact tie across blocks
    p = g[7:8]
    s, i = ttk.cosine_topk(_t(g), _t(p), n, 3)
    js, ji = cosine_topk_impl(jnp.asarray(g), jnp.asarray(p), n, 3,
                              interpret=True)
    # the tie resolves to the smallest index, like lax.top_k
    assert i[0, 0] == 7 and i[0, 1] == 1040
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    # masked rows (>= n) never surface
    _, i = ttk.cosine_topk(_t(g), _t(p), n, 5)
    assert i.max() < n


def _gallery_with_scores(base, others, scores, cap):
    """Rows whose cosine against ``base`` is ``scores`` (base mixed with
    an orthogonalized partner), as tests/test_pallas_topk.py builds."""
    g = np.empty((cap, DIM), np.float32)
    for j, s in enumerate(scores):
        v = others[j] - (others[j] @ base) * base
        v /= np.linalg.norm(v)
        g[j] = s * base + np.sqrt(1.0 - s * s) * v
    return g


@pytest.mark.parametrize("order", ["ascending", "descending", "clustered",
                                   "duplicate"])
def test_adversarial_orderings_match_jax(order):
    """Orderings that stress a streaming merge: every block's best
    enters (ascending), none after the first (descending), the whole
    top-k in one interior block (clustered), and an exact cross-block
    duplicate inside the top-k."""
    rng = np.random.default_rng(9)
    cap = n = 4096
    k = 6
    base = _unit(rng, 1)[0]
    others = _unit(rng, n)
    p = base[None, :].astype(np.float32)
    if order == "ascending":
        scores = np.linspace(-0.9, 0.9, n)
    elif order == "descending":
        scores = np.linspace(0.9, -0.9, n)
    elif order == "clustered":
        scores = np.concatenate([np.linspace(-0.5, 0.0, 2048),
                                 np.linspace(0.90, 0.99, 6),
                                 np.linspace(-0.5, 0.0, n - 2054)])
    else:
        scores = np.linspace(-0.9, 0.9, n)
    g = _gallery_with_scores(base, others, scores, cap)
    if order == "duplicate":
        g[1030] = g[4095]
    s, i = ttk.cosine_topk(_t(g), _t(p), n, k)
    js, ji = cosine_topk_impl(jnp.asarray(g), jnp.asarray(p), n, k,
                              interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    ref = (p @ g[:n].T)[0]
    np.testing.assert_array_equal(i.numpy()[0],
                                  np.argsort(-ref, kind="stable")[:k])
    assert len(set(i.numpy()[0].tolist())) == k


@pytest.mark.parametrize("batch", [1, 16])
def test_cosine_topk_q_matches_jax_kernel(batch):
    """int8: index-exact, scores within 1e-6 (the same quantized math)."""
    rng = np.random.default_rng(6)
    cap, n, k = 2048, 1900, 7
    g = np.zeros((cap, DIM), np.float32)
    g[:n] = _unit(rng, n)
    gq, gs = _quantize_rows(g)
    p = g[:n][rng.integers(0, n, batch)]
    pq, ps = _quantize_rows(p)
    js, ji = cosine_topk_q_impl(jnp.asarray(gq), jnp.asarray(gs),
                                jnp.asarray(pq), jnp.asarray(ps), n, k,
                                interpret=True)
    s, i = ttk.cosine_topk_q(_t(gq), _t(gs), _t(pq), _t(ps), n, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_bias_masks_tombstones_like_jax(dtype):
    """A -2e9 row bias (tombstones) masks rows in both packages; with k
    above the live count the dead rows come last, by index."""
    rng = np.random.default_rng(7)
    cap, n, k = 1024, 40, 12
    g = np.zeros((cap, DIM), np.float32)
    g[:n] = _unit(rng, n)
    bias = np.zeros(cap, np.float32)
    dead = np.array([0, 3, 19, 33])
    bias[dead] = -2e9
    p = g[[0, 5, 19]]
    if dtype == "int8":
        gq, gs = _quantize_rows(g)
        pq, ps = _quantize_rows(p)
        js, ji = cosine_topk_q_impl(jnp.asarray(gq), jnp.asarray(gs),
                                    jnp.asarray(pq), jnp.asarray(ps), n, k,
                                    interpret=True, bias=jnp.asarray(bias))
        s, i = ttk.cosine_topk_q(_t(gq), _t(gs), _t(pq), _t(ps), n, k,
                                 bias=_t(bias))
    else:
        js, ji = cosine_topk_impl(jnp.asarray(g), jnp.asarray(p), n, k,
                                  interpret=True, bias=jnp.asarray(bias))
        s, i = ttk.cosine_topk(_t(g), _t(p), n, k, bias=_t(bias))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)
    assert not np.isin(i.numpy(), dead).any()
    # k = the fill: every live row first, then the dead ones by index
    if dtype == "float32":
        s, i = ttk.cosine_topk(_t(g), _t(p), n, n, bias=_t(bias))
        s, i = s.numpy(), i.numpy()
        np.testing.assert_array_equal(i[:, -len(dead):],
                                      np.tile(dead, (3, 1)))
        assert (s[:, -len(dead):] == -2e9).all()


def test_large_k_matches_xla_program():
    """k past 1024 (the kernels' old limit): a CPU store serves it
    through the wrappers, as the JAX XLA programs do, f32 and int8."""
    rng = np.random.default_rng(8)
    cap, n, k = 2048, 1900, 1025
    g = np.zeros((cap, 64), np.float32)
    g[:n] = _unit(rng, n, 64)
    p = g[:3]
    js, ji = _search_fn(k + 1)(jnp.asarray(g), jnp.zeros(cap), jnp.asarray(p),
                               jnp.int32(n))
    got = ttk.cosine_topk(_t(g), _t(p), n, k)
    assert_topk_close(got, np.asarray(js)[:, :k], np.asarray(ji)[:, :k],
                      ref_next=js)
    gq, gs = _quantize_rows(g)
    pq, ps = _quantize_rows(p)
    js, ji = _search_q_fn(k)(jnp.asarray(gq), jnp.asarray(gs), jnp.zeros(cap),
                             jnp.asarray(pq), jnp.asarray(ps), jnp.int32(n))
    s, i = ttk.cosine_topk_q(_t(gq), _t(gs), _t(pq), _t(ps), n, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk_rows", [None, 100, 1000, 4096])
def test_chunked_reference_is_exact(chunk_rows):
    """Any chunking gives the same bits: the merge carries the global
    row index, so ties keep their order across chunk borders."""
    rng = np.random.default_rng(10)
    cap, n, k = 3000, 2900, 40
    g = np.zeros((cap, 64), np.float32)
    g[:n] = _unit(rng, n, 64)
    g[2500:2600] = g[:100]                  # ties across chunks
    p = g[[0, 50, 99]]
    want = ttk.cosine_topk_reference(_t(g), _t(p), n, k, chunk_rows=cap)
    got = ttk.cosine_topk_reference(_t(g), _t(p), n, k, chunk_rows=chunk_rows)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    i = want[1].numpy()
    assert i[0, 0] == 0 and i[0, 1] == 2500


def test_stable_topk_matches_lax_top_k_with_ties():
    import jax

    rng = np.random.default_rng(11)
    x = rng.integers(-3, 4, size=(5, 300)).astype(np.float32) / 4
    x[0, :] = 0.0
    x[1, ::2] = -0.0                        # -0 ties with +0
    x[2, 7] = -2e9
    js, ji = jax.lax.top_k(jnp.asarray(x), 50)
    s, i = ttk.stable_topk(_t(x), 50)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _assert_covers(plan, cap, tile):
    assert plan["slice_rows"] % tile == 0
    assert plan["slices"] * plan["slice_rows"] >= cap
    assert (plan["slices"] - 1) * plan["slice_rows"] < cap


@pytest.mark.parametrize("batch,cap,k", [(1, 10_000_000, 5), (64, 1 << 20, 20),
                                         (300, 1 << 20, 100),
                                         (2048, 10**6, 1024), (7, 100, 64)])
def test_launch_plan_covers_the_store(batch, cap, k):
    for dtype in (torch.float32, torch.bfloat16):
        plan = ttk.launch_plan(batch, cap, k, n_sms=132, dtype=dtype)
        assert 1 <= plan["per_cta"] <= min(batch, 64)
        assert plan["per_cta"] <= plan["slots"] <= 64
        assert plan["smem"] == ttk.stream_smem_bytes(
            plan["slots"], plan["stages"], plan["per_cta"], k)
        _assert_covers(plan, cap, ttk.STREAM_ROWS)
        # about one CTA per SM, never more than 132 in one wave
        n_ptiles = -(-batch // plan["per_cta"])
        assert n_ptiles * plan["slices"] <= max(132, n_ptiles)
    # kernel 4 (int8) takes the same plan, with its probe scales
    plan = ttk.launch_plan(batch, cap, k, n_sms=132, dtype=torch.int8)
    assert 1 <= plan["per_cta"] <= min(batch, 64)
    assert plan["slots"] in (8, 16, 32, 64) and plan["per_cta"] <= plan["slots"]
    assert plan["smem"] == ttk.stream_smem_bytes(
        plan["slots"], plan["stages"], plan["per_cta"], k, int8=True)
    _assert_covers(plan, cap, ttk.STREAM_ROWS)
    n_ptiles = -(-batch // plan["per_cta"])
    assert n_ptiles * plan["slices"] <= max(132, n_ptiles)


@pytest.mark.parametrize("k", [1, 5, 100, 1024])
@pytest.mark.parametrize("batch", [1, 7, 33, 64, 65, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_launch_plan_fits_shared_memory(dtype, batch, k):
    """The stream kernel's plan at every k up to 1024 and batch: the
    ring, score tile and flags, int8 probe scales and lists fit an H100
    block's 232,448 bytes (summed independently of the plan's own
    formula),
    with at least 3 ring stages (down to 8 probes per CTA at k = 1024),
    and the probe slots are a kernel template that holds the CTA's
    probes."""
    f32 = dtype == "float32"
    cap = 10**6
    plan = ttk.launch_plan(batch, cap, k, n_sms=132,
                           dtype=getattr(torch, dtype))
    slots, stages, per_cta = plan["slots"], plan["stages"], plan["per_cta"]
    # 128-byte chunks at a 144-byte stride, then 256 row scales and bias
    ring = stages * ((256 + slots) * 144 + 2 * 256 * 4)
    smem = ring + slots * (260 * 4 + 8) + per_cta * k * 8
    if dtype == "int8":
        smem += slots * 4
    assert plan["smem"] == smem <= 232_448
    assert plan["shared_lists"] and not plan["merge_scratch"]
    assert 3 <= stages <= 4
    assert per_cta <= slots
    assert slots in ((1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 64) if f32
                     else (8, 16, 32, 64))
    if k <= 20:                     # up to 64 probes read the store once
        assert per_cta == min(batch, 64)
    if k == 1024:
        assert per_cta == min(batch, 8)
    _assert_covers(plan, cap, 256)


@pytest.mark.parametrize("k", [1100, 5000, 12000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_launch_plan_places_large_lists(dtype, k):
    """Past k = 1024: the running lists stay in shared memory while
    min(B, 8) probes' lists fit beside a 3-stage ring (k 1100 and 5000
    at B = 2), else they live in the workspace with no list bytes in
    shared memory (k 12,000: 2 x 12,000 x 8 bytes do not fit). The
    merge's lists go to a global scratch when neither all slices' lists
    twice (16 x slices x k bytes) nor three lists (k x 24 bytes) fit in
    232,448 bytes (k 12,000). No slice is shorter than k rows."""
    cap, batch = 1 << 16, 2
    int8 = dtype == "int8"
    plan = ttk.launch_plan(batch, cap, k, n_sms=132,
                           dtype=getattr(torch, dtype))
    assert plan["per_cta"] == batch
    assert plan["shared_lists"] == (k < 12000)
    assert plan["merge_scratch"] == (k == 12000)
    assert plan["merge_scratch"] == (16 * plan["slices"] * k > 232_448
                                     and 24 * k > 232_448)
    lists = batch * k * 8 if plan["shared_lists"] else 0
    assert plan["smem"] == ttk.stream_smem_bytes(
        plan["slots"], plan["stages"], batch, k, int8=int8,
        shared_lists=plan["shared_lists"]) <= 232_448
    assert plan["smem"] - lists == ttk.stream_smem_bytes(
        plan["slots"], plan["stages"], batch, k, int8=int8,
        shared_lists=False)
    assert plan["slice_rows"] >= k and plan["slices"] <= cap // k
    _assert_covers(plan, cap, ttk.STREAM_ROWS)


def test_wrappers_reject_bad_inputs():
    g = torch.zeros((16, 64))
    with pytest.raises(ValueError, match="dim"):
        ttk.cosine_topk(g, torch.zeros((1, 32)), 16, 1)
    with pytest.raises(ValueError, match="store dtype"):
        ttk.cosine_topk(g.to(torch.float16), torch.zeros((1, 64)), 16, 1)
    with pytest.raises(ValueError, match="exceeds the store"):
        ttk.cosine_topk(g, torch.zeros((1, 64)), 16, 17)
    with pytest.raises(ValueError, match="bias"):
        ttk.cosine_topk(g, torch.zeros((1, 64)), 16, 1, bias=torch.zeros(3))
