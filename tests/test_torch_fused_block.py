"""Port fused-block stack vs the JAX Pallas kernel (interpret mode).

Both packages fold the same warm variables; the port's stack runs its
plain PyTorch version on the CPU (the CUDA kernel only on a card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_serving import _NET_KW, _warm_variables
from tests.test_torch_gpu import _BLOCKS as _GPU_BLOCKS
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.serving import engine as jeng
from tf_face_toolbox_tpu.serving.fused_block import (
    fused_bottleneck_stack as jax_stack)
from tf_face_toolbox_tpu_torch.models import create_network
from tf_face_toolbox_tpu_torch.serving import engine as teng
from tf_face_toolbox_tpu_torch.serving import fused_block as tfb

torch.set_num_threads(1)

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _segments(dt: str, stage: int):
    """(JAX entry, tail), (port entry, tail) of one stage's fused segment
    (cached: the operands are only read)."""
    jdt, tdt = _DTYPES[dt]
    jnet = jax_network("resnet_tiny", **_NET_KW, stem="imagenet", dtype=jdt)
    variables = _warm_variables(jnet, jax.random.key(0), (2, 32, 32, 3))
    _, jentry, jtail = jeng._plan_stage_fusion(
        jeng.build_plan(jnet, variables).stages[stage])
    tnet = create_network("resnet_tiny", **_NET_KW, stem="imagenet",
                          dtype=tdt)
    _, tentry, ttail = teng._plan_stage_fusion(
        teng.build_plan(tnet, flatten_variables(variables)).stages[stage])
    return (jentry, jtail), (tentry, ttail)


def _run_both(dt, stage, size, seed=2):
    jdt, tdt = _DTYPES[dt]
    (jentry, jtail), (tentry, ttail) = _segments(dt, stage)
    cin = (tentry["w1"] if tentry is not None else ttail["w1s"][0]).shape[1]
    x = np.maximum(np.random.default_rng(seed).standard_normal(
        (2, size, size, cin)), 0).astype(np.float32)
    want = jax_stack(jnp.asarray(x, jdt), jentry, jtail, h=size, w=size,
                     images_per_step=1, interpret=True)
    got = tfb.fused_bottleneck_stack(torch.from_numpy(x).to(tdt), tentry,
                                     ttail, h=size, w=size)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("stage,size", [(0, 8), (0, 7), (1, 4), (1, 5)])
def test_fused_stack_matches_jax_kernel_f32(stage, size):
    """Stage 0: stride-1 projection entry + identity tail; stage 1: the
    identity tail after a strided entry. Even and odd map sizes."""
    got, want = _run_both("f32", stage, size)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_fused_stack_matches_jax_kernel_bf16():
    got, want = _run_both("bf16", 0, 8)
    a = got.reshape(got.shape[0], -1).astype(np.float64)
    b = want.reshape(want.shape[0], -1).astype(np.float64)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() >= 0.9999


def test_operands_are_the_jax_operands_transposed():
    """The port's output-major operands hold the JAX kernel's weights."""
    (jentry, jtail), (tentry, ttail) = _segments("f32", 0)
    b = tentry["w1"].shape[0]
    # rtol: the two folds' f32 rsqrt may differ in the last bit
    np.testing.assert_allclose(tentry["w1"].numpy(),
                               np.asarray(jentry["w1"]).T, rtol=1e-6)
    np.testing.assert_allclose(
        tentry["w2"].numpy(),
        np.asarray(jentry["w2"]).reshape(9, b, b).transpose(2, 0, 1),
        rtol=1e-6)
    np.testing.assert_allclose(tentry["wp"].numpy(),
                               np.asarray(jentry["wp"]).T, rtol=1e-6)
    np.testing.assert_allclose(ttail["b3s"].numpy(),
                               np.asarray(jtail["b3s"])[:, 0], rtol=1e-6)
    assert ttail["w1s"].shape[0] == jtail["w1s"].shape[0]


# the launch plan (decided by launch_plan, checked by the C entry
# point): the r50 stages' fused segments at 256 images (imagenet stem:
# 28x28 entry and tail, 14x14, 7x7, 4x4; face stem: 56x56 and 7x7 at 64
# images), and every shape the kernel tests run on the card
_R50 = [(256, 28, 28, 64, 64, 256), (256, 28, 28, 256, 64, 256),
        (256, 14, 14, 512, 128, 512), (256, 7, 7, 1024, 256, 1024),
        (256, 4, 4, 2048, 512, 2048), (64, 56, 56, 256, 64, 256),
        (64, 7, 7, 2048, 512, 2048)]
_PLAN_SHAPES = _R50 + [s[:6] for s in _GPU_BLOCKS]


def _smem_sum(plan, h, w, b):
    """y1s + y2s + the ring, by the formula: whole images hold y1's
    image rows and one zero row, tiles y1's (th+2) x (tw+2) halo."""
    th, tw, g = plan["th"], plan["tw"], plan["g"]
    if (th, tw) == (h, w):
        rows = 2 * g * h * w + 1
    else:
        rows = g * ((th + 2) * (tw + 2) + th * tw)
    ring = max(ph["nb"] for ph in plan["phases"].values())
    return rows * (b + 8) * 2 + plan["stages"] * ring * 144


@pytest.mark.parametrize("shape", _PLAN_SHAPES, ids=str)
def test_launch_plan_fits_and_covers(shape):
    """Shared memory within a CTA's 232,448 bytes; every phase's warps
    tile the n-block with at most 64 f32 accumulators a thread, and its
    passes cover every output row; a pair's two halves of each phase's
    columns are multiples of 16 and cover them without overlap; on whole
    images every pass's rows more than half fill the warps' m-tile
    slots unless the n-block is already as wide as it goes."""
    n, h, w, cin, b, c = shape
    plan = tfb.launch_plan(*shape)
    assert plan["smem_bytes"] <= 232448
    assert plan["stages"] in (2, 3) and plan["cluster"] in (1, 2)
    th, tw, g, cl = plan["th"], plan["tw"], plan["g"], plan["cluster"]
    whole = (th, tw) == (h, w)
    assert plan["grid"] == -(-n // g) * -(-h // th) * -(-w // tw) * cl
    assert cl == 1 or whole
    for name, ph in plan["phases"].items():
        # the kernel's warps: nb // 64 across, the rest down the rows
        warps_n = ph["nb"] // tfb.WARP_COLS
        assert warps_n * tfb.WARP_COLS == ph["nb"] and tfb.WARPS % warps_n == 0
        rows = tfb.WARPS // warps_n * tfb.WARP_ROWS
        assert rows * ph["nb"] // tfb.THREADS <= 64, name
        assert ph["m"] <= rows or ph["nb"] == tfb.WARP_COLS, name  # one pass if wider
        assert ph["nb"] < 2 * max(ph["n_cta"], tfb.WARP_COLS)  # no idle n-block half
        # rank r computes columns [r * n_cta, (r + 1) * n_cta)
        halves = [set(range(r * ph["n_cta"], (r + 1) * ph["n_cta"]))
                  for r in range(cl)]
        assert set().union(*halves) == set(range(ph["n"]))
        assert sum(map(len, halves)) == ph["n"] and ph["n_cta"] % 16 == 0
        if whole:
            m_tiles, slots = -(-ph["m"] // 16), rows // 16
            idle = -(-m_tiles // slots) * slots - m_tiles
            widest = ph["nb"] == 256 or 2 * ph["nb"] > ph["n_cta"]
            assert 2 * idle < slots or widest, (name, m_tiles, slots)
    m2 = g * th * tw
    m1 = m2 if whole else g * (th + 2) * (tw + 2)
    assert (plan["phases"]["y1"]["m"], plan["phases"]["y3"]["m"]) == (m1, m2)
    assert plan["smem_bytes"] == _smem_sum(plan, h, w, b)
    two = 2 * (plan["smem_bytes"] + tfb.SMEM_PER_CTA) <= tfb.SMEM_PER_SM
    assert plan["ctas_per_sm"] == (2 if two and not whole else 1)


# shapes whose 2-stage ring does not fit beside the tile the plan would
# otherwise take, with the (th, tw, g, cluster) that it takes: the tile
# halves at 20x13 x 256 -> 1024 (14x13 -> 7x13); at 9x9 x 512 -> 2048
# the whole image fits once y1 has no halo (the halo tile was 5x9); at
# 4x4 x 384 -> 1536 and 4x4 x 768 -> 3072 fewer images fit than the
# four of the 4x4 stage's plan
_SHRINK = {(256, 9, 9, 2048, 512, 2048): (9, 9, 1, 2),
           (256, 20, 13, 1024, 256, 1024): (7, 13, 1, 1),
           (256, 4, 4, 1536, 384, 1536): (4, 4, 4, 2),
           (256, 4, 4, 3072, 768, 3072): (4, 4, 2, 1)}


@pytest.mark.parametrize("shape", _R50 + list(_SHRINK), ids=str)
def test_launch_plan_keeps_the_tile_rule_where_the_ring_fits(shape):
    """The tile halves only where a 2-stage ring does not fit beside
    one tile's y1s and y2s (maps up to 16 wide whole, else 14-wide
    tiles); a smaller g is taken wherever its busiest SM streams no
    more weight bytes; the shrink shapes take the plans listed."""
    n, h, w, cin, b, c = shape
    plan = tfb.launch_plan(*shape)
    th, tw = (h if h <= 16 else 14), (w if w <= 16 else 14)
    whole = (th, tw) == (h, w)
    fits = tfb._plan_bytes(th, tw, 1, b, c, 2, whole) <= tfb.SMEM_MAX
    assert fits == ((plan["th"], plan["tw"]) == (th, tw))
    for g in range(1, plan["g"]):
        other = tfb.launch_plan(*shape, g=g, cluster=plan["cluster"])
        assert other["stream_bytes"] > plan["stream_bytes"], g
    if shape in _SHRINK:
        assert (plan["th"], plan["tw"], plan["g"], plan["cluster"]) == _SHRINK[shape]


@pytest.mark.parametrize("shape,g,cluster", [
    ((256, 4, 4, 2048, 512, 2048), 4, 2), ((256, 4, 4, 2048, 512, 2048), 2, 1),
    ((7, 7, 7, 1024, 256, 1024), 3, 2), ((2, 1, 1, 256, 64, 256), 2, 1),
    ((256, 28, 28, 256, 64, 256), 1, 1), ((4, 20, 13, 64, 32, 128), 1, 1)],
    ids=str)
def test_launch_plan_smem_sum_both_modes(shape, g, cluster):
    """Forced plans, whole images (lone and pair) and halo tiles: the
    shared-memory sum is the formula's (the C side recomputes it and
    refuses any other), and a pair halves every phase's columns."""
    n, h, w, cin, b, c = shape
    plan = tfb.launch_plan(*shape, g=g, cluster=cluster)
    assert (plan["g"], plan["cluster"]) == (g, cluster)
    assert plan["smem_bytes"] == _smem_sum(plan, h, w, b)
    assert [ph["n_cta"] for ph in plan["phases"].values()] == [
        b // cluster, b // cluster, c // cluster]
    if (plan["th"], plan["tw"]) == (h, w):
        assert plan["phases"]["y1"]["m"] == g * h * w


def test_launch_plan_main_path():
    """resnet_v1_50 at 256 images: the tiles, images a CTA, ring stages,
    CTAs an SM, cluster and n-blocks of the four fused stages."""
    got = [(p["th"], p["tw"], p["g"], p["stages"], p["ctas_per_sm"],
            p["cluster"], tuple(p["phases"][k]["nb"] for k in ("y1", "y2", "y3")))
           for p in (tfb.launch_plan(*s) for s in _R50[1:5])]
    assert got == [(14, 14, 1, 3, 2, 1, (64, 64, 64)),
                   (14, 14, 1, 3, 1, 2, (64, 64, 64)),
                   (7, 7, 4, 2, 1, 2, (64, 64, 64)),
                   (4, 4, 4, 2, 1, 2, (256, 256, 256))]


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        tfb.launch_plan(1, 4, 4, 16384, 16384, 16384)


def test_stack_rejects_bad_operands():
    (_, _), (tentry, ttail) = _segments("f32", 0)
    x = torch.zeros((1, 4, 4, tentry["w1"].shape[1]))
    with pytest.raises(ValueError, match="spatial"):
        tfb.fused_bottleneck_stack(x, tentry, ttail, h=5, w=4)
    with pytest.raises(ValueError, match="entry/tail"):
        tfb.fused_bottleneck_stack(x, None, None, h=4, w=4)
    bad = {**tentry, "w3": tentry["w3"][:, :-1]}
    with pytest.raises(ValueError, match="w3"):
        tfb.fused_bottleneck_block(x, bad)

