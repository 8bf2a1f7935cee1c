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


def _tile_rule_before_the_ring(n, h, w, b):
    """The tile rule as it was before the weight ring took shared
    memory: halve while y1s + y2s pass 232,448 bytes, then pack up to
    8 whole images while they fit 160 KB."""
    def nbytes(th, tw, g):
        return g * ((th + 2) * (tw + 2) + th * tw) * (b + tfb.PAD) * 2
    th, tw = (h if h <= 16 else 14), (w if w <= 16 else 14)
    while nbytes(th, tw, 1) > tfb.SMEM_MAX and (th > 1 or tw > 1):
        if th >= tw:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    g = 1
    if (th, tw) == (h, w):
        while g * 2 <= min(8, n) and nbytes(th, tw, g * 2) <= tfb.SMEM_BUDGET:
            g *= 2
    return th, tw, g


@pytest.mark.parametrize("shape", _PLAN_SHAPES, ids=str)
def test_launch_plan_fits_and_covers(shape):
    """Shared memory within a CTA's 232,448 bytes; every phase's warps
    tile the n-block with at most 64 f32 accumulators a thread, and its
    passes cover every output row."""
    n, h, w, cin, b, c = shape
    plan = tfb.launch_plan(*shape)
    assert plan["smem_bytes"] <= 232448
    assert plan["stages"] in (2, 3)
    th, tw, g = plan["th"], plan["tw"], plan["g"]
    assert plan["grid"] == -(-n // g) * -(-h // th) * -(-w // tw)
    for name, ph in plan["phases"].items():
        # the kernel's warps: nb // 64 across, the rest down the rows
        warps_n = ph["nb"] // tfb.WARP_COLS
        assert warps_n * tfb.WARP_COLS == ph["nb"] and tfb.WARPS % warps_n == 0
        rows = tfb.WARPS // warps_n * tfb.WARP_ROWS
        assert rows * ph["nb"] // tfb.THREADS <= 64, name
        assert ph["m"] <= rows or ph["nb"] == tfb.WARP_COLS, name  # one pass if wider
        assert ph["nb"] < 2 * max(ph["n"], tfb.WARP_COLS)   # no idle n-block half
    m1, m2 = g * (th + 2) * (tw + 2), g * th * tw
    assert (plan["phases"]["y1"]["m"], plan["phases"]["y3"]["m"]) == (m1, m2)
    ring = max(ph["nb"] for ph in plan["phases"].values())
    assert plan["smem_bytes"] == ((m1 + m2) * (b + tfb.PAD) * 2
                                  + plan["stages"] * ring * tfb.ROW_STRIDE * 2)
    two = 2 * (plan["smem_bytes"] + tfb.SMEM_PER_CTA) <= tfb.SMEM_PER_SM
    assert plan["ctas_per_sm"] == (2 if two else 1)


# where a 2-stage ring does not fit beside the tile of the rule before
# it: the tile that the halving leaves (th, tw, g). The tile halves at
# 9x9 x 512 -> 2048 and 20x13 x 256 -> 1024; the images packed halve at
# 4x4 x 384 -> 1536 (4 to 2) and 4x4 x 768 -> 3072 (2 to 1).
_SHRINK = {(256, 9, 9, 2048, 512, 2048): (5, 9, 1),
           (256, 20, 13, 1024, 256, 1024): (7, 13, 1),
           (256, 4, 4, 1536, 384, 1536): (4, 4, 2),
           (256, 4, 4, 3072, 768, 3072): (4, 4, 1)}


@pytest.mark.parametrize("shape", _R50 + list(_SHRINK), ids=str)
def test_launch_plan_keeps_the_tile_rule_where_the_ring_fits(shape):
    """The ring shrinks the tile (or the images packed) only where it
    does not fit beside y1s and y2s; then by the same halving."""
    n, h, w, cin, b, c = shape
    th, tw, g = before = _tile_rule_before_the_ring(n, h, w, b)
    plan = tfb.launch_plan(*shape)
    fits = tfb._plan_bytes(th, tw, g, b, c, 2) <= tfb.SMEM_MAX
    assert fits == (shape not in _SHRINK)
    assert (plan["th"], plan["tw"], plan["g"]) == (
        before if fits else _SHRINK[shape])


def test_launch_plan_main_path():
    """resnet_v1_50 at 256 images: the tiles, n-blocks, stages and CTAs
    an SM of the four fused stages."""
    got = [(p["th"], p["tw"], p["g"], p["stages"], p["ctas_per_sm"],
            tuple(p["phases"][k]["nb"] for k in ("y1", "y2", "y3")))
           for p in (tfb.launch_plan(*s) for s in _R50[1:5])]
    assert got == [(14, 14, 1, 3, 2, (64, 64, 64)),
                   (14, 14, 1, 3, 1, (64, 64, 64)),
                   (7, 7, 2, 3, 1, (64, 128, 128)),
                   (4, 4, 2, 3, 1, (128, 256, 256))]


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

