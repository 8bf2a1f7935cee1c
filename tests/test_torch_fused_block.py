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

