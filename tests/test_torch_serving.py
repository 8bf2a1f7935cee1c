"""Port serving engine (BN-folded, optionally fused) vs the JAX engine.

Both engines fold the same warm variables. The port runs the folded
convs through torch and the fused blocks through the kernel's plain
PyTorch version (CPU); the JAX engine runs its Pallas kernel in
interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_serving import _NET_KW, _warm_variables
from tests.util import jit_apply
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.serving import engine as jeng
from tf_face_toolbox_tpu_torch.interop.port import unflatten_variables
from tf_face_toolbox_tpu_torch.models import create_network, random_variables
from tf_face_toolbox_tpu_torch.serving import engine as teng

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _variables(stem: str, head: str, dtype_name: str):
    jnet = jax_network("resnet_tiny", **_NET_KW, stem=stem, head_variant=head,
                       dtype=getattr(jnp, dtype_name))
    return jnet, _warm_variables(jnet, jax.random.key(0), (4, 32, 32, 3))


def _inputs(seed=1):
    return np.random.default_rng(seed).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("stem,head", [("imagenet", "gap"), ("face", "gap"),
                                       ("imagenet", "flatten")])
def test_engine_matches_jax_f32(stem, head, use_kernels):
    jnet, variables = _variables(stem, head, "float32")
    x = _inputs()
    want_engine = np.asarray(jeng.make_serving_apply(
        jnet, variables, use_pallas=True, interpret=True)(None, x))
    want_module = np.asarray(jit_apply(jnet, variables, x))
    tnet = create_network("resnet_tiny", **_NET_KW, stem=stem,
                          head_variant=head, input_size=32)
    apply = teng.make_serving_apply(tnet, flatten_variables(variables),
                                    use_kernels=use_kernels, device="cpu")
    got = apply(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want_engine.shape
    np.testing.assert_allclose(got, want_engine, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, want_module, rtol=2e-4, atol=2e-4)


def test_engine_matches_jax_bf16():
    jnet, variables = _variables("imagenet", "gap", "bfloat16")
    x = _inputs(2)
    want = np.asarray(jeng.make_serving_apply(
        jnet, variables, use_pallas=True, interpret=True)(None, x),
        np.float64)
    tnet = create_network("resnet_tiny", **_NET_KW, stem="imagenet",
                          dtype=torch.bfloat16)
    got = teng.make_serving_apply(tnet, flatten_variables(variables),
                                  use_kernels=True,
                                  device="cpu")(torch.from_numpy(x))
    assert got.dtype == torch.float32
    got = got.double().numpy()
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999


@pytest.mark.parametrize("network,stem", [("resnet_v1_50", "imagenet"),
                                          ("resnet_v1_50", "face"),
                                          ("resnet_v1_101", "imagenet")])
def test_fusion_plan_equals_jax(network, stem):
    """Same split per stage: folded prefix length, entry block, and the
    number of stacked identity blocks (13 fused blocks for the r50
    imagenet stem: 3 + 3 + 5 + 2)."""
    tnet = create_network(network, stem=stem)
    flat = random_variables(tnet, seed=0)
    variables = unflatten_variables(flat)
    jplan = jeng.build_plan(jax_network(network, stem=stem), variables)
    tplan = teng.build_plan(tnet, flat)
    splits = []
    for jblocks, tblocks in zip(jplan.stages, tplan.stages, strict=True):
        jn, jentry, jtail = jeng._plan_stage_fusion(jblocks)
        tn, tentry, ttail = teng._plan_stage_fusion(tblocks)
        jk = 0 if jtail is None else jtail["w1s"].shape[0]
        tk = 0 if ttail is None else ttail["w1s"].shape[0]
        assert (tn, tentry is None, tk) == (jn, jentry is None, jk)
        splits.append((tentry is not None) + tk)
    if (network, stem) == ("resnet_v1_50", "imagenet"):
        assert splits == [3, 3, 5, 2]


def test_engine_refuses_what_it_cannot_fold():
    with pytest.raises(ValueError, match="ResNet family"):
        teng.build_plan(torch.nn.Linear(2, 2), {"params": {}})
    net = create_network("resnet_tiny", dtype=torch.float32)
    flat = random_variables(net)
    with pytest.raises(ValueError, match="bf16"):
        teng.make_serving_apply(net, flat, use_kernels=True,
                                device=torch.device("cuda"))
