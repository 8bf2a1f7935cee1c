"""Port ResNet and the weight bridge vs the JAX package.

Weights come from JAX init plus train-mode steps (non-trivial BN
statistics), cross the flat ``.npz`` key space, and load into the port
with ``load_jax_variables``; both forwards then see the same inputs.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_serving import _NET_KW, _warm_variables
from tests.util import jit_apply
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.models import init_variables
from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
from tf_face_toolbox_tpu_torch.models import (
    create_network,
    list_networks,
    random_variables,
)
from tf_face_toolbox_tpu_torch.models.layers import l2_normalize, same_pad

torch.set_num_threads(1)


def _pair(stem, head, size, name="resnet_tiny", kw=_NET_KW, steps=2):
    """(JAX net, warm flat variables, port net with them loaded)."""
    jnet = jax_network(name, **kw, stem=stem, head_variant=head)
    variables = _warm_variables(jnet, jax.random.key(0), (2, size, size, 3),
                                steps=steps)
    flat = flatten_variables(variables)
    tnet = create_network(name, **kw, stem=stem, head_variant=head,
                          input_size=size)
    return jnet, variables, load_jax_variables(tnet, flat)


@pytest.mark.parametrize("stem", ["imagenet", "face"])
@pytest.mark.parametrize("head", ["gap", "flatten"])
@pytest.mark.parametrize("size", [32, 27])
def test_resnet_matches_jax_f32(stem, head, size):
    jnet, variables, tnet = _pair(stem, head, size)
    x = np.random.default_rng(size).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jit_apply(jnet, variables, x))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("stem", ["imagenet", "face"])
@pytest.mark.parametrize("head", ["gap", "flatten"])
def test_random_variables_span_the_jax_key_space(stem, head):
    jnet = jax_network("resnet_tiny", **_NET_KW, stem=stem, head_variant=head)
    want = flatten_variables(init_variables(jnet, jax.random.key(0),
                                            (1, 24, 24, 3)))
    tnet = create_network("resnet_tiny", **_NET_KW, stem=stem,
                          head_variant=head, input_size=24)
    got = random_variables(tnet, seed=3)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())
    np.testing.assert_array_equal(
        random_variables(tnet, seed=3)["params/ConvBN_0/kernel"],
        got["params/ConvBN_0/kernel"])


def test_weight_bridge_is_total():
    jnet = jax_network("resnet_tiny", **_NET_KW, stem="imagenet")
    flat = flatten_variables(init_variables(jnet, jax.random.key(0),
                                            (1, 16, 16, 3)))
    tnet = create_network("resnet_tiny", **_NET_KW, stem="imagenet")
    load_jax_variables(tnet, flat)
    np.testing.assert_array_equal(
        tnet.ConvBN_0.weight.detach().numpy(),
        flat["params/ConvBN_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        tnet.EmbeddingHead_0.Dense_0.weight.detach().numpy(),
        flat["params/EmbeddingHead_0/Dense_0/kernel"].T)
    np.testing.assert_array_equal(
        tnet.BottleneckBlock_0.ConvBN_1.BatchNorm_0.running_var.numpy(),
        flat["batch_stats/BottleneckBlock_0/ConvBN_1/BatchNorm_0/var"])

    missing = dict(flat)
    del missing["batch_stats/BottleneckBlock_1/ConvBN_2/BatchNorm_0/mean"]
    with pytest.raises(ValueError, match="1 missing"):
        load_jax_variables(tnet, missing)
    extra = {**flat, "params/BottleneckBlock_9/ConvBN_0/kernel":
             flat["params/BottleneckBlock_0/ConvBN_0/kernel"]}
    with pytest.raises(ValueError, match="1 unused"):
        load_jax_variables(tnet, extra)
    bad = {**flat, "params/ConvBN_0/kernel":
           flat["params/ConvBN_0/kernel"][:, :, :, :-1]}
    with pytest.raises(ValueError, match="params/ConvBN_0/kernel"):
        load_jax_variables(tnet, bad)


@pytest.mark.parametrize("size,k,s,want", [
    (112, 7, 2, (2, 3)),     # imagenet stem conv
    (56, 3, 2, (0, 1)),      # max pool / strided 3x3 on an even map
    (7, 3, 2, (1, 1)),       # 3x3/s2 on 7 -> 4
    (28, 1, 2, (0, 0)),      # strided 1x1 projection
    (14, 3, 1, (1, 1)),
])
def test_same_pad_is_tf_same(size, k, s, want):
    top, bottom, left, right = same_pad(size, size, k, s)
    assert (top, bottom) == want and (left, right) == want


def test_l2_normalize_is_not_f_normalize():
    x = torch.tensor([[3.0, 4.0], [0.0, 0.0], [1e-7, 0.0]])
    got = l2_normalize(x)
    np.testing.assert_allclose(got[0].numpy(), [0.6, 0.8], rtol=1e-6)
    assert torch.equal(got[1], torch.zeros(2))
    # sqrt(x^2 + 1e-12) for a tiny x: not the unit vector F.normalize gives
    np.testing.assert_allclose(got[2, 0].item(),
                               1e-7 / np.sqrt(1e-14 + 1e-12), rtol=1e-5)


def test_unported_networks_and_options_raise():
    """Every JAX registry name is ported (the dct stem and the ViTs since
    item 17b, held against JAX in tests/test_torch_dct.py and
    tests/test_torch_vit.py); int8 serving raised naming item 18 until it
    was ported (held against JAX in tests/test_torch_int8.py): True is
    JAX's alias of "dynamic"."""
    from tf_face_toolbox_tpu.models import list_networks as jax_list

    assert list_networks() == jax_list()
    net = create_network("resnet_tiny", quantized=True)
    assert net.BottleneckBlock_0.ConvBN_0.mode == "dynamic"
    assert not hasattr(net.BottleneckBlock_0.ConvBN_0, "act_max")
    assert create_network("resnet_tiny", stem="dct").stem == "dct"


@pytest.mark.mid
def test_resnet50_full_width_matches_jax():
    """Full-width stage shapes at a small spatial input (as
    tests/test_serving.py::test_engine_resnet50_slice)."""
    jnet, variables, tnet = _pair("imagenet", "gap", 64,
                                  name="resnet_v1_50", kw={}, steps=1)
    x = np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jit_apply(jnet, variables, x))
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
