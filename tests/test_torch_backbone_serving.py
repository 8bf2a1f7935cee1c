"""The port's folded engine, extract CLI and bench on SE-ResNet, the
space2depth stem, ResNeXt and DenseNet vs the JAX package, at tiny
widths.

SE-ResNet and the space2depth stem serve through the folded engine
(and, at space2depth, the fused blocks, here through the kernel's plain
version) equal to JAX's ``make_serving_apply`` (allclose 2e-4);
ResNeXt and DenseNet are refused by the engine, as JAX refuses them,
and ``cli.extract --engine auto`` serves them through the module path.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_backbones import FAMILIES, _D, _jax, _warm_variables, _x
from tests.util import jit_apply
from tf_face_toolbox_tpu.interop.port import flatten_variables
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.serving import engine as jeng
from tf_face_toolbox_tpu_torch.models import create_network, random_variables
from tf_face_toolbox_tpu_torch.serving import engine as teng

torch.set_num_threads(1)

@pytest.mark.parametrize("family", ["se_resnet", "space2depth",
                                    "se_space2depth"])
def test_folded_engine_matches_jax(family):
    """The folded engine on SE-ResNet and on the space2depth stem equals
    JAX's ``make_serving_apply`` and the JAX module."""
    if family == "se_space2depth":
        name, kw, _ = FAMILIES["se_resnet"]
        stem = "space2depth"
        jnet = jax_network(name, **kw, stem=stem)
        variables = _warm_variables(jnet, jax.random.key(0), (2, 32, 32, 3))
    else:
        name, kw, stem = FAMILIES[family]
        jnet, variables = _jax(family, "gap", 32)
    x = _x(32, seed=3)
    want = np.asarray(jeng.make_serving_apply(jnet, variables)(None, x))
    tnet = create_network(name, **kw, stem=stem)
    got = teng.make_serving_apply(tnet, flatten_variables(variables),
                                  device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, np.asarray(jit_apply(jnet, variables, x)),
                               rtol=2e-4, atol=2e-4)


def test_fused_route_matches_jax_pallas_on_space2depth():
    """use_kernels=True on a space2depth net (the stride-1 entry block
    fused at stage 0) runs the kernel's plain version here, and equals
    JAX's engine with its Pallas kernel in interpret mode. On an SE net
    every stage stays folded, as in JAX."""
    kw = dict(stage_sizes=(2, 2), width_per_group=8, **_D)
    jnet = jax_network("resnet_tiny", **kw, stem="space2depth")
    variables = _warm_variables(jnet, jax.random.key(0), (2, 32, 32, 3))
    x = _x(32, seed=4)
    want = np.asarray(jeng.make_serving_apply(
        jnet, variables, use_pallas=True, interpret=True)(None, x))
    tnet = create_network("resnet_tiny", **kw, stem="space2depth")
    flat = flatten_variables(variables)
    got = teng.make_serving_apply(tnet, flat, use_kernels=True,
                                  device="cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    stage0 = teng._plan_stage_fusion(teng.build_plan(tnet, flat).stages[0])
    assert stage0[0] == 0 and stage0[1] is not None and \
        stage0[2]["w1s"].shape[0] == 1            # entry + 1 identity block

    se = create_network("se_resnet_50", stem="space2depth")
    for blocks in teng.build_plan(se, random_variables(se)).stages:
        assert teng._plan_stage_fusion(blocks) == (len(blocks), None, None)


@pytest.mark.parametrize("network,stem,splits", [
    ("resnet_v1_50", "space2depth", [3, 3, 5, 2]),
    ("se_resnet_50", "imagenet", [0, 0, 0, 0])])
def test_fusion_plan_equals_jax(network, stem, splits):
    """The fused blocks per stage equal JAX's split: 13 at the space2depth
    stem (a stride-1 entry block at 56x56), none on an SE net."""
    from tf_face_toolbox_tpu_torch.interop.port import unflatten_variables

    tnet = create_network(network, stem=stem)
    flat = random_variables(tnet, seed=0)
    jplan = jeng.build_plan(jax_network(network, stem=stem),
                            unflatten_variables(flat))
    tplan = teng.build_plan(tnet, flat)
    got = []
    for jblocks, tblocks in zip(jplan.stages, tplan.stages, strict=True):
        jn, jentry, jtail = jeng._plan_stage_fusion(jblocks)
        tn, tentry, ttail = teng._plan_stage_fusion(tblocks)
        jk = 0 if jtail is None else jtail["w1s"].shape[0]
        tk = 0 if ttail is None else ttail["w1s"].shape[0]
        assert (tn, tentry is None, tk) == (jn, jentry is None, jk)
        got.append((tentry is not None) + tk)
    assert got == splits


def test_engine_refuses_resnext_and_densenet_as_jax_does():
    for name, match in (("resnext_50", "grouped"), ("se_resnext_50", "grouped"),
                        ("densenet_121", "ResNet family")):
        net = create_network(name)
        with pytest.raises(ValueError, match=match):
            jeng.build_plan(jax_network(name), {})
        with pytest.raises(ValueError, match=match):
            teng.build_plan(net, random_variables(net))
        with pytest.raises(ValueError, match=match):
            teng.make_serving_apply(net, random_variables(net), device="cpu")


def _shard(path, n=10, size=24):
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays
    faces = np.random.default_rng(0).integers(0, 256, (n, size, size, 3),
                                              dtype=np.uint8)
    pack_arrays(str(path), faces, list(range(n)))
    return str(path)


def test_cli_extract_auto_serves_densenet_through_the_module(tmp_path,
                                                             caplog, capsys):
    """--engine auto on DenseNet logs why the engine does not apply and
    writes the module path's embeddings; an explicit --engine folded
    exits naming the engine's error; a space2depth DenseNet exits with
    JAX's message."""
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract

    shard = _shard(tmp_path / "f.faceshard")
    common = ["--data", shard, "--network", "densenet_121",
              "--embedding_dim", "16", "--image_size", "16", "--crop_from",
              "24", "--batch", "4", "--nobf16", "--loader", "python",
              "--device", "cpu"]
    auto, module = str(tmp_path / "a.npy"), str(tmp_path / "m.npy")
    with caplog.at_level(logging.INFO):
        cli_extract.main([*common, "--output", auto])
    assert "serving engine not applicable" in caplog.text
    assert "ResNet family" in caplog.text
    cli_extract.main([*common, "--output", module, "--engine", "module"])
    assert capsys.readouterr().out.count("kernel launches: fused_block=0") == 2
    got = np.load(auto)
    assert got.shape == (10, 16) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, np.load(module))
    for engine in ("folded", "fused"):
        with pytest.raises(SystemExit, match=f"--engine {engine}: serving "
                                             "engine supports the ResNet"):
            cli_extract.main([*common, "--output", auto, "--engine", engine])
    with pytest.raises(SystemExit, match="space2depth is a resnet-family"):
        cli_extract.main([*common, "--output", auto, "--stem", "space2depth"])


def test_cli_extract_serves_se_resnet_and_space2depth_folded(tmp_path,
                                                             caplog):
    """--engine auto takes the folded engine for SE-ResNet at the
    space2depth stem (no fallback logged), within f32 rounding of the
    module path."""
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract

    shard = _shard(tmp_path / "f.faceshard", n=6)
    common = ["--data", shard, "--network", "se_resnet_50", "--stem",
              "space2depth", "--embedding_dim", "16", "--image_size", "16",
              "--crop_from", "24", "--batch", "3", "--nobf16", "--loader",
              "python", "--device", "cpu"]
    auto, module = str(tmp_path / "a.npy"), str(tmp_path / "m.npy")
    with caplog.at_level(logging.INFO):
        cli_extract.main([*common, "--output", auto])
    assert "not applicable" not in caplog.text
    cli_extract.main([*common, "--output", module, "--engine", "module"])
    np.testing.assert_allclose(np.load(auto), np.load(module), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("network", ["resnext_50", "densenet_121"])
def test_bench_refuses_the_engine_for_what_it_cannot_fold(network):
    from tf_face_toolbox_tpu_torch import bench

    with pytest.raises(SystemExit, match="bench: --impl folded: serving "
                                         "engine"):
        bench.main(["--network", network, "--impl", "folded", "--stem",
                    "face"])
