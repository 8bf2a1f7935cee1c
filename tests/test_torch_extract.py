"""The port's extraction slice vs the JAX package, end to end.

A raw FaceShard goes through both packages' extract_shard with the same
flat weights; the port's CLIs run as subprocesses on the CPU; and the
port must stand alone at run time (no jax, flax or JAX package).
"""

import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_serving import _warm_variables
from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
from tf_face_toolbox_tpu.extract import extract_shard as jax_extract_shard
from tf_face_toolbox_tpu.interop.port import flatten_variables, save_variables_npz
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.ops.verification import similarity_matrix as jax_sim
from tf_face_toolbox_tpu.ops.verification import verify_pairs as jax_verify_pairs
from tf_face_toolbox_tpu.train.checkpoint import load_embeddings as jax_load
from tf_face_toolbox_tpu.train.checkpoint import save_embeddings as jax_save
from tf_face_toolbox_tpu_torch.data.format import pack_arrays
from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
from tf_face_toolbox_tpu_torch.extract import (
    extract_dataset, extract_shard, make_extract_fn)
from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
from tf_face_toolbox_tpu_torch.io import load_embeddings, save_embeddings
from tf_face_toolbox_tpu_torch.models import create_network
from tf_face_toolbox_tpu_torch.ops.verification import (
    similarity_matrix, verify_pairs)
from tf_face_toolbox_tpu_torch.serving import make_serving_apply

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLIs' network: the registry's resnet_tiny, imagenet stem, 16-d
_NET = dict(stem="imagenet", embedding_dim=16)


@functools.lru_cache(maxsize=None)
def _jax_weights():
    jnet = jax_network("resnet_tiny", **_NET)
    return jnet, _warm_variables(jnet, jax.random.key(0), (4, 16, 16, 3))


def _shard(path, n=12, size=24, seed=0):
    faces = np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                 dtype=np.uint8)
    pack_arrays(str(path), faces, list(range(n)))
    return str(path)


def _assert_same_report(got: dict, want: dict) -> None:
    """verify_pairs reports equal up to f32 rounding; NaN (a FAR finer
    than the pair set resolves) may arrive as JSON null."""
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, float) and np.isnan(value):
            assert got[key] is None or np.isnan(got[key]), key
        else:
            assert got[key] == pytest.approx(value, rel=1e-6, abs=1e-7), key


def _jax_embeddings(shard, loader="python"):
    jnet, variables = _jax_weights()
    return jax_extract_shard(jnet, variables, JaxSource(shard),
                             image_size=16, crop_from=20, batch=5,
                             num_threads=1, loader=loader)


@pytest.mark.parametrize("engine", ["module", "folded", "fused"])
@pytest.mark.parametrize("loader", ["python", "native"])
def test_slice_matches_jax_extract_shard(tmp_path, engine, loader):
    """u8 shard -> host resize -> crop + standardize -> flip-averaged
    forward -> L2 norm, f32, through each engine of the port. Both
    packages decode with the same loader (the native C++ resize rounds
    a few pixels differently from the Python one)."""
    shard = _shard(tmp_path / "faces.faceshard")
    want = _jax_embeddings(shard, loader)
    _, variables = _jax_weights()
    flat = flatten_variables(variables)
    net = create_network("resnet_tiny", **_NET, input_size=16)
    apply = (load_jax_variables(net, flat) if engine == "module" else
             make_serving_apply(net, flat, use_kernels=engine == "fused",
                                device="cpu"))
    got = extract_shard(net, flat, FaceShardSource(shard), image_size=16,
                        crop_from=20, batch=5, num_threads=2, loader=loader,
                        extract_fn=make_extract_fn(apply), device="cpu")
    assert got.shape == want.shape == (12, 16) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cli_extract_and_eval_lfw_match_jax(tmp_path):
    shard = _shard(tmp_path / "faces.faceshard", n=20)
    _, variables = _jax_weights()
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, variables)
    out = str(tmp_path / "emb.npy")
    run = functools.partial(subprocess.run, cwd=ROOT, capture_output=True,
                            text=True, timeout=300)
    proc = run([sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
                "--variables_npz", npz, "--data", shard, "--output", out,
                "--network", "resnet_tiny", "--stem", "imagenet",
                "--embedding_dim", "16", "--image_size", "16",
                "--crop_from", "20", "--batch", "8", "--nobf16",
                "--engine", "fused", "--loader", "python",
                "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    assert "wrote (20, 16) float32 embeddings" in proc.stdout
    emb = np.load(out)
    np.testing.assert_allclose(emb, _jax_embeddings(shard), atol=1e-4)

    pairs = tmp_path / "pairs.txt"
    i1, i2 = np.arange(10), np.arange(10, 20)
    labels = np.arange(10) % 2
    pairs.write_text("# idx1 idx2 label\n" + "".join(
        f"{a} {b} {c}\n" for a, b, c in zip(i1, i2, labels)))
    proc = run([sys.executable, "-m",
                "tf_face_toolbox_tpu_torch.cli.eval_lfw",
                "--embeddings", out, "--pairs", str(pairs), "--folds", "5"])
    assert proc.returncode == 0, proc.stderr
    _assert_same_report(json.loads(proc.stdout),
                        jax_verify_pairs(emb[i1], emb[i2], labels, n_folds=5))


def test_cli_refuses_unported_inputs(tmp_path):
    # --bundle is ported (tests/test_torch_bundle.py), and so is every
    # network since item 17b: dct_vit_small extracts through the module
    # path; since item 18 int8 bundles serve (tests/test_torch_int8.py),
    # and a ViT's int8 bundle refuses as JAX's ViT does
    from tf_face_toolbox_tpu.serving.bundle import write_bundle

    shard = _shard(tmp_path / "faces.faceshard", n=2)
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--network", "dct_vit_small", "--data", shard, "--nobf16",
         "--output", str(tmp_path / "e.npy"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "serving engine not applicable" in proc.stderr
    emb = np.load(tmp_path / "e.npy")
    assert emb.shape == (2, 512) and np.isfinite(emb).all()
    path = str(tmp_path / "q.bundle.npz")
    write_bundle(path, {"params": {"x": np.zeros(1, np.float32)}},
                 dict(network="dct_vit_small", embedding_dim=512,
                      image_size=112, input_norm="per_image",
                      quant_mode="dynamic"))
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--bundle", path, "--data", shard, "--output",
         str(tmp_path / "q.npy"), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "int8 serving is not supported for the ViT family" in proc.stderr


def test_cli_weights_sources_are_exclusive(tmp_path):
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract

    with pytest.raises(SystemExit, match="exclusive"):
        cli_extract.main(["--checkpoint_dir", str(tmp_path),
                          "--variables_npz", str(tmp_path / "w.npz"),
                          "--data", "x", "--output", "y", "--device", "cpu"])


@pytest.mark.parametrize("engine,use_ema", [("fused", False),
                                            ("folded", True),
                                            ("module", True)])
def test_cli_extract_from_a_port_checkpoint(tmp_path, capsys, engine,
                                            use_ema):
    """--checkpoint_dir on a checkpoint the port trained serves the same
    embeddings as --variables_npz of the same variables (its EMA set
    and running statistics under --use_ema), through each engine."""
    from tf_face_toolbox_tpu_torch.cli import extract as cli_extract
    from tf_face_toolbox_tpu_torch.interop.port import (
        named_to_flat, save_variables_npz as save_npz)
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.loop import train_loop
    from tf_face_toolbox_tpu_torch.train.trainer import TrainConfig

    cfg = TrainConfig(network="resnet_tiny", stem="imagenet", num_classes=7,
                      embedding_dim=16, image_size=16, crop_from=20,
                      global_batch=8, ema_decay=0.5)
    rng = np.random.default_rng(0)
    batches = ({"image": rng.integers(0, 256, (8, 20, 20, 3), np.uint8),
                "label": rng.integers(0, 7, 8)} for _ in range(3))
    run = str(tmp_path / "run")
    state = train_loop(cfg, batches, num_steps=3, train_dir=run,
                       log_every=0, device="cpu").state
    assert CheckpointManager(run).latest_step() == 3
    params = state.ema_params if use_ema else state.params
    npz = str(tmp_path / "w.npz")
    save_npz(npz, named_to_flat({**params, **state.batch_stats}))
    shard = _shard(tmp_path / "faces.faceshard", n=10)
    common = ["--data", shard, "--network", "resnet_tiny", "--stem",
              "imagenet", "--embedding_dim", "16", "--image_size", "16",
              "--crop_from", "20", "--batch", "4", "--nobf16", "--engine",
              engine, "--loader", "python", "--device", "cpu"]
    out_ckpt, out_npz = str(tmp_path / "c.npy"), str(tmp_path / "n.npy")
    cli_extract.main([*common, "--checkpoint_dir", run, "--output", out_ckpt,
                      *(["--use_ema"] if use_ema else [])])
    cli_extract.main([*common, "--variables_npz", npz, "--output", out_npz])
    out = capsys.readouterr().out
    assert out.count("kernel launches: fused_block=0") == 2
    got, want = np.load(out_ckpt), np.load(out_npz)
    assert got.shape == (10, 16)
    np.testing.assert_array_equal(got, want)


def test_pairs_formats_match_jax(tmp_path):
    """Both pairs formats parse to the JAX CLI's rows: the official LFW
    pairs.txt (header, matched and mismatched lines, a comment) through
    --names, and the index format with a comment line."""
    from tf_face_toolbox_tpu.cli import eval_lfw as jcli
    from tf_face_toolbox_tpu_torch.cli import eval_lfw as tcli

    names = tmp_path / "list.txt"
    names.write_text("".join(f"lfw/{p}/{p}_{i:04d}.jpg {k}\n" for k, (p, i) in
                             enumerate([("Ann_Lee", 1), ("Ann_Lee", 2),
                                        ("Bo", 1), ("Bo", 3), ("Cy", 1)])))
    official = tmp_path / "pairs.txt"
    official.write_text("2\t1\n# a comment line\nAnn_Lee\t1\t2\nBo\t1\tCy\t1\n"
                        "Bo\t1\t3\nAnn_Lee\t2\tBo\t3\n")
    index = tmp_path / "index.txt"
    index.write_text("# idx1 idx2 label\n0 1 1\n2 4 0\n")
    for path in (official, index):
        assert tcli._is_official_lfw(str(path)) == jcli._is_official_lfw(
            str(path)) == (path == official)
    got = tcli.load_lfw_pairs(str(official), str(names))
    want = jcli.load_lfw_pairs(str(official), str(names))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], [1, 0, 1, 0])
    for g, w in zip(tcli.load_pairs(str(index)), jcli.load_pairs(str(index))):
        np.testing.assert_array_equal(g, w)


def test_verify_pairs_matches_jax():
    rng = np.random.default_rng(0)
    e1, e2 = rng.standard_normal((2, 60, 8)).astype(np.float32)
    labels = np.arange(60) % 2
    _assert_same_report(verify_pairs(e1, e2, labels, n_folds=10),
                        jax_verify_pairs(e1, e2, labels, n_folds=10))
    np.testing.assert_allclose(similarity_matrix(e1, e2[:7]).numpy(),
                               np.asarray(jax_sim(e1, e2[:7])), atol=1e-6)


def test_extract_dataset_is_batch_independent():
    _, variables = _jax_weights()
    net = create_network("resnet_tiny", **_NET, input_size=16)
    fn = make_extract_fn(load_jax_variables(net, flatten_variables(variables)))
    x = np.random.default_rng(2).standard_normal((6, 16, 16, 3)).astype(
        np.float32)
    got = extract_dataset(fn, [x[:4], x[4:]], device="cpu")
    assert got.shape == (6, 16)
    np.testing.assert_allclose(got, fn(torch.from_numpy(x)).numpy(),
                               atol=1e-6)


def test_entry_points_default_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    import inspect

    from tf_face_toolbox_tpu_torch.extract import _standardized_batches

    for fn in (extract_shard, extract_dataset, _standardized_batches,
               make_serving_apply):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("ext", ["npy", "npz", "mat", "bin"])
def test_embedding_files_interchange_with_jax(tmp_path, ext):
    emb = np.random.default_rng(1).standard_normal((5, 4)).astype(np.float32)
    save_embeddings(str(tmp_path / f"a.{ext}"), emb)
    np.testing.assert_array_equal(jax_load(str(tmp_path / f"a.{ext}"))[0], emb)
    jax_save(str(tmp_path / f"b.{ext}"), emb)
    np.testing.assert_array_equal(
        load_embeddings(str(tmp_path / f"b.{ext}"))[0], emb)


def test_port_imports_no_jax():
    """Every module of the port (and chip_smoke.py) imports without
    jax, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tf_face_toolbox_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tf_face_toolbox_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 20
