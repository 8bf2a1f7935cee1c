"""Resumable bulk extraction (``extract_shard_to_npy``), feature-norm
quality, data-parallel extraction and their ``cli.extract`` flags in the
port, against the JAX package (tests/test_extract_resume.py's cases).

The port's f32 module path on a 22-face shard (16 px crops of 20 px
faces, batch 4, the python loader) is held to JAX's ``extract_shard``
at atol 1e-4 (tests/test_torch_extract.py's bar); the port's chunked
outputs to its own one-shot run bit for bit (the same batches through
the same program); the quality to JAX's ``with_quality`` at rtol 1e-4
(f32 sums of the same magnitude); the sidecar to the one JAX writes for
the same arguments, field for field but the fingerprint (each package
digests its own key space); two gloo ranks with a ragged tail (batch 5,
padded to 6) to the single process at f32 rounding (rtol 1e-5, atol
1e-6: each rank forwards 3 rows where the single process forwards 5).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist as td
from tests.test_torch_extract import _NET, _jax_weights
from tf_face_toolbox_tpu.data.pipeline import FaceShardSource as JaxSource
from tf_face_toolbox_tpu.extract import extract_shard as jax_extract_shard
from tf_face_toolbox_tpu.extract import (
    extract_shard_to_npy as jax_extract_shard_to_npy)
from tf_face_toolbox_tpu.interop.port import (
    flatten_variables,
    save_variables_npz,
)
from tf_face_toolbox_tpu_torch.cli import extract as cli
from tf_face_toolbox_tpu_torch.data.format import pack_arrays
from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
from tf_face_toolbox_tpu_torch.extract import (
    extract_shard,
    extract_shard_to_npy,
    make_extract_fn,
)
from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
from tf_face_toolbox_tpu_torch.models import create_network

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 22
ARGS = dict(image_size=16, crop_from=20, batch=4, num_threads=1,
            loader="python")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("resume")
    faces = np.random.default_rng(0).integers(0, 256, (N, 20, 20, 3),
                                              dtype=np.uint8)
    shard = str(tmp / "faces.faceshard")
    pack_arrays(shard, faces, list(range(N)))
    _, variables = _jax_weights()
    flat = flatten_variables(variables)
    net = load_jax_variables(create_network("resnet_tiny", **_NET,
                                            input_size=16), flat).eval()
    ref = extract_shard(net, flat, FaceShardSource(shard), device="cpu",
                        **ARGS)
    return tmp, shard, flat, net, ref


def _to_npy(setup, out, **kw):
    _, shard, flat, net, _ = setup
    return extract_shard_to_npy(net, flat, FaceShardSource(shard), out,
                                device="cpu", **{**ARGS, **kw})


def _counting(net, dies_after=None):
    fn = make_extract_fn(net)
    calls = {"n": 0}

    def counted(x):
        calls["n"] += 1
        if dies_after is not None and calls["n"] > dies_after:
            raise RuntimeError("simulated preemption")
        return fn(x)

    return counted, calls


def test_one_shot_matches_jax(setup):
    _, shard, _, _, ref = setup
    jnet, variables = _jax_weights()
    want = jax_extract_shard(jnet, variables, JaxSource(shard), **ARGS)
    np.testing.assert_allclose(ref, want, atol=1e-4, rtol=0)


def test_resumable_equals_oneshot(setup):
    tmp, *_, ref = setup
    out = str(tmp / "a.npy")
    got = _to_npy(setup, out, chunk_rows=8)
    np.testing.assert_array_equal(np.asarray(got), ref)
    side = json.load(open(out + ".progress.json"))
    assert side["done"] == [0, 8, 16]       # kept on completion
    np.testing.assert_array_equal(np.load(out), ref)


def test_sidecar_fields_equal_jax(setup):
    tmp, shard, *_ = setup
    jnet, variables = _jax_weights()
    for rows, name in ((None, "s"), ((4, 20), "r")):
        ours, theirs = str(tmp / f"{name}.npy"), str(tmp / f"j{name}.npy")
        _to_npy(setup, ours, chunk_rows=10, rows=rows, fingerprint="port")
        jax_extract_shard_to_npy(jnet, variables, JaxSource(shard), theirs,
                                 chunk_rows=10, rows=rows,
                                 fingerprint="jax", **ARGS)
        suffix = "" if rows is None else f".rows{rows[0]}-{rows[1]}"
        a = json.load(open(ours + suffix + ".progress.json"))
        b = json.load(open(theirs + suffix + ".progress.json"))
        assert a.pop("fingerprint") == "port"
        assert b.pop("fingerprint") == "jax"
        assert a == b
        np.testing.assert_allclose(np.load(ours), np.load(theirs),
                                   atol=1e-4, rtol=0)


def test_crash_resume_recomputes_one_chunk_bit_equal(setup):
    tmp, _, _, net, ref = setup
    out = str(tmp / "b.npy")
    dying, calls = _counting(net, dies_after=3)
    with pytest.raises(RuntimeError, match="preemption"):
        _to_npy(setup, out, chunk_rows=8, extract_fn=dying)
    assert json.load(open(out + ".progress.json"))["done"] == [0]
    counting, calls = _counting(net)
    got = _to_npy(setup, out, chunk_rows=8, extract_fn=counting)
    # chunks [8:16) and [16:22) remain: 2 + 2 batches
    assert calls["n"] == 4
    np.testing.assert_array_equal(np.asarray(got), ref)
    calls["n"] = 0
    got = _to_npy(setup, out, chunk_rows=8, extract_fn=counting)
    assert calls["n"] == 0
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_rows_land_at_offsets_in_chunked_output(setup):
    tmp, *_, ref = setup
    out = str(tmp / "c.npy")
    _to_npy(setup, out, chunk_rows=8, rows=(8, 22))
    got = np.load(out)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[8:22], ref[8:22])
    assert np.all(got[:8] == 0)
    assert os.path.exists(out + ".rows8-22.progress.json")
    assert not os.path.exists(out + ".progress.json")


def test_chunk_rows_align_to_batch(setup):
    tmp, *_, ref = setup
    out = str(tmp / "d.npy")
    got = _to_npy(setup, out, chunk_rows=10)       # -> 8
    np.testing.assert_array_equal(np.asarray(got), ref)
    assert json.load(open(out + ".progress.json"))["chunk_rows"] == 8
    out = str(tmp / "d2.npy")
    _to_npy(setup, out)                             # 64 * batch
    assert json.load(open(out + ".progress.json"))["chunk_rows"] == 256


def test_sequential_ranges_fill_one_file(setup):
    tmp, *_, ref = setup
    out = str(tmp / "f.npy")
    _to_npy(setup, out, chunk_rows=8, rows=(0, 8))
    _to_npy(setup, out, chunk_rows=8, rows=(8, 22))
    np.testing.assert_array_equal(np.load(out), ref)


def test_range_jobs_keep_independent_resume_state(setup):
    tmp, _, _, net, ref = setup
    out = str(tmp / "h.npy")
    dying, _ = _counting(net, dies_after=1)
    with pytest.raises(RuntimeError, match="preemption"):
        _to_npy(setup, out, chunk_rows=4, rows=(0, 8), extract_fn=dying)
    _to_npy(setup, out, chunk_rows=4, rows=(8, 22))
    counting, calls = _counting(net)
    _to_npy(setup, out, chunk_rows=4, rows=(0, 8), extract_fn=counting)
    assert calls["n"] == 1                  # only the lost chunk [4:8)
    np.testing.assert_array_equal(np.load(out), ref)


def test_a_range_sidecar_does_not_outlive_its_output(setup):
    """Range A finishes, its output is deleted, range B creates the file
    anew: A's sidecar described the deleted file, so a rerun of A
    recomputes its rows instead of leaving them at zero in B's file."""
    tmp, _, _, net, ref = setup
    out = str(tmp / "stale.npy")
    _to_npy(setup, out, chunk_rows=4, rows=(0, 8))
    assert os.path.exists(out + ".rows0-8.progress.json")
    os.remove(out)
    _to_npy(setup, out, chunk_rows=4, rows=(8, 22))
    assert not os.path.exists(out + ".rows0-8.progress.json")
    counting, calls = _counting(net)
    _to_npy(setup, out, chunk_rows=4, rows=(0, 8), extract_fn=counting)
    assert calls["n"] == 2                  # both chunks of [0, 8)
    np.testing.assert_array_equal(np.load(out), ref)


def test_fingerprint_mismatch_recomputes(setup):
    tmp, _, _, net, _ = setup
    out = str(tmp / "i.npy")
    dying, _ = _counting(net, dies_after=3)
    with pytest.raises(RuntimeError, match="preemption"):
        _to_npy(setup, out, chunk_rows=8, extract_fn=dying,
                fingerprint="model-A")
    counting, calls = _counting(net)
    _to_npy(setup, out, chunk_rows=8, extract_fn=counting,
            fingerprint="model-B")
    assert calls["n"] == 6                  # all 22 rows, nothing reused


def test_existing_incompatible_file_and_non_npy_raise(setup):
    tmp, *_ = setup
    out = str(tmp / "g.npy")
    np.save(out, np.zeros((3, 16), np.float32))
    with pytest.raises(ValueError, match="incompatible"):
        _to_npy(setup, out, chunk_rows=8)
    np.save(out, np.zeros((N, 16), np.float16))
    with pytest.raises(ValueError, match="incompatible"):
        _to_npy(setup, out, chunk_rows=8)
    with pytest.raises(ValueError, match="npy"):
        _to_npy(setup, str(tmp / "e.mat"))
    with pytest.raises(ValueError, match="out of range"):
        _to_npy(setup, str(tmp / "e.npy"), rows=(0, 99))


def test_quality_matches_jax(setup):
    _, shard, flat, net, ref = setup
    emb, q = extract_shard(net, flat, FaceShardSource(shard), device="cpu",
                           with_quality=True, **ARGS)
    np.testing.assert_array_equal(emb, ref)
    jnet, variables = _jax_weights()
    jemb, jq = jax_extract_shard(jnet, variables, JaxSource(shard),
                                 with_quality=True, **ARGS)
    assert q.shape == (N,) and q.dtype == np.float32
    np.testing.assert_allclose(q, jq, rtol=1e-4)
    np.testing.assert_allclose(emb, jemb, atol=1e-4, rtol=0)
    # the magnitude of the mean of the two views, before normalizing
    x = next(iter(__import__("tf_face_toolbox_tpu_torch.extract",
                             fromlist=["_"])._standardized_batches(
        FaceShardSource(shard), image_size=16, crop_from=20, batch=4,
        num_threads=1, loader="python", device="cpu")))
    with torch.no_grad():
        s = net(x) + net(x.flip(2))
    np.testing.assert_allclose(q[:4], 0.5 * s.norm(dim=-1).numpy(),
                               rtol=1e-5)


def _cli(tmp, shard, *extra):
    return [f"--data={shard}", f"--output={tmp}/o.npy", "--device=cpu",
            "--network=resnet_tiny", "--stem=imagenet", "--embedding_dim=16",
            "--image_size=16", "--crop_from=20", "--batch=4", "--nobf16",
            "--loader=python", *extra]


@pytest.mark.parametrize("extra,why", [
    (["--chunk_rows=8", "--output_dtype=float16"], "not available with"),
    (["--chunk_rows=8", "--output={tmp}/o.mat"], "not .npy"),
    (["--chunk_rows=8", "--output_quality={tmp}/q.npy"], "one-shot-mode"),
    (["--data_parallel", "--engine=fused"], "single-device"),
    (["--data_parallel", "--engine=folded"], "single-device")],
    ids=["float16", "not_npy", "quality", "dp_fused", "dp_folded"])
def test_cli_refusals(setup, extra, why):
    tmp, shard, *_ = setup
    extra = [e.replace("{tmp}", str(tmp)) for e in extra]
    with pytest.raises(SystemExit, match=why):
        cli.main(_cli(tmp, shard, *extra))


def test_cli_chunked_ranges_and_quality(setup, tmp_path, capsys):
    """Two --rows jobs fill one --chunk_rows file equal to a one-shot
    run; --output_quality writes the one-shot run's quality."""
    _, shard, flat, _, _ = setup
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, _jax_weights()[1])
    base = [f"--data={shard}", "--device=cpu", "--network=resnet_tiny",
            "--stem=imagenet", "--embedding_dim=16", "--image_size=16",
            "--crop_from=20", "--batch=4", "--nobf16", "--loader=python",
            f"--variables_npz={npz}", "--engine=module"]
    one = str(tmp_path / "one.npy")
    cli.main([*base, f"--output={one}",
              f"--output_quality={tmp_path}/q.npy"])
    out = str(tmp_path / "chunked.npy")
    cli.main([*base, f"--output={out}", "--chunk_rows=8", "--rows=0:8"])
    cli.main([*base, f"--output={out}", "--chunk_rows=8", "--rows=8:22"])
    text = capsys.readouterr().out
    assert "wrote rows [8:22) of the (22, 16) output" in text
    np.testing.assert_array_equal(np.load(out), np.load(one))
    side = json.load(open(out + ".rows8-22.progress.json"))
    assert side["fingerprint"].startswith(
        "resnet_tiny/imagenet/gap/dim=16/norm=per_image/q=False/bf16=False/w=")
    assert np.load(f"{tmp_path}/q.npy").shape == (22,)
    # the same weights give the same fingerprint; other weights another
    assert cli._weights_fingerprint(flat, "t") == cli._weights_fingerprint(
        dict(flat), "t")
    other = {k: v + 1 for k, v in flat.items()}
    assert cli._weights_fingerprint(other, "t") != cli._weights_fingerprint(
        flat, "t")


@pytest.fixture(scope="module")
def ranks():
    with td.Ranks(2) as r:
        yield r


def test_two_ranks_with_a_ragged_tail_equal_one_process(setup, ranks,
                                                        tmp_path):
    _, shard, flat, net, _ = setup
    out = str(tmp_path / "dp.npy")
    got = ranks.run(td.extract_ranks, shard=shard, flat=flat, output=out,
                    batch=5, chunk_rows=10, net_kw=_NET)
    (e0, q0, o0), (e1, q1, o1) = got
    np.testing.assert_array_equal(e0, e1)
    np.testing.assert_array_equal(q0, q1)
    assert o1 is None           # rank 0 alone writes
    src = FaceShardSource(shard)
    emb, q = extract_shard(net, flat, src, device="cpu", with_quality=True,
                           **{**ARGS, "batch": 5})
    np.testing.assert_allclose(e0, emb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q0, q, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(o0, e0)
    np.testing.assert_array_equal(np.load(out), e0)
    assert json.load(open(out + ".progress.json"))["done"] == [0, 10, 20]


def test_cli_data_parallel_under_torchrun(setup, tmp_path):
    """``cli.extract --data_parallel`` on two gloo ranks through torchrun:
    rank 0 writes what one process writes."""
    _, shard, flat, net, _ = setup
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, _jax_weights()[1])
    base = [f"--data={shard}", "--device=cpu", "--network=resnet_tiny",
            "--stem=imagenet", "--embedding_dim=16", "--image_size=16",
            "--crop_from=20", "--batch=5", "--nobf16", "--loader=python",
            f"--variables_npz={npz}", "--data_parallel"]
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = str(tmp_path / "dp.npy")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         *base, f"--output={out}", f"--output_quality={tmp_path}/q.npy"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("wrote (22, 16) float32 embeddings") == 1
    emb, q = extract_shard(net, flat, FaceShardSource(shard), device="cpu",
                           with_quality=True, **{**ARGS, "batch": 5})
    np.testing.assert_allclose(np.load(out), emb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.load(f"{tmp_path}/q.npy"), q, rtol=1e-5,
                               atol=1e-6)
