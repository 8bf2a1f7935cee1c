"""Port 1:N identification (verification 1:N half, clustering, CLIs) vs
the JAX package, on the CPU, from the same numpy inputs."""

import json

import numpy as np
import pytest
import torch

from tests.test_clustering import _make_identities
from tf_face_toolbox_tpu.ops import clustering as jclu
from tf_face_toolbox_tpu.ops import verification as jver
from tf_face_toolbox_tpu_torch.cli import cluster as tcli_cluster
from tf_face_toolbox_tpu_torch.cli import eval_identification as tcli_eval
from tf_face_toolbox_tpu_torch.cli import search as tcli_search
from tf_face_toolbox_tpu_torch.ops import clustering as tclu
from tf_face_toolbox_tpu_torch.ops import verification as tver

torch.set_num_threads(1)

DIM = 64


def _unit(n, seed=0):
    e = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _gallery_set(seed=0):
    """30 identities x 3 faces in the gallery; probes: 20 mated faces
    near their identity and 10 non-mated ones."""
    rng = np.random.default_rng(seed)
    emb, truth = _make_identities(rng, 40, 4, spread=0.05)
    gal = np.concatenate([emb[i * 4:i * 4 + 3] for i in range(30)])
    glab = np.repeat(np.arange(30), 3)
    probe = np.concatenate([emb[i * 4 + 3:i * 4 + 4] for i in range(40)])
    plab = np.arange(40)
    keep = np.r_[0:20, 30:40]
    return gal, glab, probe[keep], plab[keep]


@pytest.mark.parametrize("snorm", [False, True])
def test_top_k_matches_equals_jax(snorm):
    gal = _unit(200, seed=1)
    gal[150:160] = gal[:10]                     # exact ties: smaller row first
    probe = np.concatenate([gal[:10], _unit(13, seed=2)])
    kw = {}
    if snorm:
        cohort = _unit(50, seed=3)
        kw = dict(probe_stats=jver.cohort_stats(probe, cohort, top=10),
                  gallery_stats=jver.cohort_stats(gal, cohort, top=10))
    ji, js = jver.top_k_matches(gal, probe, k=7, batch=5, **kw)
    ti, ts = tver.top_k_matches(gal, probe, k=7, batch=5, device="cpu", **kw)
    assert ti.dtype == np.int32 and ts.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, atol=1e-5)
    if not snorm:
        np.testing.assert_array_equal(ti[:10, :2],
                                      np.stack([np.arange(10),
                                                150 + np.arange(10)], 1))
    with pytest.raises(ValueError, match="BOTH"):
        tver.top_k_matches(gal, probe, k=3, probe_stats=(0, 1), device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        tver.top_k_matches(gal[:3], probe, k=4, device="cpu")


@pytest.mark.parametrize("top", [0, 7])
def test_cohort_stats_equal_jax(top):
    emb, cohort = _unit(33, seed=4), _unit(40, seed=5)
    jmu, jsd = jver.cohort_stats(emb, cohort, top=top, batch=8)
    tmu, tsd = tver.cohort_stats(emb, cohort, top=top, batch=8, device="cpu")
    np.testing.assert_allclose(tmu, jmu, atol=1e-6)
    np.testing.assert_allclose(tsd, jsd, atol=1e-6)
    with pytest.raises(ValueError, match="top"):
        tver.cohort_stats(emb, cohort, top=41, device="cpu")


def test_identification_stats_cmc_dir_equal_jax():
    gal, glab, probe, plab = _gallery_set()
    js = jver.identification_stats(gal, glab, probe, plab, batch=7)
    ts = tver.identification_stats(gal, glab, probe, plab, batch=7,
                                   device="cpu")
    np.testing.assert_array_equal(ts["mated_mask"], js["mated_mask"])
    np.testing.assert_array_equal(ts["ranks"], js["ranks"])
    assert ts["ranks"].dtype == np.int32 and ts["s_correct"].dtype == np.float32
    np.testing.assert_allclose(ts["s_correct"], js["s_correct"], atol=1e-6)
    np.testing.assert_allclose(ts["nm_top"], js["nm_top"], atol=1e-6)
    assert ts["gallery_size"] == js["gallery_size"] == 90
    assert tver.cmc_curve(None, None, None, None, ranks=(1, 2, 5), stats=ts) == \
        jver.cmc_curve(None, None, None, None, ranks=(1, 2, 5), stats=js)
    got = tver.dir_at_far(None, None, None, None, fars=(0.1, 0.5), stats=ts)
    want = jver.dir_at_far(None, None, None, None, fars=(0.1, 0.5), stats=js)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-6, nan_ok=True)
    assert tver.identification_rank_k(gal, glab, probe[:20], plab[:20], k=2,
                                      device="cpu") == \
        jver.identification_rank_k(gal, glab, probe[:20], plab[:20], k=2)
    # empty non-mated set keeps the dtypes
    ts = tver.identification_stats(gal, glab, probe[:20], plab[:20],
                                   device="cpu")
    assert ts["nm_top"].dtype == np.float32 and len(ts["nm_top"]) == 0


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16", "int8"])
def test_cluster_embeddings_labels_equal_jax(store_dtype):
    rng = np.random.default_rng(1)
    emb, truth = _make_identities(rng, 5, 8)
    emb = np.concatenate([emb, emb[:1]])        # an exact duplicate row
    kw = dict(threshold=0.8, k=4, batch=7, store_dtype=store_dtype)
    jl, jn = jclu.cluster_embeddings(emb, **kw)
    tl, tn = tclu.cluster_embeddings(emb, device="cpu", **kw)
    assert tn == jn == 5
    np.testing.assert_array_equal(tl, jl)
    ji, jsims = jclu.knn_graph(emb, k=5, batch=7, store_dtype=store_dtype)
    ti, tsims = tclu.knn_graph(emb, k=5, batch=7, store_dtype=store_dtype,
                               device="cpu")
    assert not np.any(ti == np.arange(len(emb))[:, None])   # no self-match
    np.testing.assert_allclose(tsims, jsims, atol=5e-6)
    if store_dtype != "bfloat16":
        np.testing.assert_array_equal(ti, ji)
    assert ti[0, 0] == 40 and ti[40, 0] == 0


def test_cluster_noise_and_streaming_store():
    rng = np.random.default_rng(2)
    a, _ = _make_identities(rng, 2, 5, spread=0.02)
    out = rng.normal(size=(1, DIM)).astype(np.float32)
    out /= np.linalg.norm(out)
    emb = np.concatenate([a, out])
    labels, n = tclu.cluster_embeddings(emb, threshold=0.9, k=3, min_size=2,
                                        device="cpu")
    assert n == 2 and labels[-1] == -1
    # a store budget of one row's bytes: the kNN graph streams exactly
    tiny = tclu.knn_graph(emb, k=3, hbm_limit_gb=1e-9, device="cpu")
    full = tclu.knn_graph(emb, k=3, device="cpu")
    np.testing.assert_array_equal(tiny[0], full[0])
    with pytest.raises(ValueError, match=">= 2"):
        tclu.knn_graph(emb[:1], k=3, device="cpu")


def test_cli_cluster_in_process(tmp_path, capsys):
    rng = np.random.default_rng(3)
    emb, truth = _make_identities(rng, 3, 5)
    ep = tmp_path / "emb.npy"
    np.save(ep, emb)
    names = tmp_path / "list.txt"
    names.write_text("".join(f"img{i}.jpg {truth[i]}\n"
                             for i in range(len(truth))))
    out = tmp_path / "labels.npy"
    tcli_cluster.main([f"--embeddings={ep}", f"--output={out}",
                       "--threshold=0.8", "--k=4", f"--names={names}",
                       "--store_dtype=int8", "--device=cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["clusters"] == 3 and report["noise_rows"] == 0
    want, _ = jclu.cluster_embeddings(emb, threshold=0.8, k=4,
                                      store_dtype="int8")
    np.testing.assert_array_equal(np.load(out), want)
    lines = open(str(out) + ".clusters.txt").read().splitlines()
    assert len(lines) == 3 and lines[0].startswith("0 img")


def _write_set(tmp_path):
    gal, glab, probe, plab = _gallery_set(seed=4)
    paths = {}
    for name, arr in (("gal", gal), ("probe", probe)):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], arr)
    for name, lab in (("gal_list", glab), ("probe_list", plab)):
        paths[name] = str(tmp_path / f"{name}.txt")
        with open(paths[name], "w") as f:
            f.writelines(f"face_{i}.jpg {v}\n" for i, v in enumerate(lab))
    return paths, (gal, glab, probe, plab)


def test_cli_search_in_process(tmp_path, capsys):
    paths, (gal, glab, probe, _) = _write_set(tmp_path)
    out = str(tmp_path / "m.npz")
    tcli_search.main([f"--gallery={paths['gal']}", f"--probe={paths['probe']}",
                      f"--gallery_list={paths['gal_list']}", "--k=4",
                      "--threshold=0.5", f"--output={out}", "--device=cpu"])
    summary = json.loads(capsys.readouterr().out)
    ji, js = jver.top_k_matches(gal, probe, k=4)
    got = np.load(out)
    np.testing.assert_array_equal(got["indices"], ji)
    np.testing.assert_allclose(got["scores"], js, atol=1e-6)
    np.testing.assert_array_equal(
        got["labels"], np.where(js >= 0.5, glab[ji], -1))
    assert summary["probes"] == 30 and summary["gallery"] == 90
    # --data_parallel (ported since; tests/test_torch_distributed_gallery.py
    # holds it against JAX's sharded search) ranks the same
    tcli_search.main([f"--gallery={paths['gal']}", f"--probe={paths['probe']}",
                      f"--output={out}", "--k=4", "--data_parallel",
                      "--device=cpu"])
    assert json.loads(capsys.readouterr().out)["probes"] == 30
    np.testing.assert_array_equal(np.load(out)["indices"], ji)


def test_cli_search_snorm_in_process(tmp_path, capsys):
    paths, (gal, _, probe, _) = _write_set(tmp_path)
    cohort = _unit(60, seed=9)
    cp = str(tmp_path / "cohort.npy")
    np.save(cp, cohort)
    out = str(tmp_path / "m.npz")
    tcli_search.main([f"--gallery={paths['gal']}", f"--probe={paths['probe']}",
                      f"--cohort={cp}", "--snorm_top=20", "--k=3",
                      f"--output={out}", "--device=cpu"])
    summary = json.loads(capsys.readouterr().out)
    assert summary["snorm"] == {"cohort": 60, "top": 20}
    ji, js = jver.top_k_matches(
        gal, probe, k=3,
        probe_stats=jver.cohort_stats(probe, cohort, top=20),
        gallery_stats=jver.cohort_stats(gal, cohort, top=20))
    np.testing.assert_array_equal(np.load(out)["indices"], ji)
    np.testing.assert_allclose(np.load(out)["scores"], js, atol=1e-5)


def test_cli_eval_identification_in_process(tmp_path, capsys):
    paths, (gal, glab, probe, plab) = _write_set(tmp_path)
    tcli_eval.main([f"--gallery={paths['gal']}", f"--probe={paths['probe']}",
                    f"--gallery_list={paths['gal_list']}",
                    f"--probe_list={paths['probe_list']}", "--ranks=1,5",
                    "--far=0.1,0.5", "--device=cpu"])
    report = json.loads(capsys.readouterr().out)
    stats = jver.identification_stats(gal, glab, probe, plab)
    want = jver.cmc_curve(gal, glab, probe, plab, ranks=[1, 5], stats=stats)
    assert report["probes"] == want["probes"] == 20
    assert report["skipped"] == 10
    assert {int(k): v for k, v in report["cmc"].items()} == want["cmc"]
    assert report["mean_rank"] == pytest.approx(want["mean_rank"])
    want_open = jver.dir_at_far(gal, glab, probe, plab, fars=[0.1, 0.5],
                                stats=stats)
    for key, v in want_open.items():
        assert report["open_set"][key] == pytest.approx(v, abs=1e-6)
