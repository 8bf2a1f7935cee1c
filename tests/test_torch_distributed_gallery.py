"""Port DistributedGallery, sharded_top_k_matches and the sharded CLIs vs
the JAX package, on the CPU.

The port's store shards over ``[cpu] * n``; JAX's over the conftest's
fake CPU mesh (``create_mesh(data=n)``) with its XLA program
(``use_pallas = False``, the oracle of its own tests). Both enroll the
same numpy embeddings and answer the same probes. Labels must be equal
(equal scores in JAX's shard-major order) and scores within f32
rounding: atol 1e-6 (f32 and the exact int8 rescore), 5e-6 (bf16, whose
products are exact in f32 but summed in another order).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_gallery import DIM, _same, _unit
from tf_face_toolbox_tpu.ops import verification as jver
from tf_face_toolbox_tpu.parallel.mesh import create_mesh
from tf_face_toolbox_tpu.serving import distributed_gallery as jdist
from tf_face_toolbox_tpu.serving import gallery as jgal
from tf_face_toolbox_tpu_torch.ops import topk as ttk
from tf_face_toolbox_tpu_torch.ops import verification as tver
from tf_face_toolbox_tpu_torch.serving import distributed_gallery as tdist
from tf_face_toolbox_tpu_torch.serving import gallery as tgal

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16", "int8"]
ATOL = {"float32": 1e-6, "bfloat16": 5e-6, "int8": 1e-6}
CPU = torch.device("cpu")


def _pair(n, **kw):
    j = jdist.DistributedGallery(DIM, mesh=create_mesh(data=n), **kw)
    j.use_pallas = False
    return j, tdist.DistributedGallery(DIM, devices=[CPU] * n, **kw)


@pytest.fixture(scope="module")
def corpus():
    return _unit(45), _unit(5, seed=1)


@pytest.mark.parametrize("n", [1, 3, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matches_jax_and_one_device(corpus, dtype, n):
    """7-row enrolls cross the per-shard block boundaries (block 4)."""
    e, probes = corpus
    jg, tg = _pair(n, block=4, dtype=dtype)
    for g in (jg, tg):
        for i in range(0, 45, 7):
            g.enroll(e[i:i + 7], np.arange(i, min(i + 7, 45)))
    assert len(tg) == 45 and tg.device_bytes() == jg.device_bytes()
    labels, scores = _same(jg, tg, probes, 6, atol=ATOL[dtype])
    one = tgal.DeviceGallery(DIM, block=8, dtype=dtype, device="cpu")
    one.enroll(e, np.arange(45))
    ol, os_ = one.search(probes, k=6)
    np.testing.assert_array_equal(labels, ol)
    np.testing.assert_allclose(scores, os_, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_incremental_equals_bulk(corpus, dtype):
    e, probes = corpus
    bulk = tdist.DistributedGallery(DIM, devices=[CPU] * 8, block=4,
                                    dtype=dtype)
    bulk.enroll(e, np.arange(45))
    inc = tdist.DistributedGallery(DIM, devices=[CPU] * 8, block=4,
                                   dtype=dtype)
    for i in range(0, 45, 3):
        inc.enroll(e[i:i + 3], np.arange(i, min(i + 3, 45)))
    for s in range(8):
        assert torch.equal(bulk._dev[s], inc._dev[s])
        assert torch.equal(bulk._dev_bias[s], inc._dev_bias[s])
        if dtype == "int8":
            assert torch.equal(bulk._dev_scale[s], inc._dev_scale[s])
    for x, y in zip(bulk.search(probes, k=5), inc.search(probes, k=5)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [3, 8])
@pytest.mark.parametrize("step", [1, 2, 3, 5, 11])
def test_striped_layout_invariant(n, step):
    """Every enroll cadence leaves shard s's slot j holding global row
    j * n + s, zeros past its fill."""
    e = _unit(45, seed=7)
    g = tdist.DistributedGallery(DIM, devices=[CPU] * n, block=4)
    for i in range(0, 45, step):
        g.enroll(e[i:i + step], np.arange(i, min(i + step, 45)))
    for s in range(n):
        rows = g._shard_rows(45, s)
        store = g._dev[s].numpy()
        np.testing.assert_array_equal(store[:rows], e[s::n])
        assert not store[rows:].any()


def test_host_reupload_growth_path(corpus):
    """grow_on_device_max = 0: every block-boundary growth re-uploads from
    the host; the stores and results are the on-device growth's."""
    e, probes = corpus
    jg, tg = _pair(8, block=4)
    dev = tdist.DistributedGallery(DIM, devices=[CPU] * 8, block=4)
    jg.grow_on_device_max = tg.grow_on_device_max = 0
    for g in (jg, tg, dev):
        for i in range(0, 45, 7):
            g.enroll(e[i:i + 7], np.arange(i, min(i + 7, 45)))
    _same(jg, tg, probes, 6)
    for s in range(8):
        assert torch.equal(tg._dev[s], dev._dev[s])


@pytest.mark.parametrize("dtype", DTYPES)
def test_probe_chunk_guard_is_exact(corpus, dtype):
    """A shrunk ``scan_sims_bytes`` makes the plain programs search each
    shard in row chunks; the result is one pass's (and JAX's, whose
    guard chunks the probes)."""
    e, probes = corpus
    jg, tg = _pair(3, block=4, dtype=dtype)
    jg.sims_bytes_guard = 4 * DIM
    tg.use_kernels = False
    tg.scan_sims_bytes = 4 * 5 * 4               # (5 probes, 4 rows)
    assert tg._scan_chunk(5, 16) == 4
    for g in (jg, tg):
        g.enroll(e, np.arange(45))
    _same(jg, tg, probes, 6, atol=ATOL[dtype])


def test_fewer_rows_than_shards():
    e = _unit(3, seed=2)
    jg, tg = _pair(8, block=4)
    for g in (jg, tg):
        g.enroll(e, [10, 11, 12])
    labels, scores = _same(jg, tg, e[1], 3)
    assert labels[0, 0] == 11 and set(labels[0]) == {10, 11, 12}
    assert scores[0, 0] == pytest.approx(1.0, abs=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k_spans_shards(corpus, dtype):
    """k = 20 > a shard's 6 rows: every shard contributes its whole
    store (int8: a coarse stage of 45 rows)."""
    e, probes = corpus
    jg, tg = _pair(8, block=4, dtype=dtype)
    for g in (jg, tg):
        g.enroll(e, np.arange(45))
    _same(jg, tg, probes, 20, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_remove_tombstones_then_compacts_as_jax(dtype):
    e = _unit(45, seed=25)
    probes = _unit(4, seed=26)
    jg, tg = _pair(4, block=4, dtype=dtype)
    for g in (jg, tg):
        g.enroll(e, np.arange(45))
    before = [t.clone() for t in tg._dev]
    for lab in range(11):       # threshold max(4, 11.25): the 12th compacts
        assert jg.remove(lab) == tg.remove(lab) == 1
    assert tg._tomb == 11 and tg._n == 45 and len(tg) == 34
    assert all(torch.equal(a, b) for a, b in zip(before, tg._dev))
    assert tg.remove(3) == 0
    labels, _ = _same(jg, tg, probes, 5, atol=ATOL[dtype])
    assert not np.isin(labels, np.arange(11)).any()
    assert jg.remove(11) == tg.remove(11) == 1
    assert tg._tomb == 0 and tg._n == 33 and len(tg) == 33
    _same(jg, tg, probes, 5, atol=ATOL[dtype])
    labels, _ = _same(jg, tg, e[12], 33, atol=ATOL[dtype])
    assert sorted(labels[0]) == list(range(12, 45))


def test_capacity_refusal_per_shard():
    # 4-row blocks x 64-d f32 = 1 KiB a shard: 32 rows fit over 8 shards
    lim = 4 * DIM * 4 / 1e9
    jg, tg = _pair(8, block=4, hbm_limit_gb=lim)
    msgs = []
    for g, err in ((jg, jgal.GalleryCapacityError),
                   (tg, tgal.GalleryCapacityError)):
        g.enroll(_unit(32, seed=3), np.arange(32))
        with pytest.raises(err, match="each of the 8") as info:
            g.enroll(_unit(8, seed=4), np.arange(8))
        msgs.append(str(info.value))
        assert len(g) == 32 and g.device_bytes() == 8 * 4 * DIM * 4
    assert msgs[0] == msgs[1]
    # a tombstone is reclaimed before refusing
    tg.remove(5)
    tg.enroll(_unit(1, seed=5), [99])
    assert len(tg) == 32 and tg._tomb == 0
    unbounded = tdist.DistributedGallery(DIM, devices=[CPU] * 2, block=4,
                                         hbm_limit_gb=0)
    unbounded.enroll(_unit(100, seed=6), np.arange(100))
    assert len(unbounded) == 100


@pytest.mark.parametrize("writer", ["jax_dist", "port_dist", "jax_device",
                                    "port_device"])
def test_snapshots_interchange(tmp_path, writer):
    """One .npz for both packages and both stores."""
    e = _unit(12, seed=9)
    src = {"jax_dist": lambda: jdist.DistributedGallery(
               DIM, mesh=create_mesh(data=4), block=4),
           "port_dist": lambda: tdist.DistributedGallery(
               DIM, devices=[CPU] * 4, block=4),
           "jax_device": lambda: jgal.DeviceGallery(DIM, block=8),
           "port_device": lambda: tgal.DeviceGallery(DIM, block=8,
                                                     device="cpu")}[writer]()
    src.enroll(e, 10 + np.arange(12))
    src.remove(15)
    path = str(tmp_path / "g.npz")
    assert src.save(path) == 11
    jd = jdist.DistributedGallery.load(path, mesh=create_mesh(data=3),
                                       block=4, dtype="bfloat16")
    jd.use_pallas = False
    td = tdist.DistributedGallery.load(path, devices=[CPU] * 3, block=4,
                                       dtype="bfloat16")
    one = tgal.DeviceGallery.load(path, block=8, dtype="bfloat16",
                                  device="cpu")
    assert len(td) == len(jd) == len(one) == 11
    labels, _ = _same(jd, td, e, 11, atol=ATOL["bfloat16"])
    assert 15 not in labels
    np.testing.assert_array_equal(labels, one.search(e, k=11)[0])


def test_duck_typed_surface():
    """What the daemon and cli.serve read of a store."""
    jg, tg = _pair(4)
    for name in ("overflow", "streaming", "dim", "dtype", "hbm_limit_gb",
                 "block", "n_dev", "rescore_expand", "compact_frac"):
        assert getattr(tg, name) == getattr(jg, name), name
    assert tg.overflow == "refuse" and tg.streaming is False
    assert len(tg) == 0 and tg.device_bytes() == jg.device_bytes() == \
        4 * 1024 * DIM * 4
    with pytest.raises(ValueError, match="empty"):
        tg.search(np.zeros((1, DIM), np.float32))
    with pytest.raises(ValueError, match="dim"):
        tg.enroll(np.zeros((1, DIM + 1), np.float32), [0])
    tg.enroll(_unit(3), [1, 2, 3])
    with pytest.raises(ValueError, match="probe dim"):
        tg.search(np.zeros((1, DIM + 1), np.float32))
    with pytest.raises(ValueError, match="dtype"):
        tdist.DistributedGallery(DIM, devices=[CPU], dtype="f8")
    with pytest.raises(ValueError, match="empty"):
        tdist.DistributedGallery(DIM, devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.DistributedGallery(DIM)


def test_concurrent_search_enroll_remove():
    """Searches racing enrolls (appends and growths) and removes
    (tombstones and compactions) stay exact for the rows they see."""
    e = _unit(400, seed=11)
    g = tdist.DistributedGallery(DIM, devices=[CPU] * 4, block=4)
    g.enroll(e[:64], np.arange(64))
    errors = []
    stop = threading.Event()

    def searcher():
        try:
            rng = np.random.default_rng()
            while not stop.is_set():
                i = int(rng.integers(0, 32))
                labels, scores = g.search(e[i], k=1)
                assert labels[0, 0] == i, (labels, i)
                assert scores[0, 0] == pytest.approx(1.0, abs=1e-5)
        except Exception as exc:    # noqa: BLE001 - collected for assert
            errors.append(exc)

    def writer():
        try:
            nxt = 64
            for i in range(40):
                g.enroll(e[nxt:nxt + 4], np.arange(nxt, nxt + 4))
                nxt += 4
                if i % 3 == 2:
                    g.remove(nxt - 2)
        except Exception as exc:    # noqa: BLE001
            errors.append(exc)
        finally:
            stop.set()

    threads = [threading.Thread(target=searcher) for _ in range(3)]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(g) == 64 + 160 - 13


@pytest.mark.parametrize("dtype", DTYPES)
def test_ties_across_shards_keep_the_shard_major_order(dtype):
    """One embedding enrolled at rows 1, 2 and 5 under labels 10, 20 and
    50 over 4 shards: rows 1 and 5 sit on shard 1, row 2 on shard 2, so
    JAX's merge ranks them [10, 50, 20]; a merge by global row would give
    [10, 20, 50] (DeviceGallery's order)."""
    e = _unit(12, seed=13)
    e[2] = e[5] = e[1]
    labels = np.arange(12) * 10
    jg, tg = _pair(4, block=4, dtype=dtype)
    for g in (jg, tg):
        g.enroll(e, labels)
    got, scores = _same(jg, tg, e[1], 3, atol=ATOL[dtype])
    assert got[0].tolist() == [10, 50, 20]
    assert scores[0, 0] == scores[0, 1] == scores[0, 2]
    one = tgal.DeviceGallery(DIM, block=4, dtype=dtype, device="cpu")
    one.enroll(e, labels)
    assert one.search(e[1], k=3)[0][0].tolist() == [10, 20, 50]


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_wrapper_path_equals_plain_path(dtype):
    """use_kernels on a CPU store goes through the kernels' wrappers,
    which run their plain versions; equal to use_kernels = False, with no
    launch counted."""
    e = _unit(50, seed=12)
    a = tdist.DistributedGallery(DIM, devices=[CPU] * 4, block=4, dtype=dtype)
    b = tdist.DistributedGallery(DIM, devices=[CPU] * 4, block=4, dtype=dtype)
    b.use_kernels = False
    launches = (ttk.cosine_topk.launches, ttk.cosine_topk_q.launches)
    for g in (a, b):
        g.enroll(e, np.arange(50))
        g.remove(4)
    for x, y in zip(a.search(e[:7], k=6), b.search(e[:7], k=6)):
        np.testing.assert_array_equal(x, y)
    assert (ttk.cosine_topk.launches, ttk.cosine_topk_q.launches) == launches


@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("snorm", [False, True])
def test_sharded_top_k_matches_equals_jax(n, snorm):
    gal = _unit(61, seed=1)
    gal[50:55] = gal[:5]                  # exact ties across blocks
    probe = np.concatenate([gal[:5], _unit(8, seed=2)])
    kw = {}
    if snorm:
        cohort = _unit(40, seed=3)
        kw = dict(probe_stats=jver.cohort_stats(probe, cohort, top=10),
                  gallery_stats=jver.cohort_stats(gal, cohort, top=10))
    for k in (7, 30):                     # 30 > a 4-shard block of 16
        ji, js = jver.sharded_top_k_matches(gal, probe, k=k,
                                            mesh=create_mesh(data=n),
                                            batch=5, **kw)
        ti, ts = tver.sharded_top_k_matches(gal, probe, k=k,
                                            devices=[CPU] * n, batch=5, **kw)
        assert ti.dtype == np.int32 and ts.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        # s-norm scores reach ~20: f32 rounding is relative there
        np.testing.assert_allclose(ts, js, atol=1e-5, rtol=1e-6)
        one_i, one_s = tver.top_k_matches(gal, probe, k=k, batch=5,
                                          device="cpu", **kw)
        np.testing.assert_array_equal(ti, one_i)
    if not snorm:
        np.testing.assert_array_equal(ti[:5, :2], np.stack(
            [np.arange(5), 50 + np.arange(5)], 1))
    with pytest.raises(ValueError, match="outside"):
        tver.sharded_top_k_matches(gal, probe, k=62, devices=[CPU])
    with pytest.raises(ValueError, match="BOTH"):
        tver.sharded_top_k_matches(gal, probe, k=3, devices=[CPU],
                                   probe_stats=(1, 1))


def test_cli_search_data_parallel_equals_jax(tmp_path, capsys):
    from tests.test_torch_identification import _write_set
    from tf_face_toolbox_tpu_torch.cli import search as tcli_search

    paths, (gal, glab, probe, _) = _write_set(tmp_path)
    out = str(tmp_path / "m.npz")
    tcli_search.main([f"--gallery={paths['gal']}", f"--probe={paths['probe']}",
                      f"--gallery_list={paths['gal_list']}", "--k=4",
                      "--threshold=0.5", f"--output={out}", "--data_parallel",
                      "--probe_batch=7", "--device=cpu"])
    summary = json.loads(capsys.readouterr().out)
    ji, js = jver.sharded_top_k_matches(gal, probe, k=4, mesh=create_mesh(),
                                        batch=7)
    got = np.load(out)
    np.testing.assert_array_equal(got["indices"], ji)
    np.testing.assert_allclose(got["scores"], js, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["labels"],
                                  np.where(js >= 0.5, glab[ji], -1))
    want = {"probes": 30, "gallery": 90, "k": 4,
            "top1_score_mean": float(js[:, 0].mean()), "threshold": 0.5,
            "top1_unknown_frac": float((got["labels"][:, 0] < 0).mean()),
            "output": out}
    assert summary.keys() == want.keys()
    assert summary["top1_score_mean"] == pytest.approx(
        want.pop("top1_score_mean"), abs=1e-6)
    assert {k: summary[k] for k in want} == want


@pytest.mark.parametrize("argv,match", [
    (["--gallery_shards", "2", "--gallery_overflow", "stream"],
     "--gallery_overflow=stream is single-device"),
    (["--gallery_shards", "2"], r"mesh \(2x1\) needs 2 devices, have 1"),
    (["--gallery_shards", "-1", "--gallery_overflow", "stream"],
     "refuse-only")])
def test_cli_serve_shard_refusals(tmp_path, argv, match):
    """JAX's messages (its cli/serve.py and create_mesh), before the
    model boots: the CPU has one device."""
    from tf_face_toolbox_tpu_torch.cli import serve as cli_serve

    with pytest.raises(SystemExit, match=match):
        cli_serve.main([*argv, "--gallery", str(tmp_path / "g.npz"),
                        "--variables_npz", str(tmp_path / "w.npz"),
                        "--device", "cpu"])
    args = cli_serve.parse_args(["--gallery_shards", "-1", "--device", "cpu"])
    assert cli_serve._shard_devices(args) == [CPU]


def test_daemon_sequence_over_four_shards_matches_jax(tmp_path):
    """tests/test_torch_serve.py's scripted HTTP sequence, the gallery
    striped over 4 shards in both packages (8 rows fit, the 9th: 507)."""
    import sys

    from tests import test_torch_serve as ts
    from tf_face_toolbox_tpu.serving import server as jax_server
    from tf_face_toolbox_tpu_torch.serving.server import serve

    gkw = dict(block=1, hbm_limit_gb=70e-9)   # 2 rows a shard: 64 B
    port_mod = sys.modules[serve.__module__]
    jg = jdist.DistributedGallery(ts.DIM, mesh=create_mesh(data=4), **gkw)
    jg.use_pallas = False
    tg = tdist.DistributedGallery(ts.DIM, devices=[CPU] * 4, **gkw)
    stacks = {}
    for tag, mod, svc, make_b, gallery in (
            ("jax", jax_server, ts._jax_service(),
             lambda: ts._jax_service(dim=ts.DIM + 2, seed=1, step=11), jg),
            ("port", port_mod, ts._port_service(),
             lambda: ts._port_service(dim=ts.DIM + 2, seed=1, step=11), tg)):
        batchers = {"a": mod.DynamicBatcher(svc, max_wait_ms=1.0),
                    "b": mod.DynamicBatcher(make_b(), max_wait_ms=1.0)}
        server = mod.serve(batchers, port=0, max_body_mb=1, gallery=gallery)
        stacks[tag] = (server, batchers)
    try:
        replies = {}
        for tag, (server, _) in stacks.items():
            steps, snap = ts._sequence(tmp_path, tag)
            replies[tag] = ts._run_sequence(
                f"http://127.0.0.1:{server.server_address[1]}", steps)
            saved = np.load(snap)
            assert sorted(saved["labels"].tolist()) == [0, 1, 3, 4, 5, 6, 7]
        for (m, p, _, h), got, want in zip(steps, replies["port"],
                                           replies["jax"]):
            where = f"{m} {p} {h or ''}"
            assert got[0] == want[0], f"{where}: {got} vs {want}"
            ts._same(got[1], want[1], where)
        codes = [r[0] for r in replies["port"]]
        assert 507 in codes and codes.count(404) == 5
        identify = [r[1] for (m, p, _, _), r in zip(steps, replies["port"])
                    if p.startswith("/identify?k=3")]
        assert [r["matches"][0]["label"] for r in identify] == [0, 1, 2, 3]
        assert os.path.exists(str(tmp_path / "port_snapshot.npz"))
    finally:
        for server, batchers in stacks.values():
            server.shutdown()
            server.server_close()
            for b in batchers.values():
                b.close()
