"""The port's serving daemon (``serving/server.py``, ``reload.py``,
``grpc_server.py``, ``cli.serve``) vs the JAX package's.

The same seeded variables serve in both packages: the services agree on
uint8 requests and JPEG bodies (embeddings and quality, f32, atol
1e-5); one scripted HTTP request sequence against JAX's ``serve()`` and
the port's gives the same status codes, JSON key sets, embeddings and
``/identify`` matches; the batcher coalesces; reloads swap or refuse as
JAX's do; the checkpoint watcher follows a port train dir; a unix-socket
rolling restart drops no request; gRPC answers as JAX's does; and
``cli.serve`` runs as a subprocess from each boot source and drains on
SIGTERM.
"""

import functools
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_serve import _unix_post, _wait_serving
from tests.test_serving import _warm_variables
from tests.test_torch_bundle import _train_dir
from tf_face_toolbox_tpu.interop.port import flatten_variables as jax_flatten
from tf_face_toolbox_tpu.models import create_network as jax_network
from tf_face_toolbox_tpu.serving import server as jax_server
from tf_face_toolbox_tpu.serving.gallery import DeviceGallery as JaxGallery
from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz
from tf_face_toolbox_tpu_torch.models import create_network
from tf_face_toolbox_tpu_torch.serving import make_serving_apply
from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery
from tf_face_toolbox_tpu_torch.serving.server import (
    DynamicBatcher, EmbeddingService, bulk_embed, serve)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, CROP, DIM, BATCH = 16, 20, 8, 4


@functools.lru_cache(maxsize=None)
def _weights(dim=DIM, seed=0):
    jnet = jax_network("resnet_tiny", embedding_dim=dim, dtype=jnp.float32)
    return jnet, _warm_variables(jnet, jax.random.key(seed),
                                 (4, SIZE, SIZE, 3))


def _port_service(dim=DIM, seed=0, engine="module", **kw):
    _, variables = _weights(dim, seed)
    flat = jax_flatten(variables)
    net = create_network("resnet_tiny", embedding_dim=dim)
    apply_fn = (make_serving_apply(net, flat, device="cpu")
                if engine == "folded" else None)
    svc = EmbeddingService(net, flat, image_size=SIZE, crop_from=CROP,
                           batch=BATCH, apply_fn=apply_fn,
                           dtype=torch.float32, device="cpu", **kw)
    svc.warmup()
    return svc


def _jax_service(dim=DIM, seed=0, **kw):
    jnet, variables = _weights(dim, seed)
    svc = jax_server.EmbeddingService(jnet, variables, image_size=SIZE,
                                      crop_from=CROP, batch=BATCH,
                                      dtype=jnp.float32, **kw)
    svc.warmup()
    return svc


@pytest.fixture(scope="module")
def services():
    return {"jax": _jax_service(), "module": _port_service(),
            "folded": _port_service(engine="folded")}


def _images(n, seed=0, size=CROP):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _encoded(img, fmt="JPEG") -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **({"quality": 95}
                                            if fmt == "JPEG" else {}))
    return buf.getvalue()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@pytest.mark.parametrize("engine", ["module", "folded"])
def test_service_matches_jax(services, engine):
    imgs = _images(BATCH, seed=1)
    emb, q = services[engine].embed_batch(imgs, with_quality=True)
    want, want_q = services["jax"].embed_batch(imgs, with_quality=True)
    assert emb.dtype == q.dtype == np.float32 and emb.shape == (BATCH, DIM)
    np.testing.assert_allclose(emb, want, atol=1e-5)
    np.testing.assert_allclose(q, want_q, atol=1e-5, rtol=1e-5)


def test_request_bodies_decode_and_embed_as_in_jax(services):
    """JPEG, PNG and npy bodies at another size go through the same host
    decode + half-pixel resize and the same device chain."""
    port, jsvc = services["module"], services["jax"]
    for i, img in enumerate(_images(3, seed=2, size=28)):
        for body in (_encoded(img), _encoded(img, "PNG"), _npy(img)):
            got, want = port.decode_request(body), jsvc.decode_request(body)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(port.embed_batch(got[None]),
                                       jsvc.embed_batch(want[None]),
                                       atol=1e-5)
    for svc in (port, jsvc):
        with pytest.raises(ValueError, match="npy payload"):
            svc.decode_request(_npy(np.zeros((4, 4), np.uint8)))


def test_padding_does_not_leak_between_rows(services):
    svc = services["module"]
    imgs = _images(BATCH, seed=3)
    full = svc.embed_batch(imgs)
    np.testing.assert_allclose(np.linalg.norm(full, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(svc.embed_batch(imgs[:2]), full[:2], atol=1e-6)
    np.testing.assert_allclose(svc.embed_batch(imgs[3:]), full[3:], atol=1e-6)
    with pytest.raises(ValueError, match="service batch"):
        svc.embed_batch(_images(BATCH + 1))
    with pytest.raises(ValueError, match="uint8"):
        svc.validate(imgs[0].astype(np.float32))


def test_batcher_coalesces_and_validates_alone(services):
    svc = services["module"]
    batcher = DynamicBatcher(svc, max_wait_ms=200.0)
    try:
        imgs = _images(8, seed=4)
        want = np.concatenate([svc.embed_batch(imgs[:4]),
                               svc.embed_batch(imgs[4:])])
        results = [None] * 8
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(i, batcher.submit(imgs[i])))
            for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        np.testing.assert_allclose(np.stack(results), want, atol=1e-6)
        s = batcher.stats
        assert s["requests"] == 8 and s["images"] == 8
        assert s["device_calls"] < 8
        # a malformed request fails alone, before it could join a batch
        with pytest.raises(ValueError):
            batcher.submit(imgs[0][:8])
        assert batcher.stats["requests"] == 8
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(imgs[0])


def test_every_forward_runs_on_the_service_thread(services):
    """Warm-up, coalesced and bulk forwards all launch from the
    service's one forward thread (cuDNN caches its plans per thread),
    and a forward from a bulk request thread returns the same rows."""
    _, variables = _weights()
    flat = jax_flatten(variables)
    net = create_network("resnet_tiny", embedding_dim=DIM)
    threads = []

    def apply_fn(x):
        threads.append(threading.get_ident())
        return folded(x)

    folded = make_serving_apply(net, flat, device="cpu")
    svc = EmbeddingService(net, flat, image_size=SIZE, crop_from=CROP,
                           batch=BATCH, apply_fn=apply_fn,
                           dtype=torch.float32, device="cpu")
    svc.warmup()
    imgs = _images(6, seed=16)
    batcher = DynamicBatcher(svc, max_wait_ms=1.0)
    try:
        got = []
        worker = threading.Thread(target=lambda: got.append(
            bulk_embed(batcher, imgs)))
        worker.start()
        worker.join(timeout=60)
        single = batcher.submit(imgs[0])
    finally:
        batcher.close()
    assert len(set(threads)) == 1 and threading.get_ident() not in threads
    assert len(threads) == 1 + 2 + 1          # warm-up, 2 bulk chunks, 1
    want = services["jax"].embed_batch(imgs[:4])
    np.testing.assert_allclose(got[0][:4], want, atol=1e-5)
    np.testing.assert_allclose(single, want[0], atol=1e-5)


# ---- one scripted HTTP sequence against both daemons ------------------------


def _call(base, method, path, body=None, headers=None):
    """-> (status, payload: dict, or the array of an npy reply)."""
    req = urllib.request.Request(base + path, data=body, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, ctype, raw = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        status, ctype, raw = e.code, e.headers["Content-Type"], e.read()
    if ctype == "application/x-npy":
        return status, np.load(io.BytesIO(raw), allow_pickle=False)
    return status, json.loads(raw)


def _same(got, want, where=""):
    """Equal structure (dict keys, list lengths); numbers within f32
    rounding; other leaves equal. Error strings and latencies are not
    compared (only their keys)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for key in want:
            if key not in ("error", "latency_ms", "latency_ms_by_endpoint",
                           "device_calls", "mean_batch_fill", "path"):
                _same(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, list) and all(isinstance(v, str) for v in want):
        assert got == want, where
    elif isinstance(want, list) and want and isinstance(want[0], dict):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, (list, np.ndarray)):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), atol=1e-5,
                                   rtol=1e-5, err_msg=where)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-5, rel=1e-5), where
    else:
        assert got == want, where


def _sequence(tmp_path, tag):
    imgs = _images(12, seed=5)
    npy = _npy(imgs[0])
    accept_npy = {"Accept": "application/x-npy"}
    snap = str(tmp_path / f"{tag}_snapshot.npz")
    steps = [
        ("GET", "/healthz", None, None),
        ("GET", "/healthz?model=b", None, None),
        ("GET", "/gallery", None, None),
        ("POST", "/embed", _encoded(imgs[1]), None),
        ("POST", "/embed", npy, None),
        ("POST", "/embed?quality=1", npy, None),
        ("POST", "/embed", npy, accept_npy),
        ("POST", "/embed_batch", _npy(imgs[:6]), None),
        ("POST", "/embed_batch?quality=1", _npy(imgs[:3]), None),
        ("POST", "/embed_batch", _npy(imgs[:5]), accept_npy),
        ("POST", "/embed_batch?quality=1", _npy(imgs[:2]), accept_npy),
        ("POST", "/embed?model=b", npy, None),
        ("POST", "/embed_batch?model=b", _npy(imgs[:2]), None),
        ("POST", "/embed?model=nope", npy, None),
        ("GET", "/stats?model=nope", None, None),
        ("POST", "/embed", b"not an image", None),
        ("POST", "/embed_batch", npy, None),           # (H, W, 3): not 4-d
        ("POST", "/embed", b"\0" * (1 << 20 | 1), None),   # > 1 MiB cap
        ("POST", "/nothing", npy, None),
        ("GET", "/nothing", None, None),
        ("POST", "/identify", npy, None),              # empty gallery: 409
        *[("POST", f"/enroll?label={i}", _npy(imgs[i]), None)
          for i in range(8)],
        ("POST", "/enroll?label=8", _npy(imgs[8]), None),   # past: 507
        ("POST", "/enroll?label=x", npy, None),
        ("POST", "/enroll?label=9&min_quality=100", _npy(imgs[9]), None),
        ("POST", "/enroll?label=9&model=b", npy, None),
        *[("POST", f"/identify?k=3", _npy(imgs[i]), None) for i in range(4)],
        ("POST", "/identify?k=20&threshold=2", _npy(imgs[10]), None),
        ("POST", "/deenroll?label=2", None, None),
        ("POST", "/deenroll?label=x", None, None),
        ("POST", "/identify?k=8", _npy(imgs[2]), None),
        ("GET", "/gallery", None, None),
        ("POST", "/gallery/save", None, None),
        ("POST", f"/gallery/save?path={snap}", None, None),
        ("GET", "/stats?model=a", None, None),
        ("GET", "/stats", None, None),
    ]
    return steps, snap


def _run_sequence(base, steps):
    return [_call(base, m, p, b, h) for m, p, b, h in steps]


def test_http_sequence_matches_jax(services, tmp_path):
    gkw = dict(block=4, hbm_limit_gb=300e-9)   # 8 rows fit, the 9th: 507
    stacks = {}
    for tag, make_b, gallery in (
            ("jax", lambda: _jax_service(dim=DIM + 2, seed=1, step=11),
             JaxGallery(DIM, **gkw)),
            ("port", lambda: _port_service(dim=DIM + 2, seed=1, step=11),
             DeviceGallery(DIM, device="cpu", **gkw))):
        main = services["jax" if tag == "jax" else "module"]
        mod = jax_server if tag == "jax" else sys.modules[serve.__module__]
        batchers = {"a": mod.DynamicBatcher(main, max_wait_ms=1.0),
                    "b": mod.DynamicBatcher(make_b(), max_wait_ms=1.0)}
        server = mod.serve(batchers, port=0, max_body_mb=1, gallery=gallery)
        stacks[tag] = (server, batchers)
    try:
        replies = {}
        for tag, (server, _) in stacks.items():
            steps, snap = _sequence(tmp_path, tag)
            replies[tag] = _run_sequence(
                f"http://127.0.0.1:{server.server_address[1]}", steps)
            saved = np.load(snap)
            assert sorted(saved["labels"].tolist()) == [0, 1, 3, 4, 5, 6, 7]
        for (m, p, _, h), got, want in zip(steps, replies["port"],
                                           replies["jax"]):
            where = f"{m} {p} {h or ''}"
            assert got[0] == want[0], f"{where}: {got} vs {want}"
            _same(got[1], want[1], where)
        codes = [r[0] for r in replies["port"]]
        assert codes.count(404) == 5 and 507 in codes and 422 in codes
        assert 413 in codes and 409 in codes and codes.count(400) == 6
        identify = [r[1] for (m, p, _, _), r in zip(steps, replies["port"])
                    if p.startswith("/identify?k=3")]
        assert [r["matches"][0]["label"] for r in identify] == [0, 1, 2, 3]
        after = replies["port"][steps.index(
            ("POST", "/identify?k=8", _npy(_images(12, seed=5)[2]), None))]
        assert 2 not in [m["label"] for m in after[1]["matches"]]
    finally:
        for server, batchers in stacks.values():
            server.shutdown()
            server.server_close()
            for b in batchers.values():
                b.close()


# ---- reloads --------------------------------------------------------------------


def test_reload_swaps_to_the_new_weights(services):
    svc = _port_service(step=1)
    _, other = _weights(DIM, seed=3)
    imgs = _images(BATCH, seed=6)
    before = svc.embed_batch(imgs)
    svc.reload(jax_flatten(other), step=2)
    assert (svc.step, svc.reloads) == (2, 1)
    want = _jax_service(seed=3).embed_batch(imgs)
    np.testing.assert_allclose(svc.embed_batch(imgs), want, atol=1e-5)
    assert np.abs(before - want).max() > 1e-3


def test_reload_refuses_a_mismatched_tree(services):
    svc = services["module"]
    _, variables = _weights(DIM + 2, seed=0)
    with pytest.raises(ValueError, match="do not match"):
        svc.reload(jax_flatten(variables))
    assert svc.reloads == 0


def test_reload_refuses_a_bare_swap_on_baked_weights(services):
    svc = services["folded"]
    _, variables = _weights(DIM, seed=0)
    with pytest.raises(ValueError, match="bakes weights"):
        svc.reload(jax_flatten(variables))


def test_folded_reload_rebuilds_and_matches_the_module_path():
    svc = _port_service(engine="folded")
    _, other = _weights(DIM, seed=3)
    flat = jax_flatten(other)
    net = create_network("resnet_tiny", embedding_dim=DIM)
    svc.reload(flat, apply_fn=make_serving_apply(net, flat, device="cpu"),
               step=5)
    imgs = _images(BATCH, seed=7)
    np.testing.assert_allclose(svc.embed_batch(imgs),
                               _jax_service(seed=3).embed_batch(imgs),
                               atol=1e-5)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A port train dir (resnet_tiny, imagenet stem, 16-d) with steps 1-3;
    tests copy steps out of it and never write to it."""
    return _train_dir(str(tmp_path_factory.mktemp("serve_run")))


def test_checkpoint_watcher_follows_a_port_train_dir(run_dir, tmp_path):
    from tf_face_toolbox_tpu_torch.pretrained import load_variables
    from tf_face_toolbox_tpu_torch.serving.reload import CheckpointWatcher

    run = run_dir
    live = tmp_path / "live"
    live.mkdir()
    shutil.copytree(f"{run}/1", live / "1")
    args = ("resnet_tiny", 16, 16, torch.float32)
    net, flat = load_variables(str(live), *args, stem="imagenet")
    svc = EmbeddingService(net, flat, image_size=16, crop_from=20, batch=4,
                           dtype=torch.float32, step=1, device="cpu")

    def rebuild():
        from tf_face_toolbox_tpu_torch.train.checkpoint import (
            CheckpointManager)
        step = CheckpointManager(str(live)).latest_step()
        return (load_variables(str(live), *args, stem="imagenet",
                               step=step)[1], None, step)

    watcher = CheckpointWatcher(svc, str(live), rebuild, interval=3600)
    assert watcher.poll_once() is False
    shutil.copytree(f"{run}/3", live / ".3.tmp")
    os.rename(live / ".3.tmp", live / "3")
    assert watcher.poll_once() is True
    assert (svc.step, svc.reloads) == (3, 1)
    want = load_variables(run, *args, stem="imagenet", step=3)[1]
    assert all(np.array_equal(svc._variables[k], want[k]) for k in want)
    imgs = _images(4, seed=8)
    fresh = EmbeddingService(net, want, image_size=16, crop_from=20, batch=4,
                             dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(svc.embed_batch(imgs),
                                  fresh.embed_batch(imgs))
    assert watcher.poll_once() is False
    # a rebuild that fails keeps the live weights and is retried
    shutil.copytree(f"{run}/3", live / "4")
    os.remove(live / "4" / "meta.json")
    assert watcher.poll_once() is False and svc.step == 3
    watcher.start().stop()


def test_unix_socket_rolling_restart_drops_no_request(services, tmp_path):
    svc = services["module"]
    sock = str(tmp_path / "roll.sock")
    payloads = [_npy(img) for img in _images(8, seed=9)]
    batcher_a = DynamicBatcher(svc)
    server_a = serve(batcher_a, unix_socket=sock)
    results, mu, stop = [], threading.Lock(), threading.Event()

    def client(idx):
        k = 0
        while not stop.is_set():
            body = payloads[(idx + k) % len(payloads)]
            k += 1
            for _ in range(50):
                try:
                    status, _ = _unix_post(sock, "/embed", body)
                    break
                except (ConnectionRefusedError, FileNotFoundError,
                        ConnectionResetError, BrokenPipeError):
                    time.sleep(0.05)
            else:
                status = -1
            with mu:
                results.append(status)
            time.sleep(0.01)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.6)
    batcher_b = DynamicBatcher(svc)
    server_b = serve(batcher_b, unix_socket=sock)    # takes the path over
    server_a.shutdown()
    assert server_a.wait_idle(30)
    server_a.server_close()
    batcher_a.close()
    time.sleep(0.6)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    server_b.shutdown()
    server_b.wait_idle(10)
    server_b.server_close()
    batcher_b.close()
    assert len(results) > 8
    assert all(r == 200 for r in results), results


# ---- gRPC ---------------------------------------------------------------------------


def test_grpc_answers_as_jax_does(services):
    grpc = pytest.importorskip(
        "grpc", reason="the gRPC transport needs grpcio, not installed")
    from tf_face_toolbox_tpu.serving import grpc_server as jax_grpc
    from tf_face_toolbox_tpu_torch.serving import grpc_server

    imgs = _images(6, seed=10)
    replies, stacks = {}, []
    try:
        for tag, mod, gmod, svc in (
                ("jax", jax_server, jax_grpc, services["jax"]),
                ("port", sys.modules[serve.__module__], grpc_server,
                 services["module"])):
            b = mod.DynamicBatcher(svc, max_wait_ms=1.0)
            server = gmod.serve_grpc({"a": b}, port=0, max_body_mb=1)
            client = gmod.GrpcEmbeddingClient(f"127.0.0.1:{server.bound_port}")
            stacks.append((server, client, b))
            out = {"embed": client.embed(imgs[0]),
                   "embed_jpeg": client.embed(_encoded(imgs[1])),
                   "embed_batch": client.embed_batch(imgs),
                   "health": client.health(), "health_a": client.health(
                       model="a"), "stats": client.stats(model="a")}
            codes = []
            for call in (lambda: client.embed(b"junk"),
                         lambda: client.embed(imgs[0], model="nope"),
                         lambda: client.embed(b"\0" * (1 << 20 | 1))):
                with pytest.raises(grpc.RpcError) as exc:
                    call()
                codes.append(exc.value.code())
            out["codes"] = codes
            replies[tag] = out
        got, want = replies["port"], replies["jax"]
        assert got["codes"] == want["codes"] == [
            grpc.StatusCode.INVALID_ARGUMENT, grpc.StatusCode.NOT_FOUND,
            grpc.StatusCode.INVALID_ARGUMENT]
        for key in ("embed", "embed_jpeg", "embed_batch"):
            assert got[key].dtype == np.float32
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)
        for key in ("health", "health_a", "stats"):
            _same(got[key], want[key], key)
        # gRPC's rows equal HTTP's (the service's own) for the same faces
        svc = services["module"]
        np.testing.assert_allclose(
            got["embed_batch"], np.concatenate([svc.embed_batch(imgs[:4]),
                                                svc.embed_batch(imgs[4:])]),
            atol=1e-6)
    finally:
        for server, client, b in stacks:
            client.close()
            server.stop(grace=5).wait()
            b.close()


def test_grpc_drain_refuses_new_and_completes_inflight(services):
    grpc = pytest.importorskip(
        "grpc", reason="the gRPC transport needs grpcio, not installed")
    from tf_face_toolbox_tpu_torch.serving.grpc_server import (
        GrpcEmbeddingClient, serve_grpc)

    batcher = DynamicBatcher(services["module"], max_wait_ms=300.0)
    server = serve_grpc(batcher, port=0)
    client = GrpcEmbeddingClient(f"127.0.0.1:{server.bound_port}")
    try:
        client.health()
        seen = batcher.stats["requests"]
        results = []
        t = threading.Thread(target=lambda: results.append(
            client.embed(_images(1, seed=11)[0])))
        t.start()
        deadline = time.monotonic() + 10
        while (batcher.stats["requests"] <= seen
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert batcher.stats["requests"] > seen, "RPC never arrived"
        ev = server.stop(grace=10)
        t.join(timeout=10)
        assert results and results[0].shape == (DIM,)
        assert ev.wait(timeout=10)
        with pytest.raises(grpc.RpcError):
            client.embed(_images(1, seed=12)[0], timeout=5)
    finally:
        client.close()
        batcher.close()


# ---- cli.serve as a subprocess -----------------------------------------------------


_NET = ["--network", "resnet_tiny", "--embedding_dim", str(DIM),
        "--image_size", str(SIZE), "--crop_from", str(CROP)]


def _start_cli(args: list) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "tf_face_toolbox_tpu_torch.cli.serve",
         "--device", "cpu", "--nobf16", "--port", "0", "--max_batch",
         str(BATCH), "--max_wait_ms", "1", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    proc.base = _wait_serving(proc, 120).split("serving on ")[1].split()[0]
    return proc


def _drain(proc) -> list:
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = [ln.strip() for ln in proc.captured]
    assert proc.returncode == 0, proc.stderr.read()
    assert lines[-2:] == ["kernel launches: topk=0 topk_q=0", "drained; bye"]
    return lines


def test_cli_serve_from_variables_npz_with_a_gallery(tmp_path, services):
    _, variables = _weights()
    npz = str(tmp_path / "w.npz")
    save_variables_npz(npz, jax_flatten(variables))
    snap = str(tmp_path / "gallery.npz")
    proc = _start_cli(["--variables_npz", npz, *_NET, "--stem", "face",
                       "--gallery", snap])
    try:
        imgs = _images(3, seed=13)
        want = services["jax"].embed_batch(imgs)
        for i, img in enumerate(imgs):
            status, out = _call(proc.base, "POST", "/embed", _npy(img))
            assert status == 200
            np.testing.assert_allclose(out["embedding"], want[i], atol=1e-5)
            assert _call(proc.base, "POST", f"/enroll?label={10 + i}",
                         _npy(img))[0] == 200
        status, out = _call(proc.base, "POST", "/identify?k=2",
                            _encoded(imgs[1], "PNG"))
        assert status == 200 and out["matches"][0]["label"] == 11
        health = _call(proc.base, "GET", "/healthz")[1]
        assert health == {"status": "ok", "batch": BATCH, "image_size": SIZE,
                          "serving_step": None}
    finally:
        _drain(proc)
    saved = np.load(snap)
    assert saved["labels"].tolist() == [10, 11, 12]


def test_cli_serve_from_bundles(tmp_path, services):
    from tf_face_toolbox_tpu.serving.bundle import write_bundle

    meta = dict(network="resnet_tiny", embedding_dim=DIM, image_size=SIZE,
                crop_from=CROP, input_norm="per_image", quant_mode="none",
                stem="face", head_variant="gap", step=4)
    paths = []
    for dim, seed in ((DIM, 0), (DIM + 2, 1)):
        paths.append(str(tmp_path / f"m{dim}.bundle.npz"))
        write_bundle(paths[-1], _weights(dim, seed)[1],
                     dict(meta, embedding_dim=dim))
    imgs = _images(2, seed=14)
    proc = _start_cli(["--bundle", paths[0], "--engine", "folded"])
    try:
        status, out = _call(proc.base, "POST", "/embed_batch", _npy(imgs))
        assert status == 200
        np.testing.assert_allclose(out["embeddings"],
                                   services["jax"].embed_batch(imgs),
                                   atol=1e-5)
        assert _call(proc.base, "GET", "/healthz")[1]["serving_step"] == 4
    finally:
        _drain(proc)
    proc = _start_cli(["--bundle", f"big={paths[0]},small={paths[1]}"])
    try:
        assert " models=big,small" in proc.captured[-1]
        small = _call(proc.base, "POST", "/embed?model=small", _npy(imgs[0]))
        np.testing.assert_allclose(
            small[1]["embedding"],
            _jax_service(dim=DIM + 2, seed=1).embed_batch(imgs[:1])[0],
            atol=1e-5)
        assert len(_call(proc.base, "POST", "/embed", _npy(imgs[0]))[1][
            "embedding"]) == DIM
        health = _call(proc.base, "GET", "/healthz")[1]
        assert sorted(health["models"]) == ["big", "small"]
    finally:
        _drain(proc)


def test_cli_serve_hot_reloads_a_port_train_dir(run_dir, tmp_path):
    from tf_face_toolbox_tpu_torch.pretrained import load_variables

    run = run_dir
    live = tmp_path / "live"
    live.mkdir()
    shutil.copytree(f"{run}/2", live / "2")
    proc = _start_cli(["--checkpoint_dir", str(live), "--network",
                       "resnet_tiny", "--stem", "imagenet", "--embedding_dim",
                       "16", "--image_size", "16", "--crop_from", "20",
                       "--watch_interval", "0.2"])
    try:
        assert _call(proc.base, "GET", "/healthz")[1]["serving_step"] == 2
        shutil.copytree(f"{run}/3", live / ".3.tmp")
        os.rename(live / ".3.tmp", live / "3")
        deadline = time.monotonic() + 60
        while (_call(proc.base, "GET", "/healthz")[1]["serving_step"] != 3
               and time.monotonic() < deadline):
            time.sleep(0.1)
        stats = _call(proc.base, "GET", "/stats")[1]
        assert (stats["serving_step"], stats["reloads"]) == (3, 1)
        net, flat = load_variables(run, "resnet_tiny", 16, 16, torch.float32,
                                   stem="imagenet", step=3)
        want = EmbeddingService(net, flat, image_size=16, crop_from=20,
                                batch=BATCH, dtype=torch.float32,
                                device="cpu", apply_fn=make_serving_apply(
                                    net, flat, device="cpu"))
        imgs = _images(2, seed=15)
        out = _call(proc.base, "POST", "/embed_batch", _npy(imgs))[1]
        np.testing.assert_allclose(out["embeddings"], want.embed_batch(imgs),
                                   atol=1e-6)
    finally:
        _drain(proc)


@pytest.mark.parametrize("argv,match", [
    # int8 (item 18) is ported: what refuses now is what JAX's CLI
    # refuses (static without a calibration shard, int8 on the folded
    # engine); the daemon's int8 runs are in tests/test_torch_int8.py
    pytest.param(["--quant_mode", "static"], "needs --calibrate_data",
                 id="argv0-item 18"),
    pytest.param(["--quant_mode", "dynamic", "--engine", "folded"],
                 "--engine folded serves fp", id="argv1-item 18"),
    # --gallery_shards is ported: more shards than devices refuses as
    # JAX's create_mesh does (tests/test_torch_distributed_gallery.py)
    pytest.param(["--gallery_shards", "2", "--gallery", "g.npz"],
                 r"mesh \(2x1\) needs 2 devices", id="argv2-item 14"),
    # the DCT nets (item 17b) are ported: a dct_vit_small bundle refuses
    # only for its int8 mode, as JAX's ViT does
    pytest.param(["--bundle", "UNPORTED"], "not supported for the ViT",
                 id="argv3-item 17"),
    (["--bundle", "b.npz", "--variables_npz", "w.npz"], "self-contained"),
    (["--gallery", "g.npz", "--transport", "grpc"], "HTTP-only")])
def test_cli_serve_refusals(tmp_path, argv, match):
    from tf_face_toolbox_tpu.serving.bundle import write_bundle
    from tf_face_toolbox_tpu_torch.cli import serve as cli_serve

    if "UNPORTED" in argv:
        path = str(tmp_path / "vit.bundle.npz")
        write_bundle(path, {"params": {"x": np.zeros(1, np.float32)}},
                     dict(network="dct_vit_small", embedding_dim=DIM,
                          image_size=SIZE, input_norm="fixed",
                          quant_mode="dynamic"))
        argv = ["--bundle", path]
    elif "--bundle" not in argv:
        argv = [*argv, "--variables_npz", str(tmp_path / "w.npz")]
    with pytest.raises(SystemExit, match=match):
        cli_serve.main([*argv, "--device", "cpu"])
