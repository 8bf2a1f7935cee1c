"""Embedding serving daemon: dynamic batching over the fixed-batch extractor.

Counterpart of ``tf_face_toolbox_tpu/serving/server.py``, with the same
endpoints, payloads and status codes:

- ``EmbeddingService``: owns the weights, ONE fixed-batch flip-averaged
  forward (pad-to-batch, so every device call has one shape), the eval
  preprocess chain and host JPEG decode for single-image requests.
- ``DynamicBatcher``: a request queue; a dispatch thread drains up to
  the service batch or waits ``max_wait_ms`` for stragglers and
  enqueues the forward on the device; a resolve thread copies the
  results to the host and completes the per-request futures, so the
  next batch's collection overlaps this one's device time. Every
  forward, coalesced or bulk, is launched from the service's one
  forward thread, where cuDNN's per-thread plan cache stays warm.
- ``serve()``: a threaded HTTP front-end (stdlib ``http.server``): POST
  /embed (JPEG or npy body), POST /embed_batch (npy (N, H, W, 3), chunks
  dispatched before any is read back), ``Accept: application/x-npy``
  for a binary .npy body, GET /healthz, GET /stats (requests, device
  calls, mean batch fill, p50/p95/p99 overall and per endpoint), the
  ``?model=`` router of several services, a unix socket, and the 1:N
  endpoints /enroll, /identify, /deenroll, /gallery and /gallery/save
  over a ``serving.gallery.DeviceGallery``: on a CUDA store /identify
  runs top-k kernel 3 (f32, bf16) or 4 (int8), and a failed search is
  the reply's error, never a fall-back to the plain programs.
- ``grpc_server.serve_grpc()``: the same service over gRPC.

CLI: ``python -m tf_face_toolbox_tpu_torch.cli.serve --checkpoint_dir=... --port=...``
"""

from __future__ import annotations

import collections
import concurrent.futures
import copy
import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch


def _flat(variables: dict) -> dict:
    """A variables tree as the flat JAX-key dict (``interop.port``)."""
    from tf_face_toolbox_tpu_torch.interop.port import flatten_variables

    if any(isinstance(v, dict) for v in variables.values()):
        return flatten_variables(variables)
    return dict(variables)


def _spec(flat: dict) -> dict:
    """key -> (shape, dtype) of a flat variables dict."""
    return {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in flat.items()}


def _host(t) -> np.ndarray:
    """A device result on the host (waits for the device)."""
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class EmbeddingService:
    """Fixed-batch extraction service.

    The pixel chain is EXACTLY ``extract_shard``'s eval chain, so an
    embedding served online is comparable with one extracted offline:
    host decode + half-pixel bilinear resize to ``crop_from``
    (``data.pipeline._resize_u8``, not PIL's antialiasing resample),
    then on the device the center crop to ``image_size`` and the
    standardization (``ops.preprocess.preprocess_eval``), then
    ``extract.flip_averaged_embeddings`` with the quality score.

    ``net`` is a port backbone and ``variables`` its weights in the JAX
    key space (flat or nested). ``apply_fn(images) -> (N, D)`` is the
    eval forward with weights baked in (``serving.make_serving_apply``,
    the folded engine); None serves through a copy of ``net`` holding
    ``variables`` (the module path). Images enter :meth:`embed_batch`
    as uint8 ``(crop_from, crop_from, 3)``; :meth:`decode_request`
    produces that from raw JPEG/npy bytes. Embeddings and quality come
    back f32 under any compute ``dtype``. ``device``: where the forward
    runs (a CUDA device by default; tests pass "cpu").
    """

    def __init__(self, net, variables, *, image_size: int = 112,
                 crop_from: int = 0, batch: int = 32,
                 apply_fn: Callable | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 norm: str = "per_image", step: int | None = None,
                 device: str | torch.device = "cuda"):
        self._net = net
        self._dtype = dtype
        self.device = torch.device(device)
        # "per_image" | "fixed": imported InsightFace-ecosystem weights
        # serve with the fixed norm they trained with; the wrong norm
        # silently destroys accuracy
        self.norm = norm
        self.batch = int(batch)
        self.image_size = int(image_size)
        self.crop_from = int(crop_from) or image_size + 8
        if self.crop_from < image_size:
            raise ValueError(f"crop_from ({self.crop_from}) must be "
                             f">= image_size ({image_size})")
        variables = _flat(variables)
        # (forward, variables) swap as ONE reference so a hot reload
        # can never pair a new forward with old weights mid-dispatch
        self._model = (self._build_forward(apply_fn, variables), variables)
        # a custom apply_fn (the folded engine) bakes weights into its
        # closure: reload() must refuse a bare variable swap on such a
        # service (it would advance step/reloads while embeddings stay
        # stale)
        self._weights_baked = apply_fn is not None
        # checkpoint step currently live (None = .npz source) and the
        # hot-reload count, both surfaced on /healthz and /stats
        self.step = step
        self.reloads = 0
        # every forward runs on this one thread: cuDNN's execution plans
        # (and cuBLAS's workspaces) are cached per thread, so a forward
        # from each new request thread would rebuild them
        self._device_thread = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="embed-forward")

    def _build_forward(self, apply_fn: Callable | None,
                       variables: dict) -> Callable:
        from tf_face_toolbox_tpu_torch.extract import flip_averaged_embeddings
        from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
        from tf_face_toolbox_tpu_torch.ops.preprocess import preprocess_eval

        dtype, image_size, norm = self._dtype, self.image_size, self.norm
        if apply_fn is None:
            # a module of its own, so a reload never rewrites weights
            # that an in-flight batch is reading
            apply_fn = load_jax_variables(copy.deepcopy(self._net),
                                          variables).to(self.device).eval()

        def forward(images_u8: torch.Tensor):
            # inference mode is thread-local: entered where the forward
            # runs (the service's forward thread)
            with torch.inference_mode():
                x = preprocess_eval(images_u8, image_size, image_size, norm)
                return flip_averaged_embeddings(apply_fn, x.to(dtype),
                                                with_quality=True)

        return forward

    @property
    def _variables(self):
        return self._model[1]

    def _dummy(self) -> torch.Tensor:
        return torch.zeros((self.batch, self.crop_from, self.crop_from, 3),
                           dtype=torch.uint8)

    def _launch(self, forward: Callable, images: torch.Tensor):
        """``forward(images)`` queued on the device from the forward
        thread; returns its (not yet finished) device outputs."""
        return self._device_thread.submit(
            lambda: forward(images.to(self.device))).result()

    def _warm(self, forward: Callable) -> None:
        """One fixed-batch call, finished on the device: cuDNN's first-call
        algorithm choice and a kernel's lazy build happen here, on the
        forward thread, not under a request."""
        _host(self._launch(forward, self._dummy())[0])

    def warmup(self) -> None:
        """Run the fixed-batch forward once before accepting traffic."""
        self._warm(self._model[0])

    def reload(self, variables, *, apply_fn: Callable | None | type(...) = ...,
               step: int | None = None) -> None:
        """Hot-swap the served weights without dropping traffic.

        - ``apply_fn`` omitted (the module path): the new variables are
          checked leaf by leaf against the live ones (same keys, shapes,
          dtypes) and served through a fresh module copy.
        - ``apply_fn`` passed (the folded engine bakes weights into the
          closure): the new forward is built and warmed HERE, off the
          request path, before the swap.

        In-flight batches finish on whichever (forward, variables) pair
        they dispatched with; the pair swaps as one reference.
        """
        variables = _flat(variables)
        if _spec(self._model[1]) != _spec(variables):
            raise ValueError(
                "reload variables do not match the live tree "
                "(structure/shape/dtype); a mismatched swap would "
                "change the warmed program — refuse instead")
        if apply_fn is ...:
            if self._weights_baked:
                raise ValueError(
                    "this service's forward bakes weights into its "
                    "closure (custom apply_fn / folded engine); a bare "
                    "variable swap would be a silent no-op — pass the "
                    "rebuilt apply_fn to reload()")
            forward = self._build_forward(None, variables)
        else:
            forward = self._build_forward(apply_fn, variables)
            self._warm(forward)
            self._weights_baked = apply_fn is not None
        self._model = (forward, variables)
        self.step = step
        self.reloads += 1

    def validate(self, image: "np.ndarray") -> None:
        """Raise unless `image` is one service-ready frame."""
        if (getattr(image, "shape", None)
                != (self.crop_from, self.crop_from, 3)):
            raise ValueError(
                f"image must be ({self.crop_from}, {self.crop_from}, 3) "
                f"uint8 (got {getattr(image, 'shape', type(image))}); "
                "use decode_request for raw bytes")
        # dtype too: a float frame would change the padded batch's dtype
        # and the standardization it gets
        if getattr(image, "dtype", None) != np.uint8:
            raise ValueError(
                f"image dtype must be uint8 "
                f"(got {getattr(image, 'dtype', type(image))})")

    def dispatch_batch(self, images: "np.ndarray"):
        """Async half of embed_batch: pad, enqueue the forward on the
        device, and return the ``(embeddings, quality)`` device tensors
        (a CUDA forward returns once its kernels are queued, so the
        caller can collect the next batch meanwhile). Finish with
        ``_host(...)[:n]`` per element."""
        n = images.shape[0]
        if n > self.batch:
            raise ValueError(f"{n} > service batch {self.batch}")
        if images.shape[1:3] != (self.crop_from, self.crop_from):
            raise ValueError(
                f"images must arrive at the eval source scale "
                f"{self.crop_from}² (got {images.shape[1:3]}); "
                "decode_request produces it from raw bytes")
        if n < self.batch:
            pad = np.zeros((self.batch - n,) + images.shape[1:], np.uint8)
            images = np.concatenate([images, pad])
        forward, _ = self._model   # one read: reload-atomic
        return self._launch(forward,
                            torch.from_numpy(np.ascontiguousarray(images)))

    def embed_batch(self, images: "np.ndarray",
                    with_quality: bool = False):
        """(N<=batch, crop_from, crop_from, 3) uint8 → (N, D) f32
        unit-norm embeddings (plus (N,) quality scores when asked).
        Pads to the fixed batch."""
        n = images.shape[0]
        emb, q = self.dispatch_batch(images)
        emb = _host(emb)[:n]
        return (emb, _host(q)[:n]) if with_quality else emb

    def decode_request(self, body: bytes) -> np.ndarray:
        """One request body → (crop_from, crop_from, 3) uint8, through
        the SAME host chain as extract (PIL decode + half-pixel
        bilinear ``_resize_u8``). Accepts JPEG/PNG bytes or a .npy
        payload (magic-sniffed)."""
        from tf_face_toolbox_tpu_torch.data.pipeline import _decode_jpeg

        if body[:6] == b"\x93NUMPY":
            arr = np.load(io.BytesIO(body), allow_pickle=False)
            if arr.ndim != 3 or arr.shape[-1] != 3:
                raise ValueError(f"npy payload must be (H, W, 3), "
                                 f"got {arr.shape}")
        else:
            arr = _decode_jpeg(body)
        return self.decode_array(arr)

    def decode_array(self, arr: "np.ndarray") -> np.ndarray:
        """(H, W, 3) array → service-ready (crop_from, crop_from, 3)
        uint8 via the extract-chain host resize."""
        from tf_face_toolbox_tpu_torch.data.pipeline import _resize_u8

        return _resize_u8(np.asarray(arr, np.uint8),
                          self.crop_from, self.crop_from)


def bulk_embed(batcher: "DynamicBatcher", images: "np.ndarray",
               with_quality: bool = False):
    """Bulk path shared by every transport front-end: chunk ``images``
    (already decoded to the service scale) through the fixed-batch
    program, dispatching every chunk BEFORE materializing any so the
    device round trips overlap (the batcher's own dispatch→resolve
    split), and fold the work into the batcher's stats."""
    service = batcher.service
    t0 = time.monotonic()
    spans = [(i, min(i + service.batch, len(images)))
             for i in range(0, len(images), service.batch)]
    outs = [service.dispatch_batch(images[a:b]) for a, b in spans]
    embs = np.concatenate([_host(o[0])[:b - a]
                           for o, (a, b) in zip(outs, spans)])
    quals = (np.concatenate([_host(o[1])[:b - a]
                             for o, (a, b) in zip(outs, spans)])
             if with_quality else None)
    batcher.record_bulk(images=len(images), device_calls=len(spans),
                        elapsed=time.monotonic() - t0)
    return (embs, quals) if with_quality else embs


def health_payload(service: EmbeddingService) -> dict:
    """GET /healthz == tfft.Embedding/Health body."""
    return {"status": "ok", "batch": service.batch,
            "image_size": service.image_size,
            "serving_step": service.step}


def stats_payload(batcher: "DynamicBatcher") -> dict:
    """GET /stats == tfft.Embedding/Stats body."""
    s = dict(batcher.stats)
    calls = max(s["device_calls"], 1)
    s["mean_batch_fill"] = round(s["images"] / calls, 2)
    s["serving_step"] = batcher.service.step
    s["reloads"] = batcher.service.reloads
    return s


@dataclass
class _Pending:
    image: np.ndarray
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Exception | None = None


class DynamicBatcher:
    """Coalesce concurrent single-image requests into device batches.

    Two-stage pipeline: the *dispatch* worker drains the queue up to
    ``service.batch`` items (after the first item of a batch it waits at
    most ``max_wait_ms`` for stragglers — the classic latency-vs-fill
    knob), pads, and enqueues the forward on the device without waiting
    for it (a CUDA forward returns once its kernels are queued); the
    *resolve* worker copies the results to the host and completes the
    futures. Up to ``depth`` batches stay in flight, so the next batch's
    collection and host-to-device copy overlap the previous batch's
    device time.
    """

    def __init__(self, service: EmbeddingService, *,
                 max_wait_ms: float = 5.0, depth: int = 2):
        self.service = service
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._stats_mu = threading.Lock()
        self._stats = {"requests": 0, "device_calls": 0, "images": 0}
        # rings of recent request latencies (seconds), split by
        # endpoint: coalesced singles vs bulk have very different
        # latency regimes (straggler wait vs chunked device sweeps),
        # so one merged percentile hides both
        self._latencies: dict[str, collections.deque] = {
            "embed": collections.deque(maxlen=2048),
            "embed_batch": collections.deque(maxlen=2048),
        }
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._resolver = threading.Thread(target=self._resolve_loop,
                                          daemon=True)
        self._dispatcher.start()
        self._resolver.start()

    @property
    def stats(self) -> dict:
        with self._stats_mu:
            out = dict(self._stats)
            by_ep = {ep: sorted(d)
                     for ep, d in self._latencies.items() if d}

        def pcts(lats: list) -> dict:
            pick = lambda q: lats[min(len(lats) - 1,  # noqa: E731
                                      int(q * len(lats)))]
            return {"p50": round(1e3 * pick(0.50), 2),
                    "p95": round(1e3 * pick(0.95), 2),
                    "p99": round(1e3 * pick(0.99), 2)}

        merged = sorted(lat for lats in by_ep.values() for lat in lats)
        if merged:
            out["latency_ms"] = pcts(merged)
            out["latency_ms_by_endpoint"] = {
                ep: pcts(lats) for ep, lats in by_ep.items()}
        return out

    def _count(self, **deltas) -> None:
        with self._stats_mu:
            for key, d in deltas.items():
                self._stats[key] += d

    def submit(self, image: np.ndarray,
               timeout: float = 30.0,
               with_quality: bool = False):
        # validate BEFORE coalescing: a malformed request must fail
        # alone, not poison the batch it would have joined
        self.service.validate(image)
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        p = _Pending(image=image)
        self._count(requests=1)
        t0 = time.monotonic()
        self._q.put(p)
        # re-check AFTER the put: close() drains the queue once, so a
        # request enqueued concurrently with that drain would otherwise
        # block out its full timeout instead of failing fast
        if self._stop.is_set() and not p.event.is_set():
            p.error = RuntimeError("batcher is closed")
            p.event.set()
        ok = p.event.wait(timeout)
        # record latency for EVERY outcome: a timed-out request is
        # exactly the tail p99 must expose, not a survivorship gap
        with self._stats_mu:
            self._latencies["embed"].append(time.monotonic() - t0)
        if not ok:
            raise TimeoutError("embedding request timed out")
        if p.error is not None:
            raise p.error
        return p.result if with_quality else p.result[0]

    def record_bulk(self, *, images: int, device_calls: int,
                    elapsed: float) -> None:
        """Fold a bulk (/embed_batch) request into the stats so /stats
        reflects bulk traffic too."""
        self._count(requests=1, images=images,
                    device_calls=device_calls)
        with self._stats_mu:
            self._latencies["embed_batch"].append(elapsed)

    def close(self) -> None:
        self._stop.set()
        self._dispatcher.join(timeout=10)
        self._resolver.join(timeout=10)
        # fail anything still pending instead of leaving callers to
        # block out their submit timeouts
        for q in (self._q, self._inflight):
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                pendings = [item] if isinstance(item, _Pending) else item[0]
                for p in pendings:
                    p.error = RuntimeError("batcher closed")
                    p.event.set()

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.service.batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                images = np.stack([p.image for p in batch])
                device_out = self.service.dispatch_batch(images)
            except Exception as e:  # surface per-request, keep serving
                for p in batch:
                    p.error = e
                    p.event.set()
                continue
            self._count(device_calls=1, images=len(batch))
            # bounded put = backpressure at `depth` in-flight batches;
            # poll so shutdown can't wedge on a full queue
            while True:
                try:
                    self._inflight.put((batch, device_out), timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set() and not \
                            self._resolver.is_alive():
                        for p in batch:
                            p.error = RuntimeError("batcher closed")
                            p.event.set()
                        break

    def _resolve_loop(self) -> None:
        while True:
            try:
                batch, device_out = self._inflight.get(timeout=0.1)
            except queue.Empty:
                # exit only when no more batches can arrive: stop set
                # AND the dispatcher is done (else a just-dispatched
                # batch could be orphaned between put and our get)
                if self._stop.is_set() and not self._dispatcher.is_alive():
                    return
                continue
            try:
                embs = _host(device_out[0])[:len(batch)]
                quals = _host(device_out[1])[:len(batch)]
                for p, e, q in zip(batch, embs, quals):
                    p.result = (e, q)
            except Exception as e:
                for p in batch:
                    p.error = e
            for p in batch:
                p.event.set()


def serve(batcher: "DynamicBatcher | dict[str, DynamicBatcher]", *,
          host: str = "127.0.0.1",
          port: int = 0, unix_socket: str | None = None,
          max_body_mb: int = 64,
          gallery=None, enroll_min_quality: float = 0.0):
    """Start the HTTP front-end; returns the (running) HTTPServer.
    Caller owns shutdown(); call ``server.wait_idle(timeout)`` after
    shutdown() to let in-flight handlers finish (the stdlib's
    ``server_close`` does NOT join daemon handler threads — verified on
    py3.12). Endpoints: POST /embed, POST /embed_batch (npy
    (N, H, W, 3); bodies over ``max_body_mb`` get 413; send
    ``Accept: application/x-npy`` for a binary .npy response instead
    of JSON), GET /healthz, GET /stats.

    **Multi-model**: pass ``{name: DynamicBatcher}`` instead of one
    batcher (TF-Serving's multi-model server: e.g. a small fast net
    next to an accuracy-grade ResNet, each with its own
    geometry/norm).
    Requests pick a model with ``?model=<name>`` on any endpoint; the
    FIRST entry is the default, so single-model clients keep working.
    /healthz and /stats without ``?model=`` report all models keyed by
    name. Unknown names get 404 with the model list. The batchers
    share the one device — concurrent dispatches serialize there, the
    same property the in-flight pipeline already rides.

    ``unix_socket``: serve HTTP over an AF_UNIX socket at this path
    instead of TCP — the rolling-restart/reverse-proxy transport:
    no TCP handshake/TIME_WAIT per request, and
    the next daemon takes the path over atomically (bind to a temp
    name + rename) so a proxy never sees connection-refused between
    generations. A stale path from a dead process is replaced.

    ``gallery``: a serving.gallery.DeviceGallery enables the daemon's
    1:N endpoints against the DEFAULT model's embedding space:
    POST /enroll?label=<int> (image body → embed → store; an
    ``enroll_min_quality`` floor — overridable per request with
    &min_quality= — gates low-quality enrollments using the feature-
    norm score), POST /identify?k=5[&threshold=t] (image body →
    matches [{label, score}], plus "unknown": true when the top score
    is below t — the open-set decision), GET /gallery (size), and
    POST /gallery/save?path= (atomic snapshot). Multi-model daemons
    refuse gallery calls with ?model= other than the default (one
    gallery, one embedding space)."""
    from http.server import BaseHTTPRequestHandler
    from http.server import ThreadingHTTPServer as _Threading

    class ThreadingHTTPServer(_Threading):
        # the listen backlog: socketserver's default of 5 drops the
        # connects of a burst of clients, which then retry a second later
        request_queue_size = 128
    from urllib.parse import parse_qs, urlsplit

    if isinstance(batcher, DynamicBatcher):
        batchers = {None: batcher}
    else:
        if not batcher:
            raise ValueError("serve() got an empty model map")
        batchers = dict(batcher)
    default_name = next(iter(batchers))
    multi = default_name is not None
    max_body = max_body_mb * (1 << 20)
    inflight = {"n": 0}
    inflight_cv = threading.Condition()

    def route(raw_path: str):
        """→ (path, batcher | None, model_name, want_quality, qs)."""
        parts = urlsplit(raw_path)
        qs = parse_qs(parts.query)
        name = qs.get("model", [default_name])[0]
        quality = qs.get("quality", ["0"])[0] not in ("0", "", "false")
        return parts.path, batchers.get(name, None), name, quality, qs

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; stats endpoint instead
            pass

        def _reply(self, code: int, payload: dict) -> None:
            try:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionError):
                pass  # client went away; nothing to tell it

        def _wants_npy(self) -> bool:
            # content negotiation for the embedding payload: JSON text
            # is the compatible default, but at 512 floats/face its
            # encode dominates bulk responses; a binary .npy body
            # closes that gap without switching transports
            accept = self.headers.get("Accept", "")
            return ("application/x-npy" in accept
                    or "application/octet-stream" in accept)

        def _reply_npy(self, arr: "np.ndarray") -> None:
            try:
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(arr),
                        allow_pickle=False)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-npy")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionError):
                pass  # client went away; nothing to tell it

        def do_GET(self):
            path, b, name, _, _qs = route(self.path)
            if path == "/gallery":
                if gallery is None:
                    self._reply(404, {"error": "no gallery configured "
                                               "(cli.serve --gallery)"})
                elif name != default_name:
                    self._reply(404, {"error": "gallery is bound to the "
                                               "default model"})
                else:
                    self._reply(200, {
                        "size": len(gallery),
                        "dim": gallery.dim,
                        "dtype": gallery.dtype,
                        "device_mb": round(
                            gallery.device_bytes() / 1e6, 1),
                        "hbm_limit_gb": gallery.hbm_limit_gb,
                        "overflow": gallery.overflow,
                        "streaming": gallery.streaming})
                return
            if path not in ("/healthz", "/stats"):
                self._reply(404, {"error": "unknown path"})
                return
            if b is None:
                self._reply(404, {
                    "error": f"unknown model {name!r}",
                    "models": sorted(k for k in batchers if k)})
                return
            if path == "/healthz":
                payload = health_payload(b.service)
                if multi and "model=" not in self.path:
                    payload = {"status": "ok", "models": {
                        k: health_payload(v.service)
                        for k, v in batchers.items()}}
                self._reply(200, payload)
            else:
                payload = stats_payload(b)
                if multi and "model=" not in self.path:
                    payload = {"models": {k: stats_payload(v)
                                          for k, v in batchers.items()}}
                self._reply(200, payload)

        def do_POST(self):
            with inflight_cv:
                inflight["n"] += 1
            try:
                self._do_post()
            finally:
                with inflight_cv:
                    inflight["n"] -= 1
                    inflight_cv.notify_all()

        def _do_gallery(self, path, b, name, qs):
            """/enroll, /identify, /gallery/save — the daemon's 1:N
            endpoints over the device-resident gallery."""
            if gallery is None:
                self._reply(404, {"error": "no gallery configured "
                                           "(cli.serve --gallery)"})
                return
            if b is None or name != default_name:
                self._reply(404, {"error": "gallery endpoints are bound "
                                           "to the default model"})
                return
            if path == "/gallery/save":
                target = qs.get("path", [""])[0]
                if not target:
                    self._reply(400, {"error": "need ?path="})
                    return
                try:
                    n = gallery.save(target)
                except OSError as e:
                    self._reply(500, {"error": f"{e}"})
                    return
                self._reply(200, {"saved": n, "path": target})
                return
            if path == "/deenroll":
                try:
                    label = int(qs.get("label", [""])[0])
                except ValueError:
                    self._reply(400, {"error": "need ?label=<int>"})
                    return
                removed = gallery.remove(label)
                self._reply(200, {"removed": removed,
                                  "size": len(gallery)})
                return
            svc = b.service
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body:
                    self._reply(413, {"error": "body too large"})
                    return
                image = svc.decode_request(self.rfile.read(n))
                if path == "/enroll":
                    label = int(qs.get("label", [""])[0])
                min_q = float(qs.get("min_quality",
                                     [str(enroll_min_quality)])[0])
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                emb, qual = b.submit(image, with_quality=True)
                if path == "/enroll":
                    if float(qual) < min_q:
                        self._reply(422, {
                            "error": "quality below enrollment floor",
                            "quality": float(qual),
                            "min_quality": min_q})
                        return
                    size = gallery.enroll(emb, [label])
                    self._reply(200, {"enrolled": True, "label": label,
                                      "quality": float(qual),
                                      "size": size})
                else:                                   # /identify
                    k = int(qs.get("k", ["5"])[0])
                    thr = float(qs.get("threshold", ["-1e9"])[0])
                    try:
                        labs, scores = gallery.search(emb, k=k)
                    except ValueError as e:
                        self._reply(409, {"error": f"{e}"})
                        return
                    matches = [{"label": int(l), "score": float(s)}
                               for l, s in zip(labs[0], scores[0])]
                    self._reply(200, {
                        "matches": matches,
                        "quality": float(qual),
                        "unknown": bool(scores[0][0] < thr)})
            except Exception as e:
                from tf_face_toolbox_tpu_torch.serving.gallery import (
                    GalleryCapacityError)

                if isinstance(e, GalleryCapacityError):
                    code = 507        # Insufficient Storage, retryable
                elif isinstance(e, TimeoutError):
                    code = 503
                else:
                    code = 500
                self._reply(code, {"error": f"{type(e).__name__}: {e}"})

        def _do_post(self):
            path, b, name, want_quality, qs = route(self.path)
            if path in ("/enroll", "/identify", "/gallery/save",
                        "/deenroll"):
                self._do_gallery(path, b, name, qs)
                return
            if path not in ("/embed", "/embed_batch"):
                self._reply(404, {"error": "unknown path"})
                return
            if b is None:
                self._reply(404, {
                    "error": f"unknown model {name!r}",
                    "models": sorted(k for k in batchers if k)})
                return
            if want_quality and self._wants_npy():
                # checked BEFORE decode/dispatch: the binary .npy body
                # carries one array, and finding that out after a full
                # device round trip would waste the batch
                self._reply(400, {"error": "quality=1 is JSON-only; "
                                           "drop the x-npy Accept "
                                           "header"})
                return
            svc = b.service
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > max_body:
                    # drain in bounded chunks (never materialized) so
                    # the client can finish sending and read the 413
                    # instead of hitting a broken pipe
                    remaining = n
                    while remaining > 0:
                        chunk = self.rfile.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    self._reply(413, {"error": f"body {n} bytes > "
                                               f"{max_body_mb} MiB cap"})
                    return
                body = self.rfile.read(n)
                if path == "/embed_batch":
                    # bulk: .npy (N, H, W, 3) uint8 — the client
                    # already batched, so no coalescing needed
                    arr = np.load(io.BytesIO(body), allow_pickle=False)
                    if arr.ndim != 4 or arr.shape[-1] != 3:
                        raise ValueError(
                            f"npy payload must be (N, H, W, 3), "
                            f"got {arr.shape}")
                    images = np.stack([
                        svc.decode_array(a) for a in arr])
                else:
                    images = svc.decode_request(body)[None]
            except Exception as e:  # malformed payload → client error
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                if path == "/embed_batch":
                    out = bulk_embed(b, images,
                                     with_quality=want_quality)
                    embs, quals = out if want_quality else (out, None)
                    if self._wants_npy():
                        self._reply_npy(embs.astype(np.float32))
                    else:
                        payload = {"embeddings": embs.tolist()}
                        if want_quality:
                            payload["qualities"] = quals.tolist()
                        self._reply(200, payload)
                else:
                    out = b.submit(images[0], with_quality=want_quality)
                    emb, qual = out if want_quality else (out, None)
                    if self._wants_npy():
                        self._reply_npy(np.asarray(emb, np.float32))
                    else:
                        payload = {"embedding": emb.tolist()}
                        if want_quality:
                            payload["quality"] = float(qual)
                        self._reply(200, payload)
            except Exception as e:  # device/backlog fault → server error
                self._reply(503 if isinstance(e, TimeoutError) else 500,
                            {"error": f"{type(e).__name__}: {e}"})

    if unix_socket:
        import os
        import socket as socket_mod

        class UnixHTTPServer(ThreadingHTTPServer):
            address_family = socket_mod.AF_UNIX

            def server_bind(self):
                # bind a unique temp name, then rename over the target:
                # atomic takeover — clients connecting to the path get
                # either the old (draining) or the new server, never a
                # refused window
                self._tmp_path = f"{unix_socket}.{os.getpid()}.tmp"
                try:
                    os.unlink(self._tmp_path)
                except FileNotFoundError:
                    pass
                self.socket.bind(self._tmp_path)
                os.rename(self._tmp_path, unix_socket)
                self.server_address = unix_socket

            def get_request(self):
                # AF_UNIX peers have no (host, port); give the handler
                # the tuple shape BaseHTTPRequestHandler expects
                sock, _ = super().get_request()
                return sock, ("unix", 0)

        server = UnixHTTPServer(unix_socket, Handler,
                                bind_and_activate=True)
    else:
        server = ThreadingHTTPServer((host, port), Handler)

    def wait_idle(timeout: float = 30.0) -> bool:
        """Block until no handler is mid-request (call after
        shutdown()); True if drained within `timeout`."""
        deadline = time.monotonic() + timeout
        with inflight_cv:
            while inflight["n"] > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                inflight_cv.wait(remaining)
        return True

    server.wait_idle = wait_idle
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
