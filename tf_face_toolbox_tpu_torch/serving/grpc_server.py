"""gRPC transport for the embedding daemon.

Counterpart of ``tf_face_toolbox_tpu/serving/grpc_server.py``, with the
same wire contract, so a client of either daemon talks to the other.
It mirrors the HTTP endpoints one to one and shares the SAME
``DynamicBatcher``/``EmbeddingService`` objects: both transports can run
over one forward and one stats surface. ``grpc`` (grpcio) is imported
only when a server or client is made.

No protobuf codegen: the service is registered with
``grpc.method_handlers_generic_handler`` and raw-bytes
(de)serializers. That is still a conformant gRPC service; any language
calls it by registering identity byte marshallers for these method
paths:

- ``/tfft.Embedding/Embed``: request = one JPEG/PNG or ``.npy``
  (H, W, 3) frame (same magic-sniffing as POST /embed); response =
  ``.npy`` float32 (D,) unit-norm embedding. Coalesced through the
  dynamic batcher.
- ``/tfft.Embedding/EmbedBatch``: request = ``.npy`` uint8
  (N, H, W, 3); response = ``.npy`` float32 (N, D). Chunks are
  dispatched exactly like POST /embed_batch.
- ``/tfft.Embedding/Health`` and ``/tfft.Embedding/Stats``: empty
  request; JSON (UTF-8 bytes) response, same payloads as GET
  /healthz and GET /stats.

**Multi-model**: pass ``{name: DynamicBatcher}`` to :func:`serve_grpc`
and clients pick a model with the ``tfft-model`` invocation-metadata
key on any method (no key = the FIRST entry, the default model, as on
HTTP). Unknown names → NOT_FOUND with the model list. Health/Stats
without the key report all models keyed by name, as GET /healthz
without ``?model=`` does.

Error mapping: malformed or over-``max_body`` payloads →
INVALID_ARGUMENT (not retryable; the transport's receive cap is set
above ``max_body`` so the size guard, not gRPC's default 4 MiB
message cap, decides); batcher backlog timeout → RESOURCE_EXHAUSTED
(retryable); closed/draining batcher → UNAVAILABLE; anything else →
INTERNAL.

``GrpcEmbeddingClient`` below is the reference client; ``npy`` framing
keeps payloads self-describing without a schema registry.
"""

from __future__ import annotations

import io
import json
from typing import Any

import numpy as np


def _identity(b: bytes) -> bytes:
    return b


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    return buf.getvalue()


def _npy_load(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


class _Handlers:
    """Method bodies; one instance per server, shared batcher."""

    def __init__(self, batcher, max_body: int):
        import grpc

        self._grpc = grpc
        if isinstance(batcher, dict):
            if not batcher:
                raise ValueError("serve_grpc() got an empty model map")
            self.batchers = dict(batcher)
        else:
            self.batchers = {None: batcher}
        self.default_name = next(iter(self.batchers))
        self.max_body = max_body

    METADATA_KEY = "tfft-model"

    def _resolve(self, context, *, explicit_only: bool = False):
        """Pick the batcher for this RPC from the ``tfft-model``
        invocation metadata (None = the default model, mirroring a
        request without ``?model=`` on HTTP). ``explicit_only``:
        return None when the key is absent (Health/Stats aggregate
        over all models in that case)."""
        name = None
        for k, v in (context.invocation_metadata() or ()):
            if k == self.METADATA_KEY:
                name = v if isinstance(v, str) else v.decode()
                break
        if name is None:
            if explicit_only:
                return None, None
            name = self.default_name
        if name not in self.batchers:
            known = [k or "<default>" for k in self.batchers]
            context.abort(self._grpc.StatusCode.NOT_FOUND,
                          f"unknown model {name!r}; served: {known}")
        return name, self.batchers[name]

    def _guard_size(self, body: bytes, context) -> None:
        if len(body) > self.max_body:
            context.abort(
                self._grpc.StatusCode.INVALID_ARGUMENT,
                f"body {len(body)} bytes > {self.max_body} cap")

    def embed(self, request: bytes, context) -> bytes:
        grpc = self._grpc
        _, batcher = self._resolve(context)
        self._guard_size(request, context)
        try:
            image = batcher.service.decode_request(request)
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"{type(e).__name__}: {e}")
        try:
            emb = batcher.submit(image)
        except TimeoutError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except RuntimeError as e:  # batcher closed (draining)
            context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        return _npy_bytes(np.asarray(emb, np.float32))

    def embed_batch(self, request: bytes, context) -> bytes:
        from tf_face_toolbox_tpu_torch.serving.server import bulk_embed

        grpc = self._grpc
        _, batcher = self._resolve(context)
        self._guard_size(request, context)
        service = batcher.service
        try:
            arr = _npy_load(request)
            if arr.ndim != 4 or arr.shape[-1] != 3:
                raise ValueError(
                    f"npy payload must be (N, H, W, 3), got {arr.shape}")
            images = np.stack([service.decode_array(a) for a in arr])
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"{type(e).__name__}: {e}")
        try:
            embs = bulk_embed(batcher, images)
        except Exception as e:
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")
        return _npy_bytes(embs.astype(np.float32))

    def health(self, request: bytes, context) -> bytes:
        from tf_face_toolbox_tpu_torch.serving.server import health_payload

        del request
        _, batcher = self._resolve(context, explicit_only=True)
        if batcher is not None:
            payload = health_payload(batcher.service)
        elif self.default_name is None:
            payload = health_payload(self.batchers[None].service)
        else:  # multi-model, no key: all models (same shape as HTTP)
            payload = {"status": "ok", "models": {
                n: health_payload(b.service)
                for n, b in self.batchers.items()}}
        return json.dumps(payload).encode()

    def stats(self, request: bytes, context) -> bytes:
        from tf_face_toolbox_tpu_torch.serving.server import stats_payload

        del request
        _, batcher = self._resolve(context, explicit_only=True)
        if batcher is not None:
            payload = stats_payload(batcher)
        elif self.default_name is None:
            payload = stats_payload(self.batchers[None])
        else:
            payload = {"models": {n: stats_payload(b)
                                  for n, b in self.batchers.items()}}
        return json.dumps(payload).encode()


def serve_grpc(batcher, *, host: str = "127.0.0.1", port: int = 0,
               unix_socket: str | None = None, max_workers: int = 16,
               max_body_mb: int = 64):
    """Start the gRPC front-end; returns the started ``grpc.Server``
    with ``bound_port`` set (0 when serving a unix socket).

    ``batcher``: one DynamicBatcher, or a ``{name: DynamicBatcher}``
    map for the multi-model server (module docstring: clients route
    with the ``tfft-model`` metadata key; first entry = default).

    Caller
    owns shutdown: ``server.stop(grace)`` returns an event —
    in-flight RPCs complete within ``grace`` seconds while new ones
    are refused, which is the drain half of a rolling restart
    (gRPC's native equivalent of the HTTP server's wait_idle).

    ``unix_socket``: serve on ``unix:<path>`` instead of TCP — gRPC
    supports AF_UNIX targets natively on both ends. The listener is
    bound to a unique temp name and renamed over the target, the same
    atomic-takeover protocol as the HTTP unix server: grpc core
    unlinks ITS OWN bound path when the server stops, so a draining
    old daemon that had bound the target path directly would delete
    the socket file the NEW daemon just took over; after the rename, the old daemon's stop-unlink hits its
    stale temp name instead and the takeover survives the drain.
    """
    import concurrent.futures
    import os

    import grpc

    max_body = max_body_mb * (1 << 20)
    handlers = _Handlers(batcher, max_body)
    methods = {
        "Embed": handlers.embed,
        "EmbedBatch": handlers.embed_batch,
        "Health": handlers.health,
        "Stats": handlers.stats,
    }
    generic = grpc.method_handlers_generic_handler(
        "tfft.Embedding",
        {name: grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=_identity,
            response_serializer=_identity)
         for name, fn in methods.items()})
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="tfft-grpc"),
        # gRPC's transport defaults to a 4 MiB message cap, which
        # would silently override the max_body contract before
        # _guard_size ever ran; the +1 MiB slack ensures an over-cap
        # body reaches the guard and fails loudly as INVALID_ARGUMENT.
        # Send side is uncapped: responses are our own (N, D) frames.
        options=[("grpc.max_receive_message_length",
                  max_body + (1 << 20)),
                 ("grpc.max_send_message_length", -1)])
    server.add_generic_rpc_handlers((generic,))
    if unix_socket:
        tmp = f"{unix_socket}.{os.getpid()}.tmp"
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        server.add_insecure_port(f"unix:{tmp}")  # raises on failure
        os.rename(tmp, unix_socket)
        server.bound_port = 0
    else:
        server.bound_port = server.add_insecure_port(f"{host}:{port}")
    server.start()
    return server


class GrpcEmbeddingClient:
    """Reference client for the raw-bytes wire contract above.

    ``target`` is any gRPC target string — ``host:port`` or
    ``unix:/path``. Methods mirror the HTTP endpoints.
    """

    def __init__(self, target: str):
        import grpc

        self._grpc = grpc
        # lift the channel's own 4 MiB defaults: body limits are the
        # SERVER'S contract (max_body → INVALID_ARGUMENT), not
        # something the client transport should pre-empt, and bulk
        # embedding responses can exceed 4 MiB (N > 2048 at D=512)
        self._channel = grpc.insecure_channel(
            target,
            options=[("grpc.max_send_message_length", -1),
                     ("grpc.max_receive_message_length", -1)])
        mk = lambda m: self._channel.unary_unary(  # noqa: E731
            f"/tfft.Embedding/{m}", request_serializer=_identity,
            response_deserializer=_identity)
        self._embed = mk("Embed")
        self._embed_batch = mk("EmbedBatch")
        self._health = mk("Health")
        self._stats = mk("Stats")

    @staticmethod
    def _meta(model: "str | None"):
        return ((("tfft-model", model),) if model else None)

    def embed(self, image: "np.ndarray | bytes",
              timeout: float = 30.0,
              model: "str | None" = None) -> np.ndarray:
        """One frame (uint8 array or raw JPEG/npy bytes) → (D,) f32.
        ``model`` routes on a multi-model daemon (metadata key)."""
        body = image if isinstance(image, (bytes, bytearray)) \
            else _npy_bytes(np.asarray(image))
        return _npy_load(self._embed(bytes(body), timeout=timeout,
                                     metadata=self._meta(model)))

    def embed_batch(self, images: np.ndarray,
                    timeout: float = 120.0,
                    model: "str | None" = None) -> np.ndarray:
        """(N, H, W, 3) uint8 → (N, D) f32."""
        return _npy_load(
            self._embed_batch(_npy_bytes(images), timeout=timeout,
                              metadata=self._meta(model)))

    def health(self, timeout: float = 10.0,
               model: "str | None" = None) -> dict:
        return json.loads(self._health(b"", timeout=timeout,
                                       metadata=self._meta(model)))

    def stats(self, timeout: float = 10.0,
              model: "str | None" = None) -> dict:
        return json.loads(self._stats(b"", timeout=timeout,
                                      metadata=self._meta(model)))

    def close(self) -> None:
        self._channel.close()

    def __enter__(self) -> "GrpcEmbeddingClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
