"""Embedding serving daemon CLI.

Counterpart of ``tf_face_toolbox_tpu/cli/serve.py``: loads a port
checkpoint, a ``.npz`` of variables in the JAX key space, or deployment
bundles of either package, warms ONE fixed-batch forward on the card,
and serves HTTP (or gRPC) with dynamic request batching
(``serving/server.py``):

    python -m tf_face_toolbox_tpu_torch.cli.serve \\
        --checkpoint_dir=/models/run --network=resnet_v1_50 \\
        --port=8000 --max_batch=64 --max_wait_ms=5 \\
        --gallery=/models/gallery.npz --gallery_dtype=int8

    curl -s -X POST --data-binary @face.jpg localhost:8000/embed
    curl -s -X POST --data-binary @face.jpg 'localhost:8000/identify?k=5'
    curl -s localhost:8000/healthz ; curl -s localhost:8000/stats

``--engine auto`` serves through the BN-folded engine where it applies
(ResNet, SE-ResNet) and through the module elsewhere, with a log line,
as ``cli.extract --engine auto`` does. On a CUDA device the gallery's
/identify runs top-k kernel 3 (f32/bf16 store) or 4 (int8 store).
SIGTERM/SIGINT drains: new connections are refused, requests in flight
complete, the gallery is saved, and the daemon prints its top-k kernel
launches and ``drained; bye``. ``--gallery_shards N`` stripes the
gallery over the first N visible devices of ``--device`` (-1: every
one; ``serving.distributed_gallery``), refuse-only past capacity.
``--quant_mode dynamic|static`` serves W8A8 int8 convs through the
module (``models/layers.py``); static calibrates its frozen scales on
``--calibrate_data`` at boot and again on every hot reload, as JAX's
``prepare`` does. An int8 bundle serves the mode it bakes in.
``--engine folded`` serves fp only and refuses int8.
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint_dir", default="", help="port train dir")
    p.add_argument("--variables_npz", default="",
                   help="serve a .npz of variables in the JAX key space "
                        "instead of a checkpoint")
    p.add_argument("--bundle", default="",
                   help="boot from one-file deployment bundles (cli.export, "
                        "either package's); each bundle's config record "
                        "supplies network/stem/head/embedding_dim/"
                        "image_size/crop_from/input_norm, so those flags "
                        "are ignored. A comma-separated [name=]path list "
                        "serves several models from one daemon (route with "
                        "?model=<name> on HTTP / the tfft-model metadata "
                        "key on gRPC; the first entry is the default; name "
                        "defaults to the bundle's network)")
    p.add_argument("--network", default="resnet_v1_50", help="backbone name")
    p.add_argument("--stem", default="face",
                   choices=["face", "imagenet", "space2depth"],
                   help="backbone stem")
    p.add_argument("--head", default="gap", choices=["gap", "flatten"],
                   help="embedding head")
    p.add_argument("--input_norm", default="per_image",
                   choices=["per_image", "fixed"],
                   help="per_image = tf.image standardization; fixed = "
                        "(x-127.5)/127.5 (InsightFace-trained weights)")
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--image_size", type=int, default=112,
                   help="served input size")
    p.add_argument("--crop_from", type=int, default=0,
                   help="eval source scale (0 = image_size + 8; requests "
                        "are resized here, then center-cropped on the "
                        "device, the same chain as cli.extract)")
    p.add_argument("--bf16", dest="bf16", action="store_true", default=True,
                   help="bfloat16 compute (default)")
    p.add_argument("--nobf16", dest="bf16", action="store_false",
                   help="float32 compute")
    p.add_argument("--use_ema", dest="use_ema", action="store_true",
                   default=False, help="serve the EMA weights")
    p.add_argument("--nouse_ema", dest="use_ema", action="store_false")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "module", "flax", "folded"],
                   help="eval forward: auto = the BN-folded engine where it "
                        "serves the net, else the module; module (alias "
                        "flax, the JAX CLI's name) = the nn.Module forward")
    p.add_argument("--quant_mode", default="none",
                   choices=["none", "dynamic", "static"],
                   help="int8 serving; static needs --calibrate_data")
    p.add_argument("--calibrate_data", default="",
                   help="FaceShard sampled for static-int8 scales at boot "
                        "(and at every hot reload)")
    p.add_argument("--calibrate_batches", type=int, default=4,
                   help="calibration batches (of --max_batch, at most 128)")
    p.add_argument("--host", default="127.0.0.1", help="bind address")
    p.add_argument("--port", type=int, default=8000, help="bind port")
    p.add_argument("--unix_socket", default="",
                   help="serve over an AF_UNIX socket at this path instead "
                        "of TCP (rolling restarts: the next daemon takes the "
                        "path over atomically while this one drains)")
    p.add_argument("--transport", default="http", choices=["http", "grpc"],
                   help="wire protocol: http (stdlib front-end) or grpc "
                        "(raw-bytes tfft.Embedding service)")
    p.add_argument("--gallery", default="",
                   help="enable the 1:N endpoints (/enroll, /identify, "
                        "/deenroll, /gallery, /gallery/save) with this .npz "
                        "snapshot path: loaded at boot when it exists, "
                        "saved on drain. Bound to the default model's "
                        "embedding space; HTTP transport only")
    p.add_argument("--enroll_min_quality", type=float, default=0.0,
                   help="default feature-norm quality floor for /enroll "
                        "(0 = accept all; override per request with "
                        "&min_quality=)")
    p.add_argument("--gallery_dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="device store dtype: bfloat16 halves the bytes, int8 "
                        "quarters them (two-stage search with an exact f32 "
                        "rescore)")
    p.add_argument("--gallery_hbm_gb", type=float, default=8.0,
                   help="gallery device-store budget; enrollments past it "
                        "are refused with HTTP 507 (0 = unbounded)")
    p.add_argument("--gallery_overflow", default="refuse",
                   choices=["refuse", "stream"],
                   help="past --gallery_hbm_gb: 'refuse' enrollments (507) "
                        "or 'stream' the host master through the device")
    p.add_argument("--gallery_shards", type=int, default=0,
                   help="shard the gallery over this many devices of "
                        "--device (DistributedGallery: rows striped over "
                        "the shards, per-shard top-k merged; capacity "
                        "scales to shards x --gallery_hbm_gb). 0 = one "
                        "device, -1 = every visible one "
                        "(--gallery_overflow=stream is single-device)")
    p.add_argument("--max_batch", type=int, default=64,
                   help="device batch (pad-to-batch)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="straggler wait after the first request of a batch")
    p.add_argument("--watch_interval", type=float, default=0.0,
                   help="poll --checkpoint_dir every N seconds and hot-swap "
                        "onto new checkpoints without dropping traffic "
                        "(0 = off)")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def _refuse(args) -> None:
    """The flag combinations the JAX CLI refuses, with its messages."""
    quant = args.quant_mode != "none"
    if args.bundle:
        if args.checkpoint_dir or args.variables_npz:
            raise SystemExit("--bundle is self-contained; drop "
                             "--checkpoint_dir/--variables_npz")
        if quant or args.calibrate_data:
            raise SystemExit("--bundle bakes the quant mode and scales in "
                             "at export time; drop --quant_mode/"
                             "--calibrate_data")
        if args.watch_interval > 0:
            raise SystemExit("--watch_interval polls a train dir; "
                             "bundles are immutable artifacts")
    else:
        if args.quant_mode == "static" and not args.calibrate_data:
            raise SystemExit("--quant_mode=static needs --calibrate_data "
                             "(a shard sampled for activation scales)")
        if bool(args.checkpoint_dir) == bool(args.variables_npz):
            raise SystemExit("pass exactly one of --checkpoint_dir / "
                             "--variables_npz / --bundle")
        if args.watch_interval > 0 and not args.checkpoint_dir:
            raise SystemExit("--watch_interval polls a --checkpoint_dir")
    if args.engine == "folded" and quant:
        raise SystemExit("--engine folded serves fp; int8 uses the module "
                         "(--engine module)")
    if args.gallery and args.transport == "grpc":
        raise SystemExit("--gallery endpoints are HTTP-only")
    if args.gallery and args.gallery_shards:
        if args.gallery_overflow == "stream":
            raise SystemExit(
                "--gallery_overflow=stream is single-device; a "
                "sharded gallery (--gallery_shards) is refuse-only "
                "— past capacity, use cli.search offline")
        _shard_devices(args)


def _shard_devices(args) -> list:
    """The devices of ``--gallery_shards``: the first N visible devices
    of ``--device`` (every CUDA device, or one CPU), all of them at -1;
    more than are visible refuses with JAX's ``create_mesh`` message."""
    import torch

    device = torch.device(args.device)
    visible = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if device.type == "cuda" else [device])
    n = len(visible) if args.gallery_shards < 0 else args.gallery_shards
    if n > len(visible):
        raise SystemExit(f"mesh ({n}x1) needs {n} devices, have "
                         f"{len(visible)}")
    return visible[:n]


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    _refuse(args)

    import torch

    from tf_face_toolbox_tpu_torch.serving.server import (
        DynamicBatcher, EmbeddingService)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run on the host")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    module_only = args.engine in ("module", "flax")
    quant = False if args.quant_mode == "none" else args.quant_mode

    def make_apply(net, flat, *, boot: bool, int8=quant):
        """The engine's forward for ``net`` holding ``flat``, or None for
        the module path (int8 serves there). ``boot`` turns an
        inapplicable --engine folded into the process's exit; inside the
        watcher thread it stays an ordinary exception (logged, retried
        next poll)."""
        if module_only or int8:
            return None
        from tf_face_toolbox_tpu_torch.serving import make_serving_apply

        try:
            return make_serving_apply(net, flat, device=device)
        except ValueError as e:
            if args.engine == "folded":
                if boot:
                    raise SystemExit(f"--engine folded: {e}") from e
                raise
            logging.info("serving engine not applicable (%s); using the "
                         "module path", e)
            return None

    def prepare(flat):
        """Post-restore serving prep, shared by boot and hot reload (so a
        reloaded model goes through the chain the booted one did): the
        static-int8 calibration pass, on the serving device."""
        if quant != "static":
            return flat
        from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
        from tf_face_toolbox_tpu_torch.extract import calibrate_on_shard

        logging.info("calibrating static-int8 scales on %d batches of %s",
                     args.calibrate_batches, args.calibrate_data)
        return calibrate_on_shard(
            args.network, flat, FaceShardSource(args.calibrate_data),
            image_size=args.image_size, crop_from=args.crop_from,
            batch=min(args.max_batch, 128),
            num_batches=args.calibrate_batches, norm=args.input_norm,
            device=device, embedding_dim=args.embedding_dim, dtype=dtype,
            stem=args.stem, head_variant=args.head,
            input_size=args.image_size)

    if args.bundle:
        from tf_face_toolbox_tpu_torch.interop.port import flatten_variables
        from tf_face_toolbox_tpu_torch.serving.bundle import (
            network_from_meta, read_bundle)

        specs = []
        for entry in args.bundle.split(","):
            name, sep, path = entry.partition("=")
            specs.append((name.strip() if sep else None,
                          (path if sep else entry).strip()))
        batchers = {}
        for name, path in specs:
            variables, meta = read_bundle(path)
            int8 = meta["quant_mode"] != "none"
            if args.engine == "folded" and int8:
                raise SystemExit(f"--engine folded serves fp; bundle {path} "
                                 f"bakes in int8 ({meta['quant_mode']})")
            try:
                net = network_from_meta(meta, dtype=dtype)
            except ValueError as e:      # a net JAX serves fp only
                raise SystemExit(f"--bundle {path}: {e}") from e
            flat = flatten_variables(variables)
            logging.info("bundle %s: %s step=%s quant=%s norm=%s", path,
                         meta["network"], meta.get("step"),
                         meta["quant_mode"], meta["input_norm"])
            svc = EmbeddingService(
                net, flat, image_size=int(meta["image_size"]),
                crop_from=int(meta.get("crop_from", 0)),
                batch=args.max_batch,
                apply_fn=make_apply(net, flat, boot=True, int8=int8),
                dtype=dtype, norm=meta["input_norm"], step=meta.get("step"),
                device=device)
            key = name or meta["network"]
            if key in batchers:
                raise SystemExit(f"duplicate model name {key!r}; "
                                 "disambiguate with --bundle name=path")
            logging.info("warming %s (b%d)...", key, args.max_batch)
            svc.warmup()
            batchers[key] = DynamicBatcher(svc, max_wait_ms=args.max_wait_ms)
        # one UNNAMED model -> the plain single-model server (the
        # payloads of checkpoint/npz boots); several, or an explicit
        # name= (the user will route by it) -> the model router
        single = len(specs) == 1 and specs[0][0] is None
        front = next(iter(batchers.values())) if single else batchers
        return _serve_front_end(args, front, list(batchers.values()), None,
                                device)

    boot_step = None
    if args.variables_npz:
        from tf_face_toolbox_tpu_torch.interop.port import (
            flatten_variables, load_variables_npz)
        from tf_face_toolbox_tpu_torch.models import create_network

        net = create_network(args.network, embedding_dim=args.embedding_dim,
                             dtype=dtype, stem=args.stem,
                             head_variant=args.head,
                             input_size=args.image_size, quantized=quant)
        flat = flatten_variables(load_variables_npz(args.variables_npz))
    else:
        from tf_face_toolbox_tpu_torch.pretrained import load_variables
        from tf_face_toolbox_tpu_torch.train.checkpoint import (
            CheckpointManager)

        # step read BEFORE the restore (rebuild() does the same): if a
        # newer checkpoint lands during the restore, the recorded step
        # undershoots what was loaded and the watcher's first poll
        # reloads; reading after would make it skip the new version
        boot_step = CheckpointManager(args.checkpoint_dir).latest_step()
        net, flat = load_variables(
            args.checkpoint_dir, args.network, args.embedding_dim,
            args.image_size, dtype, use_ema=args.use_ema, stem=args.stem,
            head=args.head, quantized=quant)
    flat = prepare(flat)

    service = EmbeddingService(
        net, flat, image_size=args.image_size, crop_from=args.crop_from,
        batch=args.max_batch, apply_fn=make_apply(net, flat, boot=True),
        dtype=dtype, norm=args.input_norm, step=boot_step, device=device)
    logging.info("warming the b%d extractor...", args.max_batch)
    service.warmup()
    batcher = DynamicBatcher(service, max_wait_ms=args.max_wait_ms)

    watcher = None
    if args.watch_interval > 0:
        from tf_face_toolbox_tpu_torch.pretrained import load_variables
        from tf_face_toolbox_tpu_torch.serving.reload import CheckpointWatcher
        from tf_face_toolbox_tpu_torch.train.checkpoint import (
            CheckpointManager)

        def rebuild():
            # step read BEFORE restore: if a newer checkpoint lands in
            # between, the recorded step undershoots and the next poll
            # reloads again: it converges, never serves stale
            step = CheckpointManager(args.checkpoint_dir).latest_step()
            _, v = load_variables(
                args.checkpoint_dir, args.network, args.embedding_dim,
                args.image_size, dtype, use_ema=args.use_ema,
                stem=args.stem, head=args.head, quantized=quant, step=step)
            v = prepare(v)
            return v, make_apply(net, v, boot=False), step

        watcher = CheckpointWatcher(service, args.checkpoint_dir, rebuild,
                                    interval=args.watch_interval).start()
        logging.info("watching %s every %.1fs for new checkpoints",
                     args.checkpoint_dir, args.watch_interval)
    return _serve_front_end(args, batcher, [batcher], watcher, device)


def _serve_front_end(args, batcher, all_batchers, watcher, device):
    """Bind the transport, block until SIGTERM/SIGINT, drain, exit.

    ``batcher`` is what the front-end serves (one DynamicBatcher or the
    multi-model ``{name: batcher}`` map); ``all_batchers`` is the flat
    list to close at drain time."""
    import os
    import signal
    import threading

    import numpy as np

    from tf_face_toolbox_tpu_torch.ops import topk
    from tf_face_toolbox_tpu_torch.serving.server import serve

    launches = (topk.cosine_topk.launches, topk.cosine_topk_q.launches)
    gallery = None
    if args.gallery:
        from tf_face_toolbox_tpu_torch.serving.distributed_gallery import (
            DistributedGallery)
        from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

        first = (next(iter(batcher.values())) if isinstance(batcher, dict)
                 else batcher)
        svc = first.service
        dim = svc.embed_batch(np.zeros(
            (1, svc.crop_from, svc.crop_from, 3), np.uint8)).shape[1]
        gkw = dict(dtype=args.gallery_dtype,
                   hbm_limit_gb=args.gallery_hbm_gb)
        if args.gallery_shards:
            store_cls = DistributedGallery
            gkw["devices"] = _shard_devices(args)
            logging.info("gallery sharded over %d devices",
                         len(gkw["devices"]))
        else:
            store_cls = DeviceGallery
            gkw.update(overflow=args.gallery_overflow, device=device)
        if os.path.exists(args.gallery):
            gallery = store_cls.load(args.gallery, **gkw)
            if gallery.dim != dim:
                raise SystemExit(
                    f"--gallery={args.gallery} holds {gallery.dim}-d "
                    f"embeddings; the served model produces {dim}-d")
            logging.info("gallery loaded: %d enrolled", len(gallery))
        else:
            gallery = store_cls(dim, **gkw)
    if args.transport == "grpc":
        from tf_face_toolbox_tpu_torch.serving.grpc_server import serve_grpc

        server = serve_grpc(batcher, host=args.host, port=args.port,
                            unix_socket=args.unix_socket or None)
        where = (f"unix:{args.unix_socket}" if args.unix_socket else
                 f"grpc://{args.host}:{server.bound_port}")
    else:
        server = serve(batcher, host=args.host, port=args.port,
                       unix_socket=args.unix_socket or None,
                       gallery=gallery,
                       enroll_min_quality=args.enroll_min_quality)
        where = (f"unix:{args.unix_socket}" if args.unix_socket else
                 f"http://{args.host}:{server.server_address[1]}")
    models = (" models=" + ",".join(batcher)
              if isinstance(batcher, dict) else "")
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print(f"serving on {where} (batch={args.max_batch}, "
          f"wait={args.max_wait_ms}ms){models}", flush=True)
    stop.wait()
    # graceful drain for rolling restarts: stop accepting, let running
    # handlers finish against the still-live batcher, then shut it down
    logging.info("draining: no new connections; completing in-flight")
    if watcher is not None:
        watcher.stop()
    if args.transport == "grpc":
        # gRPC's native drain: refuse new RPCs, finish in-flight ones
        if not server.stop(grace=30).wait(timeout=35):
            logging.warning("drain timeout: abandoning stuck RPCs")
    else:
        server.shutdown()       # stop the accept loop
        # server_close does not join the handler threads; wait_idle
        # tracks in-flight requests, against the still-live batcher so
        # they complete normally
        if not server.wait_idle(timeout=30):
            logging.warning("drain timeout: abandoning stuck handlers")
        server.server_close()
    for b in all_batchers:
        b.close()
    if gallery is not None:
        n = gallery.save(args.gallery)
        logging.info("gallery snapshot: %d enrolled -> %s", n, args.gallery)
    print(f"kernel launches: topk={topk.cosine_topk.launches - launches[0]} "
          f"topk_q={topk.cosine_topk_q.launches - launches[1]}", flush=True)
    print("drained; bye", flush=True)


if __name__ == "__main__":
    main()
