"""Feature-extraction CLI: weights + FaceShard -> embeddings file.

Counterpart of ``tf_face_toolbox_tpu/cli/extract.py``: stream faces,
write flip-averaged L2-normalized embeddings to disk. Weights come from
a port train directory (``--checkpoint_dir``, its latest step;
``--use_ema`` for the EMA set), the JAX package's ``.npz`` hand-off
(``--variables_npz``) or a deployment bundle of either package
(``--bundle``, which also sets the network and input flags); with none,
the network gets seeded random weights. Prints the kernel launches it made. ``--chunk_rows`` writes a
resumable ``.npy`` in chunks (a crashed run re-run with the same flags
recomputes at most one chunk); ``--output_quality`` also writes each
face's feature-norm quality; ``--data_parallel`` splits each batch over
torchrun's ranks (through the module), and rank 0 writes.
``--quant_mode dynamic|static`` (``--quantized``: dynamic) serves W8A8
int8 convs through the module (``models/layers.py``; static calibrates
on the first ``--calibrate_batches`` batches of ``--data``); an int8
bundle serves the mode it bakes in.

    python -m tf_face_toolbox_tpu_torch.cli.extract \\
        --variables_npz=/tmp/r50.npz --data=/data/lfw.faceshard \\
        --output=/tmp/lfw_embeddings.npy --stem=imagenet --engine=fused

    python -m tf_face_toolbox_tpu_torch.cli.extract --checkpoint_dir=/tmp/run \\
        --data=/data/lfw.faceshard --output=/tmp/lfw.npy --engine=fused

    # a corpus, resumable; two jobs fill one file from disjoint ranges
    python -m tf_face_toolbox_tpu_torch.cli.extract --checkpoint_dir=/tmp/run \\
        --data=/data/corpus.faceshard --output=/tmp/corpus.npy \\
        --chunk_rows=65536 --rows=0:1000000

    # on every GPU of a host
    torchrun --standalone --nproc_per_node 8 -m \\
        tf_face_toolbox_tpu_torch.cli.extract --data_parallel \\
        --checkpoint_dir=/tmp/run --data=/data/lfw.faceshard \\
        --output=/tmp/lfw.npy --output_quality=/tmp/lfw_quality.npy
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint_dir", default="",
                   help="port train dir: serve its latest checkpoint")
    p.add_argument("--use_ema", dest="use_ema", action="store_true",
                   default=False,
                   help="with --checkpoint_dir: serve the EMA weights")
    p.add_argument("--nouse_ema", dest="use_ema", action="store_false")
    p.add_argument("--variables_npz", default="",
                   help="serve from a .npz variables file in the JAX key "
                        "space ('' = random init, seed 0)")
    p.add_argument("--bundle", default="",
                   help="extract with a one-file deployment bundle "
                        "(cli.export, either package's); its config record "
                        "supplies network/stem/head/embedding_dim/"
                        "image_size/crop_from/input_norm - those flags are "
                        "ignored")
    p.add_argument("--data", required=True, help="FaceShard of eval faces")
    p.add_argument("--output", required=True,
                   help="output path; format by extension: .npy (default), "
                        ".npz, .mat (MATLAB v5), .bin (TFFB raw f32)")
    p.add_argument("--network", default="resnet_v1_50", help="backbone name")
    p.add_argument("--stem", default="face",
                   choices=["face", "imagenet", "space2depth"],
                   help="backbone stem (must match the weights; "
                        "space2depth is a ResNet-family option)")
    p.add_argument("--head", default="gap", choices=["gap", "flatten"],
                   help="embedding head variant (must match the weights)")
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--image_size", type=int, default=112,
                   help="eval crop size")
    p.add_argument("--crop_from", type=int, default=0,
                   help="resize sources to this size before the center "
                        "crop (0 = image_size + 8, the training scale)")
    p.add_argument("--batch", type=int, default=256,
                   help="extraction batch size (faces)")
    p.add_argument("--quantized", dest="quantized", action="store_true",
                   default=False,
                   help="serve with dynamic W8A8 int8 convs (alias for "
                        "--quant_mode=dynamic)")
    p.add_argument("--noquantized", dest="quantized", action="store_false")
    p.add_argument("--quant_mode", default="none",
                   choices=["none", "dynamic", "static"],
                   help="int8 serving: dynamic = per-sample scales; static "
                        "= frozen scales calibrated on the first "
                        "--calibrate_batches batches (the int8 residual "
                        "carry)")
    p.add_argument("--calibrate_batches", type=int, default=4,
                   help="calibration batches for --quant_mode=static")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "module", "folded", "fused"],
                   help="auto = folded where the engine serves the "
                        "net (ResNet, SE-ResNet) in fp, else module; "
                        "module = "
                        "the nn.Module forward; folded = BN folded into "
                        "conv weights and biases; fused = folded + "
                        "stride-1 bottleneck blocks in the fused-block "
                        "kernel")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python", "native_dct",
                            "dct_domain"],
                   help="host decode: native = C++ pool, python = PIL "
                        "threads, auto = native when it loads; native_dct "
                        "= entropy decode only, the device finishes the "
                        "JPEG (a cli.pack --recode_size shard of crop_from "
                        "geometry); dct_domain = zero-decode coefficients "
                        "straight into a stem=dct net (a shard recoded at "
                        "image_size exactly)")
    p.add_argument("--input_norm", default="per_image",
                   choices=["per_image", "fixed"],
                   help="per_image = tf.image standardization; fixed = "
                        "(x-127.5)/127.5 (InsightFace-trained weights)")
    p.add_argument("--rows", default="",
                   help="extract only records [lo:hi) of the shard; with "
                        "--chunk_rows the rows land at their true offsets "
                        "in a full-length output")
    p.add_argument("--chunk_rows", type=int, default=0,
                   help="resumable mode (.npy only): write the embeddings "
                        "into a disk-backed .npy in chunks of this many "
                        "rows, recording progress in a <output>[.rows<lo>-"
                        "<hi>].progress.json sidecar; a re-run skips the "
                        "finished chunks (0 = one-shot write)")
    p.add_argument("--output_quality", default="",
                   help="also write per-face quality scores (.npy, (N,)): "
                        "the pre-normalization feature magnitude; one-shot "
                        "mode only")
    p.add_argument("--data_parallel", dest="data_parallel",
                   action="store_true", default=False,
                   help="split each batch over torchrun's ranks (NCCL on "
                        "the card, gloo on the CPU; one rank without "
                        "torchrun), serving through the module; rank 0 "
                        "writes")
    p.add_argument("--nodata_parallel", dest="data_parallel",
                   action="store_false")
    p.add_argument("--bf16", dest="bf16", action="store_true", default=True,
                   help="bfloat16 compute (default)")
    p.add_argument("--nobf16", dest="bf16", action="store_false",
                   help="float32 compute")
    p.add_argument("--output_dtype", default="float32",
                   choices=["float32", "float16"],
                   help="storage dtype of the embeddings (not for .bin)")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def _weights_fingerprint(flat: dict, config_tag: str) -> str:
    """The resume sidecar's model identity: ``config_tag`` and a digest of
    the served variables (each flat JAX-key leaf's key, shape, dtype and
    f64 sum), so that resuming a chunked extraction under other weights
    recomputes instead of mixing two models in one file. The port's own
    digest: a sidecar the JAX CLI wrote reads as another fingerprint."""
    import hashlib

    import numpy as np

    leaves = []
    for key in sorted(flat):
        arr = np.asarray(flat[key])
        leaves.append(f"{key}:{arr.shape}:{arr.dtype}:"
                      f"{float(arr.astype(np.float64).sum()):.6e}")
    digest = hashlib.sha1("|".join(leaves).encode()).hexdigest()[:16]
    return f"{config_tag}/w={digest}"


_INT8_ENGINE = ("--engine folded/fused serves fp; int8 uses --engine module "
                "(models/layers.py)")


def _quant(args):
    """The int8 mode the flags ask for: False, "dynamic" or "static"."""
    if args.quant_mode != "none":
        return args.quant_mode
    return "dynamic" if args.quantized else False


def _refuse(args) -> None:
    """The flag combinations the JAX CLI refuses, with its messages."""
    if args.bundle and _quant(args):
        raise SystemExit("--bundle bakes the quant mode and scales in at "
                         "export time; drop --quant_mode/--quantized")
    if _quant(args) and args.engine in ("folded", "fused"):
        raise SystemExit(_INT8_ENGINE)
    if args.checkpoint_dir and args.variables_npz:
        raise SystemExit("--variables_npz and --checkpoint_dir are exclusive")
    if args.data_parallel and args.engine in ("folded", "fused"):
        raise SystemExit("--data_parallel shards net.apply over the device "
                         "mesh; --engine folded/fused is single-device - "
                         "drop one of the two")
    if args.output_dtype == "float16" and args.chunk_rows:
        raise SystemExit("--output_dtype=float16 is not available with "
                         "--chunk_rows (the resumable memmap is f32); cast "
                         "the finished file instead")
    if args.chunk_rows and not args.output.endswith(".npy"):
        raise SystemExit(
            "--chunk_rows writes a disk-backed .npy (the memmap format); "
            f"--output={args.output!r} is not .npy - drop --chunk_rows for "
            ".npz/.mat/.bin one-shot dumps")
    if args.chunk_rows and args.output_quality:
        raise SystemExit("--output_quality is one-shot-mode only (the "
                         "resumable memmap stores embeddings alone); drop "
                         "--chunk_rows")


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    _refuse(args)
    bundle = _read_bundle(args) if args.bundle else None
    if args.network.startswith("densenet") and args.stem == "space2depth":
        raise SystemExit("--stem=space2depth is a resnet-family option; "
                         "densenet supports stem=face|imagenet")
    if args.output_dtype == "float16" and args.output.endswith(".bin"):
        raise SystemExit("--output_dtype=float16 is not available for .bin "
                         "(TFFB is a fixed-f32 format)")
    rows = None
    if args.rows:
        lo, _, hi = args.rows.partition(":")
        try:
            rows = (int(lo), int(hi))
        except ValueError:
            raise SystemExit(f"--rows wants 'lo:hi', got {args.rows!r}")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run on the host")
    mesh = None
    if args.data_parallel:
        import os

        from tf_face_toolbox_tpu_torch.parallel.mesh import (
            create_topology, init_distributed)

        mesh = (init_distributed(args.device) if "WORLD_SIZE" in os.environ
                else create_topology(1, device=device))
        device = mesh.device
        if not mesh.is_main:
            logging.getLogger().setLevel(logging.WARNING)
        logging.info("data-parallel extraction over %d ranks", mesh.world)
    try:
        _extract(args, rows, device, mesh, bundle)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _read_bundle(args) -> dict:
    """``--bundle``'s variables (flat, JAX key space); its meta record
    replaces the network and input flags on ``args``, as the JAX CLI
    takes them from the bundle."""
    if args.checkpoint_dir or args.variables_npz:
        raise SystemExit("--bundle is self-contained; drop "
                         "--checkpoint_dir/--variables_npz")
    from tf_face_toolbox_tpu_torch.interop.port import flatten_variables
    from tf_face_toolbox_tpu_torch.serving.bundle import read_bundle

    variables, meta = read_bundle(args.bundle)
    if meta["quant_mode"] != "none":
        if args.engine in ("folded", "fused"):
            raise SystemExit(_INT8_ENGINE)
        args.quant_mode = meta["quant_mode"]
    args.network = meta["network"]
    args.embedding_dim = int(meta["embedding_dim"])
    args.stem = meta.get("stem") or args.stem
    args.head = meta.get("head_variant") or args.head
    args.image_size = int(meta["image_size"])
    args.crop_from = int(meta.get("crop_from", 0))
    args.input_norm = meta["input_norm"]
    logging.info("bundle: %s step=%s quant=%s norm=%s", meta["network"],
                 meta.get("step"), meta["quant_mode"], args.input_norm)
    return flatten_variables(variables)


def _extract(args, rows, device, mesh, bundle) -> None:
    import numpy as np
    import torch

    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import (
        extract_shard, extract_shard_to_npy, make_extract_fn)
    from tf_face_toolbox_tpu_torch.interop.port import (
        flatten_variables, load_jax_variables, load_variables_npz)
    from tf_face_toolbox_tpu_torch.io import save_embeddings
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.pretrained import load_variables
    from tf_face_toolbox_tpu_torch.serving import fused_block, make_serving_apply

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    quant = _quant(args)
    net_kw = dict(embedding_dim=args.embedding_dim, dtype=dtype,
                  stem=args.stem, head_variant=args.head,
                  input_size=args.image_size)
    if bundle is not None:
        net = create_network(args.network, quantized=quant, **net_kw)
        flat = bundle
    elif args.checkpoint_dir:
        net, flat = load_variables(
            args.checkpoint_dir, args.network, args.embedding_dim,
            args.image_size, dtype, use_ema=args.use_ema, stem=args.stem,
            head=args.head, quantized=quant)
    else:
        net = create_network(args.network, quantized=quant, **net_kw)
        if args.variables_npz:
            flat = flatten_variables(load_variables_npz(args.variables_npz))
            logging.info("serving variables from %s", args.variables_npz)
        else:
            flat = random_variables(net, seed=0)
            logging.info("no --variables_npz: seeded random weights")
    if quant == "static" and bundle is None:
        from tf_face_toolbox_tpu_torch.extract import calibrate_on_shard

        logging.info("calibrating static int8 scales on %d batches",
                     args.calibrate_batches)
        flat = calibrate_on_shard(
            args.network, flat, FaceShardSource(args.data),
            image_size=args.image_size, crop_from=args.crop_from,
            batch=min(args.batch, 128), num_batches=args.calibrate_batches,
            loader=args.loader, norm=args.input_norm, device=device,
            **net_kw)

    apply_fn = None
    if args.engine != "module" and mesh is None and not quant:
        try:
            apply_fn = make_serving_apply(net, flat, device=device,
                                          use_kernels=args.engine == "fused")
        except ValueError as e:
            if args.engine != "auto":
                raise SystemExit(f"--engine {args.engine}: {e}") from e
            # auto: nets outside the engine's scope (grouped convs,
            # DenseNet's concat topology) serve through the module
            logging.info("serving engine not applicable (%s); using the "
                         "module path", e)
    if apply_fn is None:
        # --data_parallel serves through the module, as JAX's net.apply
        apply_fn = load_jax_variables(net, flat).to(device)
    main = mesh is None or mesh.is_main
    quality = bool(args.output_quality)
    extract_fn = make_extract_fn(apply_fn, with_quality=quality, mesh=mesh)
    source = FaceShardSource(args.data)
    before = fused_block.fused_bottleneck_block.launches
    # with this run's kernel 2 launches so far: a killed run's last line
    # still says what it launched
    progress = lambda done, n: logging.info(  # noqa: E731
        "extracted %d / %d (kernel launches: fused_block=%d)", done, n,
        fused_block.fused_bottleneck_block.launches - before)
    if args.chunk_rows:
        tag = (f"{args.network}/{args.stem}/{args.head}/"
               f"dim={args.embedding_dim}/norm={args.input_norm}/q={quant}/"
               f"bf16={args.bf16}")
        emb = extract_shard_to_npy(
            net, flat, source, args.output, image_size=args.image_size,
            crop_from=args.crop_from, batch=args.batch,
            chunk_rows=args.chunk_rows, loader=args.loader,
            norm=args.input_norm, extract_fn=extract_fn, rows=rows,
            fingerprint=_weights_fingerprint(flat, tag), mesh=mesh,
            device=device, progress=progress)
    else:
        emb = extract_shard(
            net, flat, source, image_size=args.image_size,
            crop_from=args.crop_from, batch=args.batch, loader=args.loader,
            norm=args.input_norm, extract_fn=extract_fn, rows=rows,
            with_quality=quality, device=device, progress=progress)
    print("kernel launches: fused_block="
          f"{fused_block.fused_bottleneck_block.launches - before}",
          flush=True)
    if not main:
        return
    if args.chunk_rows:
        lo, hi = rows if rows else (0, emb.shape[0])
        # emb is the full-length memmap: say what this job computed
        print(f"wrote rows [{lo}:{hi}) of the {emb.shape} output "
              f"{args.output}")
        return
    if quality:
        emb, q = emb
        np.save(args.output_quality, q.astype(np.float32))
        print(f"wrote {q.shape} quality scores to {args.output_quality}")
    if args.output_dtype == "float16":
        emb = emb.astype(np.float16)
    save_embeddings(args.output, emb)
    print(f"wrote {emb.shape} {emb.dtype} embeddings to {args.output}")


if __name__ == "__main__":
    main()
