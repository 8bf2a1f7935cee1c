"""Feature-extraction CLI: weights + FaceShard -> embeddings file.

Counterpart of ``tf_face_toolbox_tpu/cli/extract.py``: stream faces,
write flip-averaged L2-normalized embeddings to disk. Weights come from
a port train directory (``--checkpoint_dir``, its latest step;
``--use_ema`` for the EMA set) or the JAX package's ``.npz`` hand-off
(``--variables_npz``); with neither, the network gets seeded random
weights. Prints the kernel launches it made.

    python -m tf_face_toolbox_tpu_torch.cli.extract \\
        --variables_npz=/tmp/r50.npz --data=/data/lfw.faceshard \\
        --output=/tmp/lfw_embeddings.npy --stem=imagenet --engine=fused

    python -m tf_face_toolbox_tpu_torch.cli.extract --checkpoint_dir=/tmp/run \\
        --data=/data/lfw.faceshard --output=/tmp/lfw.npy --engine=fused
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
                   help="one-file deployment bundle (not yet ported)")
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
    p.add_argument("--engine", default="auto",
                   choices=["auto", "module", "folded", "fused"],
                   help="auto = folded where the engine serves the "
                        "net (ResNet, SE-ResNet), else module; module = "
                        "the nn.Module forward; folded = BN folded into "
                        "conv weights and biases; fused = folded + "
                        "stride-1 bottleneck blocks in the fused-block "
                        "kernel")
    p.add_argument("--loader", default="auto",
                   choices=["auto", "native", "python"],
                   help="host decode: native = C++ pool, python = PIL "
                        "threads, auto = native when it loads")
    p.add_argument("--input_norm", default="per_image",
                   choices=["per_image", "fixed"],
                   help="per_image = tf.image standardization; fixed = "
                        "(x-127.5)/127.5 (InsightFace-trained weights)")
    p.add_argument("--rows", default="",
                   help="extract only records [lo:hi) of the shard")
    p.add_argument("--bf16", dest="bf16", action="store_true", default=True,
                   help="bfloat16 compute (default)")
    p.add_argument("--nobf16", dest="bf16", action="store_false",
                   help="float32 compute")
    p.add_argument("--output_dtype", default="float32",
                   choices=["float32", "float16"],
                   help="storage dtype of the embeddings (not for .bin)")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.checkpoint_dir and args.variables_npz:
        raise SystemExit("--variables_npz and --checkpoint_dir are exclusive")
    if args.bundle:
        raise SystemExit("--bundle is not yet ported (ROADMAP.md §1 "
                         "item 16); pass --variables_npz")
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

    import numpy as np
    import torch

    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import extract_shard, make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import (
        flatten_variables, load_jax_variables, load_variables_npz)
    from tf_face_toolbox_tpu_torch.io import save_embeddings
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.pretrained import load_variables
    from tf_face_toolbox_tpu_torch.serving import fused_block, make_serving_apply

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run on the host")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.checkpoint_dir:
        net, flat = load_variables(
            args.checkpoint_dir, args.network, args.embedding_dim,
            args.image_size, dtype, use_ema=args.use_ema, stem=args.stem,
            head=args.head)
    else:
        net = create_network(args.network, embedding_dim=args.embedding_dim,
                             dtype=dtype, stem=args.stem,
                             head_variant=args.head,
                             input_size=args.image_size)
        if args.variables_npz:
            flat = flatten_variables(load_variables_npz(args.variables_npz))
            logging.info("serving variables from %s", args.variables_npz)
        else:
            flat = random_variables(net, seed=0)
            logging.info("no --variables_npz: seeded random weights")

    apply_fn = None
    if args.engine != "module":
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
        apply_fn = load_jax_variables(net, flat).to(device)
    before = fused_block.fused_bottleneck_block.launches
    emb = extract_shard(
        net, flat, FaceShardSource(args.data), image_size=args.image_size,
        crop_from=args.crop_from, batch=args.batch, loader=args.loader,
        norm=args.input_norm, extract_fn=make_extract_fn(apply_fn),
        rows=rows, device=device,
        progress=lambda done, n: logging.info("extracted %d / %d", done, n))
    if args.output_dtype == "float16":
        emb = emb.astype(np.float16)
    save_embeddings(args.output, emb)
    print("kernel launches: fused_block="
          f"{fused_block.fused_bottleneck_block.launches - before}",
          flush=True)
    print(f"wrote {emb.shape} {emb.dtype} embeddings to {args.output}")


if __name__ == "__main__":
    main()
