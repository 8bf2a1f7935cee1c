"""Export a train checkpoint as a one-file deployment bundle.

Counterpart of ``tf_face_toolbox_tpu/cli/export.py``: collapse a port
train dir (or a ``.npz`` of variables in the JAX key space) and its
flags into one artifact the serving side boots from with no other
configuration (``serving/bundle.py``):

    python -m tf_face_toolbox_tpu_torch.cli.export \\
        --checkpoint_dir=/models/run --network=resnet_v1_50 \\
        --use_ema --output=/models/resnet50.bundle.npz

    python -m tf_face_toolbox_tpu_torch.cli.serve   --bundle=/models/resnet50.bundle.npz
    python -m tf_face_toolbox_tpu_torch.cli.extract --bundle=... --data=... --output=...

The bundle is the JAX package's format, so either package boots a
bundle the other wrote. ``--quant_mode`` bakes an int8 serving mode
into the bundle; ``static`` calibrates its frozen scales here, once, on
``--calibrate_data`` (in f32, on ``--device``), so serving hosts need no
calibration shard:

    python -m tf_face_toolbox_tpu_torch.cli.export --checkpoint_dir=/models/run \
        --quant_mode=static --calibrate_data=/data/faces.faceshard \
        --output=/models/resnet50.int8.bundle.npz

Without static calibration nothing here touches a device.
"""

from __future__ import annotations

import argparse
import datetime
import logging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint_dir", default="", help="port train dir")
    p.add_argument("--variables_npz", default="",
                   help="bundle a .npz of variables in the JAX key space "
                        "instead of a checkpoint")
    p.add_argument("--output", required=True, help="bundle path to write (.npz)")
    p.add_argument("--network", default="resnet_v1_50", help="backbone name")
    p.add_argument("--stem", default="face",
                   choices=["face", "imagenet", "space2depth"],
                   help="backbone stem (must match the weights)")
    p.add_argument("--head", default="gap", choices=["gap", "flatten"],
                   help="embedding head")
    p.add_argument("--embedding_dim", type=int, default=512)
    p.add_argument("--image_size", type=int, default=112,
                   help="served input size")
    p.add_argument("--crop_from", type=int, default=0,
                   help="eval source scale (0 = image_size + 8)")
    p.add_argument("--input_norm", default="per_image",
                   choices=["per_image", "fixed"],
                   help="input standardization the model serves with")
    p.add_argument("--use_ema", dest="use_ema", action="store_true",
                   default=False, help="export the EMA weights")
    p.add_argument("--nouse_ema", dest="use_ema", action="store_false")
    p.add_argument("--step", type=int, default=0,
                   help="export a specific retained checkpoint step "
                        "(0 = latest)")
    p.add_argument("--average_last", type=int, default=0,
                   help="average the params of the last N retained "
                        "checkpoints (BN statistics from the newest); "
                        "0/1 = no averaging")
    p.add_argument("--quant_mode", default="none",
                   choices=["none", "dynamic", "static"],
                   help="int8 serving mode baked into the bundle; static "
                        "runs calibration here (needs --calibrate_data)")
    p.add_argument("--calibrate_data", default="",
                   help="FaceShard sampled for static-int8 scales")
    p.add_argument("--calibrate_batches", type=int, default=4,
                   help="calibration batches")
    p.add_argument("--calibrate_batch_size", type=int, default=128,
                   help="calibration batch")
    p.add_argument("--device", default="cuda",
                   help="torch device of the static calibration pass")
    return p.parse_args(argv)


def _averaged_params(args, net_args: tuple, flat: dict, step: int,
                     steps: list) -> tuple[dict, list]:
    """``flat`` with its params replaced by the mean over the last
    ``--average_last`` retained steps at or below ``step`` (f64 sums,
    cast back); BN statistics stay the newest checkpoint's."""
    import numpy as np

    from tf_face_toolbox_tpu_torch.pretrained import load_variables

    averaged = [s for s in steps if s <= step][-args.average_last:]
    if len(averaged) < args.average_last:
        logging.warning("--average_last=%d but only %d retained "
                        "checkpoint(s) at/below step %s; averaging those",
                        args.average_last, len(averaged), step)
    trees = [flat]
    for s in averaged:
        if s != step:
            trees.append(load_variables(args.checkpoint_dir, *net_args,
                                        use_ema=args.use_ema, stem=args.stem,
                                        head=args.head, step=s)[1])
    out = dict(flat)
    for key, value in flat.items():
        if key.startswith("params/"):
            out[key] = np.mean(np.stack([np.asarray(t[key], np.float64)
                                         for t in trees]), axis=0
                               ).astype(np.asarray(value).dtype)
    logging.info("averaged params over steps %s", averaged)
    return out, averaged


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if bool(args.checkpoint_dir) == bool(args.variables_npz):
        raise SystemExit(
            "pass exactly one of --checkpoint_dir / --variables_npz")
    if args.quant_mode == "static" and not args.calibrate_data:
        raise SystemExit("--quant_mode=static needs --calibrate_data")
    if args.variables_npz and (args.step or args.average_last > 1):
        raise SystemExit("--step/--average_last select train-dir "
                         "checkpoints; they don't apply to "
                         "--variables_npz")

    import numpy as np
    import torch

    from tf_face_toolbox_tpu_torch.serving.bundle import write_bundle

    # export math runs in f32: the bundle stores f32 params; the compute
    # dtype is a serving-side choice
    net_args = (args.network, args.embedding_dim, args.image_size,
                torch.float32)
    step = None
    averaged = None
    if args.variables_npz:
        from tf_face_toolbox_tpu_torch.interop.port import (
            flatten_variables, load_variables_npz)
        from tf_face_toolbox_tpu_torch.models import create_network

        net = create_network(args.network, embedding_dim=args.embedding_dim,
                             stem=args.stem, head_variant=args.head,
                             input_size=args.image_size)
        flat = flatten_variables(load_variables_npz(args.variables_npz))
    else:
        from tf_face_toolbox_tpu_torch.pretrained import load_variables
        from tf_face_toolbox_tpu_torch.train.checkpoint import (
            CheckpointManager)

        mgr = CheckpointManager(args.checkpoint_dir)
        step = args.step or mgr.latest_step()
        net, flat = load_variables(args.checkpoint_dir, *net_args,
                                   use_ema=args.use_ema, stem=args.stem,
                                   head=args.head, step=step)
        if args.average_last > 1:
            flat, averaged = _averaged_params(args, net_args, flat, step,
                                              mgr.all_steps())

    if args.quant_mode == "static":
        from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
        from tf_face_toolbox_tpu_torch.extract import calibrate_on_shard

        if args.device.startswith("cuda") and not torch.cuda.is_available():
            raise SystemExit("--device cuda, but torch sees no CUDA device; "
                             "pass --device cpu to calibrate on the host")
        logging.info("calibrating static-int8 scales on %d batches of %s",
                     args.calibrate_batches, args.calibrate_data)
        flat = calibrate_on_shard(
            args.network, flat, FaceShardSource(args.calibrate_data),
            image_size=args.image_size, crop_from=args.crop_from,
            batch=args.calibrate_batch_size,
            num_batches=args.calibrate_batches, norm=args.input_norm,
            device=args.device, embedding_dim=args.embedding_dim,
            dtype=torch.float32, stem=getattr(net, "stem", args.stem),
            head_variant=getattr(net, "head_variant", args.head),
            input_size=args.image_size)

    meta = {
        "network": args.network,
        "embedding_dim": args.embedding_dim,
        # the resolved module attributes, so loading rebuilds exactly
        # this net
        "stem": getattr(net, "stem", None),
        "head_variant": getattr(net, "head_variant", None),
        "image_size": args.image_size,
        "crop_from": args.crop_from,
        "input_norm": args.input_norm,
        "quant_mode": args.quant_mode,
        "use_ema": args.use_ema,
        "step": None if step is None else int(step),
        "averaged_steps": averaged,
        "created": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
    }
    write_bundle(args.output, flat, meta)
    n_params = sum(int(np.asarray(v).size) for k, v in flat.items()
                   if k.startswith("params/"))
    print(f"exported {args.network} (step={meta['step']}, "
          f"quant={args.quant_mode}, ema={args.use_ema}, "
          f"{n_params / 1e6:.2f}M params) to {args.output}")


if __name__ == "__main__":
    main()
