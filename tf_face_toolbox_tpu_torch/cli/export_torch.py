"""Export a trained iresnet checkpoint as a PyTorch ``state_dict``.

Counterpart of ``tf_face_toolbox_tpu/cli/export_torch.py``, the reverse
of ``cli.import_torch``: a model trained (or fine-tuned) here is handed
back to the InsightFace/arcface_torch ecosystem (torch-serving fleets,
ONNX exporters, research forks) as the ``.pth`` state_dict layout those
tools consume (interop/torch_iresnet.py documents the layouts):

    python -m tf_face_toolbox_tpu_torch.cli.export_torch \\
        --checkpoint_dir=/models/run --network=iresnet_50 \\
        --use_ema --output=/models/ir50.pth

``--checkpoint_dir`` reads the port's own train checkpoints
(train/checkpoint.py), as ``cli.extract`` does; ``--variables_npz``
exports a ``.npz`` in the JAX key space (``cli.import_*``). Models
trained with the default per-image standardization must be fed the same
normalization on the torch side; fine-tunes of imported checkpoints
(``--input_norm=fixed``) drop into InsightFace pipelines unchanged
((x − 127.5) / 127.5). The tool prints which applies. Host only.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint_dir", default="", help="port train dir")
    p.add_argument("--variables_npz", default="",
                   help="export an .npz variable dump (cli.import_* or "
                        "interop.port.save_variables_npz) instead of a "
                        "checkpoint")
    p.add_argument("--output", required=True, help="output .pt/.pth path")
    p.add_argument("--network", default="iresnet_50",
                   help="iresnet registry name (sets the block layout)")
    p.add_argument("--embedding_dim", type=int, default=512,
                   help="embedding size")
    p.add_argument("--image_size", type=int, default=112,
                   help="input size the checkpoint's network was built at")
    p.add_argument("--use_ema", dest="use_ema", action="store_true",
                   default=False, help="export the EMA weights")
    p.add_argument("--nouse_ema", dest="use_ema", action="store_false")
    p.add_argument("--step", type=int, default=0,
                   help="export a specific retained checkpoint step "
                        "(0 = latest)")
    p.add_argument("--input_norm", default="per_image",
                   choices=["per_image", "fixed"],
                   help="normalization the model was trained with (recorded "
                        "in the hand-off note; does not change the weights)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import numpy as np
    import torch

    from tf_face_toolbox_tpu_torch.interop.torch_iresnet import (
        variables_to_iresnet_state_dict)
    from tf_face_toolbox_tpu_torch.models import _REGISTRY

    if not args.network.startswith("iresnet"):
        raise SystemExit(
            "cli.export_torch maps the iresnet family (the only "
            "architecture with a torch-ecosystem state_dict contract); "
            f"--network={args.network} has no torch key layout")
    if bool(args.checkpoint_dir) == bool(args.variables_npz):
        raise SystemExit(
            "pass exactly one of --checkpoint_dir / --variables_npz")
    if args.network not in _REGISTRY:
        have = sorted(k for k in _REGISTRY if k.startswith("iresnet"))
        raise SystemExit(f"unknown network {args.network!r}; "
                         f"iresnet registry names: {have}")
    pinned = _REGISTRY[args.network][1]

    if args.variables_npz:
        if args.step or args.use_ema:
            raise SystemExit("--step/--use_ema select train-dir "
                             "checkpoints; they don't apply to "
                             "--variables_npz")
        from tf_face_toolbox_tpu_torch.interop.port import load_variables_npz
        variables = load_variables_npz(args.variables_npz)
        step = None
    else:
        from tf_face_toolbox_tpu_torch.interop.port import unflatten_variables
        from tf_face_toolbox_tpu_torch.pretrained import load_variables
        from tf_face_toolbox_tpu_torch.train.checkpoint import (
            CheckpointManager)

        step = args.step or CheckpointManager(
            args.checkpoint_dir).latest_step()
        _, flat = load_variables(
            args.checkpoint_dir, args.network, args.embedding_dim,
            args.image_size, torch.float32, use_ema=args.use_ema,
            head="flatten", step=step)
        variables = unflatten_variables(flat)

    sd = variables_to_iresnet_state_dict(
        variables, stage_sizes=tuple(pinned["stage_sizes"]))

    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, args.output)
    n = sum(int(np.asarray(v).size) for v in sd.values())
    dim = sd["fc.bias"].shape[0]
    norm_note = ("(x - 127.5) / 127.5" if args.input_norm == "fixed"
                 else "per-image standardization (mean/std per face, "
                      "rsqrt(N) floor)")
    print(f"exported {n:,} weights ({dim}-d embedding"
          f"{'' if step is None else f', step={step}'}"
          f"{', EMA' if args.use_ema else ''}) to {args.output}; "
          f"feed the torch side {norm_note}")


if __name__ == "__main__":
    main()
