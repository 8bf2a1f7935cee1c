"""Import a TF1 (``tf.train.Saver``) checkpoint, the reference's native
training output, into a portable .npz served by ``cli.extract
--variables_npz``.

Counterpart of ``tf_face_toolbox_tpu/cli/import_tf1.py``:

    python -m tf_face_toolbox_tpu_torch.cli.import_tf1 \\
        --checkpoint=/models/face_r50.ckpt-90000 \\
        --output=/models/r50.npz --network=resnet_v1_50 --stem=face

Variable names are mapped mechanically from the network's keys by
``interop.tf1.slim_name_map`` (slim-era scoping); repo-specific scope
names are handled with ``--scope`` / ``--head_scope`` and, for
point-wise quirks, ``--name_map_json`` ({key: tf1_name}).
``--use_ema`` prefers each parameter's ExponentialMovingAverage shadow,
the weights the era's extract scripts served. The template is the
port's own network (``create_network``, ``interop.port.jax_leaves``)
at its training init: under ``--skip_missing`` the leaves the
checkpoint lacks keep those init values. Needs TensorFlow on the host
(imported lazily); touches no device.
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="TF1 checkpoint prefix (e.g. model.ckpt-90000)")
    p.add_argument("--output", required=True, help="output .npz variables path")
    p.add_argument("--network", default="resnet_v1_50", help="backbone name")
    p.add_argument("--stem", default="face",
                   choices=["face", "imagenet", "space2depth"],
                   help="backbone stem matching the checkpoint")
    p.add_argument("--head", default="gap", choices=["gap", "flatten"],
                   help="embedding head variant")
    p.add_argument("--embedding_dim", type=int, default=512,
                   help="embedding size")
    p.add_argument("--image_size", type=int, default=112,
                   help="input size for shape checks")
    p.add_argument("--scope", default="",
                   help="outermost variable scope (default: the network "
                        "name, slim convention)")
    p.add_argument("--head_scope", default="embedding",
                   help="embedding layer's variable scope upstream")
    p.add_argument("--name_map_json", default="",
                   help="JSON file of {key: tf1_name} overrides")
    p.add_argument("--use_ema", dest="use_ema", action="store_true",
                   default=False,
                   help="prefer <var>/ExponentialMovingAverage shadows")
    p.add_argument("--nouse_ema", dest="use_ema", action="store_false")
    p.add_argument("--skip_missing", dest="skip_missing", action="store_true",
                   default=False,
                   help="keep init values for unmatched leaves (prints them)")
    p.add_argument("--noskip_missing", dest="skip_missing",
                   action="store_false")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tf_face_toolbox_tpu_torch.interop.port import (
        jax_variables, save_variables_npz)
    from tf_face_toolbox_tpu_torch.interop.tf1 import (
        import_tf1_checkpoint, network_stage_sizes, slim_name_map)
    from tf_face_toolbox_tpu_torch.models import create_network, init_parameters

    net = create_network(args.network, embedding_dim=args.embedding_dim,
                         stem=args.stem, head_variant=args.head,
                         input_size=args.image_size)
    template = jax_variables(init_parameters(net, seed=0))
    overrides = None
    if args.name_map_json:
        with open(args.name_map_json) as f:
            overrides = json.load(f)
    name_map = slim_name_map(
        template, stage_sizes=network_stage_sizes(args.network),
        scope=args.scope or args.network,
        head_scope=args.head_scope, overrides=overrides)
    variables, report = import_tf1_checkpoint(
        args.checkpoint, template, name_map,
        use_ema=args.use_ema, skip_missing=args.skip_missing)
    save_variables_npz(args.output, variables)
    print(f"imported {report['imported']} variables "
          f"({report['ema_used']} from EMA shadows) into {args.output}")
    for key in ("missing", "unused"):
        if report[key]:
            print(f"{key} ({len(report[key])}): "
                  + ", ".join(report[key][:8])
                  + (" ..." if len(report[key]) > 8 else ""))


if __name__ == "__main__":
    main()
