"""Import a PyTorch iresnet checkpoint (InsightFace/arcface_torch-style
``state_dict``) into a portable .npz served by ``cli.extract
--variables_npz`` / ``cli.serve --variables_npz``.

Counterpart of ``tf_face_toolbox_tpu/cli/import_torch.py``:

    python -m tf_face_toolbox_tpu_torch.cli.import_torch \\
        --pt=/models/ms1mv3_arcface_r50.pth \\
        --output=/models/ir50.npz --network=iresnet_50

Serve the result with the fixed InsightFace normalization
(``--input_norm=fixed``); see interop/torch_iresnet.py. Host only: it
touches no device.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pt", required=True, help=".pt/.pth state_dict checkpoint")
    p.add_argument("--output", required=True, help="output .npz variables path")
    p.add_argument("--network", default="iresnet_50",
                   help="iresnet registry name (sets the block layout)")
    p.add_argument("--image_size", type=int, default=112,
                   help="input size for the shape check")
    p.add_argument("--strict", dest="strict", action="store_true",
                   default=True,
                   help="fail on unconsumed state_dict entries (the default)")
    p.add_argument("--nostrict", dest="strict", action="store_false",
                   help="ignore unconsumed entries (e.g. a bundled "
                        "classifier head)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import numpy as np

    from tf_face_toolbox_tpu_torch.interop.port import (
        flatten_variables, jax_leaves, jax_shape, save_variables_npz)
    from tf_face_toolbox_tpu_torch.interop.torch_iresnet import (
        iresnet_state_dict_to_variables, load_torch_state_dict)
    from tf_face_toolbox_tpu_torch.models import _REGISTRY, create_network

    if not args.network.startswith("iresnet"):
        raise SystemExit("cli.import_torch maps the iresnet family; for "
                         "TF1/Keras sources use import_tf1/import_keras")
    if args.network not in _REGISTRY:
        raise SystemExit(f"unknown network {args.network!r}")
    pinned = _REGISTRY[args.network][1]
    sd = load_torch_state_dict(args.pt)
    variables = iresnet_state_dict_to_variables(
        sd, stage_sizes=tuple(pinned["stage_sizes"]), strict=args.strict)

    # Shape-check against the target net: every key of the imported
    # tree must exist there with the same shape, so a half-matching
    # checkpoint fails HERE, not at serve time. The embedding dim is
    # read off the checkpoint itself.
    dim = variables["params"]["fc"]["bias"].shape[0]
    net = create_network(args.network, embedding_dim=dim,
                         input_size=args.image_size)
    flat_ref = {key: jax_shape(t, kind) for key, t, kind in jax_leaves(net)}
    flat = flatten_variables(variables)
    flat_imp = {k: tuple(np.shape(v)) for k, v in flat.items()}
    if flat_ref != flat_imp:
        missing = sorted(set(flat_ref) - set(flat_imp))[:4]
        extra = sorted(set(flat_imp) - set(flat_ref))[:4]
        shapes = sorted(k for k in flat_ref.keys() & flat_imp.keys()
                        if flat_ref[k] != flat_imp[k])[:4]
        raise SystemExit(
            f"imported tree does not match {args.network}: "
            f"missing={missing} extra={extra} shape-mismatch={shapes}")

    save_variables_npz(args.output, variables)
    n = sum(np.asarray(v).size for v in flat.values())
    print(f"imported {n:,} weights ({dim}-d embedding) from {args.pt} "
          f"to {args.output}; serve with --network={args.network} "
          f"--input_norm=fixed")


if __name__ == "__main__":
    main()
