"""Dataset packer CLI: image list -> FaceShard.

Counterpart of ``tf_face_toolbox_tpu/cli/pack.py``:

    python -m tf_face_toolbox_tpu_torch.cli.pack \\
        --list=/data/casia_list.txt --root=/data/casia \\
        --output=/data/casia.faceshard

``--recode_size`` re-encodes every image to one square 4:4:4 JPEG size
(the same half-pixel resize as the loaders). ``--landmarks`` (align
while packing) needs ``ops/align``, not yet ported: ROADMAP.md §1 item
19.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--list", required=True,
                   help="lines of 'relative/path.jpg label'")
    p.add_argument("--root", default="", help="prefix for relative image paths")
    p.add_argument("--output", required=True, help="output .faceshard path")
    p.add_argument("--recode_size", type=int, default=0,
                   help="re-encode every image to this square size as a "
                        "4:4:4 JPEG (multiple of 8); 0 keeps original bytes")
    p.add_argument("--recode_quality", type=int, default=95,
                   help="JPEG quality when recoding")
    p.add_argument("--landmarks", default="",
                   help="align while packing: file parallel to --list with 10 "
                        "floats per line (not yet ported: item 19)")
    p.add_argument("--align_size", type=int, default=112,
                   help="aligned crop size (multiple of 8)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tf_face_toolbox_tpu_torch.data.format import pack_image_list

    try:
        n = pack_image_list(args.list, args.output, root=args.root,
                            recode_size=args.recode_size,
                            recode_quality=args.recode_quality,
                            landmarks_path=args.landmarks,
                            align_size=args.align_size)
    except NotImplementedError as e:
        raise SystemExit(f"--landmarks: {e}") from e
    print(f"packed {n} records into {args.output}")


if __name__ == "__main__":
    main()
