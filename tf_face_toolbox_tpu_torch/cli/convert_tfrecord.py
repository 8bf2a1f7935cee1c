"""Migrate TFRecord face datasets (the reference's format) to FaceShard.

Counterpart of ``tf_face_toolbox_tpu/cli/convert_tfrecord.py``:

    python -m tf_face_toolbox_tpu_torch.cli.convert_tfrecord \\
        --tfrecords=/data/train-00000,/data/train-00001 \\
        --output=/data/train.faceshard \\
        --image_key=image/encoded --label_key=image/label

Both CRCs of every record are checked; a corrupt file is refused.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tfrecords", required=True,
                   help="comma-separated TFRecord (or .array_record) paths")
    p.add_argument("--output", required=True, help="output .faceshard path")
    p.add_argument("--image_key", default="image/encoded",
                   help="Example feature holding the encoded image bytes")
    p.add_argument("--label_key", default="image/label",
                   help="Example feature holding the int identity label")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tf_face_toolbox_tpu_torch.data.tfrecord import (
        convert_tfrecords_to_faceshard)

    n = convert_tfrecords_to_faceshard(
        [p for p in args.tfrecords.split(",") if p], args.output,
        image_key=args.image_key, label_key=args.label_key)
    print(f"converted {n} records into {args.output}")


if __name__ == "__main__":
    main()
