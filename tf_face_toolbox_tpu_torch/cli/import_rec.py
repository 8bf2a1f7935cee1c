"""Import an MXNet/InsightFace .rec face dataset into FaceShard.

Counterpart of ``tf_face_toolbox_tpu/cli/import_rec.py``. The
InsightFace distributions of MS1M/Glint360K/CASIA ship as
``train.rec``/``train.idx``:

    python -m tf_face_toolbox_tpu_torch.cli.import_rec \\
        --rec=/data/faces_emore/train.rec \\
        --output=/data/train.faceshard

Identities are relabeled to dense 0..K-1 (what --num_classes expects);
the original -> dense mapping lands in <output>.labels.json. Pass
--norelabel to keep source ids verbatim.
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rec", required=True,
                   help="train.rec path (the .idx is not needed: records "
                        "are read in order)")
    p.add_argument("--output", required=True, help="output .faceshard path")
    p.add_argument("--relabel", dest="relabel", action="store_true",
                   default=True,
                   help="map identities to dense 0..K-1 in first-seen order "
                        "(mapping written to <output>.labels.json)")
    p.add_argument("--norelabel", dest="relabel", action="store_false")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from tf_face_toolbox_tpu_torch.data.recordio import (
        convert_rec_to_faceshard)

    n, k = convert_rec_to_faceshard(
        args.rec, args.output, relabel=args.relabel,
        log_every=100_000, log=logging.info)
    print(f"imported {n} images / {k} identities into {args.output}")


if __name__ == "__main__":
    main()
