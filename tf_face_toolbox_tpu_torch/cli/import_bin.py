"""Import an InsightFace verification .bin (lfw/cfp_fp/agedb_30).

Counterpart of ``tf_face_toolbox_tpu/cli/import_bin.py``. Writes a
FaceShard plus an index-format pairs file, so the extract -> eval chain
runs unchanged:

    python -m tf_face_toolbox_tpu_torch.cli.import_bin \\
        --bin=/data/faces_emore/lfw.bin --output=/tmp/lfw.faceshard
    python -m tf_face_toolbox_tpu_torch.cli.extract \\
        --checkpoint_dir=... --data=/tmp/lfw.faceshard \\
        --output=/tmp/lfw_emb.npy ...
    python -m tf_face_toolbox_tpu_torch.cli.eval_lfw \\
        --embeddings=/tmp/lfw_emb.npy --pairs=/tmp/lfw.faceshard.pairs.txt
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bin", required=True,
                   help="InsightFace verification .bin (pickled "
                        "(bins, issame_list))")
    p.add_argument("--output", required=True, help="output .faceshard path")
    p.add_argument("--pairs", default="",
                   help="output pairs file (default <output>.pairs.txt)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from tf_face_toolbox_tpu_torch.data.binpairs import (
        convert_bin_to_faceshard)

    n, pairs, transcoded = convert_bin_to_faceshard(
        args.bin, args.output, pairs_path=args.pairs or None,
        log=logging.info)
    note = f" ({transcoded} transcoded to JPEG)" if transcoded else ""
    print(f"imported {n} images / {pairs} pairs into "
          f"{args.output}{note}")


if __name__ == "__main__":
    main()
