"""Merge FaceShards: the parallel-packing workflow's second half.

Counterpart of ``tf_face_toolbox_tpu/cli/merge.py``. Pack chunks of a
large dataset concurrently (one ``cli.pack`` per chunk), then combine
them into the one shard the training pipeline maps:

    python -m tf_face_toolbox_tpu_torch.cli.merge \\
        --inputs=chunk0.faceshard,chunk1.faceshard,... \\
        --output=full.faceshard [--relabel]

``--relabel`` offsets each chunk's labels past the previous chunk's
largest, so per-chunk identity numbering (every chunk starting at 0)
stays disjoint. Streaming, O(1) memory.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--inputs", required=True,
                   help="comma-separated input .faceshard paths, in order")
    p.add_argument("--output", required=True, help="merged .faceshard path")
    p.add_argument("--relabel", dest="relabel", action="store_true",
                   default=False,
                   help="offset each input's labels past the previous "
                        "input's max (disjoint per-chunk id spaces)")
    p.add_argument("--norelabel", dest="relabel", action="store_false")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tf_face_toolbox_tpu_torch.data.format import merge_shards

    inputs = [p for p in args.inputs.split(",") if p]
    n = merge_shards(inputs, args.output, relabel=args.relabel)
    print(f"merged {len(inputs)} shards ({n} records) into {args.output}")


if __name__ == "__main__":
    main()
