"""Cluster embeddings for dataset cleaning / identity dedup.

Counterpart of ``tf_face_toolbox_tpu/cli/cluster.py``:

    python -m tf_face_toolbox_tpu_torch.cli.cluster \
        --embeddings=emb.npy --output=labels.npy \
        --threshold=0.6 --k=10 [--min_size=2] [--names=list.txt]

The kNN graph runs on the device through the gallery's top-k kernels
(``ops/clustering.py``), the connected components on the host. Writes
an int64 label per row (-1 = noise below --min_size) and prints a JSON
report. With --names (the pack list file the embeddings were extracted
from), also writes ``<output>.clusters.txt``: one line per cluster,
``<cluster_id> <path> <path> ...``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--embeddings", default="",
                   help="input .npy (N, D), L2-normalized (cli.extract output)")
    p.add_argument("--output", default="", help="output .npy of int64 labels (N,)")
    p.add_argument("--threshold", type=float, default=0.6,
                   help="cosine linkage threshold (calibrate on a labeled "
                        "split; 0.5-0.7 typical for margin-softmax nets)")
    p.add_argument("--k", type=int, default=10,
                   help="neighbors per row in the kNN graph")
    p.add_argument("--min_size", type=int, default=1,
                   help="components smaller than this become -1 (noise)")
    p.add_argument("--batch", type=int, default=2048,
                   help="probe batch for the kNN search")
    p.add_argument("--store_dtype", default="bfloat16",
                   choices=["float32", "bfloat16", "int8"],
                   help="device store dtype for the kNN search")
    p.add_argument("--hbm_gb", type=float, default=8.0,
                   help="device-store budget; larger sets stream exactly")
    p.add_argument("--names", default="",
                   help="optional pack list file (path label per line) "
                        "aligned with the embedding rows; enables "
                        "<output>.clusters.txt")
    p.add_argument("--device", default="cuda",
                   help="torch device of the store (cuda runs the kernels)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if not args.embeddings or not args.output:
        raise SystemExit("--embeddings and --output are required")
    from tf_face_toolbox_tpu_torch.ops.clustering import cluster_embeddings

    emb = np.load(args.embeddings)
    labels, n_clusters = cluster_embeddings(
        emb, threshold=args.threshold, k=args.k, batch=args.batch,
        store_dtype=args.store_dtype, hbm_limit_gb=args.hbm_gb,
        min_size=args.min_size, device=args.device)
    np.save(args.output, labels)

    sizes = np.bincount(labels[labels >= 0]) if n_clusters else \
        np.zeros(0, np.int64)
    report = {
        "rows": int(emb.shape[0]),
        "clusters": int(n_clusters),
        "noise_rows": int((labels == -1).sum()),
        "largest": int(sizes.max()) if sizes.size else 0,
        "singletons": int((sizes == 1).sum()) if sizes.size else 0,
        "threshold": args.threshold,
        "k": args.k,
    }
    print(json.dumps(report))

    if args.names:
        with open(args.names) as f:
            paths = [ln.split()[0] for ln in f if ln.strip()]
        if len(paths) != emb.shape[0]:
            raise SystemExit(
                f"--names has {len(paths)} rows, embeddings have "
                f"{emb.shape[0]}")
        # one stable argsort + boundary split: O(N log N)
        order = np.argsort(labels, kind="stable")
        order = order[labels[order] >= 0]
        bounds = np.flatnonzero(np.diff(labels[order])) + 1
        with open(args.output + ".clusters.txt", "w") as f:
            for grp in (np.split(order, bounds) if order.size else ()):
                f.write(f"{labels[grp[0]]} "
                        + " ".join(paths[i] for i in grp) + "\n")


if __name__ == "__main__":
    main()
