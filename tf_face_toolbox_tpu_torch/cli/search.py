"""Open-set 1:N gallery search: each probe's top-k gallery matches.

Counterpart of ``tf_face_toolbox_tpu/cli/search.py``. Given gallery
and probe embeddings (both from ``cli.extract``), writes each probe's
top-k gallery rows with cosine scores, optionally mapped to identity
labels and thresholded (scores below ``--threshold`` become identity
-1, "unknown"). One f32 matrix product and a top-k per probe batch on
the device; ties go to the smallest gallery row. ``--data_parallel``
splits the gallery's rows over the devices
(``ops.verification.sharded_top_k_matches``).

    python -m tf_face_toolbox_tpu_torch.cli.search \
        --gallery=gal.npy --gallery_list=gal_list.txt \
        --probe=probe.npy --k=5 --threshold=0.3 \
        --output=matches.npz

Output .npz: ``indices`` (P, k) int32 gallery rows, ``scores`` (P, k)
f32 descending, and with ``--gallery_list`` ``labels`` (P, k) int32
identities with the threshold applied.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gallery", required=True, help="gallery embeddings file")
    p.add_argument("--probe", required=True, help="probe embeddings file")
    p.add_argument("--gallery_list", default="",
                   help="pack list file with gallery labels (optional: adds "
                        "a thresholded identity matrix to the output)")
    p.add_argument("--k", type=int, default=5, help="matches per probe")
    p.add_argument("--threshold", type=float, default=0.0,
                   help="open-set floor: matches scoring below this become "
                        "identity -1 (only meaningful with --gallery_list)")
    p.add_argument("--probe_batch", type=int, default=4096,
                   help="probes per device matrix product")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard the gallery over the visible devices of "
                        "--device (every CUDA device, or one CPU): each "
                        "ranks its block of rows, the candidates merge; "
                        "results equal the single-device ranking")
    p.add_argument("--cohort", default="",
                   help="impostor-cohort embeddings file: switches scores to "
                        "adaptive s-norm (--threshold then applies on the "
                        "normalized scale)")
    p.add_argument("--snorm_top", type=int, default=200,
                   help="cohort scores per embedding used for the adaptive "
                        "statistics (0 = whole cohort)")
    p.add_argument("--output", required=True, help="output .npz path")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from tf_face_toolbox_tpu_torch.data.format import load_labels
    from tf_face_toolbox_tpu_torch.io import load_embeddings
    from tf_face_toolbox_tpu_torch.ops.verification import (
        cohort_stats, sharded_top_k_matches, top_k_matches)

    gallery, _ = load_embeddings(args.gallery)
    probe, _ = load_embeddings(args.probe)
    p_stats = g_stats = None
    if args.cohort:
        cohort, _ = load_embeddings(args.cohort)
        top = min(args.snorm_top, cohort.shape[0]) if args.snorm_top else 0
        p_stats = cohort_stats(probe, cohort, top=top, device=args.device)
        g_stats = cohort_stats(gallery, cohort, top=top, device=args.device)
    if args.data_parallel:
        device = torch.device(args.device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if device.type == "cuda" else [device])
        indices, scores = sharded_top_k_matches(
            gallery, probe, k=args.k, devices=devices,
            batch=args.probe_batch, probe_stats=p_stats,
            gallery_stats=g_stats)
    else:
        indices, scores = top_k_matches(gallery, probe, k=args.k,
                                        batch=args.probe_batch,
                                        probe_stats=p_stats,
                                        gallery_stats=g_stats,
                                        device=args.device)
    out = {"indices": indices, "scores": scores.astype(np.float32)}
    summary = {
        "probes": int(probe.shape[0]),
        "gallery": int(gallery.shape[0]),
        "k": args.k,
        "top1_score_mean": float(scores[:, 0].mean()),
    }
    if args.cohort:
        summary["snorm"] = {"cohort": int(cohort.shape[0]), "top": top}
    if args.gallery_list:
        gal_labels = load_labels(args.gallery_list)
        if len(gal_labels) != gallery.shape[0]:
            raise SystemExit(
                f"--gallery_list has {len(gal_labels)} labels but the "
                f"gallery has {gallery.shape[0]} rows")
        labels = gal_labels[indices].astype(np.int32)
        labels = np.where(scores >= args.threshold, labels, -1)
        out["labels"] = labels
        summary["threshold"] = args.threshold
        summary["top1_unknown_frac"] = float((labels[:, 0] < 0).mean())
    np.savez(args.output, **out)
    summary["output"] = args.output
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
