"""Closed-set identification (1:N) evaluation: CMC, plus DIR@FAR.

Counterpart of ``tf_face_toolbox_tpu/cli/eval_identification.py``:
gallery + probe embedding files → rank-k hit rates, megaface-style, in
probe batches of one f32 matrix product each on the device. When the
probe set holds identities absent from the gallery, they are scored as
impostors for the open-set DIR@FAR.

    python -m tf_face_toolbox_tpu_torch.cli.eval_identification \
        --gallery=gal.npy --gallery_list=gal_list.txt \
        --probe=probe.npy --probe_list=probe_list.txt --ranks=1,5,10

Labels come from the pack list files the extraction consumed
(``image_path label`` per line, row order = embedding order).
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gallery", required=True, help="gallery embeddings file")
    p.add_argument("--probe", required=True, help="probe embeddings file")
    p.add_argument("--gallery_list", required=True,
                   help="pack list file with gallery labels")
    p.add_argument("--probe_list", required=True,
                   help="pack list file with probe labels")
    p.add_argument("--ranks", default="1,5,10", help="CMC ranks to report")
    p.add_argument("--far", default="1e-1,1e-2",
                   help="open-set operating points: DIR@FAR is reported "
                        "whenever the probe set has non-mated identities")
    p.add_argument("--dir_rank", type=int, default=1,
                   help="rank within which a mated probe must be identified "
                        "for DIR@FAR")
    p.add_argument("--probe_batch", type=int, default=4096,
                   help="probes per device matrix product")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tf_face_toolbox_tpu_torch.cli import json_sanitize
    from tf_face_toolbox_tpu_torch.data.format import load_labels
    from tf_face_toolbox_tpu_torch.io import load_embeddings
    from tf_face_toolbox_tpu_torch.ops.verification import (
        cmc_curve, dir_at_far, identification_stats)

    gallery, _ = load_embeddings(args.gallery)
    probe, _ = load_embeddings(args.probe)
    glabels = load_labels(args.gallery_list)
    plabels = load_labels(args.probe_list)
    for name, emb, lab in (("gallery", gallery, glabels),
                           ("probe", probe, plabels)):
        if len(emb) != len(lab):
            raise SystemExit(
                f"{name}: {len(emb)} embeddings vs {len(lab)} labels — "
                "list file must be the one the extraction consumed")
    # one similarity sweep feeds both protocols
    stats = identification_stats(gallery, glabels, probe, plabels,
                                 batch=args.probe_batch, device=args.device)
    report = cmc_curve(gallery, glabels, probe, plabels,
                       ranks=[int(k) for k in args.ranks.split(",")],
                       stats=stats)
    if report["skipped"]:
        # cmc's skipped probes are the open-set non-mated set
        report["open_set"] = dir_at_far(
            gallery, glabels, probe, plabels,
            fars=[float(f) for f in args.far.split(",")],
            rank=args.dir_rank, stats=stats)
    else:
        report["open_set_note"] = (
            "DIR@FAR skipped: every probe identity is enrolled in the "
            "gallery, so there are no non-mated probes to set FAR "
            "thresholds (add distractor probes for the open-set "
            "protocol)")
    print(json.dumps(json_sanitize(report), indent=2, allow_nan=False))


if __name__ == "__main__":
    main()
