"""IJB-style template (set-to-set) verification CLI.

Counterpart of ``tf_face_toolbox_tpu/cli/eval_templates.py``: aggregates
per-image embeddings into template embeddings (media mean, then template
mean; ``ops/templates.py``) and scores template pairs at fixed FARs, the
IJB-B/C 1:1 protocol. The chain:

    python -m tf_face_toolbox_tpu_torch.cli.extract --data=ijbc.faceshard \\
        --output=emb.npy
    python -m tf_face_toolbox_tpu_torch.cli.eval_templates \\
        --embeddings=emb.npy --meta=meta.txt --pairs=pairs.txt \\
        [--output_templates=tmpl.npy]

``--meta``: one line per embedding row (shard order):
``template_id media_id [subject_id]``. ``--pairs``: ``t1 t2 label``
lines, or ``t1 t2`` with the labels from the meta subject ids.
``--output_templates`` saves the template embeddings (rows in sorted
template-id order; with subject ids, a ``.labels.npy`` beside it) for
1:N runs through ``cli.eval_identification``. Prints a JSON report.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--embeddings", required=True,
                   help="embeddings from cli.extract (.npy/.npz/.mat/.bin)")
    p.add_argument("--meta", required=True,
                   help="per-row 'template_id media_id [subject_id]' file")
    p.add_argument("--pairs", required=True,
                   help="'t1 t2 label' or 't1 t2' (labels from the meta "
                        "subject ids) lines")
    p.add_argument("--fars", default="1e-1,1e-2,1e-3,1e-4,1e-5",
                   help="comma-separated FAR operating points")
    p.add_argument("--output_templates", default="",
                   help="optional .npy of the template embeddings (rows "
                        "by sorted template id; subject labels beside it "
                        "as .labels.npy)")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def load_meta(path: str):
    """-> (template_ids, media_ids, subject_by_template | None)."""
    tids, mids, subs = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) not in (2, 3):
                raise SystemExit(
                    f"--meta line needs 2-3 fields, got: {line!r}")
            tids.append(parts[0])
            mids.append(parts[1])
            subs.append(parts[2] if len(parts) == 3 else None)
    if not tids:
        raise SystemExit(f"--meta {path} has no data lines")
    subject = None
    if all(s is not None for s in subs):
        subject = {}
        for t, s in zip(tids, subs):
            if subject.setdefault(t, s) != s:
                raise SystemExit(
                    f"template {t} spans subjects {subject[t]} and {s}")
    return np.asarray(tids), np.asarray(mids), subject


def load_template_pairs(path: str, subject: dict | None):
    """-> ((P, 2) template ids, (P,) labels)."""
    p1, p2, lab = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if len(parts) == 3:
                p1.append(parts[0])
                p2.append(parts[1])
                lab.append(int(parts[2]))
            elif len(parts) == 2:
                if subject is None:
                    raise SystemExit(
                        "pairs file has no labels and --meta has no "
                        "subject ids to derive them from")
                for t in parts:
                    if t not in subject:
                        raise SystemExit(
                            f"pair references template {t} absent "
                            f"from --meta")
                p1.append(parts[0])
                p2.append(parts[1])
                lab.append(int(subject[parts[0]] == subject[parts[1]]))
            else:
                raise SystemExit(
                    f"pairs line needs 2-3 fields, got: {line!r}")
    if not p1:
        raise SystemExit(f"--pairs {path} has no data lines")
    return (np.stack([np.asarray(p1), np.asarray(p2)], axis=1),
            np.asarray(lab))


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from tf_face_toolbox_tpu_torch.cli import json_sanitize
    from tf_face_toolbox_tpu_torch.io import load_embeddings
    from tf_face_toolbox_tpu_torch.ops.templates import (
        aggregate_templates, verify_templates)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch sees no CUDA device; "
                         "pass --device cpu to run on the host")
    emb, _ = load_embeddings(args.embeddings)
    tids, mids, subject = load_meta(args.meta)
    if len(tids) != len(emb):
        raise SystemExit(f"--meta rows ({len(tids)}) != embedding rows "
                         f"({len(emb)})")
    pairs, labels = load_template_pairs(args.pairs, subject)
    t_emb, t_keys = aggregate_templates(emb, tids, mids, device=device)
    if args.output_templates:
        np.save(args.output_templates, t_emb)
        if subject is not None:
            np.save(args.output_templates.removesuffix(".npy")
                    + ".labels.npy",
                    np.asarray([subject[k] for k in t_keys.tolist()]))
    report = {"templates": int(len(t_keys)), "images": int(len(emb))}
    try:
        report.update(verify_templates(
            t_emb, t_keys, pairs, labels,
            fars=tuple(float(f) for f in args.fars.split(",") if f),
            device=device))
    except ValueError as e:
        raise SystemExit(str(e))
    print(json.dumps(json_sanitize(report), indent=2, allow_nan=True))


if __name__ == "__main__":
    main()
