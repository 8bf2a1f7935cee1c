"""LFW-style verification CLI: pairs file + embeddings -> k-fold report.

Counterpart of ``tf_face_toolbox_tpu/cli/eval_lfw.py``. Two pairs-file
formats are accepted (auto-detected):

1. Index format: ``idx1 idx2 label`` per line, idx = row indices into
   the embeddings array, label 1 (same) / 0 (diff).
2. The official LFW ``pairs.txt`` (view 2): an optional
   ``<folds>\t<per_fold>`` header, then ``name  n1  n2`` lines for
   matched pairs and ``name1  n1  name2  n2`` for mismatched ones. This
   format needs ``--names``, the pack list file (image paths in shard
   order), to resolve ``Name_0001``-style identifiers to rows.

    python -m tf_face_toolbox_tpu_torch.cli.eval_lfw \
        --embeddings=/tmp/lfw_embeddings.npy --pairs=/data/pairs.txt \
        --names=/data/lfw_list.txt
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_pairs(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Index-format pairs: 'idx1 idx2 label' lines."""
    i1, i2, lab = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3 or not all(map(_isint, parts)):
                continue  # comment / annotation / header line
            i1.append(int(parts[0]))
            i2.append(int(parts[1]))
            lab.append(int(parts[2]))
    return np.asarray(i1), np.asarray(i2), np.asarray(lab)


def _name_index(names_path: str) -> dict[tuple[str, int], int]:
    """(person name, photo number) → embedding row, from the pack list
    file (one image path per line, optionally followed by a label, in
    shard order). Accepts LFW's ``.../Name/Name_0001.jpg`` layout or
    any path whose basename ends in ``_<number>``."""
    index: dict[tuple[str, int], int] = {}
    with open(names_path) as f:
        row = 0
        for line in f:
            parts = line.split()
            if not parts:
                continue
            stem = os.path.splitext(os.path.basename(parts[0]))[0]
            name, _, num = stem.rpartition("_")
            if name and num.isdigit():
                index[(name, int(num))] = row
            row += 1
    return index


def _isint(tok: str) -> bool:
    return tok.lstrip("-").isdigit()


def _official_label(parts: list[str]) -> int | None:
    """1 for an official matched line (``name n1 n2``), 0 for a
    mismatched one (``name1 n1 name2 n2``), None for anything else."""
    if (len(parts) == 3 and not _isint(parts[0]) and _isint(parts[1])
            and _isint(parts[2])):
        return 1
    if (len(parts) == 4 and not _isint(parts[0]) and _isint(parts[1])
            and not _isint(parts[2]) and _isint(parts[3])):
        return 0
    return None


def _is_official_lfw(path: str) -> bool:
    """Official format detector. The first line that parses as either
    format decides; lines that parse as neither (comments, annotations,
    headers) are ignored — mirroring ``load_pairs``, which skips
    non-pair lines, so a ``# idx1 idx2 label`` comment can't flip an
    index-format file into the official branch."""
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 3 and all(map(_isint, parts)):
                return False  # index-format data line
            if _official_label(parts) is not None:
                return True  # official matched/mismatched data line
    return False


def load_lfw_pairs(path: str, names_path: str):
    """Official LFW pairs.txt → (i1, i2, labels) row indices.

    Matched line: ``name n1 n2``; mismatched: ``name1 n1 name2 n2``.
    The header line(s) of ints are skipped. Raises KeyError naming the
    missing photo if the embeddings don't cover a referenced image.
    """
    index = _name_index(names_path)

    def lookup(name: str, num: str) -> int:
        key = (name, int(num))
        if key not in index:
            raise KeyError(
                f"pairs file references {name}_{int(num):04d} but it is "
                f"not in --names ({names_path})")
        return index[key]

    i1, i2, lab = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            label = _official_label(parts)
            if label == 1:
                i1.append(lookup(parts[0], parts[1]))
                i2.append(lookup(parts[0], parts[2]))
            elif label == 0:
                i1.append(lookup(parts[0], parts[1]))
                i2.append(lookup(parts[2], parts[3]))
            else:
                continue  # header / comment / blank line
            lab.append(label)
    return np.asarray(i1), np.asarray(i2), np.asarray(lab)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--embeddings", required=True, help=".npy from cli.extract")
    p.add_argument("--pairs", required=True,
                   help="pairs file ('idx1 idx2 label' or official LFW)")
    p.add_argument("--names", default="",
                   help="pack list file mapping embedding rows to image "
                        "paths (needed for the official-LFW format)")
    p.add_argument("--folds", type=int, default=10,
                   help="cross-validation folds")
    p.add_argument("--roc_out", default="",
                   help="write the full ROC curve (thresholds/far/tar) to "
                        "this .npz; the JSON report always has auc/eer")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from tf_face_toolbox_tpu_torch.cli import json_sanitize
    from tf_face_toolbox_tpu_torch.io import load_embeddings
    from tf_face_toolbox_tpu_torch.ops.verification import (
        cosine_similarity, roc_curve, verify_pairs)

    emb, _ = load_embeddings(args.embeddings)
    if _is_official_lfw(args.pairs):
        if not args.names:
            raise SystemExit(
                "official-LFW pairs format detected; pass --names="
                "<pack list file> to map names to embedding rows")
        i1, i2, labels = load_lfw_pairs(args.pairs, args.names)
    else:
        i1, i2, labels = load_pairs(args.pairs)
    report = verify_pairs(emb[i1], emb[i2], labels, n_folds=args.folds)
    if args.roc_out:
        sims = cosine_similarity(emb[i1], emb[i2]).numpy()
        thresholds, far, tar = roc_curve(sims, labels)
        np.savez(args.roc_out, thresholds=thresholds, far=far, tar=tar)
        report["roc_out"] = args.roc_out
    print(json.dumps(json_sanitize(report), indent=2, allow_nan=False))


if __name__ == "__main__":
    main()
