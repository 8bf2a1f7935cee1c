"""LFW-style 1:1 verification: cosine similarity + the 10-fold protocol.

Counterpart of the 1:1 part of ``tf_face_toolbox_tpu/ops/verification.py``.
The similarities are torch (f32 on any device); the protocol itself
(folds, thresholds, TAR@FAR, ROC) is host numpy, copied unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models.layers import l2_normalize


def cosine_similarity(emb1, emb2) -> torch.Tensor:
    """Row-wise cosine similarity of two (P, D) embedding batches."""
    e1 = l2_normalize(torch.as_tensor(emb1).to(torch.float32))
    e2 = l2_normalize(torch.as_tensor(emb2).to(torch.float32))
    return torch.sum(e1 * e2, dim=-1)


def similarity_matrix(gallery, probe) -> torch.Tensor:
    """All-pairs cosine matrix (G, P), one f32 matrix product."""
    g = l2_normalize(torch.as_tensor(gallery).to(torch.float32))
    p = l2_normalize(torch.as_tensor(probe).to(torch.float32))
    return g @ p.T


def _accuracy_curve(sims: np.ndarray, labels: np.ndarray,
                    thresholds: np.ndarray) -> np.ndarray:
    """Accuracy at every threshold, vectorized: (T,) from (P,) sims."""
    # (T, P) boolean predictions → mean match with labels along P.
    preds = sims[None, :] >= thresholds[:, None]
    return (preds == labels[None, :].astype(bool)).mean(axis=1)


def verify_folds(sims: np.ndarray, labels: np.ndarray, *, n_folds: int = 10,
                 thresholds: np.ndarray | None = None) -> dict:
    """Standard LFW k-fold protocol (SURVEY.md §3.3).

    For each fold: pick the best threshold on the other k-1 folds, report
    accuracy on the held-out fold. Returns mean/std accuracy and the
    per-fold numbers. ``sims``/``labels`` are (P,) arrays; pairs must be
    ordered so folds are contiguous chunks (standard LFW layout).
    """
    sims = np.asarray(sims, np.float64)
    labels = np.asarray(labels).astype(bool)
    if thresholds is None:
        thresholds = np.arange(-1.0, 1.0001, 0.0025)
    n = len(sims)
    if n % n_folds:
        raise ValueError(f"{n} pairs not divisible into {n_folds} folds")
    fold = n // n_folds
    # Degenerate-fold guard: the LFW protocol assumes every fold mixes
    # same- and diff-pairs (the official pairs.txt interleaves them). A
    # single-class fold yields meaningless thresholds — warn loudly.
    for k in range(n_folds):
        chunk = labels[k * fold:(k + 1) * fold]
        if chunk.all() or not chunk.any():
            import warnings
            warnings.warn(
                f"fold {k} contains only {'positive' if chunk.all() else 'negative'}"
                " pairs; interleave the pairs file for meaningful folds",
                stacklevel=2)
            break
    accs, thrs = [], []
    for k in range(n_folds):
        test = np.zeros(n, bool)
        test[k * fold:(k + 1) * fold] = True
        train_acc = _accuracy_curve(sims[~test], labels[~test], thresholds)
        best = thresholds[int(np.argmax(train_acc))]
        test_acc = float(
            ((sims[test] >= best) == labels[test]).mean())
        accs.append(test_acc)
        thrs.append(float(best))
    accs = np.asarray(accs)
    return {
        "accuracy_mean": float(accs.mean()),
        "accuracy_std": float(accs.std()),
        "fold_accuracies": accs.tolist(),
        "fold_thresholds": thrs,
    }


def tar_at_far(sims: np.ndarray, labels: np.ndarray,
               fars=(1e-1, 1e-2, 1e-3)) -> dict:
    """True-accept rate at fixed false-accept rates (the IJB-style
    operating-point metric that complements the LFW fold accuracy).

    The threshold for each target FAR is the tightest one the negative
    pairs support: with k = floor(FAR·N_neg) impostors allowed,
    threshold = the (k+1)-th highest negative score, and acceptance is
    STRICTLY above it — so at most k negatives pass (achieved
    FAR ≤ target). TAR = fraction of positives above the threshold.
    FARs finer than 1/N_neg are reported as NaN rather than
    extrapolated.
    """
    sims = np.asarray(sims, np.float64)
    labels = np.asarray(labels).astype(bool)
    pos = np.sort(sims[labels])
    neg = np.sort(sims[~labels])[::-1]      # descending
    out = {}
    for far in fars:
        key = f"tar@far={far:g}"
        k = int(np.floor(far * len(neg)))   # impostors we may accept
        if len(neg) == 0 or len(pos) == 0 or (k == 0 and far > 0
                                              and 1 / len(neg) > far):
            out[key] = float("nan")         # FAR finer than resolution
            continue
        # strictly above the (k+1)-th negative ⇒ ≤ k false accepts
        thr = neg[k] if k < len(neg) else -np.inf
        accepted = pos > thr
        out[key] = float(accepted.mean())
        out[key.replace("tar@", "thr@")] = float(thr)
    return out


def roc_curve(sims: np.ndarray, labels: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full ROC at every distinct score: ``(thresholds, far, tar)``.

    Acceptance is STRICTLY above the threshold — the same convention as
    :func:`tar_at_far`, so the curve passes exactly through every
    reported operating point. ``thresholds`` is the descending distinct
    scores plus a final ``-inf`` (accept-everything) entry; ``far`` and
    ``tar`` ascend from 0 to 1. Plot-ready and the basis for AUC/EER.
    """
    sims = np.asarray(sims, np.float64)
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError(f"roc_curve needs both classes; got "
                         f"{n_pos} positives / {n_neg} negatives")
    order = np.argsort(-sims, kind="stable")
    s, pos = sims[order], labels[order]
    cum_tp = np.cumsum(pos)
    cum_fp = np.cumsum(~pos)
    # last index of each tie group: thresholds are the distinct scores
    ends = np.nonzero(np.r_[np.diff(s) != 0, True])[0]
    # accepting > s[ends[i]] admits exactly the groups before i
    tp = np.r_[0, cum_tp[ends[:-1]], cum_tp[-1]].astype(np.float64)
    fp = np.r_[0, cum_fp[ends[:-1]], cum_fp[-1]].astype(np.float64)
    thresholds = np.r_[s[ends], -np.inf]
    return thresholds, fp / n_neg, tp / n_pos


def auc_eer(far: np.ndarray, tar: np.ndarray) -> tuple[float, float]:
    """Area under the ROC (trapezoid) and the equal-error rate (the
    point where FAR == 1 − TAR == FRR, linearly interpolated between
    the two bracketing curve points)."""
    far = np.asarray(far, np.float64)
    tar = np.asarray(tar, np.float64)
    auc = float(np.trapezoid(tar, far))
    # frr − far is monotonically non-increasing along the curve; find
    # the sign change and interpolate
    diff = (1.0 - tar) - far
    idx = int(np.searchsorted(-diff, 0.0, side="left"))
    if idx == 0:
        eer = float(far[0])
    elif idx >= len(far):
        eer = float(1.0 - tar[-1])
    else:
        d0, d1 = diff[idx - 1], diff[idx]
        w = 0.0 if d0 == d1 else d0 / (d0 - d1)
        eer = float((1 - w) * far[idx - 1] + w * far[idx])
    return auc, eer


def verify_pairs(emb1: np.ndarray, emb2: np.ndarray, labels: np.ndarray,
                 *, n_folds: int = 10) -> dict:
    """End-to-end: embeddings for each pair side → LFW-protocol report
    (fold accuracy + TAR@FAR operating points + ROC AUC / EER)."""
    sims = cosine_similarity(np.asarray(emb1), np.asarray(emb2)).numpy()
    report = verify_folds(sims, labels, n_folds=n_folds)
    report.update(tar_at_far(sims, labels))
    try:
        _, far, tar = roc_curve(sims, labels)
        report["auc"], report["eer"] = auc_eer(far, tar)
    except ValueError:  # single-class pair set: no ROC, like tar@far's NaNs
        report["auc"] = report["eer"] = float("nan")
    return report
