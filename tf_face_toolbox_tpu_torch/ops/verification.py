"""Verification (1:1) and identification (1:N) protocols.

Counterpart of ``tf_face_toolbox_tpu/ops/verification.py``. The
similarities are torch f32 matrix products on the given device; the
protocols themselves (folds, thresholds, TAR@FAR, ROC, CMC, DIR@FAR)
are host numpy, copied unchanged. The 1:N functions run outside any
kernel, as in the JAX package; their top-k uses
``ops/topk.stable_topk`` so ties go to the smallest index, as with
``lax.top_k``.
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


def cohort_stats(embeddings: np.ndarray, cohort: np.ndarray, *,
                 top: int = 0, batch: int = 4096, device="cuda"
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-embedding (mean, std) of its cosines against an impostor
    cohort — the z-/t-norm statistics of score normalization.

    ``top`` > 0: the adaptive variant — statistics over only each
    embedding's ``top`` highest cohort scores. Returns ``(mu (N,),
    sigma (N,))``; sigma is floored at 1e-6 so division is safe.
    """
    cohort = np.asarray(cohort, np.float32)
    if top < 0 or top > cohort.shape[0]:
        raise ValueError(f"top={top} outside [0, cohort="
                         f"{cohort.shape[0]}]")
    c = torch.as_tensor(cohort, device=device)
    mus, sds = [], []
    embeddings = np.asarray(embeddings)
    for i in range(0, embeddings.shape[0], batch):
        e = torch.as_tensor(embeddings[i:i + batch], dtype=torch.float32,
                            device=device)
        sims = similarity_matrix(c, e).T              # (B, C)
        if top:
            sims = torch.topk(sims, top, dim=-1).values
        mus.append(sims.mean(dim=-1).cpu().numpy())
        sds.append(sims.std(dim=-1, correction=0).cpu().numpy())
    if not mus:
        raise ValueError("empty embedding set")
    return np.concatenate(mus), np.maximum(np.concatenate(sds), 1e-6)


def _snorm(sims, probe_stats, gallery_stats):
    """S-norm: ½(z-norm + t-norm) of a (B, G) score block."""
    mu_p, sd_p = probe_stats
    mu_g, sd_g = gallery_stats
    return 0.5 * ((sims - mu_p[:, None]) / sd_p[:, None]
                  + (sims - mu_g[None, :]) / sd_g[None, :])


def top_k_matches(gallery: np.ndarray, probe: np.ndarray, *,
                  k: int = 5, batch: int = 4096,
                  probe_stats=None, gallery_stats=None, device="cuda",
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Open-set 1:N search: the top-``k`` gallery rows per probe by
    cosine. Returns ``(indices (P, k) int32, scores (P, k) f32)``,
    scores descending per row, ties to the smallest gallery row.

    ``probe_stats``/``gallery_stats``: optional ``(mu, sigma)`` pairs
    from :func:`cohort_stats`; scores become adaptive s-norm before
    ranking. Pass both or neither.
    """
    from tf_face_toolbox_tpu_torch.ops.topk import stable_topk

    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if (probe_stats is None) != (gallery_stats is None):
        raise ValueError("s-norm needs BOTH probe_stats and "
                         "gallery_stats (or neither)")
    gallery = np.asarray(gallery)
    if k > gallery.shape[0]:
        raise ValueError(f"k={k} exceeds gallery size {gallery.shape[0]}")
    g = torch.as_tensor(gallery, dtype=torch.float32, device=device)
    use_norm = probe_stats is not None
    if use_norm:
        g_stats = tuple(torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                        device=device) for v in gallery_stats)
    scores, indices = [], []
    probe = np.asarray(probe)
    for i in range(0, probe.shape[0], batch):
        p = torch.as_tensor(probe[i:i + batch], dtype=torch.float32,
                            device=device)
        sims = similarity_matrix(g, p).T            # (B, G)
        if use_norm:
            pst = tuple(torch.as_tensor(np.asarray(v[i:i + batch]),
                                        dtype=torch.float32, device=device)
                        for v in probe_stats)
            sims = _snorm(sims, pst, g_stats)
        s, ix = stable_topk(sims, k)
        scores.append(s.cpu().numpy())
        indices.append(ix.cpu().numpy())
    if not scores:
        raise ValueError("empty probe set")
    return np.concatenate(indices), np.concatenate(scores)


def sharded_top_k_matches(gallery: np.ndarray, probe: np.ndarray, *,
                          k: int, devices=None, batch: int = 4096,
                          probe_stats=None, gallery_stats=None,
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Gallery-sharded 1:N search: :func:`top_k_matches` over galleries
    larger than one device's memory. The rows go to ``devices`` (one a
    shard, default every visible CUDA device; repeats allowed) in
    contiguous blocks, zero rows padding the last; each shard ranks its
    block (padded rows score -2e9; s-norm with the gallery statistics
    beside their rows), every shard launched before any is read, and a
    stable top-k over the shard-major candidates on the first device
    merges them. Blocks keep shard-major order equal to row order, so
    ties go to the smallest row. Returns ``(indices (P, k) int32,
    scores (P, k) f32)`` in global row numbering.
    """
    from tf_face_toolbox_tpu_torch.ops.topk import MASKED, stable_topk

    gallery = np.asarray(gallery, np.float32)
    probe = np.asarray(probe, np.float32)
    if (probe_stats is None) != (gallery_stats is None):
        raise ValueError("s-norm needs BOTH probe_stats and "
                         "gallery_stats (or neither)")
    use_norm = probe_stats is not None
    if devices is None:
        from tf_face_toolbox_tpu_torch.serving.distributed_gallery import (
            default_devices)
        devices = default_devices()
    devices = [torch.device(d) for d in devices]
    n_dev = len(devices)
    g_rows = gallery.shape[0]
    if k < 1 or k > g_rows:
        raise ValueError(f"k={k} outside [1, gallery={g_rows}]")
    shard_rows = -(-g_rows // n_dev)
    k_local = min(k, shard_rows)
    shards = []
    for s, dev in enumerate(devices):
        lo = s * shard_rows
        block = np.zeros((shard_rows, gallery.shape[1]), np.float32)
        real = gallery[lo:lo + shard_rows]
        block[:len(real)] = real
        stats = None
        if use_norm:
            # pads get (0, 1); their scores are masked after
            mu = np.zeros(shard_rows, np.float32)
            sd = np.ones(shard_rows, np.float32)
            mu[:len(real)] = np.asarray(gallery_stats[0],
                                        np.float32)[lo:lo + len(real)]
            sd[:len(real)] = np.asarray(gallery_stats[1],
                                        np.float32)[lo:lo + len(real)]
            stats = (torch.from_numpy(mu).to(dev),
                     torch.from_numpy(sd).to(dev))
        row = lo + torch.arange(shard_rows, device=dev)
        shards.append((l2_normalize(torch.from_numpy(block).to(dev)),
                       stats, row))
    scores, indices = [], []
    for i in range(0, probe.shape[0], batch):
        p_host = torch.from_numpy(probe[i:i + batch])
        pst = (tuple(torch.as_tensor(np.asarray(v[i:i + batch]),
                                     dtype=torch.float32)
                     for v in probe_stats) if use_norm else None)
        parts = []
        for dev, (g, stats, row) in zip(devices, shards):
            p = l2_normalize(p_host.to(dev))
            sims = p @ g.T                                  # (B, rows)
            if use_norm:
                sims = _snorm(sims, tuple(v.to(dev) for v in pst), stats)
            sims = torch.where(row[None, :] < g_rows, sims, MASKED)
            s, ix = stable_topk(sims, k_local)
            parts.append((s, row[ix.to(torch.int64)]))
        dev0 = devices[0]
        cand_s = torch.cat([s.to(dev0) for s, _ in parts], dim=1)
        cand_i = torch.cat([ix.to(dev0) for _, ix in parts], dim=1)
        s, pos = stable_topk(cand_s, k)
        scores.append(s.cpu().numpy())
        indices.append(torch.gather(cand_i, 1, pos.to(torch.int64))
                       .to(torch.int32).cpu().numpy())
    if not scores:
        raise ValueError("empty probe set")
    return np.concatenate(indices), np.concatenate(scores)


def identification_rank_k(gallery: np.ndarray, gallery_labels: np.ndarray,
                          probe: np.ndarray, probe_labels: np.ndarray,
                          *, k: int = 1, device="cuda") -> float:
    """Closed-set identification: rank-k hit rate (one f32 matrix
    product on the device, the ranking on the host)."""
    sims = similarity_matrix(
        torch.as_tensor(np.asarray(probe), device=device),
        torch.as_tensor(np.asarray(gallery), device=device)).cpu().numpy()
    order = np.argsort(-sims, axis=1)[:, :k]
    hits = (np.asarray(gallery_labels)[order] ==
            np.asarray(probe_labels)[:, None]).any(axis=1)
    return float(hits.mean())


def identification_stats(gallery: np.ndarray, gallery_labels: np.ndarray,
                         probe: np.ndarray, probe_labels: np.ndarray,
                         *, batch: int = 4096, device="cuda") -> dict:
    """One streamed device pass shared by the 1:N protocols.

    Per MATED probe (identity present in the gallery): the best
    correct-match score and its rank (1 + wrong-identity entries scoring
    above it). Per NON-MATED probe: the top gallery score. ``cmc_curve``
    and ``dir_at_far`` post-process this dict (``stats=``).
    """
    gallery_labels = np.asarray(gallery_labels)
    probe_labels = np.asarray(probe_labels)
    probe = np.asarray(probe)
    g = torch.as_tensor(np.asarray(gallery), dtype=torch.float32,
                        device=device)
    gl = torch.as_tensor(gallery_labels, device=device)
    mated_mask = np.isin(probe_labels, gallery_labels)

    mp, mpl = probe[mated_mask], probe_labels[mated_mask]
    scores, ranks_ = [], []
    for i in range(0, len(mp), batch):
        p = torch.as_tensor(mp[i:i + batch], dtype=torch.float32,
                            device=device)
        pl = torch.as_tensor(mpl[i:i + batch], device=device)
        sims = similarity_matrix(g, p).T            # (B, G)
        same = gl[None, :] == pl[:, None]
        best = torch.where(same, sims, -torch.inf).max(dim=1).values
        above = ((sims > best[:, None]) & ~same).sum(dim=1)
        scores.append(best.cpu().numpy())
        ranks_.append((1 + above).to(torch.int32).cpu().numpy())

    nm = probe[~mated_mask]
    # empty fallbacks keep the non-empty dtypes (f32 scores, int32 ranks)
    nm_top = np.concatenate([
        similarity_matrix(g, torch.as_tensor(
            nm[i:i + batch], dtype=torch.float32, device=device)
        ).T.max(dim=1).values.cpu().numpy()
        for i in range(0, len(nm), batch)]) if len(nm) else \
        np.empty((0,), np.float32)

    return {
        "mated_mask": mated_mask,
        "s_correct": (np.concatenate(scores) if scores
                      else np.empty((0,), np.float32)),
        "ranks": (np.concatenate(ranks_) if ranks_
                  else np.empty((0,), np.int32)),
        "nm_top": nm_top,
        "gallery_size": int(len(gallery_labels)),
    }


def cmc_curve(gallery: np.ndarray, gallery_labels: np.ndarray,
              probe: np.ndarray, probe_labels: np.ndarray,
              *, ranks=(1, 5, 10), batch: int = 4096,
              stats: dict | None = None, device="cuda") -> dict:
    """Closed-set CMC: hit rate at each rank, megaface-style.

    Rank of a probe = 1 + number of WRONG-identity gallery entries
    scoring above its best correct match (``identification_stats``).
    Probes whose identity is absent from the gallery are excluded and
    counted in ``skipped`` (feed them to ``dir_at_far``, same ``stats``).
    """
    if stats is None:
        stats = identification_stats(gallery, gallery_labels, probe,
                                     probe_labels, batch=batch,
                                     device=device)
    r = stats["ranks"]
    return {
        "probes": int(len(r)),
        "gallery": stats["gallery_size"],
        "skipped": int((~stats["mated_mask"]).sum()),
        "cmc": {int(k): (float((r <= k).mean()) if len(r) else float("nan"))
                for k in ranks},
        "mean_rank": float(r.mean()) if len(r) else float("nan"),
    }


def dir_at_far(gallery: np.ndarray, gallery_labels: np.ndarray,
               probe: np.ndarray, probe_labels: np.ndarray, *,
               fars=(1e-1, 1e-2), rank: int = 1,
               batch: int = 4096, stats: dict | None = None,
               device="cuda") -> dict:
    """Open-set identification: DIR@FAR (IJB/NIST 1:N protocol).

    Non-mated probes' top gallery scores set the alarm threshold for
    each target FAR (``tar_at_far``'s convention: acceptance strictly
    above, achieved FAR <= target, NaN when FAR is finer than
    1/N_nonmated). A mated probe is identified iff its correct identity
    sits within ``rank`` AND that match scores above the threshold:

        DIR(far, rank) = P[rank_i <= rank  AND  s_correct_i > thr(far)]
    """
    if stats is None:
        stats = identification_stats(gallery, gallery_labels, probe,
                                     probe_labels, batch=batch,
                                     device=device)
    mated_mask = stats["mated_mask"]
    s_correct = stats["s_correct"]
    r_mated = stats["ranks"]
    neg = np.sort(stats["nm_top"].astype(np.float64))[::-1]  # descending

    in_rank = r_mated <= rank
    out: dict = {
        "mated": int(mated_mask.sum()),
        "nonmated": int((~mated_mask).sum()),
        "gallery": stats["gallery_size"],
        "rank": int(rank),
        # the FAR→1 limit: pure closed-set rank-`rank` hit rate
        "dir_closed_set": (float(in_rank.mean()) if len(r_mated)
                           else float("nan")),
    }
    if len(neg) == 0:
        import warnings
        warnings.warn(
            "dir_at_far: every probe identity is enrolled — no "
            "non-mated probes to set thresholds; DIR@FAR is NaN "
            "(add distractor probes for the open-set protocol)")
    for far in fars:
        key = f"dir@far={far:g}"
        k = int(np.floor(far * len(neg)))
        if len(neg) == 0 or len(s_correct) == 0 or \
                (k == 0 and far > 0 and 1 / len(neg) > far):
            out[key] = float("nan")
            continue
        thr = neg[k] if k < len(neg) else -np.inf
        out[key] = float((in_rank & (s_correct > thr)).mean())
        out[key.replace("dir@", "thr@")] = float(thr)
    return out
