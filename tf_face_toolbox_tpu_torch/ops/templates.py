"""IJB-style template (set-to-set) evaluation.

Counterpart of ``tf_face_toolbox_tpu/ops/templates.py``. IJB-B/C compare
templates, sets of images and video frames of one subject: the frames of
one media are averaged first (a long video counts as one look), then the
media into the template, which is L2-normalized. 1:1 verification scores
template pairs by cosine at fixed FARs (TAR@FAR). Both means are segment
sums on the device (``index_add_``); the ids are compacted on the host
(``np.unique``, so the template keys come back sorted). The pairs are
scored in slices of ``pair_chunk`` on the device: at IJB-C's 1.6e7
pairs two whole (P, 512) f32 gathers would be 2 x 32 GB. Pair ids are
found by a sorted search over the keys, not a dict.
"""

from __future__ import annotations

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models.layers import l2_normalize
from tf_face_toolbox_tpu_torch.ops.verification import tar_at_far


def _segment_mean(x: torch.Tensor, seg: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Mean of ``x`` rows per segment id: one scatter-add each for the
    sums and the counts."""
    total = x.new_zeros((num_segments, x.shape[1])).index_add_(0, seg, x)
    count = x.new_zeros((num_segments,)).index_add_(
        0, seg, x.new_ones((x.shape[0],)))
    return total / torch.clamp_min(count, 1.0)[:, None]


def aggregate_templates(embeddings, template_ids, media_ids, *,
                        normalize: bool = True, device="cuda"):
    """Frame embeddings -> template embeddings (media mean, then template
    mean).

    ``embeddings``: (N, D); ``template_ids``, ``media_ids``: (N,) ids of
    any integer or string dtype. Media ids need be unique only within a
    template: the inner segment is the (template, media) pair. Returns
    (template embeddings (T, D) f32 numpy, L2-normalized unless
    ``normalize`` is off; the template keys (T,), sorted). The means run
    on ``device``.
    """
    embeddings = np.asarray(embeddings, np.float32)
    template_ids = np.asarray(template_ids)
    media_ids = np.asarray(media_ids)
    if not (len(embeddings) == len(template_ids) == len(media_ids)):
        raise ValueError("embeddings/template_ids/media_ids length "
                         f"mismatch: {len(embeddings)}/"
                         f"{len(template_ids)}/{len(media_ids)}")
    if len(embeddings) == 0:
        raise ValueError("no rows to aggregate")
    tkeys, tidx = np.unique(template_ids, return_inverse=True)
    mcodes = np.unique(media_ids, return_inverse=True)[1]
    mkeys, midx = np.unique(np.stack([tidx, mcodes], axis=1), axis=0,
                            return_inverse=True)
    device = torch.device(device)
    x = torch.from_numpy(embeddings).to(device)
    media = _segment_mean(x, torch.from_numpy(midx.reshape(-1)).to(device),
                          len(mkeys))
    # each media segment's template: the first column of its key
    t_emb = _segment_mean(media, torch.from_numpy(mkeys[:, 0]).to(device),
                          len(tkeys))
    if normalize:
        t_emb = l2_normalize(t_emb)
    return t_emb.cpu().numpy(), tkeys


def pair_scores(template_embeddings, i1: np.ndarray, i2: np.ndarray, *,
                device="cuda", pair_chunk: int = 1 << 22) -> np.ndarray:
    """Cosine of template rows ``i1`` and ``i2`` (P,), in slices of
    ``pair_chunk`` pairs on ``device``: f32, each gathered row normalized
    as ``ops.verification.cosine_similarity`` does on the whole
    gathers."""
    device = torch.device(device)
    t = torch.as_tensor(np.asarray(template_embeddings, np.float32)).to(
        device)
    out = np.empty(len(i1), np.float32)
    for lo in range(0, len(i1), pair_chunk):
        a = torch.from_numpy(i1[lo:lo + pair_chunk]).to(device)
        b = torch.from_numpy(i2[lo:lo + pair_chunk]).to(device)
        e1, e2 = l2_normalize(t[a]), l2_normalize(t[b])
        out[lo:lo + len(a)] = torch.sum(e1 * e2, dim=-1).cpu().numpy()
    return out


def verify_templates(template_embeddings, template_keys: np.ndarray,
                     pairs, labels, *,
                     fars=(1e-1, 1e-2, 1e-3, 1e-4, 1e-5),
                     device="cuda", pair_chunk: int = 1 << 22) -> dict:
    """IJB 1:1 protocol: cosine over template pairs -> TAR at the given
    FARs (``ops.verification.tar_at_far``). ``pairs``: (P, 2) template
    ids, in the id space of ``template_keys``; ``labels``: (P,), 1 =
    same subject."""
    pairs = np.asarray(pairs)
    labels = np.asarray(labels)
    keys = np.asarray(template_keys)
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]

    def rows_of(ids):
        # a sorted search, not a dict: 1.6e7 pairs of ids in a few seconds
        pos = np.clip(np.searchsorted(sorted_keys, ids), 0, len(keys) - 1)
        unknown = sorted_keys[pos] != ids
        if unknown.any():
            raise ValueError("pair references unknown template "
                             f"{ids[unknown][0]!r}")
        return order[pos].astype(np.int64)

    i1, i2 = rows_of(pairs[:, 0]), rows_of(pairs[:, 1])
    sims = pair_scores(template_embeddings, i1, i2, device=device,
                       pair_chunk=pair_chunk)
    report = {"pairs": int(len(pairs)),
              "positives": int(labels.astype(bool).sum())}
    report.update(tar_at_far(sims, labels, fars=fars))
    return report
