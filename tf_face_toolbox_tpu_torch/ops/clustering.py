"""Embedding-space face clustering (dataset cleaning / dedup).

Counterpart of ``tf_face_toolbox_tpu/ops/clustering.py``: link faces
whose cosine exceeds a threshold, take connected components, drop
small ones as noise. The kNN graph is a self-search of the embedding
set through :class:`serving.gallery.DeviceGallery` (the top-k kernels
on a CUDA device); the connected components are scipy's, on the host.

Determinism: same embeddings + threshold + k → same labels (component
ids are canonicalized to first-row order).
"""

from __future__ import annotations

import numpy as np


def knn_graph(embeddings: np.ndarray, *, k: int = 10,
              batch: int = 2048, store_dtype: str = "bfloat16",
              hbm_limit_gb: float = 8.0, device="cuda"):
    """k nearest neighbors of every row against the whole set.

    Returns ``(idx (N, k) int64, sims (N, k) f32)`` — self-matches
    removed. Embeddings are assumed L2-normalized (cli.extract's
    output contract). The store is bf16 by default (half the bytes;
    f32 accumulation) and spills to the exact streamed search past
    ``hbm_limit_gb`` instead of refusing.
    """
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    emb = np.asarray(embeddings, np.float32)
    n = emb.shape[0]
    if n < 2:
        raise ValueError(f"need >= 2 embeddings, got {n}")
    k = min(int(k), n - 1)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    g = DeviceGallery(emb.shape[1], dtype=store_dtype,
                      hbm_limit_gb=hbm_limit_gb, overflow="stream",
                      device=device)
    g.enroll(emb, np.arange(n))
    idx = np.empty((n, k), np.int64)
    sims = np.empty((n, k), np.float32)
    for i in range(0, n, batch):
        j = min(i + batch, n)
        labs, s = g.search(emb[i:j], k=k + 1)
        # drop the self-match: usually rank 0, but under bf16/int8
        # scoring an exact duplicate row can outrank self — mask by
        # row id, then keep the best k of the k+1 returned
        self_mask = labs == np.arange(i, j)[:, None]
        # stable partition: push the (single) self column out
        order = np.argsort(self_mask, axis=1, kind="stable")[:, :k]
        rows = np.arange(j - i)[:, None]
        idx[i:j] = labs[rows, order]
        sims[i:j] = s[rows, order]
    return idx, sims


def cluster_embeddings(embeddings: np.ndarray, *, threshold: float,
                       k: int = 10, batch: int = 2048,
                       store_dtype: str = "bfloat16",
                       hbm_limit_gb: float = 8.0,
                       min_size: int = 1, device="cuda"):
    """Threshold-linkage clustering: connected components of the kNN
    graph keeping edges with cosine >= ``threshold``.

    Returns ``(labels (N,) int64, n_clusters)``. Labels are dense ids
    in first-appearance order; components smaller than ``min_size``
    get label ``-1`` (noise — the cleaning workflow's drop set).
    Face-dedup thresholds typically sit at 0.5–0.7 on margin-softmax
    embeddings (calibrate on a labeled split via cli.eval_lfw's
    reported fold thresholds).
    """
    import scipy.sparse as sp

    emb = np.asarray(embeddings, np.float32)
    n = emb.shape[0]
    idx, sims = knn_graph(emb, k=k, batch=batch,
                          store_dtype=store_dtype,
                          hbm_limit_gb=hbm_limit_gb, device=device)
    src = np.repeat(np.arange(n, dtype=np.int64), idx.shape[1])
    dst = idx.reshape(-1)
    keep = sims.reshape(-1) >= threshold
    src, dst = src[keep], dst[keep]
    graph = sp.coo_matrix(
        (np.ones(src.shape[0], np.int8), (src, dst)), shape=(n, n))
    _, comp = sp.csgraph.connected_components(graph, directed=False)
    # canonicalize: dense ids in first-row order, noise to -1, vectorized
    comp = comp.astype(np.int64)
    sizes = np.bincount(comp)
    ok = sizes[comp] >= min_size                     # (n,) bool
    uniq, first_idx = np.unique(comp[ok], return_index=True)
    # rank components by first appearance among surviving rows
    rank = np.empty(uniq.shape[0], np.int64)
    rank[np.argsort(first_idx, kind="stable")] = np.arange(
        uniq.shape[0])
    mapping = np.full(sizes.shape[0], -1, np.int64)
    mapping[uniq] = rank
    labels = np.where(ok, mapping[comp], np.int64(-1))
    return labels, int(uniq.shape[0])
