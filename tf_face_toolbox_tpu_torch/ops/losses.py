"""Margin-softmax heads and the auxiliary metric losses.

Counterpart of ``tf_face_toolbox_tpu/ops/losses.py``. The combined
margin:

    logit_target = s * (cos(m1 * theta + m2) - m3)
    logit_other  = s * cos(theta)

softmax is (1, 0, 0), SphereFace (m1 > 1, 0, 0), ArcFace (1, 0.5, 0)
and CosFace (1, 0, 0.35). Everything after the class GEMM (margin,
log-softmax) is f32. The norm-adaptive losses add per-sample terms to
m2 and m3 (``extra_m2`` / ``extra_m3``): MagFace (a margin linear in
the embedding's norm, and a regularizer on the norm) and AdaFace (the
norm, standardized by EMA batch statistics, as a quality proxy).
CurricularFace modulates the hard negatives by an EMA scalar t. Center
loss and batch-hard triplet are added to the margin loss. Each is a
one-device form; ``parallel/sharded_softmax.py`` holds the
class-sharded ones, and the trainer runs them on a model row's
gathered rows.

Where the port's arithmetic could differ from a line-by-line reading:

- ``margined_target`` with ``extra_m2`` takes the arccos path even when
  m2 = 0, clamps theta_m at 0 from below (a negative AdaFace margin
  reaches it) and keeps the linear extension past pi.
- MagFace's norm is sqrt(sum(e^2) + 1e-12), not ``torch.linalg.norm``:
  the gradient at a zero embedding stays finite (an exact zero is
  reachable: a one-row replica's embedding BN gives zeros at init).
  Gradients flow through the clipped norm.
- AdaFace's norms are detached ``clip(||e||, 1e-3, 100)``, with no eps
  inside the norm; the statistics are updated, then used.
- Triplet distances are the Gram form sqrt(max(|a|^2 + |b|^2 - 2 a.b,
  1e-12)) over ``l2_normalize``, not ``torch.cdist``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tf_face_toolbox_tpu_torch.models.layers import l2_normalize


@dataclasses.dataclass(frozen=True)
class MarginConfig:
    """Combined-margin hyperparameters."""
    scale: float = 64.0
    m1: float = 1.0   # multiplicative angular margin (SphereFace)
    m2: float = 0.0   # additive angular margin (ArcFace)
    m3: float = 0.0   # additive cosine margin (CosFace)

    @staticmethod
    def softmax(scale: float = 64.0) -> "MarginConfig":
        return MarginConfig(scale=scale)

    @staticmethod
    def arcface(scale: float = 64.0, margin: float = 0.5) -> "MarginConfig":
        return MarginConfig(scale=scale, m2=margin)

    @staticmethod
    def cosface(scale: float = 64.0, margin: float = 0.35) -> "MarginConfig":
        return MarginConfig(scale=scale, m3=margin)

    @staticmethod
    def sphereface(scale: float = 64.0, margin: float = 1.35) -> "MarginConfig":
        return MarginConfig(scale=scale, m1=margin)


def cosine_logits(embeddings: torch.Tensor, weights: torch.Tensor
                  ) -> torch.Tensor:
    """cos(theta) between embeddings (N, D) and class weights (C, D) ->
    (N, C) f32. The GEMM runs in the inputs' dtype (f32 in training)."""
    e = l2_normalize(embeddings)
    w = l2_normalize(weights)
    return (e @ w.T).to(torch.float32)


def subcenter_pool(cos_theta: torch.Tensor, subcenters: int) -> torch.Tensor:
    """(N, C*K) sub-center cosines -> (N, C): the max over each class's
    K rows (class-major). K = 1 is a no-op."""
    if subcenters == 1:
        return cos_theta
    n, ck = cos_theta.shape
    if ck % subcenters:
        raise ValueError(f"classifier rows {ck} not divisible by "
                         f"subcenters {subcenters}")
    return cos_theta.reshape(n, ck // subcenters, subcenters).amax(dim=-1)


def margined_target(cos_c: torch.Tensor, cfg: MarginConfig,
                    extra_m2: torch.Tensor | None = None,
                    extra_m3: torch.Tensor | None = None) -> torch.Tensor:
    """cos(m1 * theta + m2 [+ extra_m2]) - m3 [- extra_m3] of the clipped
    cos(theta) ``cos_c`` (any shape). ``extra_m2`` / ``extra_m3``:
    per-sample additions broadcastable against it (MagFace, AdaFace);
    None gives the fixed-margin math.

    With ``extra_m2`` the arccos path is taken even at m2 = 0. theta_m is
    clamped at 0 from below (reachable with a negative adaptive margin),
    and past pi it takes the linear extension -1 - (theta_m - pi), where
    cos is no longer monotone.
    """
    if cfg.m1 != 1.0 or cfg.m2 != 0.0 or extra_m2 is not None:
        m2 = cfg.m2 if extra_m2 is None else cfg.m2 + extra_m2
        theta = torch.arccos(cos_c)
        theta_m = torch.clamp_min(cfg.m1 * theta + m2, 0.0)
        target = torch.where(theta_m <= math.pi, torch.cos(theta_m),
                             -1.0 - (theta_m - math.pi))
    else:
        target = cos_c
    target = target - cfg.m3
    if extra_m3 is not None:
        target = target - extra_m3
    return target


def _column(extra: torch.Tensor | None) -> torch.Tensor | None:
    return None if extra is None else extra[:, None]


def apply_margin(cos_theta: torch.Tensor, labels: torch.Tensor,
                 cfg: MarginConfig, extra_m2: torch.Tensor | None = None,
                 extra_m3: torch.Tensor | None = None) -> torch.Tensor:
    """The combined margin on each row's target column, then the scale.

    cos_theta: (N, C) f32; labels: (N,) int in [0, C); ``extra_m2`` /
    ``extra_m3``: optional (N,) per-sample additions.
    """
    cos_theta = cos_theta.to(torch.float32)
    one_hot = torch.nn.functional.one_hot(
        labels.long(), cos_theta.shape[-1]).to(torch.bool)
    # arccos's domain: rounding in the GEMM can spill past +-1
    cos_c = torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
    target = margined_target(cos_c, cfg, _column(extra_m2),
                             _column(extra_m3))
    return cfg.scale * torch.where(one_hot, target, cos_theta)


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def margin_softmax_loss(embeddings: torch.Tensor, weights: torch.Tensor,
                        labels: torch.Tensor, cfg: MarginConfig,
                        extra_m2: torch.Tensor | None = None,
                        extra_m3: torch.Tensor | None = None,
                        subcenters: int = 1) -> torch.Tensor:
    """Mean cross-entropy of the combined-margin logits (one device).

    ``subcenters=K``: ``weights`` is the class-major (C*K, D) table.
    """
    cos = subcenter_pool(cosine_logits(embeddings, weights), subcenters)
    return _nll(apply_margin(cos, labels, cfg, extra_m2, extra_m3), labels)


def init_classifier_weights(num_classes: int, embedding_dim: int, *,
                            generator: torch.Generator | None = None,
                            device="cpu") -> torch.Tensor:
    """Class-weight matrix (C, D), N(0, 1) * 0.01 in f32."""
    return torch.randn((num_classes, embedding_dim), generator=generator,
                       dtype=torch.float32, device=device) * 0.01


# ---------------------------------------------------------------------------
# Norm-adaptive margins: per-sample (m2, m3) for the extra_m2 / extra_m3
# hooks above and their class-sharded twins.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MagFaceConfig:
    """MagFace (Meng et al., CVPR 2021), the official defaults: the margin
    grows linearly with the magnitude a = ||e|| over [l_a, u_a], and
    g(a) = 1/a + a/u_a^2 pushes magnitudes up."""
    l_a: float = 10.0     # magnitude range lower bound
    u_a: float = 110.0    # magnitude range upper bound
    l_m: float = 0.45     # margin at l_a
    u_m: float = 0.8      # margin at u_a
    lambda_g: float = 35.0  # regularizer weight


def magface_margins(embeddings: torch.Tensor, cfg: MagFaceConfig
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(extra_m2 (N,), the mean regularizer g), both differentiable
    through the clipped, eps-padded norm (the loss shapes the
    magnitude)."""
    e = embeddings.to(torch.float32)
    a = torch.sqrt(torch.sum(e * e, dim=-1) + 1e-12)
    a = torch.clamp(a, cfg.l_a, cfg.u_a)
    m = cfg.l_m + (cfg.u_m - cfg.l_m) * (a - cfg.l_a) / (cfg.u_a - cfg.l_a)
    g = torch.mean(1.0 / a + a / (cfg.u_a ** 2))
    return m, g


@dataclasses.dataclass(frozen=True)
class AdaFaceConfig:
    """AdaFace (Kim et al., CVPR 2022), the official defaults: the
    standardized feature norm interpolates ArcFace-like (high quality)
    and CosFace-like (low quality) margins."""
    m: float = 0.4        # margin magnitude
    h: float = 0.333      # norm-score concentration
    t_alpha: float = 0.01  # EMA momentum of the norm statistics
    eps: float = 1e-3


def adaface_stats_init(device="cpu") -> dict:
    """The EMA statistics' official start: mean 20, std 100 (f32)."""
    return {"norm_mean": torch.tensor(20.0, device=device),
            "norm_std": torch.tensor(100.0, device=device)}


def adaface_norms(embeddings: torch.Tensor) -> torch.Tensor:
    """AdaFace's quality proxy: the detached norms, clipped to [1e-3,
    100] (no eps inside the norm)."""
    norms = torch.linalg.vector_norm(embeddings.detach().to(torch.float32),
                                     dim=-1)
    return torch.clamp(norms, 1e-3, 100.0)


def adaface_margins(norms: torch.Tensor, stats: dict, cfg: AdaFaceConfig,
                    batch_mean: torch.Tensor | None = None,
                    batch_std: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """(extra_m2 (N,), extra_m3 (N,), the new statistics).

    ``norms``: each row's norm, detached. ``batch_mean`` / ``batch_std``
    replace the batch's own moments (the trainer passes the global
    batch's). The statistics are updated, then used; the std has
    ddof=1, as the official ``torch.std``.
    """
    safe = torch.clamp(norms.to(torch.float32), 1e-3, 100.0)
    if batch_mean is None:
        batch_mean = safe.mean()
    if batch_std is None:
        n = safe.shape[0]
        batch_std = torch.sqrt(((safe - batch_mean) ** 2).sum()
                               / max(n - 1, 1))
    t = cfg.t_alpha
    new = {"norm_mean": t * batch_mean + (1.0 - t) * stats["norm_mean"],
           "norm_std": t * batch_std + (1.0 - t) * stats["norm_std"]}
    scaler = (safe - new["norm_mean"]) / (new["norm_std"] + cfg.eps)
    scaler = torch.clamp(scaler * cfg.h, -1.0, 1.0)
    return -cfg.m * scaler, cfg.m * scaler + cfg.m, new


def curricular_logits(cos_c: torch.Tensor, one_hot: torch.Tensor,
                      target_cos: torch.Tensor, t: torch.Tensor,
                      cfg: MarginConfig) -> torch.Tensor:
    """CurricularFace's scaled logits: the margined target T_i on the
    label's column, and each negative harder than T_i (cos_j > T_i)
    as cos_j * (t + cos_j). ``cos_c``: clipped cosines (N, C);
    ``target_cos``: each row's target cosine (N,). The hard test reads
    T_i detached."""
    target = margined_target(target_cos, cfg)
    hard = cos_c > target.detach()[:, None]
    neg = torch.where(hard, cos_c * (t + cos_c), cos_c)
    return cfg.scale * torch.where(one_hot > 0, target[:, None], neg)


def curricular_loss(embeddings: torch.Tensor, weights: torch.Tensor,
                    labels: torch.Tensor, cfg: MarginConfig,
                    t: torch.Tensor, subcenters: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """CurricularFace (Huang et al., CVPR 2020), one device: (mean NLL,
    t'). t' = 0.01 * mean(detached target cosine) + 0.99 * t is used in
    the same step (update-then-use); sub-centers are pooled before the
    clip."""
    cos = subcenter_pool(cosine_logits(embeddings, weights), subcenters)
    cos_c = torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)
    one_hot = torch.nn.functional.one_hot(labels.long(),
                                          cos.shape[-1]).float()
    target_cos = (cos_c * one_hot).sum(dim=-1)
    t_new = 0.01 * target_cos.detach().mean() + 0.99 * t
    logits = curricular_logits(cos_c, one_hot, target_cos, t_new, cfg)
    return _nll(logits, labels), t_new


def curricular_t_init(device="cpu") -> dict:
    """The curriculum's official start: t = 0 (f32)."""
    return {"t": torch.tensor(0.0, device=device)}


# ---------------------------------------------------------------------------
# Auxiliary metric losses: center loss (Wen et al., ECCV 2016) and
# batch-hard triplet (Hermans et al. 2017).
# ---------------------------------------------------------------------------


def center_loss(embeddings: torch.Tensor, centers: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """1/2 * mean ||e_i - c_{y_i}||^2; the centers are detached (they
    train by ``center_update``'s delta rule)."""
    d = embeddings.to(torch.float32) - centers.detach()[labels.long()]
    return 0.5 * torch.mean(torch.sum(d * d, dim=-1))


def center_sums(embeddings: torch.Tensor, labels: torch.Tensor,
                owned: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, D + 1): each class's sum of its detached f32 embeddings and,
    in the last column, its count, over the rows ``owned`` marks. An
    ``index_add_`` (JAX takes a one-hot product: the sums agree to f32
    rounding, not bit for bit)."""
    e = embeddings.detach().to(torch.float32)
    ones = torch.ones_like(e[:, :1])
    vals = torch.cat([e, ones], dim=1) * owned[:, None].to(torch.float32)
    return torch.zeros((rows, e.shape[1] + 1), dtype=torch.float32,
                       device=e.device).index_add_(0, labels.long(), vals)


def apply_center_sums(centers: torch.Tensor, sums: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """c_j - alpha * (n_j * c_j - sum_j) / (1 + n_j): a class absent from
    the batch (n_j = 0) stays."""
    counts = sums[:, -1:]
    delta = counts * centers - sums[:, :-1]
    return centers - alpha * delta / (1.0 + counts)


def center_update(embeddings: torch.Tensor, centers: torch.Tensor,
                  labels: torch.Tensor, alpha: float = 0.5) -> torch.Tensor:
    """The delta rule c_j <- c_j - alpha * sum_{y_i=j}(c_j - e_i) /
    (1 + n_j), a new tensor."""
    owned = torch.ones_like(labels, dtype=torch.bool)
    return apply_center_sums(
        centers, center_sums(embeddings, labels, owned, centers.shape[0]),
        alpha)


def batch_hard_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                            margin: float = 0.3,
                            normalized: bool = True) -> torch.Tensor:
    """Batch-hard triplet loss on Euclidean distances, over L2-normalized
    embeddings by default: for each anchor, relu(margin + its farthest
    positive - its nearest negative). Anchors with no positive or no
    negative in the batch are left out of the mean (a P x K batch,
    ``data.pipeline.balanced_batch_iterator``, has both)."""
    e = embeddings.to(torch.float32)
    if normalized:
        e = l2_normalize(e)
    sq = torch.sum(e * e, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (e @ e.T)
    d = torch.sqrt(torch.clamp_min(d2, 1e-12))
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=e.device)
    pos_mask = same & ~eye
    neg_mask = ~same
    big = 1e9
    d_pos = torch.where(pos_mask, d, -big).amax(dim=-1)
    d_neg = torch.where(neg_mask, d, big).amin(dim=-1)
    valid = pos_mask.any(dim=-1) & neg_mask.any(dim=-1)
    per_anchor = torch.clamp_min(margin + d_pos - d_neg, 0.0)
    per_anchor = torch.where(valid, per_anchor, 0.0)
    n_valid = torch.clamp_min(valid.to(torch.float32).sum(), 1.0)
    return per_anchor.sum() / n_valid
