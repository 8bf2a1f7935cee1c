"""Margin-softmax heads: the combined (m1, m2, m3) margin, fixed per run.

Counterpart of the fixed-margin half of ``tf_face_toolbox_tpu/ops/
losses.py``:

    logit_target = s * (cos(m1 * theta + m2) - m3)
    logit_other  = s * cos(theta)

softmax is (1, 0, 0), SphereFace (m1 > 1, 0, 0), ArcFace (1, 0.5, 0)
and CosFace (1, 0, 0.35). Everything after the class GEMM (margin,
log-softmax) is f32. The norm-adaptive margins (MagFace, AdaFace,
CurricularFace) and the center and triplet losses are not ported yet
(ROADMAP.md §1 item 9).
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


def margined_target(cos_c: torch.Tensor, cfg: MarginConfig) -> torch.Tensor:
    """cos(m1 * theta + m2) - m3 of the clipped cos(theta) ``cos_c``.

    theta_m is clamped at 0 from below, and past pi it takes the linear
    extension -1 - (theta_m - pi), where cos is no longer monotone.
    """
    if cfg.m1 != 1.0 or cfg.m2 != 0.0:
        theta = torch.arccos(cos_c)
        theta_m = torch.clamp_min(cfg.m1 * theta + cfg.m2, 0.0)
        target = torch.where(theta_m <= math.pi, torch.cos(theta_m),
                             -1.0 - (theta_m - math.pi))
    else:
        target = cos_c
    return target - cfg.m3


def apply_margin(cos_theta: torch.Tensor, labels: torch.Tensor,
                 cfg: MarginConfig) -> torch.Tensor:
    """The combined margin on each row's target column, then the scale.

    cos_theta: (N, C) f32; labels: (N,) int in [0, C).
    """
    cos_theta = cos_theta.to(torch.float32)
    one_hot = torch.nn.functional.one_hot(
        labels.long(), cos_theta.shape[-1]).to(torch.bool)
    # arccos's domain: rounding in the GEMM can spill past +-1
    cos_c = torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7)
    logits = torch.where(one_hot, margined_target(cos_c, cfg), cos_theta)
    return cfg.scale * logits


def margin_softmax_loss(embeddings: torch.Tensor, weights: torch.Tensor,
                        labels: torch.Tensor, cfg: MarginConfig,
                        subcenters: int = 1) -> torch.Tensor:
    """Mean cross-entropy of the combined-margin logits (one device).

    ``subcenters=K``: ``weights`` is the class-major (C*K, D) table.
    """
    cos = subcenter_pool(cosine_logits(embeddings, weights), subcenters)
    logits = apply_margin(cos, labels, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def init_classifier_weights(num_classes: int, embedding_dim: int, *,
                            generator: torch.Generator | None = None,
                            device="cpu") -> torch.Tensor:
    """Class-weight matrix (C, D), N(0, 1) * 0.01 in f32."""
    return torch.randn((num_classes, embedding_dim), generator=generator,
                       dtype=torch.float32, device=device) * 0.01
