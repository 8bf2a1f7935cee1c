"""Class-sharded (Partial-FC) margin softmax over the model axis.

Counterpart of ``tf_face_toolbox_tpu/parallel/sharded_softmax.py``:
the exact and sampled margin heads (with MagFace's and AdaFace's
per-sample ``extra_m2`` / ``extra_m3``), CurricularFace, and the center
loss and its update. The classifier's classes are split over
the ``model`` ranks of a data row: rank m holds classes [m * C_local,
(m + 1) * C_local) (K class-major rows each with sub-centers), scores
every row of the row's batch against them, and the softmax combines
across the shards with two small collectives
(``parallel/collectives.py``):

    global max   = pmax over the row of each sample's shard max
    denominator  = psum over the row of sum exp(logit - global max)
    target logit = psum over the row (each label lives on one shard)

This is the one-device ``margin_softmax_loss`` exactly, without the
(N, C) logits on any one rank. Gradients flow through the psums (their
backward sums the cotangent over the row), so a rank's loss divided by
the model size gives each shard its exact gradient.

The center table (C_pad, D) is split over the model axis as the
classifier is: each sample's center lives on one shard, and a psum over
the row assembles the per-sample distances; the update's sums are taken
over the global batch (a sum over the data axis).

``mesh`` is a ``parallel.mesh.Topology`` (None: one shard, every class).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from tf_face_toolbox_tpu_torch.ops.losses import (
    MarginConfig,
    apply_center_sums,
    center_sums,
    cosine_logits,
    curricular_logits,
    margined_target,
    subcenter_pool,
)
from tf_face_toolbox_tpu_torch.parallel import collectives

_NEG = -1e30   # a masked logit: exp(_NEG - max) is 0, never inf * 0


def _index(mesh) -> int:
    return mesh.model_index if mesh is not None else 0


def _ownership(labels: torch.Tensor, c_local: int, index: int):
    """Each label's column on shard ``index`` (0 where another shard owns
    it) and whether this shard owns it."""
    local = labels.long() - index * c_local
    owned = (local >= 0) & (local < c_local)
    return torch.where(owned, local, 0), owned


def _one_hot(labels: torch.Tensor, c_local: int, index: int) -> torch.Tensor:
    """(N, C_local) f32: 1 at each label's column on shard ``index``, a
    zero row where another shard owns the label."""
    safe, owned = _ownership(labels, c_local, index)
    return F.one_hot(safe, c_local).float() * owned[:, None].float()


def column_weight(index: int, c_local: int, total_classes: int | None,
                   device) -> torch.Tensor:
    """(C_local,): 1, or 0 for a column at or past ``total_classes`` (the
    padding of C up to a multiple of the shards)."""
    if total_classes is None:
        return torch.ones(c_local, device=device)
    cols = index * c_local + torch.arange(c_local, device=device)
    return (cols < total_classes).float()


def _clip(cos: torch.Tensor) -> torch.Tensor:
    # arccos's domain: rounding in the GEMM can spill past +-1
    return torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7)


def _margin_logits(cos: torch.Tensor, one_hot: torch.Tensor,
                   cfg: MarginConfig, extra_m2=None, extra_m3=None
                   ) -> torch.Tensor:
    """The margin on the label's column (the mask, since a label may live
    on another shard), then the scale; ``extra_m2`` / ``extra_m3``: (N,)
    per-sample additions, the same on every shard of the row."""
    target = margined_target(
        _clip(cos), cfg, None if extra_m2 is None else extra_m2[:, None],
        None if extra_m3 is None else extra_m3[:, None])
    return cfg.scale * torch.where(one_hot > 0, target, cos)


def local_margin_logits(embeddings: torch.Tensor, w_shard: torch.Tensor,
                        labels: torch.Tensor, cfg: MarginConfig, mesh=None,
                        *, extra_m2=None, extra_m3=None,
                        subcenters: int = 1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """A shard's scaled margin logits and its ownership mask.

    ``embeddings``: (N, D), every row of the data row's batch;
    ``w_shard``: (C_local * K, D); ``labels``: (N,) global class ids.
    ``extra_m2`` / ``extra_m3``: optional (N,) per-sample margin
    additions (MagFace, AdaFace), the same on every shard of the row.
    Returns (logits (N, C_local) f32, one_hot (N, C_local) f32).
    """
    logits, _, one_hot = exact_logits(embeddings, w_shard, labels, cfg,
                                      _index(mesh), None, subcenters,
                                      extra_m2, extra_m3)
    return logits, one_hot


def exact_logits(embeddings: torch.Tensor, w_shard: torch.Tensor,
                 labels: torch.Tensor, cfg: MarginConfig, index: int,
                 total_classes: int | None, subcenters: int = 1,
                 extra_m2=None, extra_m3=None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard ``index``'s (logits (N, C_local), weight (C_local,): 1, or
    0 for a column at or past ``total_classes``, the padding of C up to
    a multiple of the shards, one_hot (N, C_local))."""
    c_local = w_shard.shape[0] // subcenters
    one_hot = _one_hot(labels, c_local, index)
    cos = subcenter_pool(cosine_logits(embeddings, w_shard), subcenters)
    weight = column_weight(index, c_local, total_classes, w_shard.device)
    return (_margin_logits(cos, one_hot, cfg, extra_m2, extra_m3), weight,
            one_hot)


def _shifted_sums(masked: torch.Tensor, weight: torch.Tensor,
                  one_hot: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """A shard's part of the denominator and of the target logit, each
    row shifted by ``top``: (2, N)."""
    shifted = masked - top[:, None]
    return torch.stack([(shifted.exp() * weight).sum(dim=-1),
                        (shifted * one_hot).sum(dim=-1)])


def _masked(logits: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    # a pad's raw logit may exceed the valid max by enough that exp
    # overflows to inf, and inf * 0 is NaN: shift and exp masked logits
    return torch.where(weight > 0, logits, _NEG)


def masked_nll(logits: torch.Tensor, weight: torch.Tensor,
               one_hot: torch.Tensor, mesh) -> torch.Tensor:
    """The distributed softmax NLL, mean over rows (JAX's
    ``_masked_softmax_nll``, with the sampled head's column weights):
    ``logits`` (N, cols) of this shard, ``weight`` (cols,) each column's
    weight in the denominator (0: a pad), and the label mask
    ``one_hot``. The max shift cancels in the log-softmax, so it is
    detached; the denominator and target are psummed together."""
    masked = _masked(logits, weight)
    top = collectives.model_pmax(masked.amax(dim=-1), mesh)
    denom, target = collectives.model_psum(
        _shifted_sums(masked, weight, one_hot, top), mesh)
    return (denom.log() - target).mean()


def masked_nll_of_shards(blocks: list) -> torch.Tensor:
    """``masked_nll`` of a model row's shards in one process: ``blocks``
    the shards' (logits, weight, one_hot) in model order, combined as the
    collectives combine them (the max, then the sum over the shards)."""
    masked = [_masked(logits, weight) for logits, weight, _ in blocks]
    top = functools.reduce(torch.maximum,
                           [m.amax(dim=-1) for m in masked]).detach()
    denom, target = sum(_shifted_sums(m, weight, one_hot, top)
                        for m, (_, weight, one_hot) in zip(masked, blocks))
    return (denom.log() - target).mean()


def sharded_margin_softmax_loss(embeddings: torch.Tensor,
                                w_shard: torch.Tensor, labels: torch.Tensor,
                                cfg: MarginConfig, mesh=None,
                                total_classes: int | None = None,
                                extra_m2=None, extra_m3=None,
                                subcenters: int = 1) -> torch.Tensor:
    """Exact cross-entropy over class shards: the mean NLL over the N
    rows (the same on every rank of the row). ``total_classes``: the true
    class count when C was padded to a multiple of the shards;
    ``extra_m2`` / ``extra_m3``: (N,) per-sample margin additions."""
    return masked_nll(*exact_logits(embeddings, w_shard, labels, cfg,
                                    _index(mesh), total_classes, subcenters,
                                    extra_m2, extra_m3),
                      mesh)


class _GatherCompactSync(torch.autograd.Function):
    """``w_shard[sampled]``, whose backward averages the compact (budget,
    D) cotangent over the data axis before it scatters it into a zero
    (C_local, D) gradient: the data exchange moves budget * D values,
    the sample rate times the shard (An et al. 2021, "Partial FC").
    Needs ``sampled`` equal on every rank of the data column; the
    shard's gradient comes back already averaged over the data axis."""

    @staticmethod
    def forward(ctx, w_shard, sampled, mesh):
        ctx.save_for_backward(sampled)
        ctx.shape, ctx.mesh = w_shard.shape, mesh
        return w_shard[sampled]

    @staticmethod
    def backward(ctx, grad):
        (sampled,) = ctx.saved_tensors
        grad = collectives.data_pmean(grad.contiguous(), ctx.mesh)
        out = grad.new_zeros(ctx.shape).index_add_(0, sampled, grad)
        return out, None, None


def draw_uniforms(generator: torch.Generator, c_local: int) -> torch.Tensor:
    """A shard's sampling keys for one step: (c_local,) f32 uniforms in
    [0, 1) on the generator's device (the JAX head's ``jax.random.
    uniform(fold_in(key, shard))``; the trainer seeds ``generator`` from
    (rng, step, 0x9FC, model index), so every rank of a data column draws
    the same)."""
    return torch.rand(c_local, generator=generator, device=generator.device)


def check_budget(budget: int, c_local: int, n_pool: int) -> None:
    if not 0 < budget <= c_local:
        raise ValueError(f"budget {budget} must be in (0, {c_local}]")
    # a shard can own at most min(pool, C_local) distinct positives
    if budget < min(n_pool, c_local):
        raise ValueError(
            f"budget {budget} < min(batch pool {n_pool}, shard {c_local}): "
            "owned positives could overflow the sampled set")


def sampled_logits(embeddings: torch.Tensor, w_shard: torch.Tensor,
                   labels: torch.Tensor, pos_labels: torch.Tensor,
                   cfg: MarginConfig, uniforms: torch.Tensor, budget: int,
                   index: int, total_classes: int | None, gather=None,
                   extra_m2=None, extra_m3=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard ``index``'s sampled columns: every class of ``pos_labels``
    it owns, then the valid columns of least ``uniforms``, pads last
    (top ``budget`` of the negated keys -1 / uniform / 2), in ascending
    column order. Returns (logits (N, budget), weight (budget,): 1 for a
    positive, 1/q for a valid negative (q its inclusion probability), 0
    for a pad, one_hot (N, budget)). ``gather(w_shard, sampled)`` reads
    the sampled rows (default: indexing); ``extra_m2`` / ``extra_m3``:
    (N,) per-sample margin additions."""
    c_local = w_shard.shape[0]
    device = w_shard.device
    offset = index * c_local
    safe, owned = _ownership(labels, c_local, index)
    pos_safe, pos_owned = _ownership(pos_labels, c_local, index)
    pos_in_shard = torch.zeros(c_local, dtype=torch.int32,
                               device=device).index_add_(
        0, pos_safe, pos_owned.int()) > 0
    num_pos = pos_in_shard.sum()
    valid_local = c_local if total_classes is None else min(
        max(total_classes - offset, 0), c_local)
    col_valid = torch.arange(c_local, device=device) < valid_local
    keys = torch.where(pos_in_shard, -1.0,
                       torch.where(col_valid, uniforms, 2.0))
    sampled = torch.topk(-keys, budget).indices.sort().values

    w_sub = w_shard[sampled] if gather is None else gather(w_shard, sampled)
    pos_of_class = torch.zeros(c_local, dtype=torch.long, device=device)
    pos_of_class[sampled] = torch.arange(budget, device=device)
    one_hot = (F.one_hot(pos_of_class[safe], budget).float()
               * owned[:, None].float())
    logits = _margin_logits(cosine_logits(embeddings, w_sub), one_hot, cfg,
                            extra_m2, extra_m3)

    drawn = torch.minimum(budget - num_pos, valid_local - num_pos)
    pool = torch.clamp_min(valid_local - num_pos, 1)
    q = torch.clamp(drawn.float() / pool.float(), 1e-9, 1.0)
    weight = torch.where(pos_in_shard[sampled], 1.0,
                         torch.where(col_valid[sampled], 1.0 / q, 0.0))
    return logits, weight, one_hot


def sampled_sharded_margin_softmax_loss(
        embeddings: torch.Tensor, w_shard: torch.Tensor,
        labels: torch.Tensor, cfg: MarginConfig,
        generator: torch.Generator, budget: int, mesh=None,
        total_classes: int | None = None, extra_m2=None, extra_m3=None,
        data_sync: bool = False) -> torch.Tensor:
    """Sampled Partial-FC: each shard scores ``budget`` of its C_local
    columns, the denominator importance-corrected (an unbiased estimate
    of the exact one; ``budget == C_local`` is the exact loss).

    ``generator`` draws this shard's keys (``draw_uniforms``). With
    ``data_sync``, the positives are the global batch's (the labels
    gathered over the data axis), so every rank of a data column samples
    the same set, and the shard is read through the compact-exchange
    gather: its gradient comes back averaged over the data axis, and the
    caller must not average it again. Needs ``budget >= min(pool,
    C_local)`` (pool: the rows whose positives are kept). ``extra_m2`` /
    ``extra_m3``: (N,) per-sample margin additions.
    """
    c_local = w_shard.shape[0]
    pos_labels = labels
    gather = None
    if data_sync:
        pos_labels = collectives.data_all_gather(labels, mesh)

        def gather(w, sampled):
            return _GatherCompactSync.apply(w, sampled, mesh)
    check_budget(budget, c_local, pos_labels.shape[0])
    logits, weight, one_hot = sampled_logits(
        embeddings, w_shard, labels, pos_labels, cfg,
        draw_uniforms(generator, c_local), budget, _index(mesh),
        total_classes, gather, extra_m2, extra_m3)
    return masked_nll(logits, weight, one_hot, mesh)


# ---------------------------------------------------------------------------
# The class-sharded center loss and CurricularFace. One-device oracles:
# ops/losses.center_loss, center_update, curricular_loss.
# ---------------------------------------------------------------------------


def sharded_center_loss(embeddings: torch.Tensor, c_shard: torch.Tensor,
                        labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """1/2 * mean ||e_i - c_{y_i}||^2 with the centers split over the
    model row: ``embeddings`` (N, D) the row's gathered rows (the same on
    each of its ranks), ``c_shard`` (C_local, D) this rank's centers,
    detached. Each sample's distance comes from its owner's shard, summed
    over the row (differentiable)."""
    safe, owned = _ownership(labels, c_shard.shape[0], _index(mesh))
    d = embeddings.to(torch.float32) - c_shard.detach()[safe]
    per = torch.sum(d * d, dim=-1) * owned.float()
    return 0.5 * collectives.model_psum(per, mesh).mean()


def sharded_center_update(embeddings: torch.Tensor, c_shard: torch.Tensor,
                          labels: torch.Tensor, mesh=None,
                          alpha: float = 0.5) -> torch.Tensor:
    """The delta rule on this rank's centers, a new (C_local, D) tensor:
    c_j - alpha * sum_{y_i=j}(c_j - e_i) / (1 + n_j), the class sums and
    counts of the row's gathered rows summed over the data axis (one
    all-reduce), so every data rank applies the global batch's update
    (the centers are the same down a data column, split along a row)."""
    c_local = c_shard.shape[0]
    safe, owned = _ownership(labels, c_local, _index(mesh))
    sums = center_sums(embeddings, safe, owned, c_local)
    return apply_center_sums(c_shard, collectives.data_psum(sums, mesh),
                             alpha)


def target_cosines(embeddings: torch.Tensor, w_shard: torch.Tensor,
                   labels: torch.Tensor, index: int, subcenters: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shard ``index``'s clipped cosines (N, C_local) (sub-centers pooled
    before the clip), its label mask (N, C_local) and its part of each
    row's target cosine (N,): 0 where another shard owns the label, so
    the parts of a row's shards sum to the target cosine."""
    c_local = w_shard.shape[0] // subcenters
    one_hot = _one_hot(labels, c_local, index)
    cos_c = _clip(subcenter_pool(cosine_logits(embeddings, w_shard),
                                 subcenters))
    return cos_c, one_hot, (cos_c * one_hot).sum(dim=-1)


def curricular_t(target_cos: torch.Tensor, t: torch.Tensor,
                 mesh=None, data_sync: bool = False) -> torch.Tensor:
    """t' = 0.01 * r + 0.99 * t, r the mean detached target cosine (over
    the data axis too with ``data_sync``: the global batch's)."""
    r = target_cos.detach().mean()
    if data_sync:
        r = collectives.data_pmean(r, mesh)
    return 0.01 * r + 0.99 * t


def sharded_curricular_loss(embeddings: torch.Tensor, w_shard: torch.Tensor,
                            labels: torch.Tensor, cfg: MarginConfig,
                            t: torch.Tensor, mesh=None,
                            total_classes: int | None = None,
                            subcenters: int = 1, data_sync: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Class-sharded CurricularFace: (mean NLL over the row's rows, t').

    The target cosine lives on one shard: a psum over the row gives it
    to every shard (differentiable) for the hard-negative test. t' is
    taken from it (``curricular_t``) and used in the same step; the
    caller keeps it as the next step's t.
    """
    index = _index(mesh)
    cos_c, one_hot, part = target_cosines(embeddings, w_shard, labels,
                                          index, subcenters)
    target_cos = collectives.model_psum(part, mesh)
    t_new = curricular_t(target_cos, t, mesh, data_sync)
    logits = curricular_logits(cos_c, one_hot, target_cos, t_new, cfg)
    weight = column_weight(index, one_hot.shape[1], total_classes,
                           w_shard.device)
    return masked_nll(logits, weight, one_hot, mesh), t_new
