"""The plain version of the train step: every rank in one process.

``replica_loop_step`` runs the ranks of a (world / model, model) step
one after another, each with its own rows of the global batch, its own
``TrainContext`` and generators (those of its rank), and sums by hand
what the collective step exchanges. It forwards every rank's rows
first, so that the heads' global-batch statistics (AdaFace's norm
moments, CurricularFace's mean target cosine) are taken over every
row; then for each data row it takes the row's objective over the
global (C_pad * K, D) classifier's ``model`` shards by hand (the
sampled head with each model index's draws), the shards' parts combined
as the collectives combine them, and the center and triplet losses on
the row's rows against the whole center table. Backward of each row's
objective, the mean of the rows' gradients and terms, the mean of the
ranks' BN running statistics, and the center update over the global
batch make one update. Up to two ranks a sum this is the collective
step's arithmetic in its order. The tests and the smoke hold the
multi-process step against it; no training path calls it.
"""

from __future__ import annotations

import torch

from tf_face_toolbox_tpu_torch.ops.losses import adaface_norms
from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss
from tf_face_toolbox_tpu_torch.parallel.mesh import Topology
from tf_face_toolbox_tpu_torch.train.state import TrainState
from tf_face_toolbox_tpu_torch.train.trainer import (
    StepParts,
    TrainConfig,
    adaface_moments,
    mean_terms,
)


def _shards(parts: StepParts, state: TrainState) -> list[torch.Tensor]:
    w = state.classifier
    rows = w.shape[0] // parts.model
    return [w[m * rows:(m + 1) * rows] for m in range(parts.model)]


def _curricular_rows(parts: StepParts, state: TrainState, embs: list,
                     labs: list) -> tuple[list, torch.Tensor]:
    """Each data row's shards' ``target_cosines`` and target cosine, and
    t' from the rows' mean target cosines (the mean over the data axis
    of each row's)."""
    cfg, shards = parts.cfg, _shards(parts, state)
    rows = []
    for emb, labels in zip(embs, labs):
        pieces = [ss.target_cosines(emb, shard, labels, m, cfg.subcenters)
                  for m, shard in enumerate(shards)]
        rows.append((pieces, sum(part for _, _, part in pieces)))
    # the mean over the data rows of each row's mean, as data_pmean takes
    t_new = ss.curricular_t(torch.stack([tgt.mean() for _, tgt in rows]),
                            state.head_state["curricular"]["t"])
    return rows, t_new


def _row_objective(parts: StepParts, state: TrainState, emb: torch.Tensor,
                   labels: torch.Tensor, pool: torch.Tensor, moments,
                   curricular) -> tuple[torch.Tensor, dict, dict]:
    """A data row's ``StepParts.objective``, its margin head over the
    classifier's ``model`` shards by hand: ``emb``, ``labels`` its rows,
    ``pool`` the global (micro-)batch's labels (the sampled head's
    positives), ``curricular`` the row's (``target_cosines`` of each
    shard, target cosine) and t'."""
    cfg, shards = parts.cfg, _shards(parts, state)
    rows = shards[0].shape[0]

    def margin_loss(extra_m2, extra_m3):
        if curricular is not None:
            (pieces, target_cos), t_new = curricular
            blocks = [(ss.curricular_logits(cos_c, one_hot, target_cos,
                                            t_new, cfg.margin),
                       ss.column_weight(m, one_hot.shape[1],
                                        cfg.num_classes, emb.device),
                       one_hot)
                      for m, (cos_c, one_hot, _) in enumerate(pieces)]
            return ss.masked_nll_of_shards(blocks), t_new
        if parts.budget is None:
            blocks = [ss.exact_logits(emb, shard, labels, cfg.margin, m,
                                      cfg.num_classes, cfg.subcenters,
                                      extra_m2, extra_m3)
                      for m, shard in enumerate(shards)]
        else:
            ss.check_budget(parts.budget, rows, pool.shape[0])
            blocks = [ss.sampled_logits(
                emb, shard, labels, pool, cfg.margin,
                ss.draw_uniforms(parts.pfc_generator(state, m), rows),
                parts.budget, m, cfg.num_classes, None, extra_m2, extra_m3)
                for m, shard in enumerate(shards)]
        return ss.masked_nll_of_shards(blocks)

    return parts.objective(state, emb, labels, margin_loss, moments)


def replica_loop_step(net: torch.nn.Module, cfg: TrainConfig,
                      state: TrainState, images, labels, world: int,
                      model: int = 1) -> tuple[TrainState, dict]:
    """One step of ``world`` ranks, ``model`` to a data row, on the global
    batch (``images``, ``labels``: ``cfg.global_batch`` rows), in place;
    ``state`` holds the global classifier and center table. Returns
    (state, metrics) as the collective step does."""
    if world % model:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    data = world // model
    parts = StepParts(net, cfg, state, Topology(
        data=data, model=model, device=state.classifier.device))
    images, labels = torch.as_tensor(images), torch.as_tensor(labels)
    if images.shape[0] != cfg.global_batch:
        raise ValueError(f"{images.shape[0]} rows, not the global batch "
                         f"{cfg.global_batch}")
    n, k = parts.rows_a_rank, cfg.accum_steps
    ctxs, xs, ys = [], [], []
    for r in range(world):
        ctx, x = parts.prepare(state, images[r * n:(r + 1) * n].to(
            parts.device), r)
        ctxs.append(ctx)
        xs.append(x.chunk(k))
        ys.append(labels[r * n:(r + 1) * n].to(
            device=parts.device, dtype=torch.long).chunk(k))
    pools = [torch.cat([y[j] for y in ys]) for j in range(k)]
    for p in (*state.params.values(), state.classifier):
        p.grad = None
    # every rank's forwards first: the heads' statistics span the rows
    embs = [[torch.cat([net(xs[r][j], train=ctxs[r]).to(torch.float32)
                        for r in range(d * model, (d + 1) * model)])
             for j in range(k)] for d in range(data)]
    labs = [[torch.cat([ys[r][j] for r in range(d * model, (d + 1) * model)])
             for j in range(k)] for d in range(data)]
    # adaptive heads and centers refuse accumulation: k == 1 below
    moments = curricular = None
    if cfg.margin_mode == "adaface":
        moments = adaface_moments(adaface_norms(
            torch.cat([e[0] for e in embs])))
    elif cfg.margin_mode == "curricular":
        curricular = _curricular_rows(parts, state, [e[0] for e in embs],
                                      [y[0] for y in labs])
    grads = terms = update = None
    for d in range(data):
        for p in (*state.params.values(), state.classifier):
            p.grad = None
        steps = []
        for j in range(k):
            row_curricular = (None if curricular is None else
                              (curricular[0][d], curricular[1]))
            total, row_terms, update = _row_objective(
                parts, state, embs[d][j], labs[d][j], pools[j], moments,
                row_curricular)
            total.backward()
            steps.append(row_terms)
        terms_d = mean_terms(steps)
        grads_d = [g.clone() for g in parts.grads(state)]
        if k > 1:
            torch._foreach_div_(grads_d, float(k))
        if grads is None:
            grads, terms = grads_d, terms_d
            continue
        torch._foreach_add_(grads, grads_d)
        terms = {name: terms[name] + v for name, v in terms_d.items()}
    for p, g in zip((*state.params.values(), state.classifier), grads):
        p.grad = g.div_(data)
    if "centers" in update:
        # the center update's sums span the global batch
        update["centers"] = (torch.cat([e[0] for e in embs]).detach(),
                             torch.cat([y[0] for y in labs]))
    stats = {}
    for ctx in ctxs:
        for m, (mean, var) in ctx.stats.items():
            if m not in stats:
                stats[m] = (mean.clone(), var.clone())
            else:
                stats[m][0].add_(mean)
                stats[m][1].add_(var)
    for mean, var in stats.values():
        mean.div_(world)
        var.div_(world)
    return parts.apply(state, {name: v / data for name, v in terms.items()},
                       stats, update)
