"""The plain version of the train step: every rank in one process.

``replica_loop_step`` runs the ranks of a (world / model, model) step
one after another, each with its own rows of the global batch, its own
``TrainContext`` and generators (those of its rank), and sums by hand
what the collective step exchanges. For each data row it forwards the
row's ranks and takes the row's loss over the global (C_pad * K, D)
classifier's ``model`` shards by hand (the sampled head with each model
index's draws), the shards' parts combined as the collectives combine
them. Backward of each row's loss, the mean of the rows' gradients and
losses, and the mean of the ranks' BN running statistics make one
update. Up to two ranks a sum this is the collective step's arithmetic
in its order. The tests and the smoke hold the multi-process step
against it; no training path calls it.
"""

from __future__ import annotations

import torch

from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss
from tf_face_toolbox_tpu_torch.parallel.mesh import Topology
from tf_face_toolbox_tpu_torch.train.state import TrainState
from tf_face_toolbox_tpu_torch.train.trainer import StepParts, TrainConfig


def _row_loss(parts: StepParts, state: TrainState, emb: torch.Tensor,
              labels: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """A data row's mean loss, over the classifier's ``model`` shards by
    hand: ``emb``, ``labels`` its rows, ``pool`` the global
    (micro-)batch's labels (the sampled head's positives)."""
    cfg, w = parts.cfg, state.classifier
    rows = w.shape[0] // parts.model
    shards = [w[m * rows:(m + 1) * rows] for m in range(parts.model)]
    if parts.budget is None:
        blocks = [ss.exact_logits(emb, shard, labels, cfg.margin, m,
                                  cfg.num_classes, cfg.subcenters)
                  for m, shard in enumerate(shards)]
    else:
        ss.check_budget(parts.budget, rows, pool.shape[0])
        blocks = [ss.sampled_logits(
            emb, shard, labels, pool, cfg.margin,
            ss.draw_uniforms(parts.pfc_generator(state, m), rows),
            parts.budget, m, cfg.num_classes)
            for m, shard in enumerate(shards)]
    return ss.masked_nll_of_shards(blocks)


def replica_loop_step(net: torch.nn.Module, cfg: TrainConfig,
                      state: TrainState, images, labels, world: int,
                      model: int = 1) -> tuple[TrainState, dict]:
    """One step of ``world`` ranks, ``model`` to a data row, on the global
    batch (``images``, ``labels``: ``cfg.global_batch`` rows), in place;
    ``state`` holds the global classifier. Returns (state, metrics) as
    the collective step does."""
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
    grads = loss = None
    for d in range(data):
        row = range(d * model, (d + 1) * model)
        for p in (*state.params.values(), state.classifier):
            p.grad = None
        losses = []
        for j in range(k):
            emb = torch.cat([net(xs[r][j], train=ctxs[r]).to(torch.float32)
                             for r in row])
            micro = _row_loss(parts, state, emb,
                              torch.cat([ys[r][j] for r in row]), pools[j])
            micro.backward()
            losses.append(micro.detach())
        loss_d = losses[0] if k == 1 else torch.stack(losses).mean()
        grads_d = [g.clone() for g in parts.grads(state)]
        if k > 1:
            torch._foreach_div_(grads_d, float(k))
        if grads is None:
            grads, loss = grads_d, loss_d
            continue
        torch._foreach_add_(grads, grads_d)
        loss = loss + loss_d
    for p, g in zip((*state.params.values(), state.classifier), grads):
        p.grad = g.div_(data)
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
    return parts.apply(state, loss / data, stats)
