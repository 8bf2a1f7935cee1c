"""The plain version of the data-parallel step: W replicas in one process.

``replica_loop_step`` runs the ranks of a ``world``-rank step one after
another: each takes its rows of the global batch, augments, forwards and
backwards with its own ``TrainContext`` and generators (those of its
rank), and keeps its gradients, loss and BN running statistics; their
means then make one update, as the collective step's averages do. The
tests and the smoke hold the multi-process step against it; no training
path calls it.
"""

from __future__ import annotations

import torch

from tf_face_toolbox_tpu_torch.parallel.mesh import Topology
from tf_face_toolbox_tpu_torch.train.state import TrainState
from tf_face_toolbox_tpu_torch.train.trainer import StepParts, TrainConfig


def replica_loop_step(net: torch.nn.Module, cfg: TrainConfig,
                      state: TrainState, images, labels,
                      world: int) -> tuple[TrainState, dict]:
    """One step of ``world`` replicas on the global batch (``images``,
    ``labels``: ``cfg.global_batch`` rows), in place; returns (state,
    metrics) as the collective step does."""
    parts = StepParts(net, cfg, state,
                      Topology(data=world, device=state.classifier.device))
    images, labels = torch.as_tensor(images), torch.as_tensor(labels)
    if images.shape[0] != cfg.global_batch:
        raise ValueError(f"{images.shape[0]} rows, not the global batch "
                         f"{cfg.global_batch}")
    n = parts.rows_a_rank
    grads = loss = stats = None
    for r in range(world):
        x = images[r * n:(r + 1) * n].to(parts.device)
        y = labels[r * n:(r + 1) * n].to(device=parts.device,
                                         dtype=torch.long)
        loss_r, stats_r = parts.local(state, x, y, r)
        grads_r = [g.clone() for g in parts.grads(state)]
        if grads is None:
            grads, loss = grads_r, loss_r
            stats = {m: (mean.clone(), var.clone())
                     for m, (mean, var) in stats_r.items()}
            continue
        torch._foreach_add_(grads, grads_r)
        loss = loss + loss_r
        for m, (mean, var) in stats_r.items():
            stats[m][0].add_(mean)
            stats[m][1].add_(var)
    for p, g in zip((*state.params.values(), state.classifier), grads):
        p.grad = g.div_(world)
    for mean, var in stats.values():
        mean.div_(world)
        var.div_(world)
    return parts.apply(state, loss / world, stats)
