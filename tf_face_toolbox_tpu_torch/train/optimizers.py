"""The optimizers of the train step, as optax computes them.

Counterpart of ``make_optimizer`` in ``tf_face_toolbox_tpu/train/trainer.py``
(optax 0.2.6): two parameter groups, decay on every JAX ``/kernel`` leaf
and the classifier, none on BatchNorm scales and biases or Dense biases.

- ``sgd``: L2 on the decayed leaves, then momentum (``optax.sgd``'s
  ``trace`` then the rate): ``torch.optim.SGD``, dampening 0.
- ``adam``: L2 on the decayed leaves added to the gradient, then
  ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected):
  ``torch.optim.Adam`` with per-group ``weight_decay``.
- ``adamw``: decoupled decay inside the update, times the scheduled rate
  (``optax.adamw(mask=)``): ``torch.optim.AdamW`` per group.
- ``lars``: ``optax.lars``, which torch lacks: :class:`LARS`.

Each optimizer's state is named by slot (``SLOTS``), which is what a
checkpoint saves per parameter.
"""

from __future__ import annotations

import torch

from tf_face_toolbox_tpu_torch.parallel import collectives

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
LARS_TRUST, LARS_EPS = 0.001, 0.0
# the per-parameter state each optimizer keeps, by torch's slot names
SLOTS = {"sgd": ("momentum_buffer",),
         "adam": ("step", "exp_avg", "exp_avg_sq"),
         "adamw": ("step", "exp_avg", "exp_avg_sq"),
         "lars": ("trace",)}


class LARS(torch.optim.Optimizer):
    """``optax.lars`` with its defaults: ``add_decayed_weights`` (the
    group's ``weight_decay``) -> ``scale_by_trust_ratio`` on every leaf
    (ratio ``LARS_TRUST * |p| / (|u| + LARS_EPS)``, 1 where either norm
    is 0) -> ``scale_by_learning_rate`` -> ``trace(momentum)``. The rate
    comes before the momentum, so the trace carries updates already
    scaled by the rate of their own step (SGD's applies the current rate
    to the whole trace).

    Each parameter is one JAX leaf and its norms are the leaf's. The
    parameters in ``sharded`` are this rank's shards of a leaf split over
    the model row of ``mesh``: their squared norms are summed over the
    row before the ratio. Every parameter needs a gradient (zeros where
    the loss does not reach it): optax updates every leaf.
    """

    def __init__(self, params, lr: float, *, momentum: float = 0.9,
                 sharded=(), mesh=None):
        super().__init__(params, {"lr": lr, "weight_decay": 0.0})
        self.momentum = momentum
        self.mesh = mesh
        self._sharded = {id(p) for p in sharded}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS takes no closure")
        for group in self.param_groups:
            params = list(group["params"])
            if any(p.grad is None for p in params):
                raise ValueError("LARS updates every leaf: give each "
                                 "parameter a gradient (zeros where none "
                                 "reaches it)")
            grads = [p.grad for p in params]
            wd = group["weight_decay"]
            updates = (torch._foreach_add(grads, params, alpha=wd) if wd
                       else [g.clone() for g in grads])
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(updates))
            shard = [i for i, p in enumerate(params)
                     if id(p) in self._sharded]
            if shard and collectives.model_sharded(self.mesh):
                sq = torch.stack([p_norm[shard], u_norm[shard]]).square()
                sq = collectives.model_psum(sq, self.mesh).sqrt()
                p_norm[shard], u_norm[shard] = sq[0], sq[1]
            ratio = LARS_TRUST * p_norm / (u_norm + LARS_EPS)
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(ratio), ratio)
            torch._foreach_mul_(updates, list(ratio.unbind()))
            torch._foreach_mul_(updates, -group["lr"])
            traces = []
            for p, u in zip(params, updates):
                st = self.state[p]
                if "trace" not in st:
                    # optax's trace starts at zero: u + momentum * 0 = u
                    st["trace"] = u
                    continue
                traces.append((st["trace"], u))
            if traces:
                ts = [t for t, _ in traces]
                torch._foreach_mul_(ts, self.momentum)
                torch._foreach_add_(ts, [u for _, u in traces])
            torch._foreach_add_(params, [self.state[p]["trace"]
                                         for p in params])


def build(name: str, groups: list[dict], *, lr: float, momentum: float,
          classifier: torch.Tensor, mesh=None) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``groups`` (each with its own
    ``weight_decay``); ``classifier`` is a shard of a leaf split over the
    model row of ``mesh`` (LARS's global norms)."""
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                               dampening=0.0)
    if name == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=ADAM_BETAS,
                                eps=ADAM_EPS)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=lr, betas=ADAM_BETAS,
                                 eps=ADAM_EPS)
    if name == "lars":
        return LARS(groups, lr, momentum=momentum, sharded=[classifier],
                    mesh=mesh)
    raise ValueError(f"unknown optimizer '{name}'; have sgd|adam|adamw|lars")
