"""Train state: parameters, BN statistics, classifier, optimizer, RNG.

Counterpart of ``tf_face_toolbox_tpu/train/state.py``. ``params`` and
``batch_stats`` are the network's own tensors by ``state_dict`` name
(``BottleneckBlock_0.ConvBN_0.weight``, ``...BatchNorm_0.running_mean``):
the optimizer updates ``params`` in place, and the train step copies the
BN statistics a forward returned into ``batch_stats`` only when it
applies the step. The JAX key space is one ``interop.port.jax_leaves``
away.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class TrainState:
    step: int                          # steps taken, skipped ones included
    params: dict[str, torch.Tensor]    # f32 master weights (the module's)
    batch_stats: dict[str, torch.Tensor]   # BN running mean / var
    classifier: torch.Tensor           # (C * subcenters, D) f32
    # {"optimizer": a torch optimizer over params and classifier
    #  (train/optimizers.py), "name": its name (sgd, adam, adamw, lars),
    #  "count": updates applied}. The learning rate follows the count
    # (a skipped step holds it), as optax's schedule count does.
    opt_state: dict[str, Any]
    # Seed of the per-step generators: step s augments and drops out
    # with generators seeded from (rng, s, stream) — not JAX's threefry
    # stream, which the port does not reproduce.
    rng: int
    ema_params: dict[str, torch.Tensor] | None = None   # EMA of params
    # the loss heads' state, None without one: {"adaface": {"norm_mean",
    # "norm_std"}, "curricular": {"t"}, "centers": (C_pad / model, D)
    # f32, this rank's shard of the center table}
    head_state: dict[str, Any] | None = None


def head_leaves(head_state: dict | None) -> dict[str, torch.Tensor]:
    """A loss-head state's tensors by path: ``adaface/norm_mean``,
    ``adaface/norm_std``, ``curricular/t``, ``centers`` (none without
    one)."""
    out = {}
    for name, value in (head_state or {}).items():
        if isinstance(value, dict):
            out.update({f"{name}/{k}": v for k, v in value.items()})
        else:
            out[name] = value
    return out
