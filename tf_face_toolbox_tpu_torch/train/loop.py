"""The training loop: batches -> step_fn -> metrics.

Counterpart of ``tf_face_toolbox_tpu/train/loop.py`` without
checkpoints: ``train_dir``, ``eval_fn``, ``keep_best``, ``warm_start``
and ``teacher`` raise naming ROADMAP.md §1 item 12. Metrics stay on the
device between log points (``log_every``); the ``skip_nonfinite``
flags settle every min(log_every, 100, max_consecutive_skips) steps and
at log points, and ``max_consecutive_skips`` skips in a row raise
``FloatingPointError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from tf_face_toolbox_tpu_torch.train.state import TrainState
from tf_face_toolbox_tpu_torch.train.trainer import (
    TrainConfig,
    create_train_state,
    make_train_step,
)
from tf_face_toolbox_tpu_torch.utils.metrics import MetricLogger


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    last_metrics: dict


def train_loop(cfg: TrainConfig, batches: Iterator[dict], *,
               num_steps: int,
               train_dir: str | None = None,
               log_every: int = 100,
               net=None,
               rng_seed: int = 0,
               logger: MetricLogger | None = None,
               eval_fn=None,
               keep_best: str = "",
               should_stop: Callable[[], bool] | None = None,
               warm_start=None,
               teacher=None,
               max_consecutive_skips: int = 100,
               device="cuda") -> LoopResult:
    """Train a fresh state for ``num_steps`` steps on ``device``.

    ``batches`` yields {'image', 'label'} (numpy or tensors on
    ``device``). ``should_stop``: polled before each step; a True ends
    the loop early (``last_metrics["preempted"]`` = 1).
    """
    for name, value in (("train_dir (checkpoints, resume)", train_dir),
                        ("eval_fn", eval_fn), ("keep_best", keep_best),
                        ("warm_start (fine-tune)", warm_start),
                        ("teacher (distillation)", teacher)):
        if value:
            raise NotImplementedError(f"train_loop {name} is not ported yet "
                                      "(ROADMAP.md §1 item 12)")
    state, net = create_train_state(cfg, rng_seed, net=net, device=device)
    step_fn = make_train_step(net, cfg, state)
    logger = logger or MetricLogger(batch_size=cfg.global_batch)

    metrics: dict = {}
    preempted = False
    skip_pending: list = []
    skip_total = skip_consec = 0
    settle_cadence = min(log_every or 100, 100,
                         max_consecutive_skips or 10**9)

    def settle_skips():
        nonlocal skip_total, skip_consec
        for v in skip_pending:
            if float(v) > 0:
                skip_total += 1
                skip_consec += 1
            else:
                skip_consec = 0
        skip_pending.clear()
        if max_consecutive_skips and skip_consec >= max_consecutive_skips:
            raise FloatingPointError(
                f"skip_nonfinite: {skip_consec} consecutive steps skipped "
                f"(>= {max_consecutive_skips}): the run has diverged "
                "(every batch gives a non-finite loss or gradient); lower "
                "the learning rate instead of skipping forever")

    def host_metrics():
        host = {k: float(v) for k, v in metrics.items()}
        if "skipped_nonfinite" in metrics:
            host["skipped_nonfinite_total"] = float(skip_total)
        return host

    while state.step < num_steps:
        if should_stop is not None and should_stop():
            preempted = True
            break
        batch = next(batches)
        state, metrics = step_fn(state, batch["image"], batch["label"])
        if "skipped_nonfinite" in metrics:
            skip_pending.append(metrics["skipped_nonfinite"])
            if len(skip_pending) >= settle_cadence:
                settle_skips()
        step = state.step
        if log_every and (step % log_every == 0 or step == num_steps):
            settle_skips()
            host = host_metrics()
            if not np.isfinite(host["loss"]) and not host.get(
                    "skipped_nonfinite"):
                # a skipped step held the state: survivable; an unguarded
                # one has already poisoned the weights
                raise FloatingPointError(
                    f"non-finite loss at step {step}: {host['loss']}")
            logger.log(step, host)
    logger.flush()
    settle_skips()
    host = host_metrics()
    host["preempted"] = float(preempted)
    return LoopResult(state=state, last_metrics=host)
