"""The training loop: batches -> step_fn -> metrics -> checkpoints ->
resume.

Counterpart of ``tf_face_toolbox_tpu/train/loop.py``, on one device or
on every rank of a data-parallel run (``mesh``: a
``parallel.mesh.Topology``; each rank runs the loop on its own batches).
A ``train_dir`` holding a checkpoint resumes from its latest step (the
caller aligns the data iterator); ``warm_start`` applies only to a fresh
start. Metrics stay on the device between log points (``log_every``);
the ``skip_nonfinite`` flags settle every min(log_every, 100,
max_consecutive_skips) steps and at log points, and
``max_consecutive_skips`` skips in a row raise ``FloatingPointError``.
``teacher`` distils into the student (``make_train_step``'s).

With several ranks: only rank 0 logs, writes metrics, runs the eval
hook and writes checkpoints (``CheckpointManager``); the eval value is
broadcast from it, so ``keep_best`` decides the same everywhere; and
the ranks agree to stop (``should_stop``) by an all-reduce of their
flags every 10 steps, since a rank that broke alone would leave the
others waiting in the next step's all-reduce.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator

import numpy as np

from tf_face_toolbox_tpu_torch.parallel import collectives
from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
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
               save_every: int = 1000,
               log_every: int = 100,
               net=None,
               rng_seed: int = 0,
               logger: MetricLogger | None = None,
               eval_fn=None,
               eval_every: int = 0,
               keep_best: str = "",
               should_stop: Callable[[], bool] | None = None,
               warm_start=None,
               teacher=None,
               max_consecutive_skips: int = 100,
               mesh=None,
               input_format: str = "u8",
               device="cuda") -> LoopResult:
    """Run (or resume) training to ``num_steps`` total steps on ``device``.

    ``batches`` yields {'image', 'label'} (numpy or tensors on
    ``device``). ``train_dir``: checkpoints every ``save_every`` steps
    and at the end; a checkpoint there is resumed from, with the
    optimizer, BN statistics, step and rng as saved. ``warm_start``:
    ``state -> state`` (``train.finetune``), applied only when the run
    starts fresh. ``eval_fn(state) -> {name: value}`` every
    ``eval_every`` steps, logged as ``eval/<name>``; ``keep_best`` names
    one of its metrics (higher is better) whose improvements are saved
    to ``<train_dir>/best``. ``should_stop``: polled before each step; a
    True ends the loop early and flushes a checkpoint at the current
    step (``last_metrics["preempted"]`` = 1). ``mesh``: this rank's
    topology (``device`` is then its device). ``teacher``: a frozen
    distillation teacher, a module or ``(module, variables)``, as
    ``make_train_step`` takes it. ``input_format="dct"``: the batches'
    images are (coef, qtab) pairs (``native_dct_batch_iterator``).
    """
    if mesh is not None:
        device = mesh.device
    main = mesh is None or mesh.is_main
    state, net = create_train_state(cfg, rng_seed, net=net, mesh=mesh,
                                    device=device)
    resumed = False
    mgr = None
    if train_dir:
        mgr = CheckpointManager(train_dir, save_every=save_every, mesh=mesh)
        if mgr.latest_step() is not None:
            # restore raises the config-mismatch errors (EMA, head state)
            state = mgr.restore(state)
            resumed = True
            logging.info("resumed from step %d in %s", state.step,
                         mgr.directory)
    if warm_start is not None and not resumed:
        state = warm_start(state)
    step_fn = make_train_step(net, cfg, state, mesh=mesh, teacher=teacher,
                              input_format=input_format)
    logger = logger or MetricLogger(train_dir if main else None,
                                    batch_size=cfg.global_batch)
    stop_sync = 10 if mesh is not None and mesh.distributed else 1

    metrics: dict = {}
    preempted = False
    keep_best_warned = False
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
        if (should_stop is not None and state.step % stop_sync == 0
                and collectives.any_rank(should_stop(), mesh)):
            # preemption: the checkpoint below is flushed at the CURRENT
            # step, so no finished step is lost
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
            if main:
                logger.log(step, host)
        if eval_fn is not None and eval_every and step % eval_every == 0:
            eval_metrics = {}
            if main:
                eval_metrics = eval_fn(state)
                logger.log(step, {f"eval/{k}": v
                                  for k, v in eval_metrics.items()})
            if keep_best and mgr is not None:
                val = eval_metrics.get(keep_best)
                if val is None and eval_metrics and not keep_best_warned:
                    # a typo'd metric name would otherwise no-op for the
                    # whole run with no diagnostic
                    logging.warning(
                        "keep_best=%r is not among the eval metrics %s: "
                        "no best checkpoint will be saved", keep_best,
                        sorted(eval_metrics))
                    keep_best_warned = True
                # rank 0's value (f64), so every rank decides alike
                val = collectives.broadcast_value(
                    float("nan") if val is None else float(val), mesh)
                if np.isfinite(val):
                    mgr.save_best(state, step=step, metric=val,
                                  name=keep_best)
        if mgr is not None:
            mgr.maybe_save(state, step=step)
    if mgr is not None:
        mgr.maybe_save(state, force=True)
    logger.flush()
    settle_skips()
    host = host_metrics()
    host["preempted"] = float(preempted)
    return LoopResult(state=state, last_metrics=host)
