"""Ranks of a gloo process group for the port's data-parallel tests.

JAX-free, so the card's test file can use it too. ``Ranks(world)``
spawns ``world`` processes once; each joins one gloo group through
``parallel.mesh.init_distributed`` (torchrun's environment variables,
set here) and then runs the functions it is sent:

    with Ranks(2) as ranks:
        per_rank = ranks.run(train_steps, cfg_kw=..., steps=3)

``fn(topo, **kwargs)`` must be a module-level function (sent by name);
its results come back by rank. A rank that raises fails the call with
its traceback, and a call that outlasts ``timeout`` kills the ranks;
the next call starts new ones.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import socket
import traceback

import numpy as np
import torch

# one test config for the parity runs: CosFace, momentum, weight decay,
# a staircase with a 2-step warmup and a boundary at step 2 (learning
# rates 0.025, 0.05, 0.025); tests/test_torch_trainer.py's, with its
# batch of 16 on each of two ranks
SIZE, CLASSES, BATCH, STEPS = 16, 12, 32, 3
BASE = dict(network="resnet_tiny", num_classes=CLASSES, embedding_dim=16,
            image_size=SIZE, global_batch=BATCH, base_lr=0.05,
            warmup_steps=2, lr_boundaries=(2,), lr_decay=0.5,
            momentum=0.9, weight_decay=5e-3, margin_scale=16.0,
            margin_m3=0.35, augment=False)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _serve(rank: int, world: int, port: int, device: str, tasks, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from tf_face_toolbox_tpu_torch.parallel.mesh import init_distributed

    try:
        topo = init_distributed(device, backend="gloo")
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            module, name, kwargs = task
            try:
                fn = getattr(importlib.import_module(module), name)
                results.put((rank, True, fn(topo, **kwargs)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    def __init__(self, world: int = 2, device: str = "cpu",
                 timeout: float = 300.0):
        self.world, self.device, self.timeout = world, device, timeout
        self._procs = None

    def _start(self):
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._results = ctx.Queue()
        port = free_port()
        self._procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, self.world, port, self.device, self._tasks[r], self._results))
            for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn, **kwargs) -> list:
        if self._procs is None:
            self._start()
        for q in self._tasks:
            q.put((fn.__module__, fn.__name__, kwargs))
        out, errors = {}, []
        try:
            for _ in range(self.world):
                rank, ok, value = self._results.get(timeout=self.timeout)
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break       # the others may wait in a collective
        except queue.Empty:
            errors.append(f"no result within {self.timeout} s")
        if errors:
            self.close(kill=True)
            raise AssertionError("\n".join(errors))
        return [out[r] for r in range(self.world)]

    def close(self, kill: bool = False):
        if self._procs is None:
            return
        if not kill:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if kill else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- what the ranks run --------------------------------------------------

def batches(nan_at=None, steps=STEPS, seed=7, u8=False):
    """The parity runs' global f32 batches (``u8``: uint8 faces of 20 x
    20, for the augment); ``nan_at``: the step whose row 0 (rank 0's)
    holds a NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        if u8:
            x = rng.integers(0, 256, (BATCH, 20, 20, 3), np.uint8)
        else:
            x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(
                np.float32)
        if i == nan_at:
            x[0, 0, 0, 0] = np.nan
        out.append((x, rng.integers(0, CLASSES, BATCH).astype(np.int32)))
    return out


def snapshot(state) -> dict:
    """Host copies of a state in the JAX key space and layouts: variables,
    classifier, momentum (as ``momentum/<key>``), EMA, and the step."""
    from tf_face_toolbox_tpu_torch.interop import port

    def named_to_flat(named):
        # copies: on the CPU the port's arrays share the live tensors
        return {k: v.copy() for k, v in port.named_to_flat(named).items()}

    opt = state.opt_state["optimizer"]
    momentum = {}
    for name, p in {**state.params, "classifier": state.classifier}.items():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            momentum[name] = buf
    cls_buf = momentum.pop("classifier", None)
    return {"vars": named_to_flat({**state.params, **state.batch_stats}),
            "classifier": state.classifier.detach().cpu().numpy().copy(),
            "momentum": {"params": named_to_flat(momentum),
                         "classifier": (None if cls_buf is None else
                                        cls_buf.cpu().numpy().copy())},
            "ema": (named_to_flat(state.ema_params)
                    if state.ema_params is not None else None),
            "step": state.step, "count": state.opt_state["count"]}


def describe(topo) -> tuple:
    return (topo.rank, topo.local_rank, topo.data, topo.nodes,
            topo.device.type)


def collectives_case(topo) -> tuple:
    """Each collective on rank-dependent values."""
    from tf_face_toolbox_tpu_torch.parallel import collectives

    r = topo.rank
    grads = [torch.full((3, 2), float(r + 1)), torch.arange(4.0) * (r + 1)]
    f64 = [torch.full((2,), 10.0 * (r + 1), dtype=torch.float64)]
    collectives.sync_gradients(grads, topo)
    collectives.sync_classifier_gradients(f64, topo)
    stats = [torch.tensor([float(r)])]
    collectives.sync_batch_stats(stats, topo)
    loss = collectives.replicate_mean(torch.tensor(2.0 * r), topo)
    value = collectives.broadcast_value(0.9 if r == 0 else 0.1, topo)
    anyone = collectives.any_rank(r == 1, topo)
    nobody = collectives.any_rank(False, topo)
    collectives.barrier(topo)
    try:
        collectives.check_replicated([torch.tensor([float(r)])], topo, "x")
        differs = ""
    except RuntimeError as e:
        differs = str(e)
    collectives.check_replicated([torch.ones(3)], topo, "y")
    return ([g.tolist() for g in grads], f64[0].tolist(), stats[0].item(),
            loss.item(), value, anyone, nobody, differs)


def train_steps(topo, cfg_kw: dict, flat=None, cls=None, nan_at=None,
                steps=STEPS, seed=0, u8=False) -> tuple[list, list, int]:
    """``steps`` steps of the data-parallel step on ``batches``: (metrics
    and snapshot after each, kernel 1 launches)."""
    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_preprocess)
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    cfg = TrainConfig(**{**BASE, **cfg_kw})
    state, net = create_train_state(cfg, seed, variables=flat,
                                    classifier=cls, mesh=topo,
                                    device=topo.device)
    step_fn = make_train_step(net, cfg, state, mesh=topo)
    metrics, snaps = [], []
    launches = fused_preprocess.launches
    for x, y in batches(nan_at, steps, u8=u8):
        state, m = step_fn(state, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(snapshot(state))
    return metrics, snaps, fused_preprocess.launches - launches


def replica_steps(cfg_kw: dict, world: int, flat=None, cls=None,
                  nan_at=None, steps=STEPS, seed=0, device="cpu", u8=False):
    """The same steps through ``parallel.reference.replica_loop_step`` in
    this process."""
    from tf_face_toolbox_tpu_torch.parallel.reference import replica_loop_step
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state)

    cfg = TrainConfig(**{**BASE, **cfg_kw})
    state, net = create_train_state(cfg, seed, variables=flat,
                                    classifier=cls, device=device)
    metrics, snaps = [], []
    for x, y in batches(nan_at, steps, u8=u8):
        state, m = replica_loop_step(net, cfg, state, x, y, world)
        metrics.append({k: float(v) for k, v in m.items()})
        snaps.append(snapshot(state))
    return metrics, snaps


def rank_batches(topo, start: int, rows: int, size: int = 20):
    """Rank ``topo.rank``'s uint8 rows for each step from ``start``, the
    same whichever step a run starts at."""
    step = start
    while True:
        rng = np.random.default_rng((7, topo.rank, step))
        yield {"image": rng.integers(0, 256, (rows, size, size, 3), np.uint8),
               "label": rng.integers(0, CLASSES, rows).astype(np.int32)}
        step += 1


def loop_run(topo, train_dir: str, num_steps: int, cfg_kw: dict,
             save_every: int = 100, eval_every: int = 0,
             stop_rank: int = -1, stop_at: int = 0) -> dict:
    """``train_loop`` over ``rank_batches`` with the augment on (resuming
    from ``train_dir``'s checkpoint): the final state, the checkpoint
    writes and eval calls this rank made, and the last metrics.
    ``eval_every``: an eval hook whose metric rises with the step, kept
    best. ``stop_rank`` asks to stop from step ``stop_at`` on that rank
    alone."""
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.loop import train_loop
    from tf_face_toolbox_tpu_torch.train.trainer import TrainConfig

    cfg = TrainConfig(**{**BASE, "augment": True, "crop_from": 20,
                         "random_erase": 0.5, **cfg_kw})
    start = CheckpointManager(train_dir).latest_step() or 0
    writes, evals = [], []
    real_write = CheckpointManager._write

    def counted(self, state, step):
        writes.append(step)
        return real_write(self, state, step)

    def eval_fn(state):
        evals.append(state.step)
        return {"acc": 0.5 + 0.01 * state.step}

    taken = [start]         # steps this rank has drawn a batch for

    def should_stop():
        return topo.rank == stop_rank and taken[0] >= stop_at

    def counting():
        for b in rank_batches(topo, start, cfg.global_batch // topo.data):
            taken[0] += 1
            yield b

    CheckpointManager._write = counted
    try:
        result = train_loop(cfg, counting(), num_steps=num_steps,
                            train_dir=train_dir, save_every=save_every,
                            log_every=1, rng_seed=3,
                            eval_fn=eval_fn if eval_every else None,
                            eval_every=eval_every,
                            keep_best="acc" if eval_every else "",
                            should_stop=should_stop, mesh=topo)
    finally:
        CheckpointManager._write = real_write
    return {"state": snapshot(result.state), "writes": writes,
            "evals": evals, "metrics": result.last_metrics}
