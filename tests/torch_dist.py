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

from tf_face_toolbox_tpu_torch.parallel.mesh import Topology

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

_GRIDS: dict = {}


def grid(topo, model: int):
    """This rank's topology on a (world / model, model) grid of the same
    ranks (its axes' groups created once a process)."""
    if model == topo.model:
        return topo
    if model not in _GRIDS:
        from tf_face_toolbox_tpu_torch.parallel.mesh import create_topology

        _GRIDS[model] = create_topology(topo.world, model=model,
                                        rank=topo.rank,
                                        local_rank=topo.local_rank,
                                        device=topo.device)
    return _GRIDS[model]


class installed_draws:
    """Within the block, ``sharded_softmax.draw_uniforms`` returns
    ``table[generator.initial_seed()]`` (the JAX head's draws, computed
    by a test); None leaves the port's own draws."""

    def __init__(self, table):
        self.table = table

    def __enter__(self):
        from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss

        self.real = ss.draw_uniforms
        if self.table is not None:
            table = self.table

            def drawn(generator, c_local):
                u = torch.tensor(table[generator.initial_seed()])
                assert u.shape == (c_local,)
                return u.to(generator.device)

            ss.draw_uniforms = drawn

    def __exit__(self, *exc):
        from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss

        ss.draw_uniforms = self.real


def batches(nan_at=None, steps=STEPS, seed=7, u8=False, classes=CLASSES,
            rows=BATCH):
    """The parity runs' global f32 batches of ``rows`` (``u8``: uint8
    faces of 20 x 20, for the augment) with labels in [0, ``classes``);
    ``nan_at``: the step whose row 0 (rank 0's) holds a NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(steps):
        if u8:
            x = rng.integers(0, 256, (rows, 20, 20, 3), np.uint8)
        else:
            x = rng.standard_normal((rows, SIZE, SIZE, 3)).astype(
                np.float32)
        if i == nan_at:
            x[0, 0, 0, 0] = np.nan
        out.append((x, rng.integers(0, classes, rows).astype(np.int32)))
    return out


def head_snapshot(head_state) -> dict | None:
    """Host copies of a state's loss-head state, flat: ``adaface/norm_mean``,
    ``adaface/norm_std``, ``curricular/t``, ``centers`` (None without
    one)."""
    from tf_face_toolbox_tpu_torch.train.state import head_leaves

    if not head_state:
        return None
    return {k: v.detach().cpu().numpy().copy()
            for k, v in head_leaves(head_state).items()}


def snapshot(state) -> dict:
    """Host copies of a state in the JAX key space and layouts: variables,
    classifier, momentum (as ``momentum/<key>``), the other optimizers'
    state (``opt``: ``<slot>/<parameter name>``, Adam's moments and step,
    LARS's trace), EMA, the loss-head state (``head_snapshot``) and the
    step."""
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
    slots = {f"{slot}/{name}": t.detach().cpu().numpy().copy()
             for name, p in {**state.params,
                             "classifier": state.classifier}.items()
             for slot, t in opt.state.get(p, {}).items()
             if slot != "momentum_buffer"}
    return {"vars": named_to_flat({**state.params, **state.batch_stats}),
            "opt": slots,
            "classifier": state.classifier.detach().cpu().numpy().copy(),
            "momentum": {"params": named_to_flat(momentum),
                         "classifier": (None if cls_buf is None else
                                        cls_buf.cpu().numpy().copy())},
            "ema": (named_to_flat(state.ema_params)
                    if state.ema_params is not None else None),
            "head": head_snapshot(state.head_state),
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
                steps=STEPS, seed=0, u8=False, model=1, classes=CLASSES,
                draws=None, keep_snapshots=True,
                data_seed=7, teacher_flat=None) -> tuple[list, list, int]:
    """``steps`` steps of the collective step on ``batches``, the ranks on
    a (world / ``model``, ``model``) grid (``draws``: the sampled head's
    keys by generator seed, see ``installed_draws``; ``teacher_flat``: a
    distillation teacher's variables, a network as the student's):
    (metrics and snapshot after each, its classifier a shard, kernel 1
    launches)."""
    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_preprocess)
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    mesh = grid(topo, model)
    cfg = TrainConfig(**{**BASE, **cfg_kw})
    state, net = create_train_state(cfg, seed, variables=flat,
                                    classifier=cls, mesh=mesh,
                                    device=topo.device)
    teacher = None
    if teacher_flat is not None:
        from tf_face_toolbox_tpu_torch.train.trainer import build_network
        teacher = (build_network(cfg), teacher_flat)
    step_fn = make_train_step(net, cfg, state, mesh=mesh, teacher=teacher)
    metrics, snaps = [], []
    launches = fused_preprocess.launches
    with installed_draws(draws):
        for x, y in batches(nan_at, steps, data_seed, u8=u8,
                            classes=classes, rows=cfg.global_batch):
            state, m = step_fn(state, x, y)
            metrics.append({k: float(v) for k, v in m.items()})
            if keep_snapshots:
                snaps.append(snapshot(state))
    return metrics, snaps, fused_preprocess.launches - launches


def replica_steps(cfg_kw: dict, world: int, flat=None, cls=None,
                  nan_at=None, steps=STEPS, seed=0, device="cpu", u8=False,
                  model=1, classes=CLASSES, draws=None, data_seed=7):
    """The same steps through ``parallel.reference.replica_loop_step`` in
    this process (its classifier global)."""
    from tf_face_toolbox_tpu_torch.parallel.reference import replica_loop_step
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state)

    cfg = TrainConfig(**{**BASE, **cfg_kw})
    state, net = create_train_state(
        cfg, seed, variables=flat, classifier=cls, device=device,
        mesh=Topology(data=world // model, model=model),
        whole_classifier=True)
    metrics, snaps = [], []
    with installed_draws(draws):
        for x, y in batches(nan_at, steps, data_seed, u8=u8,
                            classes=classes, rows=cfg.global_batch):
            state, m = replica_loop_step(net, cfg, state, x, y, world,
                                         model=model)
            metrics.append({k: float(v) for k, v in m.items()})
            snaps.append(snapshot(state))
    return metrics, snaps


def join_shards(snaps: list) -> dict:
    """One snapshot with the classifier and its momentum reassembled from
    the model row's shards (``snaps``: the row's ranks in model order)."""
    out = dict(snaps[0])
    out["classifier"] = np.concatenate([s["classifier"] for s in snaps])
    cls = [s["momentum"]["classifier"] for s in snaps]
    out["momentum"] = {**snaps[0]["momentum"], "classifier": (
        None if cls[0] is None else np.concatenate(cls))}
    out["opt"] = {k: (np.concatenate([s["opt"][k] for s in snaps])
                      if k.endswith("/classifier") and v.ndim else v)
                  for k, v in snaps[0]["opt"].items()}
    if out.get("head") and "centers" in out["head"]:
        out["head"] = {**out["head"], "centers": np.concatenate(
            [s["head"]["centers"] for s in snaps])}
    return out


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

    def counted(self, state, step, *tensors):
        writes.append(step)
        return real_write(self, state, step, *tensors)

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


def _blocks(mesh, emb, w, labels, *rows_arrays):
    """This rank's data block of ``emb``, ``labels`` and each of
    ``rows_arrays`` (None stays None) as tensors, and its model shard of
    ``w``; ``emb`` and the shard require grad."""
    rows = emb.shape[0] // mesh.data
    d, m = mesh.data_index, mesh.model_index
    shard = w.shape[0] // mesh.model
    block = slice(d * rows, (d + 1) * rows)
    e = torch.tensor(emb[block], requires_grad=True)
    ws = torch.tensor(w[m * shard:(m + 1) * shard], requires_grad=True)
    y = torch.as_tensor(labels[block]).long()
    return (e, ws, y, *(None if a is None else torch.tensor(a[block])
                        for a in rows_arrays))


def sharded_head(topo, model: int, emb, w, labels, margin: dict,
                 total_classes=None, subcenters=1, budget=None,
                 data_sync=False, seeds=None, draws=None, repeats=1,
                 extra_m2=None, extra_m3=None):
    """The class-sharded head on the ranks' (world / ``model``,
    ``model``) grid: each data index takes its block of the rows of
    ``emb`` / ``labels`` (and of the per-sample margins ``extra_m2`` /
    ``extra_m3``; all of them at data 1), each model index its shard of
    ``w`` (numpy). Exact, or sampled at ``budget`` with this shard's
    generator seeded ``seeds[model index]`` (the seeds of the
    ``repeats`` draws follow on from it). Backward of the loss over the
    model size; returns (loss, its emb gradient, its shard gradient), the
    gradients averaged over ``repeats`` draws."""
    from tf_face_toolbox_tpu_torch.ops.losses import MarginConfig
    from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss

    mesh = grid(topo, model)
    cfg = MarginConfig(**margin)
    m = mesh.model_index
    e, ws, y, m2, m3 = _blocks(mesh, emb, w, labels, extra_m2, extra_m3)
    losses = []
    with installed_draws(draws):
        for i in range(repeats):
            if budget is None:
                loss = ss.sharded_margin_softmax_loss(
                    e, ws, y, cfg, mesh, total_classes=total_classes,
                    extra_m2=m2, extra_m3=m3, subcenters=subcenters)
            else:
                gen = torch.Generator().manual_seed(seeds[m] + i * model)
                loss = ss.sampled_sharded_margin_softmax_loss(
                    e, ws, y, cfg, gen, budget, mesh,
                    total_classes=total_classes, extra_m2=m2,
                    extra_m3=m3, data_sync=data_sync)
            (loss / model).backward()
            losses.append(loss.item())
    return (float(np.mean(losses)), e.grad.numpy() / repeats,
            ws.grad.numpy() / repeats)


def center_head(topo, model: int, emb, centers, labels, alpha: float):
    """The class-sharded center loss and update on the (world / ``model``,
    ``model``) grid, blocks as ``sharded_head``'s: (the loss, its emb
    gradient (backward over the model size), this rank's updated center
    shard)."""
    from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss

    mesh = grid(topo, model)
    e, c, y = _blocks(mesh, emb, centers, labels)
    loss = ss.sharded_center_loss(e, c, y, mesh)
    (loss / model).backward()
    new = ss.sharded_center_update(e, c, y, mesh, alpha=alpha)
    return loss.item(), e.grad.numpy(), new.detach().numpy()


def curricular_head(topo, model: int, emb, w, labels, margin: dict,
                    t: float, total_classes=None, subcenters=1,
                    data_sync=False):
    """The class-sharded CurricularFace on the (world / ``model``,
    ``model``) grid, blocks as ``sharded_head``'s: (the loss, t', its
    emb gradient, its shard gradient; backward over the model size)."""
    from tf_face_toolbox_tpu_torch.ops.losses import MarginConfig
    from tf_face_toolbox_tpu_torch.parallel import sharded_softmax as ss

    mesh = grid(topo, model)
    e, ws, y = _blocks(mesh, emb, w, labels)
    loss, t_new = ss.sharded_curricular_loss(
        e, ws, y, MarginConfig(**margin), torch.tensor(t), mesh,
        total_classes=total_classes, subcenters=subcenters,
        data_sync=data_sync)
    (loss / model).backward()
    return loss.item(), t_new.item(), e.grad.numpy(), ws.grad.numpy()


def checkpoint_round_trip(topo, train_dir: str, model: int,
                          cfg_kw: dict) -> dict:
    """One step on the grid, a save, a fresh state restored from it (its
    snapshot against the saved one's), and a restore into a state of
    another class count (the error)."""
    import dataclasses

    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    mesh = grid(topo, model)
    cfg = TrainConfig(**{**BASE, **cfg_kw})
    state, net = create_train_state(cfg, 0, mesh=mesh, device=topo.device)
    step_fn = make_train_step(net, cfg, state, mesh=mesh)
    x, y = batches(steps=1, classes=cfg.num_classes,
                   rows=cfg.global_batch)[0]
    state, _ = step_fn(state, x, y)
    mgr = CheckpointManager(train_dir, mesh=mesh)
    mgr.maybe_save(state, force=True)
    fresh, _ = create_train_state(cfg, 1, mesh=mesh, device=topo.device)
    mgr.restore(fresh)
    other, _ = create_train_state(
        dataclasses.replace(cfg, num_classes=cfg.num_classes + model),
        0, mesh=mesh, device=topo.device)
    try:
        mgr.restore(other)
        error = ""
    except ValueError as e:
        error = str(e)
    return {"saved": snapshot(state), "restored": snapshot(fresh),
            "error": error, "shapes": mgr.global_shapes()}


def state_at(snap: dict, cfg, mesh=None, whole=False, device="cpu"):
    """A port state at ``snap`` (a snapshot in the JAX key space, the
    port's or the JAX trainer's): variables, global classifier and
    center table (this rank's shards of them, or all with ``whole``),
    momentum buffers, EMA, the rest of the loss-head state, step and
    count. Returns (state, net)."""
    from tf_face_toolbox_tpu_torch.interop import port
    from tf_face_toolbox_tpu_torch.train.trainer import create_train_state

    state, net = create_train_state(
        cfg, 0, variables=snap["vars"], classifier=snap["classifier"],
        mesh=mesh, whole_classifier=whole, device=device)
    rows = state.classifier.shape[0]
    index = 0 if whole or mesh is None else mesh.model_index
    mom = snap["momentum"]
    if mom["classifier"] is not None:
        opt = state.opt_state["optimizer"]
        for name, p in state.params.items():
            key, kind = port.jax_key(name, p)
            opt.state[p] = {"momentum_buffer": port.from_jax_layout(
                mom["params"][key], kind).to(device)}
        opt.state[state.classifier] = {"momentum_buffer": torch.tensor(
            mom["classifier"][index * rows:(index + 1) * rows]).to(device)}
    if snap["ema"] is not None:
        with torch.no_grad():
            for name, e in state.ema_params.items():
                key, kind = port.jax_key(name, e)
                e.copy_(port.from_jax_layout(snap["ema"][key], kind))
    for key, value in (snap.get("head") or {}).items():
        value = torch.tensor(np.asarray(value, np.float32), device=device)
        if key == "centers":
            shard = state.head_state["centers"].shape[0]
            state.head_state[key] = value[index * shard:(index + 1) * shard]
        else:
            name, leaf = key.split("/")
            state.head_state[name][leaf] = value
    state.step = snap["step"]
    state.opt_state["count"] = snap.get("count", snap["step"])
    return state, net


def steps_from(topo, cfg_kw: dict, starts: list, model=1, classes=CLASSES,
               draws=None, data_seed=7, world=None, device="cpu",
               u8=False) -> list:
    """One step from each state of ``starts`` (snapshots), on its step's
    batch of ``batches``: on the ranks' grid, or with ``topo`` None
    through ``replica_loop_step`` of ``world`` ranks in this process (on
    ``device``). Returns (metrics, snapshot) of each."""
    from tf_face_toolbox_tpu_torch.parallel.reference import replica_loop_step
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, make_train_step)

    cfg = TrainConfig(**{**BASE, **cfg_kw})
    data = batches(None, max(s["step"] for s in starts) + 1, data_seed,
                   u8=u8, classes=classes, rows=cfg.global_batch)
    out = []
    with installed_draws(draws):
        for snap in starts:
            x, y = data[snap["step"]]
            if topo is None:
                state, net = state_at(snap, cfg, Topology(
                    data=world // model, model=model), whole=True,
                    device=device)
                state, m = replica_loop_step(net, cfg, state, x, y, world,
                                             model=model)
            else:
                mesh = grid(topo, model)
                state, net = state_at(snap, cfg, mesh, device=topo.device)
                state, m = make_train_step(net, cfg, state, mesh=mesh)(
                    state, x, y)
            out.append(({k: float(v) for k, v in m.items()},
                        snapshot(state)))
    return out


def extract_ranks(topo, shard: str, flat: dict, output: str, batch: int,
                  chunk_rows: int, net_kw: dict) -> tuple:
    """Data-parallel extraction of ``shard`` on the ranks (a resnet_tiny
    holding ``flat``, 16 px crops of 20 px faces, the python loader):
    (one-shot embeddings, quality, this rank's return of the resumable
    ``.npy`` writer into ``output``: the array on rank 0, None elsewhere)."""
    from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource
    from tf_face_toolbox_tpu_torch.extract import (
        extract_shard, extract_shard_to_npy, make_extract_fn)
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network

    net = load_jax_variables(create_network("resnet_tiny", **net_kw),
                             flat).eval()
    src = FaceShardSource(shard)
    kw = dict(image_size=16, crop_from=20, batch=batch, num_threads=1,
              loader="python", device=topo.device)
    emb, quality = extract_shard(
        net, flat, src, with_quality=True,
        extract_fn=make_extract_fn(net, with_quality=True, mesh=topo), **kw)
    out = extract_shard_to_npy(net, flat, src, output, chunk_rows=chunk_rows,
                               extract_fn=make_extract_fn(net, mesh=topo),
                               mesh=topo, **kw)
    return emb, quality, None if out is None else np.array(out)
