"""Training on the card: faces/sec/GPU of margin-softmax training, the
step's two augment routes held against each other, and remat's trade.

    python -m tf_face_toolbox_tpu_torch.bench_train [--batch 256]
        [--steps 20] [--warmup 5] [--remat false|true|save_convs]
        [--preset NAME] [--pfc_sample_rate R]
    torchrun --standalone --nproc_per_node <GPUs> -m \
        tf_face_toolbox_tpu_torch.bench_train --preset v5e8_data_parallel
    torchrun --standalone --nproc_per_node <GPUs> -m \
        tf_face_toolbox_tpu_torch.bench_train --preset large_id_pfc_v5e8 \
        --mesh_model <N>
    python -m tf_face_toolbox_tpu_torch.bench_train \
        --preset adaface_noisy_data
    python -m tf_face_toolbox_tpu_torch.bench_train --optimizer lars
    python -m tf_face_toolbox_tpu_torch.bench_train \
        --distill_from /tmp/run --distill_alpha 0.5

BASELINE config 4 at full width (or ``--preset``'s config: 5 is the
same network and head; 7 the same network with the class-sharded head
over 93,431 classes, sampled at 0.1, or exact with ``--pfc_sample_rate
1``; 8 AdaFace over 10,572 classes x 3 sub-centers, random erase 0.25,
cosine LR): ``resnet_v1_50`` (face stem, 512-d, bf16 compute, f32 master
weights), CosFace over 10,572 classes, SGD, synthetic uint8 faces (120 x
120, cropped to 112) through the host and device prefetch, kernel 1 on
the augment; ``--batch`` rows a GPU. Under torchrun every rank trains
over NCCL on a (ranks / ``--mesh_model``, ``--mesh_model``) grid
(``parallel/``) and rank 0 prints. ``time_training`` times ``steps``
steps with CUDA events after ``warmup``, then traces 5 more with
torch.profiler (device time by kernel kind, collectives included; the
head's cosine GEMMs, top-k and gathers as one kind; the idle share),
and counts the step's operations from the conv and Dense shapes and
the classifier columns scored; ``head`` names the loss head.
``--remat`` builds the network with that ``remat`` argument.
``--optimizer`` trains under adam, adamw or lars instead of SGD;
``--distill_from`` (a train dir or a JAX-key ``.npz`` of a
``resnet_v1_50``, face stem) adds a frozen teacher's eval forward to
each step, weighted ``--distill_alpha``. Prints one JSON line. There is no CPU mode: a
measurement that finds no card fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable

import torch

from tf_face_toolbox_tpu_torch.train.state import head_leaves
from tf_face_toolbox_tpu_torch.train.trainer import (
    StepParts,
    TrainConfig,
    build_network,
    create_train_state,
    make_train_step,
)

CONFIG4 = dict(network="resnet_v1_50", stem="face", embedding_dim=512,
               num_classes=10572, image_size=112, crop_from=120,
               global_batch=256, dtype=torch.bfloat16, pallas_input=True)
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
# a Dense feeding a BatchNorm: its bias has no gradient in exact
# arithmetic (the BN removes the mean), so its update is rounding noise
NOISE_ONLY = "EmbeddingHead_0.Dense_0.bias"


def config4(**overrides) -> TrainConfig:
    return TrainConfig(**{**CONFIG4, **overrides})


def head_kind(cfg: TrainConfig) -> str:
    """The loss head ``cfg`` trains, in words."""
    parts = ["sampled" if cfg.pfc_sample_rate < 1 else "exact",
             "fixed margin" if cfg.margin_mode == "fixed" else cfg.margin_mode]
    if cfg.subcenters > 1:
        parts.append(f"{cfg.subcenters} sub-centers")
    if cfg.center_weight > 0:
        parts.append("center loss")
    if cfg.triplet_weight > 0:
        parts.append("triplet")
    return ", ".join(parts)


def forward_flops(net: torch.nn.Module, cfg: TrainConfig, device,
                  columns: int | None = None) -> float:
    """Operations (2 per multiply-add) of one image's forward: every
    conv, matmul and Dense the network runs (torch's FlopCounterMode:
    the ViT's token-wise Dense and attention products included), and the
    classifier GEMM over ``columns`` classifier rows (default every
    class's)."""
    from torch.utils.flop_counter import FlopCounterMode

    if columns is None:
        columns = cfg.num_classes * cfg.subcenters
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        net(torch.zeros((1, cfg.image_size, cfg.image_size, 3),
                        device=device))
    return 2.0 * cfg.embedding_dim * columns + counter.get_total_flops()


REMAT = {"false": False, "true": True, "save_convs": "save_convs"}


def _remat(remat) -> dict:
    """The network's ``remat`` argument where one is asked for: a
    DenseNet, like JAX's, has no such field."""
    return {"remat": remat} if remat else {}


def _kind(name: str) -> str:
    n = name.lower()
    if "preprocess" in n:
        return "kernel 1 (preprocess)"
    if "nccl" in n:
        return "collectives (NCCL)"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit")):
        return "convs (cuDNN)"
    # the head's cosine GEMMs (and the embedding's small Dense), the
    # sampled head's top-k and sort, its gathers and scatters
    if any(k in n for k in ("gemm", "cutlass", "cublas", "sm90_xmma",
                            "topk", "radixfind", "sort", "index", "gather",
                            "scatter")):
        return "head (GEMMs, top-k, gather)"
    if "reduce" in n or "norm" in n:
        return "reductions"
    if any(k in n for k in ("elementwise", "vectorized", "unrolled",
                            "copy", "fill", "where", "foreach")):
        return "elementwise"
    return "other"


def device_profile(fn: Callable, *args, iters: int) -> dict:
    """Where the time of ``iters`` calls of ``fn(*args)`` goes on the
    card (warm ``fn`` first), from torch.profiler: host wall ms a call,
    device ms a call (every kernel's own time), the idle share (1 -
    device / wall), device ms a call by kernel kind (``_kind``), and
    every kernel's ms a call by name, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_kind: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        # device kernels only: an aten op's own device time is its
        # kernels', which are listed too
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3 / iters
        kernels.append((ms, e.key))
        by_kind[_kind(e.key)] = by_kind.get(_kind(e.key), 0.0) + ms
    device_ms = sum(by_kind.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1 - device_ms / wall_ms,
            "device_ms_by_kind": by_kind,
            "kernels_ms": sorted(kernels, reverse=True)}


def time_training(cfg: TrainConfig, *, steps: int = 20, warmup: int = 5,
                  profile_steps: int = 5, seed: int = 0, remat=False,
                  mesh=None, device="cuda", teacher=None) -> dict:
    """ms/step and faces/sec, in all and a GPU (CUDA events over
    ``steps`` after ``warmup``), peak memory, and device time by kernel
    and the idle share over ``profile_steps`` traced steps (none at 0).
    ``mesh``: this rank's topology; every rank calls this. ``teacher``:
    a distillation teacher, as ``make_train_step`` takes it."""
    from tf_face_toolbox_tpu_torch.cli.train import synthetic_batches
    from tf_face_toolbox_tpu_torch.data.pipeline import (
        device_prefetch, host_prefetch)

    if mesh is not None:
        device = mesh.device
    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    state, net = create_train_state(cfg, seed, mesh=mesh, device=device,
                                    net=build_network(cfg, **_remat(remat)))
    step_fn = make_train_step(net, cfg, state, mesh=mesh, teacher=teacher)
    parts = StepParts(net, cfg, state, mesh)
    # the classifier rows a step scores, over the model row's shards
    columns = (state.classifier.shape[0] * parts.model
               if parts.budget is None else parts.budget * parts.model)
    batches = device_prefetch(host_prefetch(
        synthetic_batches(cfg, seed, rank, world)), device=device)

    def run(n):
        nonlocal state
        metrics = None
        for _ in range(n):
            b = next(batches)
            state, metrics = step_fn(state, b["image"], b["label"])
        return metrics

    t0 = time.perf_counter()
    run(1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    run(warmup - 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    m = run(steps)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / steps
    loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    out = {"batch": cfg.global_batch, "ranks": world,
           "model": parts.model, "classes": cfg.num_classes,
           "head": head_kind(cfg), "optimizer": cfg.optimizer,
           "distill_alpha": cfg.distill_alpha if teacher else None,
           "pfc_sample_rate": cfg.pfc_sample_rate, "budget": parts.budget,
           "classifier_columns": columns, "steps": steps,
           "warmup": warmup, "remat": remat,
           "pallas_input": cfg.pallas_input, "ms_per_step": ms,
           "faces_per_sec": cfg.global_batch / ms * 1e3,
           "faces_per_sec_per_gpu": cfg.global_batch / world / ms * 1e3,
           "first_step_s": first_s, "loss": loss,
           "peak_memory_gb": peak / 1e9}
    if not profile_steps:
        return out

    p = device_profile(run, 1, iters=profile_steps)
    # a rank's rows: the operations of one GPU's share of the step
    flops = (3 * forward_flops(net, cfg, device, columns)
             * cfg.global_batch / world)
    out.update(profiled_wall_ms_per_step=p["wall_ms"],
               device_ms_per_step=p["device_ms"],
               idle_share=p["idle_share"],
               device_ms_by_kind=p["device_ms_by_kind"],
               head_share=p["device_ms_by_kind"].get(
                   "head (GEMMs, top-k, gather)", 0.0) / p["device_ms"],
               top_kernels_ms=p["kernels_ms"][:12],
               step_tflop=flops / 1e12,
               peak_share=flops / (ms / 1e3) / PEAK_BF16)
    return out


def exchange_ms(cfg: TrainConfig, mesh, iters: int = 10) -> dict:
    """One all-reduce (SUM) of a flat f32 buffer the size of the step's
    gradients (params and classifier), timed with CUDA events: what the
    exchange costs where it runs (the trainer skips it at one rank)."""
    import torch.distributed as dist

    net = build_network(cfg)
    values = (sum(p.numel() for p in net.parameters())
              + cfg.num_classes * cfg.subcenters * cfg.embedding_dim)
    flat = torch.zeros(values, device=mesh.device)
    for _ in range(2):
        dist.all_reduce(flat)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        dist.all_reduce(flat)
    end.record()
    end.synchronize()
    return {"values": values, "bytes": values * 4,
            "ms": start.elapsed_time(end) / iters}


def remat_grads(cfg: TrainConfig, images: torch.Tensor, labels: torch.Tensor,
                remats=(True, "save_convs"), *, seed: int = 0,
                device="cuda") -> dict:
    """Each ``remat``'s gradients of one step (the same variables, draws
    and batch; deterministic cuDNN) against those without: the largest
    |difference| over every leaf, as f32, and the least per-leaf cosine
    (float64) over the leaves that have a gradient."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    grads = {}
    try:
        for remat in (False, *remats):
            state, net = create_train_state(
                cfg, seed, device=device,
                net=build_network(cfg, **_remat(remat)))
            parts = StepParts(net, cfg, state)
            parts.local(state, *parts.rows(images, labels), 0)
            names = [*state.params, "classifier"]
            grads[remat] = {k: g.detach().float().clone() for k, g in
                            zip(names, parts.grads(state))}
            del state, net, parts
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    out = {}
    base = grads[False]
    for remat in remats:
        diff, cos = 0.0, 1.0
        for k, g in grads[remat].items():
            diff = max(diff, (g - base[k]).abs().max().item())
            a, b = g.double().ravel(), base[k].double().ravel()
            if a.any() or b.any():
                cos = min(cos, float(a @ b / (a.norm() * b.norm())))
        out[str(remat)] = {"max_abs_diff": diff, "min_cos": cos}
    return out


def _leaves(state) -> dict:
    """The parameters, the classifier and the loss heads' state by name."""
    return {**state.params, "classifier": state.classifier,
            **{f"head/{k}": v
               for k, v in head_leaves(state.head_state).items()}}


def step_routes(cfg: TrainConfig, images: torch.Tensor, labels: torch.Tensor,
                *, seed: int = 0, device="cuda") -> dict:
    """One step from the same variables (``seed``) and generator state
    through the kernel route (``pallas_input``) and the plain augment
    chain, and the plain route once more: the losses, and each leaf's
    update (new - old) cosine between the kernel and the plain route
    (and between the two plain runs: the comparison's noise floor), in
    float64; the leaves are the parameters, the classifier and the loss
    heads' state (``head/<name>``: the centers, AdaFace's statistics,
    t). Leaves no gradient reaches stay put in both (counted, not
    compared), as does ``NOISE_ONLY``'s noise. cuDNN runs its
    deterministic algorithms meanwhile, so that only the routes differ.
    """
    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_preprocess)

    updates, losses, launches = {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for route, pallas in (("kernel", True), ("plain", False),
                              ("plain_again", False)):
            c = dataclasses.replace(cfg, pallas_input=pallas)
            state, net = create_train_state(c, seed, device=device)
            before = {k: p.detach().clone()
                      for k, p in _leaves(state).items()}
            step_fn = make_train_step(net, c, state)
            n0 = fused_preprocess.launches
            state, m = step_fn(state, images, labels)
            torch.cuda.synchronize(device)
            launches[route] = fused_preprocess.launches - n0
            losses[route] = float(m["loss"])
            updates[route] = {k: (p.detach() - before[k]).double().ravel()
                              for k, p in _leaves(state).items()}
            del state, net, step_fn, before
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    def cosines(a_route, b_route):
        cos, zero = {}, 0
        for k, a in updates[a_route].items():
            b = updates[b_route][k]
            if k == NOISE_ONLY:
                continue
            if not a.any() and not b.any():
                zero += 1
                continue
            cos[k] = float(a @ b / (a.norm() * b.norm()))
        return cos, zero

    cos, zero = cosines("kernel", "plain")
    again, _ = cosines("plain_again", "plain")
    worst = min(cos, key=cos.get)
    return {"loss": losses, "loss_rel": abs(losses["kernel"] - losses["plain"])
            / abs(losses["plain"]), "min_cos": cos[worst],
            "worst_leaf": worst, "compared_leaves": len(cos),
            "unmoved_leaves": zero, "repeat_min_cos": min(again.values()),
            "launches": launches}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256, help="rows a GPU")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--preset", default="",
                   help="a train preset of configs.py (default: config 4's "
                        "shapes at the trainer's defaults)")
    p.add_argument("--remat", default="false", choices=sorted(REMAT),
                   help="the network's remat argument")
    p.add_argument("--pfc_sample_rate", type=float, default=None,
                   help="the head's sample rate (default: the preset's)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="under torchrun: the model axis of the ranks")
    p.add_argument("--optimizer", default=None,
                   choices=["sgd", "adam", "adamw", "lars"],
                   help="the optimizer (default: the preset's, SGD)")
    p.add_argument("--distill_from", default="",
                   help="a distillation teacher: a train dir or a .npz")
    p.add_argument("--distill_alpha", type=float, default=1.0,
                   help="the distill weight; < 1 mixes in the margin loss")
    p.add_argument("--start_after", default="",
                   help="once up (CUDA and the process group), write "
                        "<path>.ready, then wait for <path> to exist "
                        "before building the state and timing: a harness "
                        "starts the run beside other work and lets it "
                        "time once the card is free")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_train: torch sees no CUDA device")
    import torch.distributed as dist

    from tf_face_toolbox_tpu_torch import configs
    from tf_face_toolbox_tpu_torch.bench import gpu_info
    from tf_face_toolbox_tpu_torch.parallel.mesh import init_distributed

    mesh = (init_distributed("cuda", model=args.mesh_model)
            if "WORLD_SIZE" in os.environ else None)
    world = mesh.world if mesh is not None else 1
    try:
        cfg = (dataclasses.replace(configs.get_config(args.preset),
                                   pallas_input=True)
               if args.preset else config4())
        cfg = dataclasses.replace(cfg, global_batch=args.batch * world)
        if args.pfc_sample_rate is not None:
            cfg = dataclasses.replace(cfg,
                                      pfc_sample_rate=args.pfc_sample_rate)
        if args.optimizer is not None:
            cfg = dataclasses.replace(cfg, optimizer=args.optimizer)
        if args.start_after:
            torch.zeros(1, device=mesh.device if mesh is not None
                        else "cuda")
            with open(args.start_after + ".ready", "w"):
                pass
            while not os.path.exists(args.start_after):
                time.sleep(0.05)
        teacher = None
        if args.distill_from:
            from tf_face_toolbox_tpu_torch.cli.train import build_teacher

            cfg = dataclasses.replace(cfg, distill_alpha=args.distill_alpha)
            teacher = build_teacher(cfg, args.distill_from)
        r = time_training(cfg, steps=args.steps, warmup=args.warmup,
                          remat=REMAT[args.remat], mesh=mesh,
                          teacher=teacher)
        if mesh is not None:
            r["exchange"] = exchange_ms(cfg, mesh)
        if mesh is None or mesh.is_main:
            r["gpu"] = gpu_info()
            print(json.dumps(r), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
