"""Per-stage bench of the fused-block kernel on one GPU.

    python -m tf_face_toolbox_tpu_torch.bench_blocks [--batch 256]
        [--rounds 2] [--ptxas] [--pairs]

For each fused segment of ``resnet_v1_50`` (imagenet stem, bf16, seeded
random weights, 112x112 input: 28x28, 14x14, 7x7 and 4x4 maps), on
``--batch`` seeded ReLU'd random maps: milliseconds (CUDA events, 10
calls after 3) of the kernel (``fused_bottleneck_stack``) and of the
library route that computes the same blocks (the folded engine's
cuDNN / cuBLAS convs, ``BlockPlan.apply_folded``), taken in turns
(kernel, route, route, kernel) ``--rounds`` times, every reading kept.
Each is timed twice over: eagerly, where the host's gaps between
launches count, and as replays of a CUDA graph, which leave only the
device's time. Each stage's row carries a digest of the kernel's output
(``out_sha256``), so that builds run from two copies of the package
can be compared for bit-equality, and the launch plan of each of its
blocks (``plans``: tile, images a CTA, cluster, grid, ring stages,
n-blocks). ``--pairs``: at each stage whose blocks run whole images,
the kernel with its plans forced onto lone CTAs and onto clusters of
two, timed in turns the same way (``lone_*`` / ``pair_*``, with both
digests). ``--ptxas`` prints nvcc's ``-Xptxas -v`` report (registers,
spills) of ``csrc/fused_block.cu``. Prints one JSON line per stage.
There is no CPU mode: a measurement that finds no card fails.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys

import torch

STAGES = ("28x28", "14x14", "7x7", "4x4")


def stage_operands(network: str = "resnet_v1_50", stem: str = "imagenet",
                   seed: int = 0, device: str = "cuda") -> list:
    """Per stage: (input shape, entry, tail, folded blocks) of the fused
    segment, from seeded random variables folded for bf16 serving;
    ``folded`` are the same blocks as the folded engine runs them."""
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.serving.engine import (
        _plan_stage_fusion, _to, build_plan)

    net = create_network(network, dtype=torch.bfloat16, stem=stem)
    plan = build_plan(net, random_variables(net, seed))
    # the imagenet stem halves twice, space2depth once, face not at all
    size = {"imagenet": 112 // 4, "space2depth": 112 // 2}.get(stem, 112)
    out = []
    for blocks in plan.stages:
        size = -(-size // blocks[0].conv2.strides)
        n_folded, entry, tail = _plan_stage_fusion(blocks)
        cin = (entry["w1"] if entry is not None else tail["w1s"][0]).shape[1]
        folded = tuple(blk.to(device) for blk in blocks[n_folded:])
        out.append(((size, size, cin), _to(entry, device), _to(tail, device),
                    folded))
    return out


def run_folded(x: torch.Tensor, folded) -> torch.Tensor:
    """The library route: the same blocks through the folded engine."""
    for blk in folded:
        x = blk.apply_folded(x)
    return x


def stack_work(x: torch.Tensor, entry, tail) -> tuple[int, int]:
    """(bytes, operations) of one fused stage: input and output maps,
    weights and biases once; 2 x N H W x (weight values) operations
    (every weight value meets every pixel once: 1x1, 3x3 taps,
    projection)."""
    n, h, w, _ = x.shape
    parts = [t for t in (entry, tail) if t is not None]
    weights = sum(v.numel() for d in parts for k, v in d.items()
                  if k.startswith("w"))
    c = tail["w3s"].shape[1] if tail is not None else entry["w3"].shape[0]
    nbytes = (x.numel() * x.element_size() + n * h * w * c * 2 + sum(
        v.numel() * v.element_size() for d in parts for v in d.values()))
    return nbytes, 2 * n * h * w * weights


def _nvcc_flags() -> list[str]:
    from tf_face_toolbox_tpu_torch.kernels import build
    return [build._nvcc(), *build.NVCC_FLAGS]


def ptxas_report(source: str = "fused_block.cu") -> str:
    """nvcc's -Xptxas -v report for csrc/``source`` (no output file
    kept)."""
    from tf_face_toolbox_tpu_torch.kernels import build
    src = os.path.join(build.CSRC_DIR, source)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    obj = os.path.join(build.BUILD_DIR, f"ptxas_{os.getpid()}.o")
    proc = subprocess.run([*_nvcc_flags(), "-Xptxas", "-v", "-c", "-o", obj,
                           src], capture_output=True, text=True)
    if os.path.exists(obj):
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return proc.stderr


def graph_ms(fn, iters: int = 10) -> float:
    """Device milliseconds per replay of ``fn`` captured once in a CUDA
    graph: the same launches as ``time_ms`` times, without the host's
    gaps between them (cuDNN picks its algorithms in the warm-up on a
    side stream, before the capture)."""
    from tf_face_toolbox_tpu_torch.bench import time_ms
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters=iters)


def in_turns(a, b, rounds: int, timer) -> tuple[list, list]:
    """``timer`` readings of ``a`` and ``b`` taken a, b, b, a per round."""
    ra, rb = [], []
    for _ in range(rounds):
        ra.append(timer(a))
        rb += [timer(b), timer(b)]
        ra.append(timer(a))
    return ra, rb


def stage_plans(x: torch.Tensor, entry, tail, **force) -> list[dict]:
    """The launch plan of each distinct block of a fused stage."""
    from tf_face_toolbox_tpu_torch.serving import fused_block as tfb
    n, h, w, cin = x.shape
    shapes = []
    if entry is not None:
        shapes.append((cin, entry["w1"].shape[0], entry["w3"].shape[0]))
    if tail is not None:
        shapes.append((tail["w1s"].shape[2], tail["w1s"].shape[1],
                       tail["w3s"].shape[1]))
    out = []
    for cin_, b, c in shapes:
        p = tfb.launch_plan(n, h, w, cin_, b, c, tfb._n_sms(x.device), **force)
        row = {k: p[k] for k in ("th", "tw", "g", "cluster", "grid", "stages",
                                 "ctas_per_sm")}
        row["nb"] = [p["phases"][k]["nb"] for k in ("y1", "y2", "y3")]
        if row not in out:
            out.append(row)
    return out


@contextlib.contextmanager
def forced_plan(**force):
    """Run the fused-block wrapper with ``launch_plan``'s choice forced
    (``cluster=1`` or ``2``)."""
    from tf_face_toolbox_tpu_torch.serving import fused_block as tfb
    plan = tfb.launch_plan
    tfb.launch_plan = lambda *a: plan(*a, **force)
    try:
        yield
    finally:
        tfb.launch_plan = plan


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def stage_times(batch: int = 256, rounds: int = 2, seed: int = 0,
                pairs: bool = False) -> list:
    """One dict per stage: the kernel's and the library route's ms, each
    reading of both taken in turns (kernel, route, route, kernel), once
    eagerly (CUDA events around the calls, so host gaps count) and once
    as CUDA-graph replays (device time alone); GFLOP; an output digest."""
    from tf_face_toolbox_tpu_torch.bench import time_ms
    from tf_face_toolbox_tpu_torch.serving.fused_block import (
        fused_bottleneck_stack)

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for name, (shape, entry, tail, folded) in zip(
            STAGES, stage_operands(seed=seed)):
        x = torch.relu(torch.randn((batch, *shape), generator=g,
                                   device="cuda")).to(torch.bfloat16)
        h, w = shape[:2]
        _, ops = stack_work(x, entry, tail)

        def kernel():
            return fused_bottleneck_stack(x, entry, tail, h=h, w=w)

        def library():
            return run_folded(x, folded)

        row = {"stage": name, "batch": batch, "gflop": ops / 1e9,
               "out_sha256": digest(kernel()),
               "plans": stage_plans(x, entry, tail)}
        for mode, timer in (("eager", time_ms), ("graph", graph_ms)):
            ks, ls = in_turns(kernel, library, rounds, timer)
            row[f"{mode}_ms"] = ks
            row[f"{mode}_library_ms"] = ls
        if pairs and all((p["th"], p["tw"]) == (h, w) for p in row["plans"]):
            def lone():
                with forced_plan(cluster=1):
                    return kernel()

            def pair():
                with forced_plan(cluster=2):
                    return kernel()

            for tag, cluster, fn in (("lone", 1, lone), ("pair", 2, pair)):
                row[f"{tag}_plans"] = stage_plans(x, entry, tail,
                                                  cluster=cluster)
                row[f"{tag}_sha256"] = digest(fn())
            for mode, timer in (("eager", time_ms), ("graph", graph_ms)):
                row[f"lone_{mode}_ms"], row[f"pair_{mode}_ms"] = in_turns(
                    lone, pair, rounds, timer)
        row["ms"] = sum(row["eager_ms"]) / len(row["eager_ms"])
        row["library_ms"] = (sum(row["eager_library_ms"])
                             / len(row["eager_library_ms"]))
        row["tflops"] = ops / row["ms"] / 1e9
        rows.append(row)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256, help="images per stage")
    p.add_argument("--rounds", type=int, default=2,
                   help="rounds of kernel, route, route, kernel")
    p.add_argument("--ptxas", action="store_true",
                   help="print nvcc -Xptxas -v for csrc/fused_block.cu")
    p.add_argument("--pairs", action="store_true",
                   help="also time lone CTAs against pairs in turns at the "
                        "whole-image stages")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_blocks: torch sees no CUDA device; there is no CPU mode")
    from tf_face_toolbox_tpu_torch.bench import gpu_info
    print(gpu_info(), flush=True)
    if args.ptxas:
        print(ptxas_report(), flush=True)
    for row in stage_times(args.batch, args.rounds, pairs=args.pairs):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
