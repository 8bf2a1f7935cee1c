"""Port bench: flip-averaged extraction, faces/sec on one GPU.

The counterpart of the root ``bench.py`` chain: a batch of faces and
their mirrors go through one forward pass, then averaging and L2
normalization, with bf16 weights and compute at 112x112.

    python -m tf_face_toolbox_tpu_torch.bench --impl fused --batch 128
    python -m tf_face_toolbox_tpu_torch.bench --impl fused --e2e --batch 256
    python -m tf_face_toolbox_tpu_torch.bench --network densenet_121 \
        --impl module --stem face

``--network``: any ported backbone (resnet_v1_50 by default;
se_resnet_50, resnext_50, se_resnext_50, densenet_121, ...); ``--stem``:
imagenet, face or space2depth (the ResNet family's). ``--impl``: module
= the nn.Module forward (cuDNN convs, BN unfolded); folded = BN folded
into the convs; fused = folded + the fused-block kernel for every
stride-1 block run outside a squeeze-excite stage. The folded engine
does not serve ResNeXt or DenseNet: folded and fused exit naming why.
``--e2e``: the input is raw uint8 120x120 faces and the fused
preprocess kernel (resize to 112 + standardize) is inside the
measurement. ``--quant_mode dynamic|static`` serves W8A8 int8 convs
through the module (``--impl module``); static first calibrates its
scales on one seeded batch of 64 standardized faces.

Times come from CUDA events around ``--iters`` back-to-back batches
after ``--warmup`` batches, repeated ``--repeats`` times. Weights are
seeded random: the speed of a forward does not depend on their values.
Prints one JSON line. There is no CPU mode: a measurement that finds no
card fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Callable

import torch

IMPLS = ("module", "folded", "fused")
E2E_SOURCE = 120   # u8 source size of the e2e chain (resized to 112)
IMAGE_SIZE = 112


def gpu_info() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def build_forward(*, impl: str = "fused", e2e: bool = False,
                  network: str = "resnet_v1_50", stem: str = "imagenet",
                  seed: int = 0, device: str = "cuda",
                  quantized: bool | str = False) -> Callable:
    """``forward(images) -> (N, 512) f32 embeddings`` for one bench mode.

    ``images``: (N, 112, 112, 3) standardized pixels, or with ``e2e``
    (N, 120, 120, 3) uint8 faces; an e2e forward's ``plain`` attribute
    is the standardized-pixel forward of the same weights.
    ``quantized``: an int8 mode of the module path ("dynamic", or
    "static" calibrated on a seeded batch).
    """
    from tf_face_toolbox_tpu_torch.extract import make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.ops.fused_preprocess import (
        fused_eval_preprocess)
    from tf_face_toolbox_tpu_torch.serving import make_serving_apply

    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if quantized and impl != "module":
        raise ValueError("int8 serves through the module path "
                         "(impl='module')")
    net = create_network(network, dtype=torch.bfloat16, stem=stem,
                         quantized=quantized)
    flat = random_variables(net, seed)
    if quantized == "static":
        from tf_face_toolbox_tpu_torch.models import calibrate_quant_stats

        flat = calibrate_quant_stats(
            network, flat, [make_inputs(64, False, device, seed=seed + 2)],
            dtype=torch.bfloat16, stem=stem, device=device)
    if impl == "module":
        apply_fn = load_jax_variables(net, flat).to(device)
    else:
        apply_fn = make_serving_apply(net, flat, device=device,
                                      use_kernels=impl == "fused")
    extract = make_extract_fn(apply_fn)
    if not e2e:
        return extract

    def forward(u8: torch.Tensor) -> torch.Tensor:
        x = fused_eval_preprocess(u8, IMAGE_SIZE, IMAGE_SIZE,
                                  out_dtype=torch.bfloat16)
        return extract(x)

    forward.plain = extract     # the same weights, standardized pixels in
    return forward


def make_inputs(batch: int, e2e: bool, device: str = "cuda",
                seed: int = 1) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    if e2e:
        return torch.randint(0, 256, (batch, E2E_SOURCE, E2E_SOURCE, 3),
                             generator=g, device=device, dtype=torch.uint8)
    return torch.randn((batch, IMAGE_SIZE, IMAGE_SIZE, 3), generator=g,
                       device=device)


def time_ms(fn: Callable, *args, iters: int = 10, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn(*args)`` (CUDA events)."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(forward: Callable, images: torch.Tensor, *, iters: int = 10,
            warmup: int = 3, repeats: int = 3) -> dict:
    """faces/s of ``forward(images)``: the median (and min, max) over
    ``repeats`` CUDA-event readings of ``iters`` calls after ``warmup``;
    the embeddings must be finite."""
    if not bool(torch.isfinite(forward(images)).all()):
        raise RuntimeError("non-finite embeddings")
    batch = images.shape[0]
    ms = [time_ms(forward, images, iters=iters, warmup=warmup)
          for _ in range(repeats)]
    rates = sorted(batch * 1000.0 / t for t in ms)
    return {"value": statistics.median(rates), "unit": "faces/sec/GPU",
            "min": rates[0], "max": rates[-1],
            "ms_per_batch": statistics.median(ms)}


def run(*, impl: str = "fused", e2e: bool = False, batch: int = 128,
        network: str = "resnet_v1_50", stem: str = "imagenet",
        iters: int = 10, warmup: int = 3, repeats: int = 3,
        quantized: bool | str = False) -> dict:
    """Measure one mode; returns the JSON-ready result."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures a GPU; torch sees none")
    forward = build_forward(impl=impl, e2e=e2e, network=network, stem=stem,
                            quantized=quantized)
    metric = ("resnet50" if network == "resnet_v1_50" else network) + \
        "_extraction_faces_per_sec_per_gpu"
    return {
        "metric": metric,
        **measure(forward, make_inputs(batch, e2e), iters=iters,
                  warmup=warmup, repeats=repeats),
        "impl": impl,
        "quant_mode": quantized or "none",
        "e2e": e2e,
        "batch": batch,
        "stem": stem,
        "device": torch.cuda.get_device_name(0),
        "gpu": gpu_info(),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--impl", default="fused", choices=IMPLS)
    p.add_argument("--e2e", action="store_true",
                   help="uint8 120x120 in, fused preprocess kernel included")
    p.add_argument("--batch", type=int, default=128, help="faces per batch")
    p.add_argument("--network", default="resnet_v1_50")
    p.add_argument("--stem", default="imagenet",
                   choices=["imagenet", "face", "space2depth"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--quant_mode", default="none",
                   choices=["none", "dynamic", "static"],
                   help="int8 convs on the module path (--impl module)")
    args = p.parse_args(argv)
    quant = False if args.quant_mode == "none" else args.quant_mode
    if quant and args.impl != "module":
        sys.exit("bench: --quant_mode serves through --impl module")
    if args.impl != "module":
        from tf_face_toolbox_tpu_torch.models import create_network
        from tf_face_toolbox_tpu_torch.serving.engine import check_servable
        try:
            check_servable(create_network(args.network, stem=args.stem))
        except ValueError as e:
            sys.exit(f"bench: --impl {args.impl}: {e}")
    if not torch.cuda.is_available():
        sys.exit("bench: torch sees no CUDA device; there is no CPU mode")
    print(json.dumps(run(impl=args.impl, e2e=args.e2e, batch=args.batch,
                         network=args.network, stem=args.stem,
                         iters=args.iters, warmup=args.warmup,
                         repeats=args.repeats, quantized=quant)))


if __name__ == "__main__":
    main()
