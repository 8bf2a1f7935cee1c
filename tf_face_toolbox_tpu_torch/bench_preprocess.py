"""Bench of the fused preprocess kernel (kernel 1) on one GPU.

    python -m tf_face_toolbox_tpu_torch.bench_preprocess
        [--batches 128,256] [--default-only] [--ptxas] [--stamps]

At (N,120,120,3) u8 -> bf16 112x112 (the e2e chain's input stage), N
128 and 256, eval path (no flip): milliseconds a launch of the kernel
as ``launch_plan`` chooses and with its plan forced onto each cluster
size (1, 2, 4 CTAs an image) and kernel instance that holds the band
(``FORCED``), in four readings each:

- eager warm: CUDA events around back-to-back calls on one input;
- eager cold: the same, rotating over ``COLD_BATCHES`` distinct input
  batches (more bytes than the H100's 50 MB L2), so each call finds its
  input in device memory;
- graph warm / graph cold: one CUDA graph of ``COLD_BATCHES`` launches
  (on one input, or on the distinct ones), replayed; ms a launch.

Each variant's row carries a digest of its output and its largest
difference from the plain version. Also the library route
(``F.interpolate`` bilinear without antialiasing, flip, mean / var /
clamp / normalize, NHWC bf16) eager and in graph replays, with its
largest difference from the plain version. ``--default-only`` times
only ``fused_eval_preprocess`` as the package runs it, which any
version of the package has: to compare two builds, copy each package
(with this file) into its own git-ignored directory and run the bench
from each copy in turns (a, b, b, a) in one call; equal digests mean
bit-equal outputs. ``--ptxas``: nvcc's ``-Xptxas -v`` report of
``csrc/preprocess.cu``. ``--stamps``: the kernel built again with
``-DTFFT_PRE_STAMPS`` runs once per variant on a cold input, and each
CTA's phase stamps give the cycles of its phases (median and p90), its
span on the global timer, and how many CTAs ran at once. Prints one
JSON line per batch. There is no CPU mode: a measurement that finds no
card fails.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

COLD_BATCHES = 7          # 7 x 11.1 MB of u8 at 256 images: past the L2
SIZE, SOURCE = 112, 120
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


# forced plans: cluster, values a thread (the instance), persistence
FORCED = {"c1_v84": {"cluster": 1, "vals": 84},
          "c1_v42": {"cluster": 1, "vals": 42},
          "c1_v42_once": {"cluster": 1, "vals": 42, "persist": False},
          "c2_v84": {"cluster": 2, "vals": 84},
          "c2_v42": {"cluster": 2, "vals": 42},
          "c2_v42_once": {"cluster": 2, "vals": 42, "persist": False},
          "c4_v42": {"cluster": 4, "vals": 42}}


def bound_ms(n: int, size: int = SIZE, source: int = SOURCE) -> float:
    """Least time of one launch: the u8 input read and the bf16 output
    and flip flags written once at the card's memory rate."""
    nbytes = n * source * source * 3 + n * (size * size * 3 * 2 + 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def per_launch(timer, fn, inputs: list) -> float:
    """ms a launch of ``fn``: ``timer`` (``bench.time_ms``, eager, or
    ``bench_blocks.graph_ms``, graph replays) of one call on each of
    ``inputs`` in turn, over their number."""
    return timer(lambda: [fn(x) for x in inputs]) / len(inputs)


def readings(fn, batches: list) -> dict:
    """The four readings of ``fn`` (ms a launch): eager and graph, warm
    (batches[0] every time) and cold (rotating over ``batches``)."""
    from tf_face_toolbox_tpu_torch.bench import time_ms
    from tf_face_toolbox_tpu_torch.bench_blocks import graph_ms

    warm = [batches[0]] * len(batches)
    return {"ms": per_launch(time_ms, fn, warm),
            "cold_ms": per_launch(time_ms, fn, batches),
            "graph_ms": per_launch(graph_ms, fn, warm),
            "cold_graph_ms": per_launch(graph_ms, fn, batches)}


def library_route(u8: torch.Tensor, flips: torch.Tensor | None,
                  size: int = SIZE, dtype=torch.bfloat16) -> torch.Tensor:
    """The same function as library calls, for timing only (the port
    never calls it): NHWC u8 -> NCHW f32, half-pixel bilinear resize
    without antialiasing, the flip, per-image standardization, NHWC
    ``dtype``."""
    x = u8.permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    if flips is not None:
        y = torch.where(flips.bool().view(-1, 1, 1, 1), y.flip(3), y)
    mean = y.mean(dim=(1, 2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    std = var.sqrt().clamp_min(1.0 / np.sqrt(y[0].numel()))
    return ((y - mean) / std).to(dtype).permute(0, 2, 3, 1).contiguous()


def make_batches(n: int, count: int = COLD_BATCHES, seed: int = 0) -> list:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, 256, (n, SOURCE, SOURCE, 3), generator=g,
                          device="cuda", dtype=torch.uint8)
            for _ in range(count)]


STAMP_FIELDS = 10           # kStamps in csrc/preprocess.cu
# the phases between the kernel's clock stamps 0..6
PHASES = ("issue_and_columns", "copy_wait", "values", "mean", "variance",
          "store")


def load_stamped():
    """The preprocess kernel built with its phase stamps, as a library
    with ``tfft_preprocess``'s signature."""
    from tf_face_toolbox_tpu_torch.kernels import build

    src = os.path.join(build.CSRC_DIR, "preprocess.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(build.BUILD_DIR, f"stamped_preprocess_{tag}.so")
    if not os.path.exists(so):
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                               "-DTFFT_PRE_STAMPS", "-shared", "-o", so, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(so)
    for name in ("tfft_preprocess", "tfft_error_string"):
        restype, argtypes = build.SIGNATURES[name]
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    lib.tfft_preprocess_stamps.argtypes = [ctypes.c_void_p]
    lib.tfft_preprocess_stamps.restype = ctypes.c_int
    return lib


def _pct(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q))


def stamped_run(lib, batches: list, force: dict) -> dict:
    """One launch of the stamped kernel on a cold input (the other
    batches run first), its stamps summarised."""
    from tf_face_toolbox_tpu_torch.kernels import build
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp

    n = batches[0].shape[0]
    plan = fp.launch_plan(n, SOURCE, SOURCE, 3, SIZE, SIZE, **force)
    buf = torch.zeros((plan["grid"], STAMP_FIELDS), dtype=torch.int64,
                      device="cuda")
    saved = build._lib
    build._lib = lib                # the wrapper launches the stamped build
    try:
        for u8 in batches[1:] + batches[:1]:
            if u8 is batches[0]:
                torch.cuda.synchronize()
                if lib.tfft_preprocess_stamps(buf.data_ptr()) != 0:
                    raise RuntimeError("tfft_preprocess_stamps failed")
            fp.fused_eval_preprocess(u8, SIZE, SIZE, out_dtype=torch.bfloat16,
                                     **force)
        torch.cuda.synchronize()
    finally:
        lib.tfft_preprocess_stamps(None)
        build._lib = saved
    st = buf.cpu().numpy()
    st = st[st[:, 1] != 0]          # a persisting plan launches fewer CTAs
    sm, t0, t1, clk = st[:, 0], st[:, 1], st[:, 2], st[:, 3:]
    phases = np.diff(clk, axis=1)
    span_ns = int(t1.max() - t0.min())
    busy_ns = (t1 - t0).astype(np.float64)
    return {"ctas": int(st.shape[0]), "sms": int(len(np.unique(sm))),
            "most_ctas_an_sm": int(np.bincount(sm).max()),
            "span_us": span_ns / 1e3,
            "cta_us_median": _pct(busy_ns, 50) / 1e3,
            "ctas_at_once_mean": float(busy_ns.sum() / max(span_ns, 1)),
            "cycles_median": {k: _pct(phases[:, i], 50)
                              for i, k in enumerate(PHASES)},
            "cycles_p90": {k: _pct(phases[:, i], 90)
                           for i, k in enumerate(PHASES)},
            "cycles_total_median": _pct(clk[:, -1] - clk[:, 0], 50),
            "start_us_p50_p90_max": [
                (_pct(t0, q) - t0.min()) / 1e3 for q in (50, 90, 100)]}


def library_readings(u8: torch.Tensor) -> dict:
    """The library route's ms on ``u8`` (eval path, bf16), eager and in
    graph replays."""
    from tf_face_toolbox_tpu_torch.bench import time_ms
    from tf_face_toolbox_tpu_torch.bench_blocks import graph_ms

    return {"ms": time_ms(library_route, u8, None),
            "graph_ms": graph_ms(lambda: library_route(u8, None))}


def bench(n: int, default_only: bool = False, stamped=None) -> dict:
    from tf_face_toolbox_tpu_torch.bench_blocks import digest
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp

    batches = make_batches(n)
    zeros = torch.zeros(n, device=batches[0].device)
    plain = fp.fused_preprocess_reference(batches[0], zeros, out_h=SIZE,
                                          out_w=SIZE)

    def variant(**force):
        return lambda u8: fp.fused_eval_preprocess(
            u8, SIZE, SIZE, out_dtype=torch.bfloat16, **force)

    variants = {"plan": variant()}
    row = {"batch": n, "bound_ms": bound_ms(n)}
    if not default_only:
        variants.update({k: variant(**f) for k, f in FORCED.items()})
        row["launch_plan"] = {k: v for k, v in fp.launch_plan(
            n, SOURCE, SOURCE, 3, SIZE, SIZE).items()
            if k in ("cluster", "band_rows", "threads", "tc", "tr", "jc",
                     "vals", "cw", "ctas_an_sm", "copy", "persist",
                     "stage_bytes", "out_stage_bytes", "smem_bytes")}
    for name, fn in variants.items():
        out = fn(batches[0])
        torch.cuda.synchronize()
        row[f"{name}_sha256"] = digest(out)
        row[f"{name}_max_abs"] = (out.float() - plain).abs().max().item()
        row[name] = readings(fn, batches)
    if stamped is not None:
        row["stamps"] = {k: stamped_run(stamped, batches, f)
                         for k, f in [("plan", {})] + list(FORCED.items())}
    route = library_route(batches[0], None, dtype=torch.float32)
    row["library_route_max_abs_vs_plain"] = (route - plain).abs().max().item()
    row["library_route"] = library_readings(batches[0])
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", default="128,256")
    p.add_argument("--default-only", action="store_true",
                   help="time only fused_eval_preprocess as the package "
                        "runs it (no plan, no forced variants)")
    p.add_argument("--ptxas", action="store_true",
                   help="print nvcc -Xptxas -v for csrc/preprocess.cu")
    p.add_argument("--stamps", action="store_true",
                   help="per-CTA phase stamps from a stamped build")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_preprocess: torch sees no CUDA device; there is no CPU mode")
    from tf_face_toolbox_tpu_torch.bench import gpu_info
    print(gpu_info(), flush=True)
    if args.ptxas:
        from tf_face_toolbox_tpu_torch.bench_blocks import ptxas_report
        print(ptxas_report("preprocess.cu"), flush=True)
    stamped = load_stamped() if args.stamps else None
    for n in (int(b) for b in args.batches.split(",")):
        print(json.dumps(bench(n, args.default_only, stamped)), flush=True)


if __name__ == "__main__":
    main()
