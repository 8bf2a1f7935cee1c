"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (tf_face_toolbox_tpu_torch) once at the
full width of resnet_v1_50 (imagenet stem, gap head, 512-d, bf16,
seeded random weights): raw uint8 faces -> fused preprocess kernel ->
flip-averaged fused-block engine -> L2-normalized embeddings, then the
extract and eval_lfw CLIs. Phases:

1. device: the card's name and power limit; TF32 off for f32 checks
2. build: both CUDA kernels from tf_face_toolbox_tpu_torch/csrc
3. kernel vs plain PyTorch version at the main path's shapes
4. slice: the e2e chain, its launch counts, and its embeddings held
   against the f32 module path (no kernels) on the same card
5. CLIs: extract (--engine fused) and eval_lfw as subprocesses
6. times: kernels vs plain versions, and the port bench (informational)

Exits non-zero on any failure, or when torch sees no CUDA device:
there is no CPU path. Imports nothing of JAX. Scratch files go under
build/smoke/ in the checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 values at ``x`` (8 significant bits)."""
    _, exp = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def per_image_cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # float64: an f32 cosine of two equal 800k-value maps is off by 4e-5
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    return torch.nn.functional.cosine_similarity(a, b, dim=1)


def check_block_stack(name, x, entry, tail, stats: list) -> None:
    """Fused-block kernel vs its plain version on one stage's stack."""
    from tf_face_toolbox_tpu_torch.bench import time_ms
    from tf_face_toolbox_tpu_torch.serving.fused_block import (
        fused_bottleneck_stack, fused_bottleneck_stack_reference)

    h, w = x.shape[1:3]
    got = fused_bottleneck_stack(x, entry, tail, h=h, w=w)
    torch.cuda.synchronize()
    want = fused_bottleneck_stack_reference(x, entry, tail, h=h, w=w)
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    rms = want.float().pow(2).mean().sqrt().item()
    cos = per_image_cos(got, want).min().item()
    ms = time_ms(lambda: fused_bottleneck_stack(x, entry, tail, h=h, w=w))
    plain = time_ms(
        lambda: fused_bottleneck_stack_reference(x, entry, tail, h=h, w=w))
    say(f"  fused_block {name} x{tuple(x.shape)}: max_abs={err:.4g} "
        f"(max|ref|={peak:.4g}, /rms={err / rms:.4g}) min_cos={cos:.7f} "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms")
    # bf16 output: a rounding flip anywhere upstream moves an output by
    # one bf16 step, whose size at the map's largest value is peak/128.
    expect(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    expect(cos >= 0.9999, f"{name}: min cosine {cos} < 0.9999")
    expect(err <= 2 * peak / 128, f"{name}: max_abs {err} > 2 bf16 steps "
                                  f"at the peak {peak}")
    stats.append({"stage": name, "max_abs_err": err, "ms": ms,
                  "plain_ms": plain})


def stage_operands(network: str, stem: str, seed: int):
    """Per stage: (input shape, entry, tail) of the fused segment, from
    seeded random variables folded for bf16 serving on the card."""
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.serving.engine import (
        _plan_stage_fusion, _to, build_plan)

    net = create_network(network, dtype=torch.bfloat16, stem=stem)
    plan = build_plan(net, random_variables(net, seed))
    size = 112 // 4 if stem == "imagenet" else 112
    out = []
    for blocks in plan.stages:
        size = -(-size // blocks[0].conv2.strides)
        n_folded, entry, tail = _plan_stage_fusion(blocks)
        cin = (entry["w1"] if entry is not None else tail["w1s"][0]).shape[1]
        out.append(((size, size, cin), _to(entry, "cuda"), _to(tail, "cuda")))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; there is no CPU path")

    from tf_face_toolbox_tpu_torch import bench
    from tf_face_toolbox_tpu_torch.kernels import build
    from tf_face_toolbox_tpu_torch.ops import fused_preprocess as fp
    from tf_face_toolbox_tpu_torch.serving import fused_block as fb

    # ---- 1. device
    gpu = bench.gpu_info()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[1 device] {gpu} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} | TF32 off")

    # ---- 2. build
    t0 = time.time()
    lib_path = build.build()
    build.load_library()
    say(f"[2 build] {os.path.relpath(lib_path, ROOT)} in "
        f"{time.time() - t0:.1f} s (nvcc sm_90a)")

    # ---- 3. kernels vs their plain versions
    say("[3 kernels]")
    g = torch.Generator(device="cuda").manual_seed(0)
    u8 = torch.randint(0, 256, (256, 120, 120, 3), generator=g,
                       device="cuda", dtype=torch.uint8)
    flips = torch.randint(0, 2, (256,), generator=g, device="cuda")
    # a constant image at its own size: no resize, zero variance, so the
    # std floor 1/sqrt(N) must give exact zeros (not NaN)
    const = torch.full((4, 112, 112, 3), 77, dtype=torch.uint8, device="cuda")
    pre_err = 0.0
    for images, fl, label in ((u8, flips, "random flips"),
                              (const, flips[:4], "constant image")):
        want = fp.fused_preprocess_reference(images, fl, out_h=112, out_w=112)
        got = fp.fused_preprocess(images, fl, out_h=112, out_w=112)
        torch.cuda.synchronize()
        err32 = (got - want).abs().max().item()
        got16 = fp.fused_preprocess(images, fl, out_h=112, out_w=112,
                                    out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        # bf16: within one bf16 step of the plain version's rounded
        # value, beyond the f32 tolerance (near zero, (y - mean)
        # cancels and only the absolute f32 error means anything)
        want16 = want.to(torch.bfloat16).float()
        excess = ((got16.float() - want16).abs() - 1e-4).clamp_min(0)
        ulps = (excess / bf16_ulp(want16)).max().item()
        say(f"  preprocess {label} {tuple(images.shape)} -> 112: f32 "
            f"max_abs={err32:.3g}, bf16 max {ulps:.2f} ulp beyond 1e-4")
        expect(err32 <= 1e-4, f"preprocess f32 max_abs {err32} > 1e-4")
        expect(ulps <= 1.0, f"preprocess bf16 {ulps} ulp > 1 beyond 1e-4")
        if label == "constant image":
            expect(got.abs().max().item() == 0 and
                   got16.float().abs().max().item() == 0,
                   "constant image: std floor did not give zeros")
        if label == "random flips":
            pre_err = err32

    block_stats: list = []
    for (shape, entry, tail), name in zip(
            stage_operands("resnet_v1_50", "imagenet", 0),
            ("28x28", "14x14", "7x7", "4x4")):
        x = torch.relu(torch.randn((256, *shape), generator=g, device="cuda")
                       ).to(torch.bfloat16)
        check_block_stack(name, x, entry, tail, block_stats)
    face = stage_operands("resnet_v1_50", "face", 1)
    for idx, name in ((0, "face 56x56"), (3, "face 7x7")):
        shape, entry, tail = face[idx]
        x = torch.relu(torch.randn((64, *shape), generator=g, device="cuda")
                       ).to(torch.bfloat16)
        check_block_stack(name, x, entry, tail, [])

    # ---- 4. slice: the e2e chain on the card, held against f32 module
    from tf_face_toolbox_tpu_torch.extract import make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables

    faces = u8[:128]
    forward = bench.build_forward(impl="fused", e2e=True)
    fp.fused_preprocess.launches = 0
    fb.fused_bottleneck_block.launches = 0
    emb = forward(faces)
    torch.cuda.synchronize()
    launches = {"preprocess": fp.fused_preprocess.launches,
                "fused_block": fb.fused_bottleneck_block.launches}
    net32 = create_network("resnet_v1_50", stem="imagenet")
    load_jax_variables(net32, random_variables(net32, 0)).to("cuda")
    pixels = fp.fused_preprocess_reference(
        faces, torch.zeros(128, device="cuda"), out_h=112, out_w=112)
    ref = make_extract_fn(net32)(pixels)
    norms = emb.norm(dim=1)
    cos = per_image_cos(emb, ref)
    mean = ref.mean(0, keepdim=True)
    centered = per_image_cos(emb - mean, ref - mean)
    say(f"[4 slice] resnet_v1_50 imagenet bf16, 128 u8 faces 120->112: "
        f"emb {tuple(emb.shape)} {emb.dtype}, |norm-1| max "
        f"{(norms - 1).abs().max().item():.2e}, cos vs f32 module min "
        f"{cos.min().item():.6f}, batch-centered cos min "
        f"{centered.min().item():.4f}, launches {launches}")
    expect(tuple(emb.shape) == (128, 512) and emb.dtype == torch.float32,
           "embedding shape/dtype")
    expect(bool(torch.isfinite(emb).all()), "non-finite embeddings")
    expect((norms - 1).abs().max().item() < 1e-4, "embeddings not unit norm")
    expect(cos.min().item() >= 0.999, "cosine vs f32 module path < 0.999")
    # random weights give every face a large shared component, so the
    # plain cosine is lenient; the centered one still catches a wrong
    # block (bf16 rounding alone leaves it near 0.99)
    expect(centered.min().item() >= 0.95, "batch-centered cosine < 0.95")
    expect(launches == {"preprocess": 1, "fused_block": 13},
           f"launch counts {launches}, want preprocess 1, fused_block 13 "
           "(3 + 3 + 5 + 2)")

    # ---- 5. CLIs
    from tf_face_toolbox_tpu_torch.data.format import pack_arrays
    from tf_face_toolbox_tpu_torch.interop.port import save_variables_npz

    work = os.path.join(ROOT, "build", "smoke")
    os.makedirs(work, exist_ok=True)
    shard = os.path.join(work, "faces.faceshard")
    npz = os.path.join(work, "r50_imagenet_seed0.npz")
    out_npy = os.path.join(work, "emb.npy")
    pairs = os.path.join(work, "pairs.txt")
    cli_faces = torch.randint(0, 256, (400, 120, 120, 3), generator=g,
                              device="cuda", dtype=torch.uint8).cpu().numpy()
    pack_arrays(shard, cli_faces, list(range(400)))
    save_variables_npz(npz, random_variables(net32, 0))
    with open(pairs, "w") as f:
        for i in range(200):
            f.write(f"{i} {(i + 200) if i % 2 else i + 1} {1 - i % 2}\n")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.extract",
         "--engine", "fused", "--stem", "imagenet", "--variables_npz", npz,
         "--data", shard, "--output", out_npy, "--crop_from", "120",
         "--batch", "128", "--device", "cuda"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    expect(proc.returncode == 0, f"cli.extract failed:\n{proc.stderr[-3000:]}")
    import numpy as np
    emb_cli = np.load(out_npy)
    expect(emb_cli.shape == (400, 512) and np.isfinite(emb_cli).all(),
           f"cli.extract wrote {emb_cli.shape}")
    expect(np.abs(np.linalg.norm(emb_cli, axis=1) - 1).max() < 1e-4,
           "cli.extract embeddings not unit norm")
    proc = subprocess.run(
        [sys.executable, "-m", "tf_face_toolbox_tpu_torch.cli.eval_lfw",
         "--embeddings", out_npy, "--pairs", pairs],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    expect(proc.returncode == 0, f"cli.eval_lfw failed:\n{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout)
    keys = {"accuracy_mean", "accuracy_std", "fold_accuracies",
            "fold_thresholds", "tar@far=0.1", "auc", "eer"}
    expect(keys <= report.keys() and len(report["fold_accuracies"]) == 10,
           f"eval_lfw report keys {sorted(report)}")
    say(f"[5 CLIs] extract --engine fused: {emb_cli.shape} unit-norm; "
        f"eval_lfw: 200 pairs, 10 folds, keys ok (random weights: "
        f"accuracy {report['accuracy_mean']:.3f} means nothing); "
        f"{time.time() - t0:.1f} s")

    # ---- 6. times (informational)
    pre_ms = bench.time_ms(lambda: fp.fused_eval_preprocess(
        u8, 112, 112, out_dtype=torch.bfloat16))
    zeros = torch.zeros(256, device="cuda")
    pre_plain = bench.time_ms(lambda: fp.fused_preprocess_reference(
        u8, zeros, out_h=112, out_w=112))
    say(f"[6 times] {gpu}")
    say(f"  preprocess (256,120,120,3) u8 -> bf16 112: kernel "
        f"{pre_ms:.3f} ms, plain (f32) {pre_plain:.3f} ms")
    for s in block_stats:
        say(f"  fused_block stage {s['stage']} b256: kernel {s['ms']:.3f} ms, "
            f"plain {s['plain_ms']:.3f} ms")
    for batch in (128, 256):
        for e2e in (False, True):
            for impl in bench.IMPLS:
                r = bench.run(impl=impl, e2e=e2e, batch=batch, iters=5,
                              warmup=2, repeats=3)
                say(f"  bench impl={impl:6s} e2e={int(e2e)} batch={batch}: "
                    f"{r['value']:.1f} faces/s (min {r['min']:.1f}, max "
                    f"{r['max']:.1f}), {r['ms_per_batch']:.2f} ms/batch")

    kernels = [
        {"name": "preprocess", "route": "cuda",
         "source": "tf_face_toolbox_tpu_torch/csrc/preprocess.cu",
         "replaces": "tf_face_toolbox_tpu/ops/pallas_preprocess.py:64",
         "launches": launches["preprocess"], "max_abs_err": pre_err,
         "ms": pre_ms, "plain_ms": pre_plain},
        {"name": "fused_block", "route": "cuda",
         "source": "tf_face_toolbox_tpu_torch/csrc/fused_block.cu",
         "replaces": "tf_face_toolbox_tpu/serving/fused_block.py:122",
         "launches": launches["fused_block"],
         "max_abs_err": max(s["max_abs_err"] for s in block_stats),
         "ms": sum(s["ms"] for s in block_stats),
         "plain_ms": sum(s["plain_ms"] for s in block_stats)},
    ]
    say(json.dumps({"kernels": kernels}))
    say(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
