"""Bench of the int8 conv routes on one GPU (the W8A8 convs of
``models/layers.py``).

    python -m tf_face_toolbox_tpu_torch.bench_int8
        [--net resnext_50|resnet_v1_50] [--batch 256] [--seed 0]

At each int8 conv shape of the net at the face stem (112x112 in; the
stem stays fp), ``--batch`` images, int8 operands from the seed:
milliseconds (CUDA events) of ``int8_conv2d_nhwc`` as the package runs
it (one ``torch._int_mm``; a grouped conv block-diagonal) and of the bf16
cuDNN conv of the same values, the float reference. For a grouped conv
also the two other routes that can be exact:

- ``per_group``: one ``torch._int_mm`` a group, over a (G, M, K / G)
  im2col (``per_group_int_mm``);
- ``cudnn_f32``: cuDNN's f32 conv of the int8 values with TF32 off,
  exact only where cuDNN sums directly (each partial sum an integer
  below 2^24), not where it picks a transform-domain algorithm.

Every route is held bit for bit against the float64 plain version
(``int8_conv2d_plain``). Prints a line per shape and a JSON summary of
the net's convs summed. There is no CPU mode: a measurement that finds
no card fails.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from tf_face_toolbox_tpu_torch.models import layers

# (width of stage 0, bottleneck expansion, groups) of the nets benched
NETS = {"resnet_v1_50": (64, 4, 1), "resnext_50": (128, 2, 32)}


def face_conv_shapes(width0: int = 64, expansion: int = 4,
                     groups: int = 1) -> list:
    """(h, c_in, k, stride, c_out, groups, count) of every int8 conv of a
    (3, 4, 6, 3) bottleneck net at the face stem, 112x112 in: each
    block's 1x1s, its 3x3 (grouped: ResNeXt) and its projection, by
    (input size, shape); the stem stays fp. The defaults are
    resnet_v1_50's (``NETS``)."""
    from tf_face_toolbox_tpu_torch.models.resnet import block_strides

    shapes: dict = {}
    h, c = 112, 64
    for stage, n in enumerate((3, 4, 6, 3)):
        w = width0 * 2 ** stage
        for b in range(n):
            s = block_strides(stage, b, "face")
            ho = -(-h // s)
            convs = [(h, c, 1, 1, w, 1), (h, w, 3, s, w, groups),
                     (ho, w, 1, 1, expansion * w, 1)]
            if c != expansion * w or s != 1:
                convs.append((h, c, 1, s, expansion * w, 1))
            for key in convs:
                shapes[key] = shapes.get(key, 0) + 1
            h, c = ho, expansion * w
    return [(*key, n) for key, n in shapes.items()]


def per_group_int_mm(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                     groups: int) -> torch.Tensor:
    """A grouped int8 SAME conv as one ``torch._int_mm`` a group, each on
    its own (M, K / groups) im2col and kernel block, every operand
    starting 256-byte aligned (M padded to a multiple of 32 rows, a
    kernel block to 256 values; K and O a group to multiples of 8), all
    padding zeros. -> (N, Ho, Wo, O) int32."""
    o, cg, kh, kw = kq.shape
    og, kk = o // groups, kh * kw
    taps = _taps(xq, kh, stride)
    n, ho, wo = taps[0].shape[:3]
    m = n * ho * wo
    mp = max(-(-m // 32) * 32, 32)
    kp, np_ = -(-kk * cg // 8) * 8, -(-og // 8) * 8
    a = xq.new_zeros((groups, mp, kp))
    cols = a[:, :m, :kk * cg].unflatten(1, (n, ho, wo)).unflatten(-1,
                                                                  (kk, cg))
    for t, tap in enumerate(taps):
        cols[..., t, :] = tap.unflatten(-1, (groups, cg)).permute(3, 0, 1,
                                                                  2, 4)
    block = -(-np_ * kp // 256) * 256
    w = kq.new_zeros((groups, block))
    w[:, :np_ * kp].unflatten(1, (np_, kp))[:, :og, :kk * cg] = (
        kq.view(groups, og, cg, kh, kw).permute(0, 1, 3, 4, 2)
        .reshape(groups, og, kk * cg))
    y = torch.empty((groups, mp, np_), dtype=torch.int32, device=xq.device)
    for g in range(groups):
        torch._int_mm(a[g], w[g, :np_ * kp].view(np_, kp).t(), out=y[g])
    return y[:, :m, :og].permute(1, 0, 2).reshape(n, ho, wo, o)


def _taps(x: torch.Tensor, k: int, stride: int) -> list:
    """The k * k shifted strided views (N, Ho, Wo, C) of SAME-padded
    NHWC ``x``, in (row, column) order."""
    h, w = x.shape[1:3]
    top, bottom, left, right = layers.same_pad(h, w, k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    ho, wo = -(-h // stride), -(-w // stride)
    return [x[:, dy:dy + stride * (ho - 1) + 1:stride,
              dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(k) for dx in range(k)]


def cudnn_f32(xq: torch.Tensor, kq: torch.Tensor, stride: int,
              groups: int) -> torch.Tensor:
    """cuDNN's f32 SAME conv of the int8 values, TF32 off, as int32."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        y = layers.conv2d_same_nhwc(xq.to(torch.float32),
                                    kq.to(torch.float32), stride,
                                    groups=groups)
    return y.to(torch.int32)


def main(argv=None) -> None:
    from tf_face_toolbox_tpu_torch import bench

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--net", default="resnext_50", choices=sorted(NETS))
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_int8 needs a CUDA device")
    gpu = bench.gpu_info()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    totals: dict = {}
    for h, c, k, s, o, gr, n in face_conv_shapes(*NETS[args.net]):
        xq = torch.randint(-127, 128, (args.batch, h, h, c), generator=g,
                           device="cuda", dtype=torch.int8)
        kq = torch.randint(-127, 128, (o, c // gr, k, k), generator=g,
                           device="cuda", dtype=torch.int8)
        want = layers.int8_conv2d_plain(xq, kq, s, gr)
        routes = {"int8_conv2d_nhwc": layers.int8_conv2d_nhwc}
        if gr > 1:
            routes.update(per_group=per_group_int_mm, cudnn_f32=cudnn_f32)
        row = {}
        for name, fn in routes.items():
            equal = torch.equal(fn(xq, kq, s, gr), want)
            row[name] = (bench.time_ms(fn, xq, kq, s, gr), equal)
        xb, kb = xq.to(torch.bfloat16), kq.to(torch.bfloat16)
        row["bf16_cudnn"] = (bench.time_ms(
            lambda: layers.conv2d_same_nhwc(xb, kb, s, groups=gr)), None)
        for name, (ms, equal) in row.items():
            total = totals.setdefault(name, {"ms": 0.0, "shapes": 0})
            total["ms"] += ms * n
            total["shapes"] += 1
            if equal is not None:
                total["exact_shapes"] = total.get("exact_shapes", 0) + equal
        print(f"{gpu}: {args.net} {h}x{h}x{c} {k}x{k}/{s} -> {o}"
              + (f" in {gr} groups" if gr > 1 else "")
              + f" (x{n}), {args.batch} images: "
              + ", ".join(f"{name} {ms:.3f} ms"
                          + ("" if equal is None else
                             f" ({'exact' if equal else 'NOT exact'})")
                          for name, (ms, equal) in row.items()),
              flush=True)
        del xq, kq, want, xb, kb
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "net": args.net, "batch": args.batch,
                      "summed_over_convs": totals}))


if __name__ == "__main__":
    main()
