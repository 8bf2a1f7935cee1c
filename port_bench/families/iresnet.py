"""iResNet (InsightFace's recognition/arcface_torch/backbones/iresnet.py,
after ArcFace, arXiv:1801.07698): a 3x3/1 conv, BN and PReLU stem;
IBasicBlocks BN -> 3x3 conv -> BN -> PReLU -> 3x3 conv (stride here) ->
BN, plus the identity or a 1x1 conv + BN, with no activation after the
add; the "E" head BN -> flatten -> fc -> BN. Padding 1. The reference
runs in eval mode, f32, NCHW; its flatten runs in (H, W, C) order, the
order the ``fc`` kernel of the ``.npz`` key space is laid out in."""

from __future__ import annotations

import torch

from port_bench.arch import (Layer, Leaf, alpha_leaf, bn_leaves,
                             conv_leaf, dense_leaves, out_size)
from port_bench.reference.layers import batch_norm, conv, dense

TINY = {"stage_sizes": [1, 2], "stage_widths": [8, 16]}


def layers(cfg: dict) -> tuple[list[Layer], list[Leaf]]:
    """A 3x3/1 stem, every stage at stride 2 on its first block's second
    conv, the flatten head."""
    size = cfg["image_size"]
    widths = cfg["stage_widths"]
    convs, leaves = [], []

    def conv3(path, cin, cout, k, stride, h_in):
        lay = Layer(f"params/{path}/kernel", "conv", cin, cout, k, stride,
                    h_in, out_size(h_in, stride))
        convs.append(lay)
        leaves.append(conv_leaf(lay))
        return lay.h_out

    size = conv3("conv1", 3, widths[0], 3, 1, size)
    leaves.extend(bn_leaves("bn1", widths[0]))
    leaves.append(alpha_leaf("prelu", widths[0]))
    channels = widths[0]
    for stage, n in enumerate(cfg["stage_sizes"]):
        width = widths[stage]
        for i in range(n):
            stride = 2 if i == 0 else 1
            p = f"layer{stage + 1}_{i}"
            leaves.extend(bn_leaves(f"{p}/bn1", channels))
            conv3(f"{p}/conv1", channels, width, 3, 1, size)
            leaves.extend(bn_leaves(f"{p}/bn2", width))
            leaves.append(alpha_leaf(f"{p}/prelu", width))
            h = conv3(f"{p}/conv2", width, width, 3, stride, size)
            leaves.extend(bn_leaves(f"{p}/bn3", width, branch_end=True))
            if stride != 1 or channels != width:
                conv3(f"{p}/downsample_conv", channels, width, 1, stride,
                      size)
                leaves.extend(bn_leaves(f"{p}/downsample_bn", width))
            channels, size = width, h
    leaves.extend(bn_leaves("bn2", channels))
    fc = Layer("params/fc/kernel", "dense", channels * size * size,
               cfg["embedding_dim"])
    convs.append(fc)
    leaves.extend(dense_leaves(fc))
    leaves.extend(bn_leaves("features", cfg["embedding_dim"]))
    return convs, leaves


def forward(v: dict, x: torch.Tensor, cfg: dict, quant=None
            ) -> torch.Tensor:
    """(N, 3, S, S) standardized pixels -> (N, D) embeddings (not
    normalized)."""

    def conv3(x, path, stride):
        return conv(x, v[f"params/{path}/kernel"], stride, (1, 1, 1, 1),
                    quant)

    def prelu(x, path):
        a = v[f"params/{path}/alpha"].reshape(1, -1, 1, 1)
        return torch.where(x >= 0, x, a * x)

    x = prelu(batch_norm(conv3(x, "conv1", 1), v, "bn1"), "prelu")
    for stage, n in enumerate(cfg["stage_sizes"]):
        for i in range(n):
            p = f"layer{stage + 1}_{i}"
            stride = 2 if i == 0 else 1
            y = batch_norm(x, v, f"{p}/bn1")
            y = batch_norm(conv3(y, f"{p}/conv1", 1), v, f"{p}/bn2")
            y = prelu(y, f"{p}/prelu")
            y = batch_norm(conv3(y, f"{p}/conv2", stride), v, f"{p}/bn3")
            if f"params/{p}/downsample_conv/kernel" in v:
                x = conv(x, v[f"params/{p}/downsample_conv/kernel"], stride,
                         (0, 0, 0, 0), quant)
                x = batch_norm(x, v, f"{p}/downsample_bn")
            x = y + x
    x = batch_norm(x, v, "bn2")
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = dense(x, v, "fc", quant)
    return batch_norm(x, v, "features")


def program_kwargs(cfg: dict) -> dict:
    """The fields of the program's iResNet that ``cfg`` sets (the stem
    and head, which the program pins, as ``cli.extract`` passes them)."""
    return {"stem": cfg["stem"], "head_variant": cfg["head"],
            "input_size": cfg["image_size"],
            "stage_sizes": tuple(cfg["stage_sizes"]),
            "stage_widths": tuple(cfg["stage_widths"])}
