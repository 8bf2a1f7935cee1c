"""ResNet-v1 with bottleneck blocks (He et al., arXiv:1512.03385), the
face stem of ArcFace's 112x112 setting (a 3x3/1 conv at the input size,
stage 0 at stride 2) and the gap head: global average pool -> Dense ->
BatchNorm to the embedding. TF "SAME" padding, as the JAX original was
written. The reference runs in eval mode, f32, NCHW."""

from __future__ import annotations

import torch

from port_bench.arch import (Layer, Leaf, bn_leaves, conv_leaf,
                             dense_leaves, out_size)
from port_bench.reference.layers import batch_norm, conv_same, dense

TINY = {"stage_sizes": [1, 2], "width_per_group": 8}


def layers(cfg: dict) -> tuple[list[Layer], list[Leaf]]:
    """Convs and Denses, and variables, of the net ``cfg`` describes."""
    if cfg["stem"] != "face" or cfg["head"] != "gap":
        raise ValueError("the resnet family here has the face stem and "
                         "the gap head")
    size = cfg["image_size"]
    convs, leaves = [], []

    def convbn(path, cin, cout, k, stride, h_in, branch_end=False):
        lay = Layer(f"params/{path}/kernel", "conv", cin, cout, k, stride,
                    h_in, out_size(h_in, stride))
        convs.append(lay)
        leaves.append(conv_leaf(lay))
        leaves.extend(bn_leaves(f"{path}/BatchNorm_0", cout, branch_end))
        return lay.h_out

    channels = 64
    size = convbn("ConvBN_0", 3, 64, 3, 1, size)
    block = 0
    for stage, n in enumerate(cfg["stage_sizes"]):
        width = cfg["width_per_group"] * 2 ** stage
        out = width * cfg["expansion"]
        for i in range(n):
            stride = 2 if i == 0 else 1
            p = f"BottleneckBlock_{block}"
            convbn(f"{p}/ConvBN_0", channels, width, 1, 1, size)
            h = convbn(f"{p}/ConvBN_1", width, width, 3, stride, size)
            convbn(f"{p}/ConvBN_2", width, out, 1, 1, h, branch_end=True)
            if channels != out or stride != 1:
                convbn(f"{p}/ConvBN_3", channels, out, 1, stride, size)
            channels, size, block = out, h, block + 1
    leaves.extend(bn_leaves("EmbeddingHead_0/BatchNorm_0",
                            cfg["embedding_dim"]))
    head = Layer("params/EmbeddingHead_0/Dense_0/kernel", "dense", channels,
                 cfg["embedding_dim"])
    convs.append(head)
    leaves.extend(dense_leaves(head))
    return convs, leaves


def forward(v: dict, x: torch.Tensor, cfg: dict, quant=None
            ) -> torch.Tensor:
    """(N, 3, S, S) standardized pixels -> (N, D) embeddings (not
    normalized). ``v``: the variables as f32 tensors on ``x``'s
    device."""

    def convbn(x, path, stride, relu=True):
        y = conv_same(x, v[f"params/{path}/kernel"], stride, quant)
        y = batch_norm(y, v, f"{path}/BatchNorm_0")
        return torch.relu(y) if relu else y

    x = convbn(x, "ConvBN_0", 1)
    block = 0
    for n in cfg["stage_sizes"]:
        for i in range(n):
            p = f"BottleneckBlock_{block}"
            stride = 2 if i == 0 else 1
            y = convbn(x, f"{p}/ConvBN_0", 1)
            y = convbn(y, f"{p}/ConvBN_1", stride)
            y = convbn(y, f"{p}/ConvBN_2", 1, relu=False)
            if f"params/{p}/ConvBN_3/kernel" in v:
                x = convbn(x, f"{p}/ConvBN_3", stride, relu=False)
            x = torch.relu(x + y)
            block += 1
    x = x.mean(dim=(2, 3))
    x = dense(x, v, "EmbeddingHead_0/Dense_0", quant)
    return batch_norm(x, v, "EmbeddingHead_0/BatchNorm_0")


def program_kwargs(cfg: dict) -> dict:
    """The fields of the program's ResNet that ``cfg`` sets."""
    return {"stem": cfg["stem"], "head_variant": cfg["head"],
            "input_size": cfg["image_size"],
            "stage_sizes": tuple(cfg["stage_sizes"]),
            "width_per_group": cfg["width_per_group"],
            "expansion": cfg["expansion"]}
