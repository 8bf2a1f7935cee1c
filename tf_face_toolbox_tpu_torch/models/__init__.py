"""Network factory: name -> backbone module, seeded random weights, and
a fresh training init.

    net = create_network("resnet_v1_50", dtype=torch.bfloat16)
    load_jax_variables(net, random_variables(net, seed=0))
    embeddings = net(images)                       # (N, 512) float32
    init_parameters(net, seed=0)                   # before training

    flat = calibrate_quant_stats("resnet_v1_50", flat, batches)
    int8 = load_jax_variables(create_network("resnet_v1_50",
                                             quantized="static"), flat)

Every entry of the JAX registry is ported: the ResNet family (ResNet,
SE-ResNet, ResNeXt, SE-ResNeXt, the dct-stem ResNet), DenseNet, iResNet,
MobileFaceNet and the JPEG-block-token ViT family. The ResNet family and
DenseNet take JAX's int8 modes (``quantized=``, models/layers.py);
iResNet, MobileFaceNet and the ViTs refuse them, as JAX's do.
"""

from __future__ import annotations

import logging
import math
from typing import Any

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models.densenet import DenseNet
from tf_face_toolbox_tpu_torch.models.iresnet import IResNet
from tf_face_toolbox_tpu_torch.models.mobilefacenet import MobileFaceNet
from tf_face_toolbox_tpu_torch.models.resnet import ResNet
from tf_face_toolbox_tpu_torch.models.vit import FaceViT

# ResNeXt 32x4d: bottleneck width 128 at stage 0 with expansion 2
_RESNEXT = dict(groups=32, width_per_group=4, expansion=2)
_IRESNET = dict(stem="face", head_variant="flatten")
_MOBILE = dict(stem="mobile", head_variant="gdconv")
_VIT = dict(stem="dct", head_variant="gap")

# name -> (module class, fixed kwargs), as in the JAX registry
_REGISTRY: dict[str, tuple[type, dict[str, Any]]] = {
    "resnet_v1_50": (ResNet, dict(stage_sizes=(3, 4, 6, 3))),
    "resnet_v1_101": (ResNet, dict(stage_sizes=(3, 4, 23, 3))),
    "resnet_v1_152": (ResNet, dict(stage_sizes=(3, 8, 36, 3))),
    "se_resnet_50": (ResNet, dict(stage_sizes=(3, 4, 6, 3), se_reduction=16)),
    "se_resnet_101": (ResNet, dict(stage_sizes=(3, 4, 23, 3),
                                   se_reduction=16)),
    "resnext_50": (ResNet, dict(stage_sizes=(3, 4, 6, 3), **_RESNEXT)),
    "resnext_101": (ResNet, dict(stage_sizes=(3, 4, 23, 3), **_RESNEXT)),
    "se_resnext_50": (ResNet, dict(stage_sizes=(3, 4, 6, 3), **_RESNEXT,
                                   se_reduction=16)),
    # the JPEG-domain ResNet: r50's late stages after a 28x28 w128 stage
    "dct_resnet_50": (ResNet, dict(stage_sizes=(3, 6, 3),
                                   stage_widths=(128, 256, 512),
                                   stem="dct")),
    "densenet_121": (DenseNet, dict(stage_sizes=(6, 12, 24, 16))),
    "densenet_169": (DenseNet, dict(stage_sizes=(6, 12, 32, 32))),
    # iResNet and MobileFaceNet: stem and head pinned (structural)
    "iresnet_18": (IResNet, dict(stage_sizes=(2, 2, 2, 2), **_IRESNET)),
    "iresnet_50": (IResNet, dict(stage_sizes=(3, 4, 14, 3), **_IRESNET)),
    "iresnet_100": (IResNet, dict(stage_sizes=(3, 13, 30, 3), **_IRESNET)),
    "iresnet_tiny": (IResNet, dict(stage_sizes=(1, 1), stage_widths=(8, 16),
                                   **_IRESNET)),
    "mobilefacenet": (MobileFaceNet, dict(_MOBILE)),
    "mobilefacenet_x2": (MobileFaceNet, dict(width_mult=2.0, **_MOBILE)),
    "mobilefacenet_tiny": (MobileFaceNet,
                           dict(stages=((2, 16, 1, 2), (2, 16, 1, 2)),
                                stem_width=8, head_width=32, **_MOBILE)),
    # the JPEG-block-token ViTs: stem and head pinned (structural);
    # dct_vit_test is a two-block smoke-test net, not a real model
    "dct_vit_small": (FaceViT, dict(depth=12, width=384, num_heads=6,
                                    **_VIT)),
    "dct_vit_tiny": (FaceViT, dict(depth=12, width=192, num_heads=3,
                                   **_VIT)),
    "dct_vit_test": (FaceViT, dict(depth=2, width=32, num_heads=2, **_VIT)),
    # Tiny variant for smoke tests, not a reference model.
    "resnet_tiny": (ResNet, dict(stage_sizes=(1,), width_per_group=16)),
}


def list_networks() -> list[str]:
    return sorted(_REGISTRY)


def create_network(name: str, *, embedding_dim: int = 512,
                   dtype: torch.dtype = torch.float32,
                   **overrides: Any) -> torch.nn.Module:
    """Instantiate a backbone by name (eval mode).

    ``overrides``: any field of the network's module (stem,
    head_variant, stage_sizes, width_per_group, growth_rate,
    input_size, drop_path_rate, ...). A stem or head the registry pins
    (the dct ResNet's stem, iResNet, MobileFaceNet, the ViTs) is
    structural: it wins over a conflicting override,
    with a warning, as in the JAX factory (CLIs pass their --stem/--head
    defaults unconditionally).
    """
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown network '{name}'; available: {list_networks()}")
    cls, kwargs = _REGISTRY[name]
    for pinned in ("stem", "head_variant"):
        if pinned in kwargs and overrides.get(
                pinned, kwargs[pinned]) != kwargs[pinned]:
            logging.warning("network %s pins %s=%s; ignoring %s=%s", name,
                            pinned, kwargs[pinned], pinned,
                            overrides[pinned])
            overrides = {k: v for k, v in overrides.items() if k != pinned}
    net = cls(**{**kwargs, **overrides, "embedding_dim": embedding_dim,
                 "dtype": dtype})
    return net.eval()


def random_variables(net: torch.nn.Module, seed: int = 0
                     ) -> dict[str, np.ndarray]:
    """Seeded random weights as a flat dict in the JAX ``.npz`` key
    space and layouts, for runs without a checkpoint.

    BatchNorm gets non-trivial statistics (mean ~ N(0, 0.2), var ~
    U(0.5, 2)) so folding them is exercised. The last BN of each
    residual branch (ResNet's ``ConvBN_2``, iResNet's ``bn3``, a
    residual MobileFaceNet bottleneck's ``project_bn``) gets a scale of
    U(0.2, 0.5), as a trained net's branches are small against the
    identity; with unit scales the random net's activations grow block
    by block. DenseNet has no residual branch: all its scales are
    U(0.8, 1.2). For the same reason each ViT block's branch-closing
    Dense kernels (``attn/out``, ``mlp2``) have their output columns
    scaled by U(0.2, 0.5): twelve random full-size branches would grow
    the bf16 residual stream past where a cosine against f32 says much.
    PReLU slopes are U(0.1, 0.3); GDConv weights N(0, 2 / (h * w)); the
    ViT's positional table N(0, 0.02) (its init).
    """
    from tf_face_toolbox_tpu_torch.interop import port

    rng = np.random.default_rng(seed)
    ends = {f"params/{name.replace('.', '/')}/{mod.branch_end}/scale"
            for name, mod in net.named_modules()
            if getattr(mod, "branch_end", None)}
    flat = {}
    for key, tensor, kind in port.jax_leaves(net):
        if key.startswith("quant_stats/"):
            continue        # calibration's, not weights
        shape = port.jax_shape(tensor, kind)
        leaf = key.rsplit("/", 1)[1]
        if kind in ("conv", "dense"):
            fan_in = int(np.prod(shape[:-1]))
            gain = 2.0 if kind == "conv" else 1.0
            v = rng.standard_normal(shape) * np.sqrt(gain / fan_in)
            if key.endswith(("/attn/out/kernel", "/mlp2/kernel")):
                v = v * rng.uniform(0.2, 0.5, shape[-1:])
        elif leaf == "pos_embedding":
            v = rng.normal(0.0, 0.02, shape)
        elif leaf == "scale":
            branch_end = "/ConvBN_2/" in key or key in ends
            v = rng.uniform(0.2, 0.5, shape) if branch_end \
                else rng.uniform(0.8, 1.2, shape)
        elif leaf == "alpha":
            v = rng.uniform(0.1, 0.3, shape)
        elif leaf == "gdconv":
            v = rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0]
                                                            * shape[1]))
        elif leaf == "mean":
            v = rng.normal(0.0, 0.2, shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:  # BN and Dense biases
            v = rng.normal(0.0, 0.1, shape)
        flat[key] = v.astype(np.float32)
    return flat


def calibrate_quant_stats(name: str, variables: dict, batches, *,
                          embedding_dim: int = 512,
                          dtype: torch.dtype = torch.float32,
                          device: str | torch.device | None = None,
                          **overrides: Any) -> dict:
    """Static-int8 calibration: each conv's running max |input| (and, in
    the ResNet family, each block's input's: the int8 carry's scale).

    Runs ``batches`` (standardized (N, S, S, 3) images of the serving
    distribution, tensors or arrays) through the network in
    ``quantized="calibrate"`` eval mode on ``device`` (None: each batch's
    own) and returns ``variables`` with the ``quant_stats`` collection
    added, in its form (the flat JAX-key dict or a nested tree): ready
    for ``create_network(..., quantized="static")``. Stats already in
    ``variables`` are continued, as JAX's are. The params and batch
    statistics are untouched: one checkpoint serves fp, dynamic and
    static int8. An empty ``batches`` raises.
    """
    from tf_face_toolbox_tpu_torch.interop import port

    nested = any(isinstance(v, dict) for v in variables.values())
    flat = port.flatten_variables(variables) if nested else dict(variables)
    overrides.pop("quantized", None)
    net = create_network(name, embedding_dim=embedding_dim, dtype=dtype,
                         quantized="calibrate", **overrides)
    fresh = {key: np.full((), np.nan, np.float32)
             for key, _, _ in port.jax_leaves(net)
             if key.startswith("quant_stats/")}
    port.load_jax_variables(net, {**fresh, **flat})
    where = None
    with torch.inference_mode():
        for x in batches:
            x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            if where is None:
                where = torch.device(device) if device else x.device
                net.to(where)
            net(x.to(where))
    if where is None:
        raise ValueError("calibrate_quant_stats: empty batch iterable")
    out = dict(flat)
    for key, tensor, kind in port.jax_leaves(net):
        if key.startswith("quant_stats/"):
            out[key] = port.to_jax_layout(tensor, kind)
    return port.unflatten_variables(out) if nested else out


def _truncated_normal(shape, std: float, generator: torch.Generator
                      ) -> torch.Tensor:
    """N(0, std^2) truncated to two standard deviations, by the inverse
    CDF (jax.random.truncated_normal's support, times std)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    t = torch.empty(shape).uniform_(2 * lo - 1, 1 - 2 * lo,
                                    generator=generator)
    return t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def init_parameters(net: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Fresh training init, in place, with the JAX package's initialisers
    (``tf_face_toolbox_tpu/models/layers.py:31-32``):

    - conv kernels (ConvBN, grouped or not, and DenseNet's plain convs):
      variance_scaling(2.0, "fan_out", truncated normal),
      fan_out = kh * kw * out; iResNet's and MobileFaceNet's (flax's
      default, the net's ``CONV_INIT``): variance_scaling(1.0, "fan_in"),
      fan_in = kh * kw * in / groups;
    - Dense kernels (the head's and squeeze-excite's):
      variance_scaling(1.0, "fan_in", truncated normal); Dense biases 0;
    - BatchNorm: scale 1 (0 for each ResNet branch's last BN, so a
      block starts as the identity), bias 0, running mean 0, var 1;
    - PReLU slopes 0.25; GDConv: variance_scaling(2.0, "fan_in"),
      fan_in = h * w;
    - the ViT: Dense kernels as above, the positional table N(0,
      0.02), LayerNorm scales 1 and biases 0.

    flax's truncated normal divides the standard deviation by
    0.87962566 (the std of N(0, 1) truncated to +-2), so the kernels
    keep the variance scale / fan. Draws come from a CPU generator
    seeded with ``seed`` (not JAX's stream).
    """
    from tf_face_toolbox_tpu_torch.interop import port

    g = torch.Generator().manual_seed(seed)
    conv_gain, conv_fan = getattr(net, "CONV_INIT", (2.0, "fan_out"))
    with torch.no_grad():
        for key, tensor, kind in port.jax_leaves(net):
            leaf = key.rsplit("/", 1)[1]
            if key.startswith("quant_stats/"):
                continue    # calibration's, not weights
            if kind == "conv":
                o, i, kh, kw = tensor.shape
                fan = kh * kw * (o if conv_fan == "fan_out" else i)
                std = math.sqrt(conv_gain / fan) / 0.87962566103423978
                v = _truncated_normal(tensor.shape, std, g)
            elif kind == "dense":
                std = math.sqrt(1.0 / tensor.shape[1]) / 0.87962566103423978
                v = _truncated_normal(tensor.shape, std, g)
            elif leaf == "alpha":
                v = torch.full(tensor.shape, 0.25)
            elif leaf == "gdconv":
                h, w, _ = tensor.shape
                v = _truncated_normal(tensor.shape, math.sqrt(2.0 / (h * w))
                                      / 0.87962566103423978, g)
            elif leaf == "pos_embedding":
                v = torch.randn(tensor.shape, generator=g) * 0.02
            elif leaf == "scale":
                v = torch.full(tensor.shape,
                               0.0 if "/ConvBN_2/" in key else 1.0)
            elif leaf == "var":
                v = torch.ones(tensor.shape)
            else:               # BN and Dense biases, running means
                v = torch.zeros(tensor.shape)
            tensor.copy_(v)
    return net
