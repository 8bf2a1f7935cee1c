"""Serving engine: BN-folded ResNet forward, optionally with fused blocks.

Counterpart of ``tf_face_toolbox_tpu/serving/engine.py``. ``build_plan``
folds the JAX variables tree (the same weights the module path loads)
into convs with biases; ``make_serving_apply`` returns
``apply(images) -> (N, D) f32 embeddings`` that runs

- the stem, strided stage-entry blocks, squeeze-excite blocks and head
  as folded convs (cuDNN on the card, through ``F.conv2d``), and
- with ``use_kernels=True``, every stage's run of stride-1 bottleneck
  blocks through the fused-block kernel (``fused_block.py``), one
  launch per block. A stage that holds a squeeze-excite block stays
  folded, as in JAX (the kernel has no SE).

Scope: the ResNet family with groups=1 (ResNet, SE-ResNet; face,
imagenet and space2depth stems). ResNeXt's grouped 3x3, the dct stem,
DenseNet's concat topology and the other families are refused
(``build_plan`` raises ValueError), as JAX's engine refuses them; they
serve through the module path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import torch

from tf_face_toolbox_tpu_torch.interop.port import unflatten_variables
from tf_face_toolbox_tpu_torch.models.layers import (
    max_pool_same_nhwc,
    squeeze_excite,
)
from tf_face_toolbox_tpu_torch.models.resnet import (
    ResNet,
    block_strides,
    space_to_depth,
)
from tf_face_toolbox_tpu_torch.serving import fused_block
from tf_face_toolbox_tpu_torch.serving.fold import (
    FoldedConv,
    as_f32,
    bn_affine,
    fold_conv_bn,
    fold_dense_bn,
)


@dataclass(frozen=True)
class SEWeights:
    """A squeeze-excite block's two Dense layers, (out, in) in the
    compute dtype (eval SE has no BatchNorm to fold)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.w1, self.b1, self.w2, self.b2)

    def to(self, device) -> "SEWeights":
        return SEWeights(*(t.to(device) for t in
                           (self.w1, self.b1, self.w2, self.b2)))


@dataclass(frozen=True)
class BlockPlan:
    conv1: FoldedConv
    conv2: FoldedConv
    conv3: FoldedConv
    proj: FoldedConv | None
    se: SEWeights | None = None

    @property
    def stride1(self) -> bool:
        return self.conv2.strides == 1

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.se is not None:
            y = self.se(y)
        residual = self.proj(x) if self.proj is not None else x
        return torch.relu(residual + y)

    def to(self, device) -> "BlockPlan":
        return BlockPlan(self.conv1.to(device), self.conv2.to(device),
                         self.conv3.to(device),
                         None if self.proj is None else self.proj.to(device),
                         None if self.se is None else self.se.to(device))


@dataclass(frozen=True)
class ServingPlan:
    stem_kind: str
    stem: FoldedConv
    stages: tuple[tuple[BlockPlan, ...], ...]
    head_variant: str
    head_dense: tuple[torch.Tensor, torch.Tensor]        # folded (W, b)
    head_prebn: tuple[torch.Tensor, torch.Tensor] | None  # flatten variant
    compute_dtype: torch.dtype


def _fold_block(params: Any, stats: Any, *, strides: int,
                dtype) -> BlockPlan:
    proj = None
    if "ConvBN_3" in params:
        proj = fold_conv_bn(params["ConvBN_3"], stats["ConvBN_3"],
                            strides=strides, relu=False, dtype=dtype)
    se = None
    if "SqueezeExcite_0" in params:
        sep = params["SqueezeExcite_0"]
        # JAX Dense kernels are (in, out): transposed to (out, in)
        se = SEWeights(
            w1=as_f32(sep["Dense_0"]["kernel"]).T.contiguous().to(dtype),
            b1=as_f32(sep["Dense_0"]["bias"]).to(dtype),
            w2=as_f32(sep["Dense_1"]["kernel"]).T.contiguous().to(dtype),
            b2=as_f32(sep["Dense_1"]["bias"]).to(dtype))
    return BlockPlan(
        conv1=fold_conv_bn(params["ConvBN_0"], stats["ConvBN_0"],
                           dtype=dtype),
        conv2=fold_conv_bn(params["ConvBN_1"], stats["ConvBN_1"],
                           strides=strides, dtype=dtype),
        conv3=fold_conv_bn(params["ConvBN_2"], stats["ConvBN_2"],
                           relu=False, dtype=dtype),
        proj=proj,
        se=se,
    )


def check_servable(net) -> None:
    """Raise ValueError (JAX's messages) for a net outside the engine's
    scope: anything but the ResNet family, grouped convs, or the dct
    stem."""
    if not isinstance(net, ResNet):
        raise ValueError(f"serving engine supports the ResNet family, got "
                         f"{type(net).__name__}; use the module path")
    if net.groups != 1:
        raise ValueError("serving engine does not support grouped convs "
                         "(ResNeXt); use the module path")
    if net.stem == "dct":
        raise ValueError(
            "serving engine does not fold the dct stem (frequency BN + "
            "1x1 + depth2space); use the module path")


def build_plan(net: ResNet, variables: dict) -> ServingPlan:
    """Fold a ResNet's variables ({params, batch_stats} tree, or the flat
    .npz key dict) into a ServingPlan; ``net`` supplies the static
    config (stage sizes, stem, head, compute dtype). Raises ValueError
    for a net outside the engine's scope (``check_servable``)."""
    check_servable(net)
    if not isinstance(next(iter(variables.values())), dict):
        variables = unflatten_variables(variables)
    dtype = net.dtype
    params = variables["params"]
    stats = variables["batch_stats"]
    stem = fold_conv_bn(params["ConvBN_0"], stats["ConvBN_0"],
                        strides=2 if net.stem == "imagenet" else 1,
                        dtype=dtype)
    stages = []
    counter = 0
    for stage_idx, num_blocks in enumerate(net.stage_sizes):
        blocks = []
        for block_idx in range(num_blocks):
            name = f"BottleneckBlock_{counter}"
            blocks.append(_fold_block(
                params[name], stats[name],
                strides=block_strides(stage_idx, block_idx, net.stem),
                dtype=dtype))
            counter += 1
        stages.append(tuple(blocks))

    head = params["EmbeddingHead_0"]
    head_s = stats["EmbeddingHead_0"]
    prebn = None
    if net.head_variant == "flatten":
        # eval BN on the pre-flatten map folds to a per-channel affine
        r, c = bn_affine(head["BatchNorm_0"], head_s["BatchNorm_0"])
        prebn = (r.to(dtype), c.to(dtype))
        final_p, final_s = head["BatchNorm_1"], head_s["BatchNorm_1"]
    else:
        final_p, final_s = head["BatchNorm_0"], head_s["BatchNorm_0"]
    head_dense = fold_dense_bn(head["Dense_0"], final_p, final_s, dtype=dtype)
    return ServingPlan(net.stem, stem, tuple(stages), net.head_variant,
                       head_dense, prebn, dtype)


def _fused_operands(block: BlockPlan, with_proj: bool) -> dict:
    """Folded BlockPlan -> the fused kernel's output-major tensor dict."""
    b = block.conv1.kernel.shape[0]
    d = {
        "w1": block.conv1.kernel.reshape(b, -1),
        "b1": block.conv1.bias,
        # OIHW (B, B, 3, 3) -> [out][tap dy*3+dx][in]
        "w2": block.conv2.kernel.permute(0, 2, 3, 1).reshape(b, 9, b),
        "b2": block.conv2.bias,
        "w3": block.conv3.kernel.reshape(block.conv3.kernel.shape[0], b),
        "b3": block.conv3.bias,
    }
    if with_proj:
        d["wp"] = block.proj.kernel.reshape(block.proj.kernel.shape[:2])
        d["bp"] = block.proj.bias
    return {k: v.contiguous() for k, v in d.items()}


def _plan_stage_fusion(blocks: Sequence[BlockPlan]) -> tuple:
    """Split a stage into [folded prefix][one fused segment].

    Returns (n_folded_prefix, entry_dict | None, tail_dict | None). The
    fused segment is the run ending at the stage's last block: an
    optional stride-1 entry (projection) block plus the identity blocks.
    A strided entry block stays folded, and so does every block of a
    stage that holds a squeeze-excite block.
    """
    if any(blk.se is not None for blk in blocks):
        return len(blocks), None, None
    entry = None
    start = 0
    if blocks[0].proj is not None and blocks[0].stride1:
        entry = _fused_operands(blocks[0], with_proj=True)
        start = 1
    elif blocks[0].proj is not None:
        start = 1     # strided entry: folded convs
    tail_blocks = [blk for blk in blocks[start:]
                   if blk.proj is None and blk.stride1]
    if len(tail_blocks) != len(blocks) - start:
        # a mid-stage projection or stride (not in this zoo): don't fuse
        return len(blocks), None, None
    tail = None
    if tail_blocks:
        per = [_fused_operands(blk, with_proj=False) for blk in tail_blocks]
        tail = {name + "s": torch.stack([p[name] for p in per])
                for name in ("w1", "b1", "w2", "b2", "w3", "b3")}
    if entry is None and tail is None:
        return len(blocks), None, None
    return start if entry is None else 0, entry, tail


def _to(d: dict | None, device) -> dict | None:
    return None if d is None else {k: v.to(device) for k, v in d.items()}


def make_serving_apply(net: ResNet, variables: dict, *,
                       use_kernels: bool = False,
                       device: str | torch.device = "cuda") -> Callable:
    """Build ``apply(images) -> (N, D) f32 embeddings`` on ``device``.

    ``use_kernels=False``: the folded engine, folded convs only.
    ``use_kernels=True``: stride-1 block runs go through the fused-block
    kernel on a CUDA device (bf16 compute only) and through its plain
    PyTorch version on the CPU.
    """
    device = torch.device(device)
    plan = build_plan(net, variables)
    cdtype = plan.compute_dtype
    if use_kernels and device.type == "cuda" and cdtype != torch.bfloat16:
        raise ValueError("the fused-block kernel computes in bf16; use "
                         "bf16 compute or the folded engine")
    stem = plan.stem.to(device)
    stages = [tuple(blk.to(device) for blk in blocks)
              for blocks in plan.stages]
    if use_kernels:
        fusion = [(n, _to(entry, device), _to(tail, device))
                  for n, entry, tail in map(_plan_stage_fusion, stages)]
    else:
        fusion = [(len(blocks), None, None) for blocks in stages]
    w, b = (t.to(device) for t in plan.head_dense)
    prebn = (None if plan.head_prebn is None
             else tuple(t.to(device) for t in plan.head_prebn))

    @torch.inference_mode()
    def apply(images: torch.Tensor) -> torch.Tensor:
        x = images.to(device=device, dtype=cdtype)
        if plan.stem_kind == "space2depth":
            x = space_to_depth(x)
        x = stem(x)
        if plan.stem_kind == "imagenet":
            x = max_pool_same_nhwc(x, 3, 2)
        for blocks, (n_folded, entry, tail) in zip(stages, fusion):
            for blk in blocks[:n_folded]:
                x = blk.apply_folded(x)
            if entry is not None or tail is not None:
                x = fused_block.fused_bottleneck_stack(
                    x, entry, tail, h=x.shape[1], w=x.shape[2])
        if plan.head_variant == "flatten":
            r, c = prebn
            x = (x * r + c).reshape(x.shape[0], -1)
        else:
            # jnp.mean of a bf16 map sums in f32 and returns bf16
            x = x.to(torch.float32).mean(dim=(1, 2)).to(cdtype)
        # bf16 products are exact in f32: f32 accumulation, f32 result
        emb = x.to(cdtype).to(torch.float32) @ w.to(torch.float32)
        return emb + b

    return apply
