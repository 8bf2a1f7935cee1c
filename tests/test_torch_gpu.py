"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Imports nothing of JAX, so it runs where the card is:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX). Without a CUDA
device every test skips.
"""

import pytest
import torch

from tf_face_toolbox_tpu_torch.ops import fused_preprocess as tpp
from tf_face_toolbox_tpu_torch.serving import fused_block as tfb

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ "
                    "and have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _block(g, cin, b, c, entry):
    def rnd(*shape, scale):
        return torch.randn(*shape, generator=g, device="cuda") * scale
    blk = {"w1": rnd(b, cin, scale=cin ** -0.5),
           "w2": rnd(b, 9, b, scale=(9 * b) ** -0.5),
           "w3": rnd(c, b, scale=b ** -0.5)}
    if entry:
        blk["wp"] = rnd(c, cin, scale=cin ** -0.5)
    blk = {k: v.to(torch.bfloat16) for k, v in blk.items()}
    blk.update(b1=rnd(b, scale=0.1), b2=rnd(b, scale=0.1),
               b3=rnd(c, scale=0.1))
    if entry:
        blk["bp"] = rnd(c, scale=0.1)
    return blk


def _close(got, want):
    """Per-image cosine >= 0.9999 and at most two bf16 steps at the
    map's peak (a rounding flip upstream moves an output by one)."""
    n = got.shape[0]
    got, want = got.double().reshape(n, -1), want.double().reshape(n, -1)
    cos = torch.nn.functional.cosine_similarity(got, want)
    assert cos.min().item() >= 0.9999
    assert (got - want).abs().max().item() <= 2 * want.abs().max().item() / 128


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_preprocess_kernel(cuda, out_dtype):
    x = torch.randint(0, 256, (16, 120, 120, 3), generator=cuda,
                      device="cuda", dtype=torch.uint8)
    flips = torch.randint(0, 2, (16,), generator=cuda, device="cuda")
    before = tpp.fused_preprocess.launches
    got = tpp.fused_preprocess(x, flips, out_h=112, out_w=112,
                               out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tpp.fused_preprocess.launches == before + 1
    assert got.dtype == out_dtype
    want = tpp.fused_preprocess_reference(x, flips, out_h=112, out_w=112)
    tol = 1e-4 if out_dtype == torch.float32 else 1e-4 + want.abs() / 128
    assert ((got.float() - want).abs() <= tol).all()


# (n, h, w, cin, b, c, entry): an entry block on a ragged 14-wide tiling,
# identity blocks packing several images per CTA with a ragged last CTA,
# and a wide bottleneck whose tile must shrink to fit shared memory
_BLOCKS = [(4, 20, 13, 64, 32, 128, True), (5, 7, 7, 256, 64, 256, False),
           (3, 4, 4, 512, 128, 512, False), (2, 14, 14, 512, 512, 512, False)]


@pytest.mark.parametrize("shape", _BLOCKS, ids=str)
def test_fused_block_kernel(cuda, shape):
    n, h, w, cin, b, c, entry = shape
    blk = _block(cuda, cin, b, c, entry)
    x = torch.relu(torch.randn(n, h, w, cin, generator=cuda, device="cuda")
                   ).to(torch.bfloat16)
    before = tfb.fused_bottleneck_block.launches
    got = tfb.fused_bottleneck_block(x, blk)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck_block.launches == before + 1
    _close(got, tfb.bottleneck_block_reference(x, blk))


def test_fused_block_kernel_refuses_f32(cuda):
    blk = {k: (v.float() if v.dtype == torch.bfloat16 else v)
           for k, v in _block(cuda, 64, 32, 64, False).items()}
    x = torch.zeros(1, 4, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        tfb.fused_bottleneck_block(x, blk)


def test_fused_engine_matches_folded(cuda):
    """resnet_v1_50 at full width on a small input: 13 fused launches
    per forward, embeddings within bf16 rounding of the folded engine."""
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.serving import make_serving_apply

    net = create_network("resnet_v1_50", stem="imagenet",
                         dtype=torch.bfloat16)
    flat = random_variables(net, seed=0)
    x = torch.randn(8, 64, 64, 3, generator=cuda, device="cuda")
    folded = make_serving_apply(net, flat, device="cuda")(x)
    before = tfb.fused_bottleneck_block.launches
    fused = make_serving_apply(net, flat, device="cuda", use_kernels=True)(x)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck_block.launches == before + 13
    cos = torch.nn.functional.cosine_similarity(fused.double(),
                                                folded.double())
    assert cos.min().item() >= 0.999
