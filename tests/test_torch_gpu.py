"""The port's CUDA kernels vs their plain PyTorch versions, on a card.

Imports nothing of JAX, so it runs where the card is:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX). Without a CUDA
device every test skips.
"""

import copy
import ctypes

import pytest
import torch

import numpy as np

from tf_face_toolbox_tpu_torch.ops import fused_preprocess as tpp
from tf_face_toolbox_tpu_torch.ops import topk as ttk
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


# (images shape, out_h, out_w, launch_plan overrides): the main path
# at 256 images with random flips; unaligned 14x14 images (588 bytes,
# 4-byte copies) and 5x5 ones (byte loads); an upscale; a large frame;
# clusters 1, 2 and 4 forced; each kernel
# instance forced; four-channel images (a column a value); more images
# than the card holds CTAs at once (each CTA walks several, the next
# one's band copied while this one's is computed) and the main path
# without that; a frame whose bands stage in several chunks; a tall
# one-channel upscale; 224-wide outputs; output rows wider than a CTA
# (several columns a thread)
_PRE_CASES = {
    "main_256": ((256, 120, 120, 3), 112, 112, {}),
    # the trainer's call: 112 x 112 crops, identity resize
    "train_identity_256": ((256, 112, 112, 3), 112, 112, {}),
    "unaligned_14": ((5, 14, 14, 3), 14, 14, {}),
    "unaligned_5x5_bytes": ((3, 5, 5, 3), 4, 4, {}),
    "upscale_10x8_to_16x12": ((4, 10, 8, 3), 16, 12, {}),
    "frame_512": ((8, 512, 512, 3), 112, 112, {}),
    "cluster_1": ((32, 120, 120, 3), 112, 112, {"cluster": 1}),
    "cluster_2": ((32, 120, 120, 3), 112, 112, {"cluster": 2}),
    "cluster_4": ((32, 120, 120, 3), 112, 112, {"cluster": 4}),
    "c1_vals84": ((32, 120, 120, 3), 112, 112, {"cluster": 1, "vals": 84}),
    "c2_vals84": ((32, 120, 120, 3), 112, 112, {"cluster": 2, "vals": 84}),
    "c4_vals42_t448": ((32, 120, 120, 3), 112, 112,
                       {"cluster": 4, "vals": 42, "threads": 448}),
    "rgba_value_columns": ((4, 20, 16, 4), 12, 12, {}),
    "persist_loop_c1": ((600, 120, 120, 3), 112, 112, {"cluster": 1}),
    "persist_loop_c4": ((1100, 120, 120, 3), 112, 112, {"cluster": 4}),
    "no_persist": ((256, 120, 120, 3), 112, 112, {"persist": False}),
    "out_224": ((4, 120, 120, 3), 224, 224, {}),
    "frame_2048_chunked": ((2, 2048, 2048, 3), 112, 112, {}),
    "gray_tall_upscale": ((3, 30, 20, 1), 200, 24, {}),
    "wide_rows": ((3, 4, 300, 3), 4, 1000, {}),
}


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", sorted(_PRE_CASES))
def test_preprocess_kernel(cuda, case, out_dtype):
    """One launch, within the smoke's tolerance of the plain version:
    f32 1e-4 absolute, bf16 one step beyond 1e-4."""
    shape, out_h, out_w, force = _PRE_CASES[case]
    x = torch.randint(0, 256, shape, generator=cuda, device="cuda",
                      dtype=torch.uint8)
    flips = torch.randint(0, 2, (shape[0],), generator=cuda, device="cuda")
    before = tpp.fused_preprocess.launches
    got = tpp.fused_preprocess(x, flips, out_h=out_h, out_w=out_w,
                               out_dtype=out_dtype, **force)
    torch.cuda.synchronize()
    assert tpp.fused_preprocess.launches == before + 1
    assert got.dtype == out_dtype and tuple(got.shape) == (shape[0], out_h, out_w, shape[3])
    want = tpp.fused_preprocess_reference(x, flips, out_h=out_h, out_w=out_w)
    tol = 1e-4 if out_dtype == torch.float32 else 1e-4 + want.abs() / 128
    assert ((got.float() - want).abs() <= tol).all()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(4, 112, 112, 3), (5, 14, 14, 3)], ids=str)
def test_preprocess_kernel_constant_image(cuda, shape, out_dtype):
    """No resize and zero variance: the std floor gives exact zeros."""
    x = torch.full(shape, 77, dtype=torch.uint8, device="cuda")
    got = tpp.fused_eval_preprocess(x, shape[1], shape[2], out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.float().abs().max().item() == 0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(256, 120, 120, 3), (5, 14, 14, 3)], ids=str)
def test_preprocess_eval_path_takes_no_mask(cuda, shape, out_dtype):
    """The eval path launches the kernel alone, with no flip mask, and
    equals the zero-mask launch bit for bit."""
    x = torch.randint(0, 256, shape, generator=cuda, device="cuda",
                      dtype=torch.uint8)
    zeros = torch.zeros(shape[0], dtype=torch.int32, device="cuda")
    size = 112 if shape[1] == 120 else shape[1]
    want = tpp.fused_preprocess(x, zeros, out_h=size, out_w=size,
                                out_dtype=out_dtype)
    before = tpp.fused_preprocess.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = tpp.fused_eval_preprocess(x, size, size, out_dtype=out_dtype)
        torch.cuda.synchronize()
    assert tpp.fused_preprocess.launches == before + 1
    assert torch.equal(got, want)
    names = {e.key for e in prof.key_averages() if e.device_type.name == "CUDA"}
    kernels = {k for k in names if "Memcpy" not in k and "Memset" not in k}
    assert all("preprocess_kernel" in k for k in kernels), kernels


def test_preprocess_kernel_refuses_a_plan_mismatch(cuda, monkeypatch):
    """A plan whose shared-memory sum is not its own is refused (-2)
    and the wrapper raises; nothing falls back."""
    x = torch.zeros((2, 120, 120, 3), dtype=torch.uint8, device="cuda")
    prep = copy.copy(tpp._prepared(
        (2, 120, 120, 3, 112, 112, False, None, None, None, None, None),
        x.device))
    prep.launch = tpp._Launch.from_buffer_copy(prep.launch)
    prep.launch.smem_bytes += 16
    prep.ref = ctypes.addressof(prep.launch)
    monkeypatch.setattr(tpp, "_prepared", lambda key, device: prep)
    before = tpp.fused_preprocess.launches
    with pytest.raises(RuntimeError, match="refused the plan"):
        tpp.fused_eval_preprocess(x, 112, 112)
    assert tpp.fused_preprocess.launches == before


# (n, h, w, cin, b, c, entry): an entry block on a ragged 14-wide tiling,
# identity blocks packing several images per CTA with a ragged last CTA,
# a wide bottleneck whose tile must shrink to fit shared memory with a
# 2-stage ring; then the ring's edges: K (cin 80, b 48) not a multiple
# of the 64-wide chunk, n-blocks that overhang b and c (80 in a 128-wide
# block, 208 in 256), M not a multiple of 16 (9 tile rows), and the 4x4
# x 2048 -> 512 stage's shape with the projection; then the whole-image
# taps: a 1x1 map (every tap but the centre reads the zero row), a
# 16x16 whole image, 17x17 (tiled, with halos), n odd at 4x4 x 512 with
# the projection, and a 5x5 map on a pair
_BLOCKS = [(4, 20, 13, 64, 32, 128, True), (5, 7, 7, 256, 64, 256, False),
           (3, 4, 4, 512, 128, 512, False), (2, 14, 14, 512, 512, 512, False),
           (2, 9, 9, 80, 48, 96, True), (3, 5, 6, 208, 80, 208, False),
           (1, 3, 3, 64, 64, 64, False), (3, 4, 4, 2048, 512, 2048, True),
           (2, 1, 1, 256, 64, 256, False), (3, 16, 16, 128, 64, 128, False),
           (2, 17, 17, 64, 32, 128, True), (5, 4, 4, 2048, 512, 2048, True),
           (3, 5, 5, 256, 64, 256, False)]


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


# (n, h, w, cin, b, c, entry, g) forced on lone CTAs and on a pair: a
# ragged last group (5 images at g 4, 3 at g 2) at the 4x4 x 2048 -> 512
# stage's shape with the projection, the 7x7 stage's widths at g 2, a
# 5x5 and a 1x1 map
_PAIRS = [(5, 4, 4, 2048, 512, 2048, True, 4), (3, 4, 4, 2048, 512, 2048, True, 2),
          (2, 7, 7, 1024, 256, 1024, False, 2), (3, 5, 5, 256, 64, 256, False, 1),
          (2, 1, 1, 256, 64, 256, True, 2)]


@pytest.mark.parametrize("shape", _PAIRS, ids=str)
def test_fused_block_pair_equals_lone(cuda, monkeypatch, shape):
    """The same block with the plan forced onto lone CTAs and onto
    clusters of two that split the columns: both against the plain
    version, and bit-equal to each other (each output element is one
    thread's mma.sync sequence in the same K order either way)."""
    n, h, w, cin, b, c, entry, g = shape
    blk = _block(cuda, cin, b, c, entry)
    x = torch.relu(torch.randn(n, h, w, cin, generator=cuda, device="cuda")
                   ).to(torch.bfloat16)
    plan = tfb.launch_plan
    outs = []
    for cluster in (1, 2):
        monkeypatch.setattr(tfb, "launch_plan", lambda *a, cl=cluster:
                            plan(*a, g=g, cluster=cl))
        before = tfb.fused_bottleneck_block.launches
        outs.append(tfb.fused_bottleneck_block(x, blk))
        torch.cuda.synchronize()
        assert tfb.fused_bottleneck_block.launches == before + 1
    want = tfb.bottleneck_block_reference(x, blk)
    for got in outs:
        _close(got, want)
    assert torch.equal(outs[0], outs[1])


# the face stem's stride-1 stages at 112 (BASELINE config 4 served by
# --engine fused): 56x56x256 at 256 images (14x14 halo tiles, grid 4,096)
# and at 512 (a batch of 256 faces and their flips), then 28x28x512,
# 14x14x1024 and 7x7x2048, each an identity block
_FACE_STAGES = [(256, 56, 56, 256, 64, 256), (512, 56, 56, 256, 64, 256),
                (256, 28, 28, 512, 128, 512), (256, 14, 14, 1024, 256, 1024),
                (256, 7, 7, 2048, 512, 2048)]


@pytest.mark.parametrize("shape", _FACE_STAGES, ids=str)
def test_fused_block_kernel_face_stem_stages(cuda, shape):
    n, h, w, cin, b, c = shape
    blk = _block(cuda, cin, b, c, False)
    x = torch.relu(torch.randn(n, h, w, cin, generator=cuda, device="cuda")
                   ).to(torch.bfloat16)
    before = tfb.fused_bottleneck_block.launches
    got = tfb.fused_bottleneck_block(x, blk)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck_block.launches == before + 1
    _close(got, tfb.bottleneck_block_reference(x, blk))


def test_fused_engine_face_stem_matches_folded(cuda):
    """resnet_v1_50 with the face stem at 112: 12 fused launches a
    forward (2 + 3 + 5 + 2: each stage's strided entry block stays
    folded), embeddings within bf16 rounding of the folded engine."""
    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.serving import make_serving_apply

    net = create_network("resnet_v1_50", stem="face", dtype=torch.bfloat16)
    flat = random_variables(net, seed=0)
    x = torch.randn(16, 112, 112, 3, generator=cuda, device="cuda")
    folded = make_serving_apply(net, flat, device="cuda")(x)
    before = tfb.fused_bottleneck_block.launches
    fused = make_serving_apply(net, flat, device="cuda", use_kernels=True)(x)
    torch.cuda.synchronize()
    assert tfb.fused_bottleneck_block.launches == before + 12
    cos = torch.nn.functional.cosine_similarity(fused.double(),
                                                folded.double())
    assert cos.min().item() >= 0.999


def test_fused_block_kernel_refuses_f32(cuda):
    blk = {k: (v.float() if v.dtype == torch.bfloat16 else v)
           for k, v in _block(cuda, 64, 32, 64, False).items()}
    x = torch.zeros(1, 4, 4, 64, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        tfb.fused_bottleneck_block(x, blk)


def test_fused_block_kernel_refuses_a_plan_mismatch(cuda, monkeypatch):
    """The C side checks the wrapper's plan and refuses a shared-memory
    sum that is not its tiles' and ring's: the wrapper raises, no
    fallback."""
    blk = _block(cuda, 64, 64, 64, False)
    x = torch.zeros(1, 4, 4, 64, device="cuda", dtype=torch.bfloat16)
    plan = tfb.launch_plan

    def off_by_16(*args):
        return {**plan(*args), "smem_bytes": plan(*args)["smem_bytes"] + 16}

    monkeypatch.setattr(tfb, "launch_plan", off_by_16)
    before = tfb.fused_bottleneck_block.launches
    with pytest.raises(RuntimeError, match="out of step"):
        tfb.fused_bottleneck_block(x, blk)
    assert tfb.fused_bottleneck_block.launches == before


def test_fused_block_kernel_refuses_a_pair_it_cannot_split(cuda, monkeypatch):
    """A pair whose halves of B are not multiples of 16 (B 48), and a
    pair on a halo tile: the C side refuses both, the wrapper raises,
    nothing falls back to lone CTAs."""
    plan = tfb.launch_plan
    for shape in ((1, 4, 4, 64, 48, 64), (1, 20, 13, 64, 64, 64)):
        blk = _block(cuda, *shape[3:], False)
        x = torch.zeros(shape[:4], device="cuda", dtype=torch.bfloat16)
        monkeypatch.setattr(tfb, "launch_plan", lambda *a: {
            **plan(*a, cluster=1), "cluster": 2})
        before = tfb.fused_bottleneck_block.launches
        with pytest.raises(RuntimeError, match="cluster of 2"):
            tfb.fused_bottleneck_block(x, blk)
        assert tfb.fused_bottleneck_block.launches == before


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


def _unit_rows(g, n, d):
    x = torch.randn(n, d, generator=g, device="cuda")
    return x / x.norm(dim=1, keepdim=True)


def _quantize(x):
    """Per-row symmetric int8, as serving/gallery._quantize_rows."""
    scale = (x.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    q = torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def assert_topk_matches(got, want, want_next=None, *, tol=1e-5):
    """Kernel 3's bar: scores within ``tol`` of the plain version's,
    indices equal except where the plain scores around a position are
    within ``tol`` of each other (f32 sums in another order may swap
    them). ``want_next``: the plain version's top k+1 scores."""
    gs, gi = (t.cpu().numpy() for t in got)
    ws, wi = (t.cpu().numpy() for t in want)
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
    ref = ws if want_next is None else want_next.cpu().numpy()
    gap = np.diff(-ref, axis=1) <= tol             # near-tie with next
    k = ws.shape[1]
    near = np.zeros_like(wi, bool)
    near[:, 1:] |= gap[:, :k - 1]
    near[:, :gap.shape[1]] |= gap[:, :k]
    assert (gi == wi)[~near].all()


# (cap, n_valid, batch, k): ragged fill and capacity, a batch that is
# not a multiple of a probe tile, k at the kernels' limit; for kernel 3:
# one 64-probe tile and a ragged second one, k = 1024 at B = 64, a store
# smaller than one 256-row ring stage, nothing valid, everything valid,
# and a capacity off the tile rows over many slices
_TOPK_CASES = [(3000, 2500, 1, 5), (4133, 4100, 33, 20), (2048, 1100, 7, 1024),
               (700, 700, 64, 100), (5000, 4800, 64, 5), (5000, 4800, 65, 5),
               (2048, 2000, 64, 1024), (100, 90, 3, 5), (1000, 0, 5, 5),
               (1000, 1000, 9, 5), (70001, 69000, 16, 20)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", _TOPK_CASES, ids=str)
def test_topk_kernel_vs_plain(cuda, dtype, case):
    cap, n, b, k = case
    d = 512
    store = _unit_rows(cuda, cap, d)
    store[cap - 1] = store[7]                       # duplicate in another CTA
    probes = torch.cat([store[7:8], _unit_rows(cuda, b - 1, d)])
    bias = torch.zeros(cap, device="cuda")
    dead = torch.randperm(n, generator=cuda, device="cuda")[:max(1, n // 100)]
    dead = dead[(dead != 7) & (dead != cap - 1)]
    bias[dead] = -2e9
    if dtype == "int8":
        gq, gs = _quantize(store)
        pq, ps = _quantize(probes)
        before = ttk.cosine_topk_q.launches
        got = ttk.cosine_topk_q(gq, gs, pq, ps, n, k, bias=bias)
        torch.cuda.synchronize()
        assert ttk.cosine_topk_q.launches == before + 1
        want = ttk.cosine_topk_q_reference(gq, gs, pq, ps, n, k, bias=bias)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])             # bit-equal scores
    else:
        st = store.to(getattr(torch, dtype))
        before = ttk.cosine_topk.launches
        got = ttk.cosine_topk(st, probes, n, k, bias=bias)
        torch.cuda.synchronize()
        assert ttk.cosine_topk.launches == before + 1
        want = ttk.cosine_topk_reference(st, probes, n, k, bias=bias)
        nxt = ttk.cosine_topk_reference(st, probes, n, min(k + 1, cap),
                                        bias=bias)[0]
        assert_topk_matches(got, want, nxt)
    s, i = (t.cpu().numpy() for t in got)
    live = int(n - len(dead))
    assert (np.diff(s, axis=1) <= 0).all()
    if k <= live:                       # masked / dead rows never surface
        assert (i < n).all() and not np.isin(i, dead.cpu().numpy()).any()
    # the duplicated row: the smaller index first, when both make the cut
    if dtype != "int8" and cap - 1 < n:
        assert i[0, 0] == 7 and i[0, 1] == cap - 1
    if n == 0:                          # all rows tie at -2e9: by index
        assert (i == np.arange(k)).all() and (s == -2e9).all()


@pytest.mark.parametrize("dtype,d", [("float32", 4), ("float32", 136),
                                     ("bfloat16", 8), ("bfloat16", 136),
                                     ("int8", 16), ("int8", 144)])
def test_topk_kernel_narrow_rows(cuda, dtype, d):
    """Rows of one 16-byte piece, and rows whose last 128-byte column
    chunk is partial (D = 136: 544 B f32, 272 B bf16; D = 144 int8):
    the ring's zero-fill past the row must leave the sums exact."""
    cap, n, b, k = 3000, 2900, 5, 10
    if dtype == "int8":
        gq, gs = _quantize(_unit_rows(cuda, cap, d))
        pq, ps = _quantize(_unit_rows(cuda, b, d))
        got = ttk.cosine_topk_q(gq, gs, pq, ps, n, k)
        torch.cuda.synchronize()
        want = ttk.cosine_topk_q_reference(gq, gs, pq, ps, n, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        return
    st = _unit_rows(cuda, cap, d).to(getattr(torch, dtype))
    probes = _unit_rows(cuda, b, d)
    got = ttk.cosine_topk(st, probes, n, k)
    torch.cuda.synchronize()
    want = ttk.cosine_topk_reference(st, probes, n, k)
    nxt = ttk.cosine_topk_reference(st, probes, n, k + 1)[0]
    assert_topk_matches(got, want, nxt)


@pytest.mark.parametrize("order", ["ascending", "descending", "clustered"])
def test_topk_kernel_adversarial_orderings(cuda, order):
    """Scores that rise with the row (every row enters every list),
    fall (none enters after the first tile), or sit in one tile (the
    whole top-k in one CTA): index- and score-equal to the plain
    version, k past one 32-entry chunk of the lists."""
    cap, d, k = 8192, 128, 100
    base = _unit_rows(cuda, 1, d)[0]
    if order == "ascending":
        s = torch.linspace(-0.9, 0.9, cap, device="cuda")
    elif order == "descending":
        s = torch.linspace(0.9, -0.9, cap, device="cuda")
    else:
        s = torch.linspace(-0.5, 0.0, cap, device="cuda")
        s[5000:5000 + k] = torch.linspace(0.9, 0.99, k, device="cuda")
    other = _unit_rows(cuda, cap, d)
    other = other - (other @ base)[:, None] * base
    other = other / other.norm(dim=1, keepdim=True)
    store = s[:, None] * base + (1 - s * s).sqrt()[:, None] * other
    probes = base[None].repeat(3, 1)
    got = ttk.cosine_topk(store, probes, cap, k)
    torch.cuda.synchronize()
    want = ttk.cosine_topk_reference(store, probes, cap, k)
    nxt = ttk.cosine_topk_reference(store, probes, cap, k + 1)[0]
    assert_topk_matches(got, want, nxt)
    assert len(set(got[1][0].tolist())) == k


@pytest.mark.parametrize("k", [1100, 5000, 12000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_topk_kernel_large_k(cuda, dtype, k):
    """k past 1024: lists in shared memory (1100; 5000, whose merge
    needs more than 48 KB of shared memory) and in the workspace with a
    global merge scratch (12,000), against the plain version."""
    cap, n, b, d = 1 << 15, 30000, 2, 128
    store = _unit_rows(cuda, cap, d)
    probes = torch.cat([store[7:8], _unit_rows(cuda, b - 1, d)])
    bias = torch.zeros(cap, device="cuda")
    bias[torch.arange(0, n, 97, device="cuda")] = -2e9
    plan = ttk.launch_plan(b, cap, k, ttk._n_sms(store.device),
                           dtype=getattr(torch, dtype))
    assert plan["shared_lists"] == (k < 12000)
    if dtype == "int8":
        gq, gs = _quantize(store)
        pq, ps = _quantize(probes)
        got = ttk.cosine_topk_q(gq, gs, pq, ps, n, k, bias=bias)
        torch.cuda.synchronize()
        want = ttk.cosine_topk_q_reference(gq, gs, pq, ps, n, k, bias=bias)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        return
    st = store.to(getattr(torch, dtype))
    got = ttk.cosine_topk(st, probes, n, k, bias=bias)
    torch.cuda.synchronize()
    want = ttk.cosine_topk_reference(st, probes, n, k, bias=bias)
    nxt = ttk.cosine_topk_reference(st, probes, n, k + 1, bias=bias)[0]
    assert_topk_matches(got, want, nxt)


@pytest.mark.parametrize("k", [20, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_topk_kernel_neg_inf_bias(cuda, dtype, k):
    """A -inf bias on the first k rows of every slice fills each list
    with (-inf, row) entries, which rank ahead of the empty (-inf,
    INT_MAX) ones; the next live row must still insert in place."""
    cap, n, b, d = 1 << 15, 30000, 3, 128
    store = _unit_rows(cuda, cap, d)
    probes = _unit_rows(cuda, b, d)
    plan = ttk.launch_plan(b, cap, k, ttk._n_sms(store.device),
                           dtype=getattr(torch, dtype))
    bias = torch.zeros(cap, device="cuda")
    for s in range(0, cap, plan["slice_rows"]):
        bias[s:s + k] = -float("inf")
    if dtype == "int8":
        gq, gs = _quantize(store)
        pq, ps = _quantize(probes)
        got = ttk.cosine_topk_q(gq, gs, pq, ps, n, k, bias=bias)
        torch.cuda.synchronize()
        want = ttk.cosine_topk_q_reference(gq, gs, pq, ps, n, k, bias=bias)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
        return
    st = store.to(getattr(torch, dtype))
    got = ttk.cosine_topk(st, probes, n, k, bias=bias)
    torch.cuda.synchronize()
    want = ttk.cosine_topk_reference(st, probes, n, k, bias=bias)
    nxt = ttk.cosine_topk_reference(st, probes, n, k + 1, bias=bias)[0]
    assert_topk_matches(got, want, nxt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_gallery_runs_the_kernels(cuda, dtype):
    """Resident and streamed searches of a CUDA store launch kernel 3
    (f32/bf16) or 4 (int8) on every call, and agree with the plain
    programs (use_kernels=False)."""
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    rng = np.random.default_rng(0)
    e = rng.normal(size=(300, 64)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    counter = ttk.cosine_topk_q if dtype == "int8" else ttk.cosine_topk
    res = DeviceGallery(64, block=8, dtype=dtype, device="cuda")
    plain = DeviceGallery(64, block=8, dtype=dtype, device="cuda")
    plain.use_kernels = False
    limit = 64 * 64 * res.itemsize / 1e9
    stream = DeviceGallery(64, block=8, dtype=dtype, hbm_limit_gb=limit,
                           overflow="stream", device="cuda")
    stream.stream_slab_bytes = 64 * 64 * res.itemsize    # 64-row slabs
    for g in (res, plain, stream):
        g.enroll(e[:250], np.arange(250))
        g.enroll(e[250:], np.arange(250, 300))
        g.remove(3)
    assert stream.streaming
    before = counter.launches
    lr, sr = res.search(e[:9], k=5)
    assert counter.launches == before + 1
    ls, ss = stream.search(e[:9], k=5)
    assert counter.launches == before + 1 + 5           # one per slab
    lp, sp = plain.search(e[:9], k=5)
    assert counter.launches == before + 6
    np.testing.assert_array_equal(lr, lp)
    np.testing.assert_array_equal(ls, lp)
    np.testing.assert_allclose(sr, sp, atol=1e-5)
    assert 3 not in lr


@pytest.mark.parametrize("dtype,dim", [("float32", 100), ("bfloat16", 100),
                                       ("int8", 100), ("float32", 5)])
def test_cuda_gallery_any_width(cuda, dtype, dim):
    """Rows that are not a multiple of 16 bytes: the gallery pads its
    store and probes, the kernels launch, and the results equal the
    plain programs' (int8: exactly; f32/bf16: away from near-ties)."""
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    rng = np.random.default_rng(dim)
    e = rng.normal(size=(3000, dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    counter = ttk.cosine_topk_q if dtype == "int8" else ttk.cosine_topk
    kern = DeviceGallery(dim, block=512, dtype=dtype, device="cuda")
    plain = DeviceGallery(dim, block=512, dtype=dtype, device="cuda")
    plain.use_kernels = False
    for g in (kern, plain):
        g.enroll(e, np.arange(3000))
        g.remove(11)
    assert (kern._dev.shape[1] * kern.itemsize) % 16 == 0
    before = counter.launches
    lk, sk = kern.search(e[:40], k=10)
    assert counter.launches == before + 1
    # int8 at the same k: its coarse stage keeps 4k rows
    lp, sp = plain.search(e[:40], k=10 if dtype == "int8" else 11)
    if dtype == "int8":
        np.testing.assert_array_equal(lk, lp)
        np.testing.assert_array_equal(sk, sp)
    else:
        gap = np.diff(-sp, axis=1) <= 1e-5
        near = np.zeros(lk.shape, bool)
        near[:, 1:] |= gap[:, :9]
        near |= gap[:, :10]
        assert (lk == lp[:, :10])[~near].all()
        np.testing.assert_allclose(sk, sp[:, :10], atol=1e-5)
    assert 11 not in lk


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_daemon_identify_runs_the_kernels(cuda, dtype):
    """The daemon's /enroll and /identify over a CUDA gallery: every
    /identify launches kernel 3 (f32) or 4 (int8) once, each face finds
    itself first among 5,000 distractors, and the matches equal the
    plain programs' (use_kernels=False) for the embedding /embed gives
    the same body (int8 exactly; f32 away from near-ties)."""
    import io
    import json
    import urllib.request

    from tf_face_toolbox_tpu_torch.models import create_network, random_variables
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery
    from tf_face_toolbox_tpu_torch.serving.server import (
        DynamicBatcher, EmbeddingService, serve)

    net = create_network("resnet_tiny", embedding_dim=32)
    svc = EmbeddingService(net, random_variables(net, 0), image_size=16,
                           crop_from=20, batch=8, dtype=torch.float32,
                           device="cuda")
    svc.warmup()
    rng = np.random.default_rng(1)
    distractors = rng.normal(size=(5000, 32)).astype(np.float32)
    distractors /= np.linalg.norm(distractors, axis=1, keepdims=True)
    gallery = DeviceGallery(32, dtype=dtype, device="cuda")
    gallery.enroll(distractors, np.arange(1000, 6000))
    batcher = DynamicBatcher(svc, max_wait_ms=1.0)
    server = serve(batcher, port=0, gallery=gallery)
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    counter = ttk.cosine_topk_q if dtype == "int8" else ttk.cosine_topk
    try:
        faces = rng.integers(0, 256, (12, 20, 20, 3), dtype=np.uint8)
        bodies = []
        for i, face in enumerate(faces):
            buf = io.BytesIO()
            np.save(buf, face)
            bodies.append(buf.getvalue())
            assert post(f"/enroll?label={i}", bodies[-1])["enrolled"]
        plain = DeviceGallery(32, dtype=dtype, device="cuda")
        plain.use_kernels = False
        plain.enroll(gallery._host[:gallery._n], gallery._lab[:gallery._n])
        before = counter.launches
        for i, body in enumerate(bodies):
            emb = np.asarray(post("/embed", body)["embedding"], np.float32)
            got = post("/identify?k=5", body)["matches"]
            labels = [m["label"] for m in got]
            scores = np.asarray([m["score"] for m in got])
            assert labels[0] == i
            # int8 at the same k: its coarse stage keeps 4k rows
            want_l, want_s = plain.search(emb, k=5 if dtype == "int8" else 6)
            near = np.zeros(5, bool)
            if dtype != "int8":
                gap = np.diff(-want_s[0]) <= 1e-5
                near[1:] |= gap[:4]
                near |= gap[:5]
            assert (np.asarray(labels) == want_l[0, :5])[~near].all()
            np.testing.assert_allclose(scores, want_s[0, :5], atol=1e-5)
        assert counter.launches == before + len(bodies)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()


def test_train_step_kernel_route_matches_plain(cuda):
    """One training step (resnet_v1_50 face stem, bf16, CosFace over
    1,000 classes, batch 64) through kernel 1 and through the plain
    augment chain, from the same variables and draws: one launch, the
    losses within 1%, every leaf's update cosine >= 0.999 (the smoke's
    phase 11 bars)."""
    from tf_face_toolbox_tpu_torch import bench_train as bt

    cfg = bt.config4(num_classes=1000, global_batch=64)
    images = torch.randint(0, 256, (64, 120, 120, 3), generator=cuda,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 1000, (64,), generator=cuda, device="cuda")
    r = bt.step_routes(cfg, images, labels)
    assert r["launches"] == {"kernel": 1, "plain": 0, "plain_again": 0}
    assert r["loss_rel"] <= 0.01, r["loss"]
    assert r["min_cos"] >= 0.999, (r["worst_leaf"], r["min_cos"])


def test_train_step_on_the_card_launches_or_raises(cuda):
    """--pallas_input on a CUDA batch runs kernel 1 once a step; a batch
    the kernel cannot take (float pixels) raises, never falling back."""
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    cfg = TrainConfig(network="resnet_tiny", num_classes=10,
                      embedding_dim=16, image_size=16, crop_from=20,
                      global_batch=8, dtype=torch.bfloat16,
                      pallas_input=True)
    state, net = create_train_state(cfg, 0)
    assert state.classifier.device.type == "cuda"
    step = make_train_step(net, cfg, state)
    x = torch.randint(0, 256, (8, 20, 20, 3), generator=cuda, device="cuda",
                      dtype=torch.uint8)
    y = torch.randint(0, 10, (8,), generator=cuda, device="cuda")
    before = tpp.fused_preprocess.launches
    for _ in range(2):
        state, m = step(state, x, y)
    assert tpp.fused_preprocess.launches == before + 2
    assert torch.isfinite(m["loss"])
    with pytest.raises(ValueError, match="uint8"):
        step(state, x.float(), y)


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A CUDA training state (momentum and EMA after two steps) saved and
    restored onto the card (map_location) into a fresh state: every
    tensor and momentum buffer bit-equal and on the card; the next step
    from both states is bit-equal too (deterministic cuDNN)."""
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    cfg = TrainConfig(network="resnet_tiny", num_classes=10,
                      embedding_dim=16, image_size=16, crop_from=20,
                      global_batch=8, ema_decay=0.9)
    x = torch.randint(0, 256, (3, 8, 20, 20, 3), generator=cuda,
                      device="cuda", dtype=torch.uint8)
    y = torch.randint(0, 10, (3, 8), generator=cuda, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, net = create_train_state(cfg, 0)
        step = make_train_step(net, cfg, state)
        for i in range(2):
            state, _ = step(state, x[i], y[i])
        mgr = CheckpointManager(str(tmp_path / "c"))
        assert mgr.maybe_save(state, force=True)
        fresh, net2 = create_train_state(cfg, 5)
        fresh = mgr.restore(fresh)
        opt, opt2 = (s.opt_state["optimizer"] for s in (state, fresh))
        for name, p in {**state.params, "classifier": state.classifier}.items():
            q = {**fresh.params, "classifier": fresh.classifier}[name]
            assert q.device.type == "cuda" and torch.equal(p, q), name
            b, b2 = (o.state[t]["momentum_buffer"] for o, t in
                     ((opt, p), (opt2, q)))
            assert b2.device.type == "cuda" and torch.equal(b, b2), name
        for a, b in ((state.batch_stats, fresh.batch_stats),
                     (state.ema_params, fresh.ema_params)):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        assert (fresh.step, fresh.opt_state["count"]) == (2, 2)
        state, _ = step(state, x[2], y[2])
        fresh, _ = make_train_step(net2, cfg, fresh)(fresh, x[2], y[2])
        for k in state.params:
            assert torch.equal(state.params[k], fresh.params[k]), k
    finally:
        torch.backends.cudnn.deterministic = deterministic
    raw = mgr.restore_raw()
    assert raw["classifier"].device.type == "cpu"


def test_nccl_at_one_rank_trains_a_step(cuda, monkeypatch):
    """NCCL at one rank, joined from torchrun's variables: a step through
    kernel 1 (one launch) equals the one-process step bit for bit
    (deterministic cuDNN), since the collectives are the identity."""
    import torch.distributed as dist

    import torch_dist as td
    from tf_face_toolbox_tpu_torch.parallel.mesh import init_distributed
    from tf_face_toolbox_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)

    for key, value in dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0,
                           LOCAL_WORLD_SIZE=1, MASTER_ADDR="localhost",
                           MASTER_PORT=td.free_port()).items():
        monkeypatch.setenv(key, str(value))
    cfg = TrainConfig(network="resnet_tiny", num_classes=10,
                      embedding_dim=16, image_size=16, crop_from=20,
                      global_batch=8, pallas_input=True)
    x = torch.randint(0, 256, (8, 20, 20, 3), generator=cuda, device="cuda",
                      dtype=torch.uint8)
    y = torch.randint(0, 10, (8,), generator=cuda, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    topo = init_distributed("cuda")
    try:
        assert topo.device == torch.device("cuda", 0)
        assert dist.get_backend() == "nccl" and topo.data == 1
        states = []
        for mesh in (topo, None):
            state, net = create_train_state(cfg, 0, mesh=mesh)
            before = tpp.fused_preprocess.launches
            state, m = make_train_step(net, cfg, state, mesh=mesh)(state, x,
                                                                  y)
            assert tpp.fused_preprocess.launches == before + 1
            assert torch.isfinite(m["loss"])
            states.append(state)
        for k, p in states[0].params.items():
            assert torch.equal(p, states[1].params[k]), k
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()


def test_two_gloo_ranks_on_one_card_match_replica_loop(cuda):
    """Two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
    GPU), kernel 1 on each rank's augment: the ranks end bit-identical,
    and within the f32 trainer tolerance after three steps (rtol 1e-3,
    atol 3e-4; cuDNN may pick other algorithms in other processes) of
    replica_loop_step in this process."""
    import torch_dist as td

    kw = {"augment": True, "crop_from": 20, "pallas_input": True,
          "dtype": torch.float32}
    with td.Ranks(2, device="cuda:0") as ranks:
        (m0, s0, n0), (m1, s1, n1) = ranks.run(td.train_steps, cfg_kw=kw,
                                               u8=True)
    assert n0 == n1 == td.STEPS
    want_m, want = td.replica_steps(kw, 2, u8=True, device="cuda")

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                yield from walk(a[k], b[k], f"{path}/{k}")
        elif a is None or isinstance(a, (int, float)):
            assert a == b, path
        else:
            yield path, a, b

    for path, a, b in walk(s0[-1], s1[-1]):
        assert np.array_equal(a, b), path
    for path, a, b in walk(s0[-1], want[-1]):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=3e-4, err_msg=path)
    for g, w in zip(m0, want_m):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)


@pytest.mark.parametrize("head", ["exact", "sampled"])
def test_four_gloo_ranks_on_a_data_model_grid(cuda, head):
    """Four ranks sharing cuda:0 over gloo as data 2 x model 2 (the
    class-sharded head: the exact one at 13 classes, padded to 14, or the
    sampled one at 201, rate 0.5), kernel 1 on each rank's augment: three
    steps leave the replicated tensors equal on all four ranks and each
    model index's shard equal on its two data ranks, bit for bit; steps 2
    and 3, taken again from the ranks' state before them, hold to
    replica_loop_step(model=2)'s steps from those states in this process
    (rtol 1e-3, atol 3e-4; losses rtol 1e-4: cuDNN may pick other
    algorithms in other processes, and four ranks sum in another
    order)."""
    import torch_dist as td

    kw = {"augment": True, "crop_from": 20, "pallas_input": True,
          "dtype": torch.float32, "global_batch": 64,
          **({"num_classes": 13} if head == "exact" else
             {"num_classes": 201, "pfc_sample_rate": 0.5})}
    run = {"model": 2, "classes": kw["num_classes"], "u8": True}

    def replicated(snap):
        return {k: v for k, v in snap.items() if k != "classifier"} | {
            "momentum": snap["momentum"]["params"]}

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif a is None or isinstance(a, (int, float)):
            assert a == b
        else:
            assert np.array_equal(a, b)

    with td.Ranks(4, device="cuda:0") as ranks:
        out = ranks.run(td.train_steps, cfg_kw=kw, **run)
        assert [n for _, _, n in out] == [td.STEPS] * 4
        snaps = [s for _, s, _ in out]
        for r in range(4):
            same(replicated(snaps[r][-1]), replicated(snaps[0][-1]))
            same({k: snaps[r][-1][k] for k in ("classifier", "momentum")},
                 {k: snaps[r % 2][-1][k] for k in ("classifier", "momentum")})
        starts = [td.join_shards([s0, s1]) for s0, s1 in
                  zip(snaps[0][:-1], snaps[1][:-1])]
        forced = ranks.run(td.steps_from, cfg_kw=kw, starts=starts, **run)
    plain = td.steps_from(None, kw, starts, world=4, device="cuda", **run)
    for (m_got, s0), (_, s1), (m_want, want) in zip(forced[0], forced[1],
                                                   plain):
        got = td.join_shards([s0, s1])
        np.testing.assert_allclose(m_got["loss"], m_want["loss"], rtol=1e-4)
        for k, v in want["vars"].items():
            np.testing.assert_allclose(got["vars"][k], v, rtol=1e-3,
                                       atol=3e-4, err_msg=k)
        np.testing.assert_allclose(got["classifier"], want["classifier"],
                                   rtol=1e-3, atol=3e-4)


def test_remat_gradients_on_the_card(cuda):
    """remat=True and "save_convs" give the gradients of no remat on the
    card (deterministic cuDNN: the recompute repeats the same kernels),
    at resnet_v1_50's face stem in bf16 over 32 faces."""
    from tf_face_toolbox_tpu_torch import bench_train as bt

    cfg = bt.config4(num_classes=1000, global_batch=32)
    images = torch.randint(0, 256, (32, 120, 120, 3), generator=cuda,
                           device="cuda", dtype=torch.uint8)
    labels = torch.randint(0, 1000, (32,), generator=cuda, device="cuda")
    for name, r in bt.remat_grads(cfg, images, labels).items():
        assert r["max_abs_diff"] == 0, (name, r)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_gallery_runs_the_kernels_on_each_shard(cuda, dtype):
    """A DistributedGallery over [cuda:0] * 4 launches kernel 3 or 4 once
    a shard a search, equals its plain programs (use_kernels=False) and
    a host store of the same shards, keeps JAX's shard-major tie order,
    and tombstones and compacts on the card."""
    from tf_face_toolbox_tpu_torch.serving.distributed_gallery import (
        DistributedGallery)

    rng = np.random.default_rng(1)
    e = rng.normal(size=(1000, 72)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e[2] = e[5] = e[1]                  # shards 1, 2, 1: order 1, 5, 2
    counter = ttk.cosine_topk_q if dtype == "int8" else ttk.cosine_topk
    dev = torch.device("cuda", 0)
    card = DistributedGallery(72, devices=[dev] * 4, block=64, dtype=dtype)
    plain = DistributedGallery(72, devices=[dev] * 4, block=64, dtype=dtype)
    plain.use_kernels = False
    host = DistributedGallery(72, devices=["cpu"] * 4, block=64, dtype=dtype)
    labels = np.arange(1000)
    labels[900:964] = 7777                             # one block's worth
    for g in (card, plain, host):
        g.enroll(e[:700], labels[:700])
        g.enroll(e[700:], labels[700:])                # grows each shard
        g.remove(9)                                    # a tombstone
    before = counter.launches
    lc, sc = card.search(e[:9], k=5)
    assert counter.launches == before + 4
    lp, sp = plain.search(e[:9], k=5)
    lh, sh = host.search(e[:9], k=5)
    assert counter.launches == before + 4
    np.testing.assert_array_equal(lc, lp)
    np.testing.assert_array_equal(lc, lh)
    np.testing.assert_allclose(sc, sp, atol=1e-5)
    assert lc[1, :3].tolist() == [1, 5, 2] and 9 not in lc
    card.compact_frac = 0.0             # past `block` tombstones: compacts
    assert card.remove(7777) == 64
    assert card._tomb == 0 and len(card) == 935
    got, _ = card.search(e[:12], k=3)
    assert not np.isin(got, [9, 7777]).any()
    # rows 2 and 5 equal row 1, which wins their ties (shard 1, slot 0)
    assert got[:, 0].tolist() == [0, 1, 1, 3, 4, 1, 6, 7, 8, got[9, 0], 10, 11]


@pytest.mark.parametrize("name", ["iresnet_tiny", "mobilefacenet_tiny",
                                  "iresnet_50", "mobilefacenet"])
def test_zoo_bf16_on_the_card_tracks_the_f32_module(cuda, name):
    """The two families' module path in bf16 on the card, against the
    f32 module on the host: per-face cosine >= 0.999."""
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import (create_network,
                                                  random_variables)

    net32 = create_network(name, embedding_dim=64)
    flat = random_variables(net32, seed=0)
    load_jax_variables(net32, flat)
    net16 = load_jax_variables(create_network(
        name, embedding_dim=64, dtype=torch.bfloat16), flat).to("cuda")
    x = torch.randn((8, 112, 112, 3), generator=cuda, device="cuda")
    with torch.no_grad():
        got = net16(x).cpu()
        want = net32(x.cpu())
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
    assert cos.min().item() >= 0.999, cos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_store_rows_on_the_card_equal_the_hosts(cuda, dtype):
    """A CUDA store casts or quantizes its f32 rows on the card: bit for
    bit the host's values (bf16 round-to-nearest-even; int8's f32
    scale, f32 division and round-half-even), for strided views, a zero
    row, values at .5 after scaling, and padded widths."""
    from tf_face_toolbox_tpu_torch.serving.gallery import (
        row_width, store_rows)

    rng = np.random.default_rng(3)
    rows = rng.normal(size=(3000, 100)).astype(np.float32)
    rows[7] = 0.0
    rows[8, :3] = [127.0, 0.5, -1.5]       # scale 1: ties at .5 round even
    rows[9] = rng.integers(-300, 300, size=100).astype(np.float32) / 2
    item = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    width = row_width(100, item)
    for view in (rows, rows[1::3]):
        got, gs = store_rows(view, dtype, width, torch.device("cuda"))
        want, ws = store_rows(view, dtype, width, torch.device("cpu"))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want)
        if dtype == "int8":
            assert torch.equal(gs.cpu(), ws)


@pytest.mark.parametrize("name", ["dct_vit_small", "dct_vit_tiny",
                                  "dct_resnet_50"])
def test_dct_nets_bf16_on_the_card_track_the_f32_module(cuda, name):
    """The DCT nets' module path in bf16 on the card, from pixels and
    from their coefficients, against the f32 module on the host:
    per-face cosine >= 0.999."""
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import (create_network,
                                                  random_variables)
    from tf_face_toolbox_tpu_torch.ops.dct import block_dct

    net32 = create_network(name, embedding_dim=64)
    flat = random_variables(net32, seed=0)
    load_jax_variables(net32, flat)
    net16 = load_jax_variables(create_network(
        name, embedding_dim=64, dtype=torch.bfloat16), flat).to("cuda")
    x = torch.randn((8, 112, 112, 3), generator=cuda, device="cuda")
    with torch.no_grad():
        want = net32(x.cpu())
        for entry in (x, block_dct(x)):
            got = net16(entry).cpu()
            assert got.dtype == torch.float32 and torch.isfinite(got).all()
            cos = torch.nn.functional.cosine_similarity(got, want, dim=1)
            assert cos.min().item() >= 0.999, cos


def test_dct_ops_on_the_card_equal_the_hosts(cuda):
    """decode_dct within 1 LSB of the host's, prepare_coefficients within
    1e-4, and the frequency flip equal to the pixel flip, on the card."""
    from tf_face_toolbox_tpu_torch.ops import dct
    from tf_face_toolbox_tpu_torch.ops.jpeg import decode_dct

    rng = np.random.default_rng(3)
    coef = torch.from_numpy(rng.integers(-60, 60, (4, 14, 14, 3, 64),
                                         dtype=np.int16))
    coef[..., 8:] //= 8                  # a JPEG's small high frequencies
    qtab = torch.from_numpy(rng.integers(1, 20, (4, 3, 64), dtype=np.uint16))
    host = decode_dct(coef, qtab)
    card = decode_dct(coef.cuda(), qtab.cuda()).cpu()
    assert (card.int() - host.int()).abs().max().item() <= 1
    prep = dct.prepare_coefficients(coef.cuda(), qtab.cuda()).cpu()
    assert (prep - dct.prepare_coefficients(coef, qtab)).abs().max() <= 1e-4
    x = host.float().cuda()
    flipped = dct.flip_coefficients(dct.block_dct(x))
    assert (flipped - dct.block_dct(x.flip(2))).abs().max().item() <= 1e-3


# ---- int8 serving: torch._int_mm on the card's int8 tensor cores ----------


@pytest.mark.parametrize("n,h,c,o,k,stride,groups", [
    (8, 14, 64, 64, 1, 1, 1), (8, 14, 64, 256, 1, 2, 1),
    (8, 14, 64, 64, 3, 1, 1), (8, 14, 64, 64, 3, 2, 1),
    (1, 3, 12, 12, 3, 1, 1),          # M = 9: rows padded past 16
    (4, 7, 128, 128, 3, 2, 32)])      # ResNeXt's width-4 groups
def test_int8_conv_on_the_card_equals_plain(cuda, n, h, c, o, k, stride,
                                            groups):
    from tf_face_toolbox_tpu_torch.models import layers

    xq = torch.randint(-127, 128, (n, h, h, c), generator=cuda,
                       device="cuda", dtype=torch.int8)
    kq = torch.randint(-127, 128, (o, c // groups, k, k), generator=cuda,
                       device="cuda", dtype=torch.int8)
    before = layers.int8_conv2d_nhwc.launches
    got = layers.int8_conv2d_nhwc(xq, kq, stride, groups)
    assert layers.int8_conv2d_nhwc.launches == before + 1
    assert torch.equal(got, layers.int8_conv2d_plain(xq, kq, stride, groups))
    bf = layers.int8_conv2d_nhwc(xq, kq, stride, groups,
                                 out_dtype=torch.bfloat16)
    assert torch.equal(bf, got.float().to(torch.bfloat16))
    with pytest.raises(TypeError, match="int8 operands"):
        layers.int8_conv2d_nhwc(xq.float(), kq, stride, groups)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_module_path_on_the_card_tracks_the_host(cuda, mode):
    """A resnet_tiny in an int8 mode on the card (``_int_mm``) against the
    same net on the host (the plain route), bf16: per-face cosine >=
    0.9999 (the fp stem's and BatchNorms' last bits may flip a quantum)."""
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import (
        calibrate_quant_stats, create_network, random_variables)

    kw = dict(embedding_dim=32, dtype=torch.bfloat16, input_size=32)
    flat = random_variables(create_network("resnet_tiny", **kw), 0)
    x = torch.randn((4, 32, 32, 3), generator=cuda, device="cuda")
    if mode == "static":
        flat = calibrate_quant_stats("resnet_tiny", flat, [x], **kw)
    host = load_jax_variables(create_network("resnet_tiny", quantized=mode,
                                             **kw), flat)
    card = copy.deepcopy(host).to("cuda")
    with torch.inference_mode():
        got, want = card(x).cpu(), host(x.cpu())
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double())
    assert cos.min().item() >= 0.9999
