"""Fused stride-1 bottleneck blocks with BN already folded in.

Counterpart of ``tf_face_toolbox_tpu/serving/fused_block.py``. Each
block (1x1 reduce, 3x3 SAME, 1x1 expand, residual add, ReLU) is one
launch of the hand-written kernel in ``csrc/fused_block.cu``, which
keeps y1 and y2 on chip. A CUDA tensor goes through the kernel; a CPU
tensor goes through ``bottleneck_block_reference``, the plain PyTorch
version with the same rounding points.

Operands are output-major (PyTorch's (out, in) convention), so each
weight row is contiguous along the reduction and the kernel streams
it through shared memory in 128-byte pieces (``launch_plan``):

    w1 (B, Cin)   w2 (B, 9, B) = [out][tap dy*3+dx][in]   w3 (C, B)
    wp (C, Cin)   biases b1 (B,), b2 (B,), b3 (C,), bp (C,) float32

The rounding points are the TPU kernel's code (not its docstring):
the residual add happens in the compute dtype,

    identity: out = relu(cd(y3 + b3) + x)
    entry:    out = relu(cd(y3 + b3) + cd(x . wp + bp))
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_WEIGHTS = ("w1", "w2", "w3", "wp")
_BIASES = ("b1", "b2", "b3", "bp")

# The kernel's launch plan is decided here (launch_plan) and passed to
# csrc/fused_block.cu, which only checks that it fits and that its
# shared-memory sum is the one its tiles, n-blocks and stages need.
THREADS = 256
WARPS = THREADS // 32
WARP_ROWS, WARP_COLS = 32, 64   # a warp's share of an n-block
PAD = 8                         # y1s / y2s row padding (bf16)
CHUNK = 64                      # K elements of a ring stage
ROW_STRIDE = CHUNK + 8          # bf16 elements of a ring row: 144 bytes
SMEM_BUDGET = 160 * 1024        # y1s + y2s when packing several images
SMEM_MAX = 232448               # a CTA's most shared memory on an H100
SMEM_PER_SM = 228 * 1024        # an SM's, of which the system takes
SMEM_PER_CTA = 1024             # 1 KB per resident CTA


def _tile_bytes(th: int, tw: int, g: int, b: int) -> int:
    return g * ((th + 2) * (tw + 2) + th * tw) * (b + PAD) * 2


def _pick_nb(m: int, n: int) -> int:
    """n-block columns for m output rows: as wide as 64 accumulators a
    thread allow while one pass covers m, no wider than n needs."""
    mt = -(-m // 16)
    nb = 256 if mt <= 4 else 128 if mt <= 8 else 64
    while nb > WARP_COLS and nb // 2 >= n:
        nb //= 2
    return nb


def _phases(th: int, tw: int, g: int, b: int, c: int) -> dict:
    m1, m2 = g * (th + 2) * (tw + 2), g * th * tw
    return {"y1": (m1, b, _pick_nb(m1, b)), "y2": (m2, b, _pick_nb(m2, b)),
            "y3": (m2, c, _pick_nb(m2, c))}


def _plan_bytes(th: int, tw: int, g: int, b: int, c: int, stages: int) -> int:
    ring_rows = max(nb for _, _, nb in _phases(th, tw, g, b, c).values())
    return _tile_bytes(th, tw, g, b) + stages * ring_rows * ROW_STRIDE * 2


def launch_plan(n: int, h: int, w: int, cin: int, b: int, c: int) -> dict:
    """How the fused-block kernel cuts one block over N x H x W pixels.

    - Tiles: maps up to 16 wide are one tile, larger ones 14-wide tiles;
      the tile halves while y1s, y2s and a 2-stage weight ring do not fit
      in ``SMEM_MAX``. Whole-image tiles pack up to 8 images while y1s
      and y2s fit ``SMEM_BUDGET``, halving that count while the ring
      does not fit beside them.
    - Per phase (y1 on the halo; y2; y3 and the projection on the tile):
      ``m`` output rows, ``n`` columns, ``nb`` columns per n-block, which
      the kernel's 8 warps cover in 32 x 64 shares (``nb // 64`` warps
      across, the rest down the rows).
    - A third ring stage where it fits; two CTAs an SM (``ctas_per_sm``,
      the kernel's instance capped at 128 registers a thread) where
      their shared memory fits one.
    """
    th = h if h <= 16 else 14
    tw = w if w <= 16 else 14
    while _plan_bytes(th, tw, 1, b, c, 2) > SMEM_MAX and (th > 1 or tw > 1):
        if th >= tw:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    g = 1
    if th == h and tw == w:
        while g * 2 <= min(8, n) and _tile_bytes(th, tw, g * 2, b) <= SMEM_BUDGET:
            g *= 2
        while g > 1 and _plan_bytes(th, tw, g, b, c, 2) > SMEM_MAX:
            g //= 2
    stages = 3 if _plan_bytes(th, tw, g, b, c, 3) <= SMEM_MAX else 2
    smem = _plan_bytes(th, tw, g, b, c, stages)
    if smem > SMEM_MAX:
        raise ValueError(f"a fused block with B={b} does not fit in shared "
                         f"memory even at a 1x1 tile ({smem} bytes)")
    phases = {name: {"m": m, "n": cols, "nb": nb}
              for name, (m, cols, nb) in _phases(th, tw, g, b, c).items()}
    tiles = -(-h // th) * -(-w // tw)
    ctas_per_sm = 2 if 2 * (smem + SMEM_PER_CTA) <= SMEM_PER_SM else 1
    return {"th": th, "tw": tw, "g": g, "stages": stages, "smem_bytes": smem,
            "ctas_per_sm": ctas_per_sm, "grid": -(-n // g) * tiles,
            "phases": phases}


def bottleneck_block_reference(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """Plain PyTorch version of one fused block: f32 products on the
    compute-dtype operands, rounded to x.dtype where the kernel rounds."""
    n, h, w, cin = x.shape
    cdtype = x.dtype
    f32 = torch.float32
    b = blk["w1"].shape[0]
    x2 = x.reshape(-1, cin)
    y1 = torch.relu(x2.to(f32) @ blk["w1"].to(f32).T + blk["b1"]).to(cdtype)
    y1p = F.pad(y1.reshape(n, h, w, b), (0, 0, 1, 1, 1, 1))
    w2 = blk["w2"].to(f32)
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        sl = y1p[:, dy:dy + h, dx:dx + w, :].reshape(-1, b).to(f32)
        t = sl @ w2[:, tap, :].T
        acc = t if acc is None else acc + t
    y2 = torch.relu(acc + blk["b2"]).to(cdtype)
    y3 = (y2.to(f32) @ blk["w3"].to(f32).T + blk["b3"]).to(cdtype)
    if "wp" in blk:
        shortcut = (x2.to(f32) @ blk["wp"].to(f32).T + blk["bp"]).to(cdtype)
    else:
        shortcut = x2
    return torch.relu(y3 + shortcut).reshape(n, h, w, -1)


def _check_block(x: torch.Tensor, blk: dict) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    cin = x.shape[-1]
    b, c = blk["w1"].shape[0], blk["w3"].shape[0]
    want = {"w1": (b, cin), "w2": (b, 9, b), "w3": (c, b),
            "b1": (b,), "b2": (b,), "b3": (c,)}
    if "wp" in blk:
        want.update(wp=(c, cin), bp=(c,))
    elif cin != c:
        raise ValueError(f"identity block needs Cin == C, got {cin} vs {c}")
    for name, shape in want.items():
        if tuple(blk[name].shape) != shape:
            raise ValueError(f"{name}: want {shape}, got "
                             f"{tuple(blk[name].shape)}")


def fused_bottleneck_block(x: torch.Tensor, blk: dict) -> torch.Tensor:
    """One folded bottleneck block (entry when ``blk`` has wp/bp).

    x: (N, H, W, Cin) in the compute dtype. Returns (N, H, W, C).
    A CPU tensor runs the plain version; a CUDA tensor runs the kernel,
    which takes bf16 activations and weights, f32 biases, and channel
    counts that are multiples of 16.
    """
    _check_block(x, blk)
    if x.device.type == "cpu":
        return bottleneck_block_reference(x, blk)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the fused-block kernel takes bf16, got {x.dtype}")
    for name in _WEIGHTS + _BIASES:
        if name not in blk:
            continue
        t = blk[name]
        want = torch.float32 if name in _BIASES else torch.bfloat16
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on "
                             f"{x.device}, got {t.dtype} on {t.device}")
        if name in _WEIGHTS and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "copies weight rows 16 bytes at a time)")
    from tf_face_toolbox_tpu_torch.kernels.build import check, load_library

    lib = load_library()
    x = x.contiguous()
    n, h, w, cin = x.shape
    b, c = blk["w1"].shape[0], blk["w3"].shape[0]
    plan = launch_plan(n, h, w, cin, b, c)
    out = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    ptr = lambda name: blk[name].data_ptr() if name in blk else None  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    nbs = [plan["phases"][k]["nb"] for k in ("y1", "y2", "y3")]
    status = lib.tfft_bottleneck_block(
        x.data_ptr(), out.data_ptr(), ptr("w1"), ptr("b1"), ptr("w2"),
        ptr("b2"), ptr("w3"), ptr("b3"), ptr("wp"), ptr("bp"),
        n, h, w, cin, b, c, plan["th"], plan["tw"], plan["g"], *nbs,
        plan["stages"], plan["ctas_per_sm"], plan["smem_bytes"],
        x.device.index or 0, stream)
    if status == -2:
        raise RuntimeError(
            f"tfft_bottleneck_block refused the plan {plan}: it does not fit "
            f"in shared memory, or its fields are out of step with its "
            f"shared-memory sum of {plan['smem_bytes']} bytes")
    check(lib, status, "tfft_bottleneck_block")
    fused_bottleneck_block.launches += 1
    return out


fused_bottleneck_block.launches = 0


def _blocks(entry: dict | None, tail: dict | None) -> list[dict]:
    if entry is None and tail is None:
        raise ValueError("need at least one of entry/tail")
    blocks = [entry] if entry is not None else []
    if tail is not None:
        blocks += [{name: tail[name + "s"][k]
                    for name in ("w1", "b1", "w2", "b2", "w3", "b3")}
                   for k in range(tail["w1s"].shape[0])]
    return blocks


def _check_hw(x: torch.Tensor, h: int, w: int) -> None:
    if tuple(x.shape[1:3]) != (h, w):
        raise ValueError(f"x is {tuple(x.shape)}, want spatial ({h}, {w})")


def fused_bottleneck_stack(x: torch.Tensor, entry: dict | None,
                           tail: dict | None, *, h: int, w: int
                           ) -> torch.Tensor:
    """Run [entry?] + K stride-1 identity blocks, one launch per block.

    entry: None, or the stage's stride-1 projection block (keys w1, b1,
      w2, b2, w3, b3, wp, bp; layouts in the module docstring).
    tail: None, or the identity blocks stacked on a leading K axis
      (keys w1s, b1s, w2s, b2s, w3s, b3s).
    """
    _check_hw(x, h, w)
    for blk in _blocks(entry, tail):
        x = fused_bottleneck_block(x, blk)
    return x


def fused_bottleneck_stack_reference(x: torch.Tensor, entry: dict | None,
                                     tail: dict | None, *, h: int, w: int
                                     ) -> torch.Tensor:
    """Plain PyTorch version of ``fused_bottleneck_stack``."""
    _check_hw(x, h, w)
    for blk in _blocks(entry, tail):
        _check_block(x, blk)
        x = bottleneck_block_reference(x, blk)
    return x
