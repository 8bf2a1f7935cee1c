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
M_SLOTS = WARPS * WARP_ROWS // 16  # 16-row m tiles a pass covers at nb 64
PAD = 8                         # y1s / y2s row padding (bf16)
CHUNK = 64                      # K elements of a ring stage
ROW_STRIDE = CHUNK + 8          # bf16 elements of a ring row: 144 bytes
MAX_IMAGES = 8                  # whole images a CTA packs at most
SMEM_MAX = 232448               # a CTA's most shared memory on an H100
SMEM_PER_SM = 228 * 1024        # an SM's, of which the system takes
SMEM_PER_CTA = 1024             # 1 KB per resident CTA
N_SMS = 132                     # an H100 SXM's SMs, where no card is asked


def _whole(th: int, tw: int, h: int, w: int) -> bool:
    return th == h and tw == w


def _tile_rows(th: int, tw: int, g: int, whole: bool) -> int:
    """Rows of y1s + y2s: on whole images y1 holds the image rows and
    one zero row (the 3x3's padding), else the (th+2) x (tw+2) halo."""
    if whole:
        return 2 * g * th * tw + 1
    return g * ((th + 2) * (tw + 2) + th * tw)


def _tile_bytes(th: int, tw: int, g: int, b: int, whole: bool) -> int:
    return _tile_rows(th, tw, g, whole) * (b + PAD) * 2


def _pick_nb(m: int, n: int) -> int:
    """n-block columns for m output rows: the widest (at most 64
    accumulators a thread) whose m-tile slots (``M_SLOTS * 64 // nb`` a
    pass) the rows more than half fill, no wider than n needs."""
    mt = -(-m // 16)
    nb = 256 if mt <= 4 else 128 if mt <= 8 else 64
    while nb > WARP_COLS and nb // 2 >= n:
        nb //= 2
    return nb


def _phases(th: int, tw: int, g: int, b: int, c: int, whole: bool,
            cluster: int) -> dict:
    """name -> (m rows, n columns, columns a CTA computes, nb)."""
    m2 = g * th * tw
    m1 = m2 if whole else g * (th + 2) * (tw + 2)
    out = {}
    for name, m, n in (("y1", m1, b), ("y2", m2, b), ("y3", m2, c)):
        out[name] = (m, n, n // cluster, _pick_nb(m, n // cluster))
    return out


def _plan_bytes(th: int, tw: int, g: int, b: int, c: int, stages: int,
                whole: bool, cluster: int = 1) -> int:
    ring_rows = max(ph[3] for ph in
                    _phases(th, tw, g, b, c, whole, cluster).values())
    return (_tile_bytes(th, tw, g, b, whole)
            + stages * ring_rows * ROW_STRIDE * 2)


def _streamed(phases: dict, cin: int, b: int) -> int:
    """Weight elements a CTA streams through its ring: every pass over
    its rows walks every n-block's slabs (K x nb columns each). The
    projection, where there is one, scales as y3 does."""
    k = {"y1": cin, "y2": 9 * b, "y3": b}
    total = 0
    for name, (m, _, cols, nb) in phases.items():
        m_tiles = -(-m // 16)
        passes = -(-m_tiles // (M_SLOTS * WARP_COLS // nb))
        total += passes * -(-cols // nb) * nb * k[name]
    return total


def _plan(n, h, w, cin, b, c, th, tw, g, cluster, n_sms) -> dict | None:
    whole = _whole(th, tw, h, w)
    if _plan_bytes(th, tw, g, b, c, 2, whole, cluster) > SMEM_MAX:
        return None
    stages = 3 if _plan_bytes(th, tw, g, b, c, 3, whole, cluster) <= SMEM_MAX else 2
    smem = _plan_bytes(th, tw, g, b, c, stages, whole, cluster)
    phases = _phases(th, tw, g, b, c, whole, cluster)
    two = not whole and 2 * (smem + SMEM_PER_CTA) <= SMEM_PER_SM
    ctas_per_sm = 2 if two else 1
    grid = -(-n // g) * -(-h // th) * -(-w // tw) * cluster
    return {"th": th, "tw": tw, "g": g, "cluster": cluster, "stages": stages,
            "smem_bytes": smem, "ctas_per_sm": ctas_per_sm, "grid": grid,
            "stream_bytes": -(-grid // n_sms) * 2 * _streamed(phases, cin, b),
            "phases": {name: {"m": m, "n": cols, "n_cta": nc, "nb": nb}
                       for name, (m, cols, nc, nb) in phases.items()}}


def launch_plan(n: int, h: int, w: int, cin: int, b: int, c: int,
                n_sms: int = N_SMS, *, g: int | None = None,
                cluster: int | None = None) -> dict:
    """How the fused-block kernel cuts one block over N x H x W pixels.

    - Tiles: maps up to 16 wide are one tile, larger ones 14-wide tiles;
      the tile halves while y1s, y2s and a 2-stage weight ring do not fit
      in ``SMEM_MAX``. A tiled map computes y1 on a (th+2) x (tw+2) halo.
      A whole-image tile computes y1 on its image rows only, beside one
      zero row that the 3x3's out-of-image taps read.
    - Whole-image tiles pack ``g`` images (up to ``MAX_IMAGES``), on
      lone CTAs or on clusters of two (``cluster``) that share the same
      images, each CTA computing half of every phase's columns and
      streaming only those weight rows. Of the (g, cluster) that fit,
      the plan takes the one whose busiest SM streams the fewest weight
      bytes (``stream_bytes``: the CTAs an SM runs, ceil(grid / SMs),
      x a CTA's ring traffic), then pairs (on an H100 at equal bytes, a
      pair ran the 14x14 stage about 1% faster than lone CTAs), then the
      smaller g: a smaller g, and so a fuller card, wins wherever it
      costs no more.
      ``g`` and ``cluster`` force either (bench and tests).
    - Per phase (y1; y2; y3 and the projection): ``m`` output rows, ``n``
      columns, ``n_cta`` of them a CTA computes, ``nb`` columns per
      n-block, which the kernel's 8 warps cover in 32 x 64 shares
      (``nb // 64`` warps across, the rest down the rows).
    - A third ring stage where it fits; two CTAs an SM (``ctas_per_sm``,
      the kernel's instance capped at 128 registers a thread) where two
      halo tiles' shared memory fits one (whole images run one CTA an
      SM: their per-tap addressing spills at 128). ``n_sms``: the
      card's SMs.
    """
    th = h if h <= 16 else 14
    tw = w if w <= 16 else 14
    while (_plan_bytes(th, tw, 1, b, c, 2, _whole(th, tw, h, w)) > SMEM_MAX
           and (th > 1 or tw > 1)):
        if th >= tw:
            th = (th + 1) // 2
        else:
            tw = (tw + 1) // 2
    pair_ok = b % 32 == 0 and c % 32 == 0   # each half a multiple of 16
    whole = _whole(th, tw, h, w)
    if g is not None:
        gs = (g,)
    else:
        gs = range(1, min(MAX_IMAGES, n) + 1) if whole else (1,)
    if cluster is not None:
        clusters = (cluster,)
    else:
        clusters = (1, 2) if whole and pair_ok else (1,)
    if 2 in clusters and not pair_ok:
        raise ValueError(f"a pair splits B={b} and C={c} in halves that "
                         "must be multiples of 16")
    plans = [p for p in (_plan(n, h, w, cin, b, c, th, tw, gg, cl, n_sms)
                         for cl in clusters for gg in gs) if p is not None]
    if not plans:
        raise ValueError(f"a fused block with B={b} does not fit in shared "
                         f"memory at a {th}x{tw} tile, g={g}, cluster={cluster}")
    return min(plans, key=lambda p: (p["stream_bytes"], -p["cluster"], p["g"]))


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
    plan = launch_plan(n, h, w, cin, b, c, _n_sms(x.device))
    out = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device)
    ptr = lambda name: blk[name].data_ptr() if name in blk else None  # noqa: E731
    stream = torch.cuda.current_stream(x.device).cuda_stream
    nbs = [plan["phases"][k]["nb"] for k in ("y1", "y2", "y3")]
    status = lib.tfft_bottleneck_block(
        x.data_ptr(), out.data_ptr(), ptr("w1"), ptr("b1"), ptr("w2"),
        ptr("b2"), ptr("w3"), ptr("b3"), ptr("wp"), ptr("bp"),
        n, h, w, cin, b, c, plan["th"], plan["tw"], plan["g"], *nbs,
        plan["stages"], plan["ctas_per_sm"], plan["cluster"],
        plan["smem_bytes"], x.device.index or 0, stream)
    if status == -2:
        raise RuntimeError(
            f"tfft_bottleneck_block refused the plan {plan}: it does not fit "
            f"in shared memory, its fields are out of step with its "
            f"shared-memory sum of {plan['smem_bytes']} bytes, or its "
            f"cluster of {plan['cluster']} cannot be resident")
    check(lib, status, "tfft_bottleneck_block")
    fused_bottleneck_block.launches += 1
    return out


fused_bottleneck_block.launches = 0


def _n_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


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
