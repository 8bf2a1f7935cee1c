"""Shared layers: ConvBN, Conv, BatchNorm, SqueezeExcite, EmbeddingHead,
l2_normalize, and the W8A8 int8 convs.

Counterpart of ``tf_face_toolbox_tpu/models/layers.py``. Activations
are NHWC, as in the JAX package, and stay physically NHWC: a conv runs
on the ``permute(0, 3, 1, 2)`` view, which is a channels_last NCHW
tensor and needs no copy. Module and attribute names follow the flax
auto-names (``ConvBN_0``, ``BatchNorm_0``, ``Dense_0``) so the JAX
``.npz`` key space maps onto ``state_dict`` mechanically
(interop/port.py).

``dtype`` is the compute dtype; parameters and BN statistics stay f32.
BatchNorm runs in f32 on the (possibly bf16) conv output and rounds to
the compute dtype after, as flax's BatchNorm does.

int8 serving (``ConvBN(quantized=...)``, JAX's modes): the weight is
quantized per output channel (``ks = max|w| / 127``, round half to
even), the activation per sample (``dynamic``) or with a frozen
per-tensor scale from calibration (``static``: ``act_max / 127``, a
buffer whose JAX key is ``quant_stats/<path>/act_max``), and the int8
product accumulates in int32 (``int8_conv2d_nhwc``: ``torch._int_mm``
on the card's int8 tensor cores; on the host its float64 plain version).
Every division by a scale divides by a tensor (torch turns a division
by a host scalar into a product with its reciprocal on the card), and
every ``max / 127`` is, as XLA folds it, a product with the f32
reciprocal of 127. ``qat`` fake-quantizes the train forward's conv inputs and
kernels with straight-through gradients (``fake_quant_ste``).

A forward given ``train=TrainContext(...)`` runs in train mode: BatchNorm
normalizes with the batch's statistics and puts its updated running
statistics into the context (the module's buffers stay as they were;
the train step decides whether to keep them), and the flatten head's
dropout draws from the context's generator. Without one it is eval.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
MOMENTUM = 0.9             # flax's convention: the running stats' weight


def same_pad(h: int, w: int, k: int, s: int) -> tuple[int, int, int, int]:
    """TF/JAX "SAME" padding as (top, bottom, left, right).

    The output is ceil(size / s); the total padding is split with the
    smaller half before. At stride 2 on an even size this is
    asymmetric (3x3/s2 pads 0/1, 7x7/s2 at 112 pads 2/3), which
    PyTorch's symmetric ``padding=k//2`` does not reproduce.
    """
    def one(size: int) -> tuple[int, int]:
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        return total // 2, total - total // 2

    top, bottom = one(h)
    left, right = one(w)
    return top, bottom, left, right


def conv2d_same_nhwc(x: torch.Tensor, weight: torch.Tensor, stride: int,
                     bias: torch.Tensor | None = None,
                     groups: int = 1) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with an OIHW ``weight`` (O, I / groups,
    kh, kw); NHWC result."""
    k = weight.shape[-1]
    top, bottom, left, right = same_pad(x.shape[1], x.shape[2], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 groups=groups)
    return y.permute(0, 2, 3, 1).contiguous()


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(N, Ho, Wo, k * k * C) patches of SAME-padded NHWC ``x``, taps in
    (row, column) order and channels inside a tap: the k * k shifted
    strided views side by side (a 1x1 conv's is ``x`` itself, strided)."""
    n, h, w, _ = x.shape
    top, bottom, left, right = same_pad(h, w, k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    ho, wo = -(-h // stride), -(-w // stride)
    taps = [x[:, dy:dy + stride * (ho - 1) + 1:stride,
              dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(k) for dx in range(k)]
    return taps[0] if k == 1 else torch.cat(taps, dim=-1)


def _int_mm_weight(kq: torch.Tensor, groups: int) -> torch.Tensor:
    """An OIHW int8 kernel as ``_int_mm``'s (K, O) operand, K and O padded
    with zeros to multiples of 8: rows in ``_im2col``'s (tap, channel)
    order over ALL input channels, so a grouped kernel is block-diagonal
    (a group's output columns are zero outside its channels). Column-major
    (the transpose of a contiguous (O, K) matrix)."""
    o, cg, kh, kw = kq.shape
    c = cg * groups
    w = kq.permute(0, 2, 3, 1)                      # (O, kh, kw, cg)
    if groups > 1:
        full = torch.zeros((groups, o // groups, kh, kw, groups, cg),
                           dtype=kq.dtype, device=kq.device)
        g = torch.arange(groups, device=kq.device)
        full[g, :, :, :, g] = w.reshape(groups, o // groups, kh, kw, cg)
        w = full.reshape(o, kh, kw, c)
    w = w.reshape(o, kh * kw * c)
    w = F.pad(w, (0, -w.shape[1] % 8, 0, -o % 8))
    return w.t()


def int8_conv2d_int_mm(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                       groups: int = 1) -> torch.Tensor:
    """The int8 SAME conv as one ``torch._int_mm`` (s8 x s8 -> s32): the
    (N * Ho * Wo, K) int8 im2col of ``xq`` (a 1x1 stride-1 conv's is the
    NHWC tensor itself, no copy) times ``_int_mm_weight``. M is padded to
    more than 16 rows and K to a multiple of 8 with zeros (exact), as
    ``_int_mm``'s shape rules ask. A grouped conv runs block-diagonal: the
    zero blocks cost G x the operations and kernel bytes, not exactness,
    and this one call outran one ``_int_mm`` a group (N 4 to 32 a group)
    and cuDNN's f32 conv of the values (inexact on the card: not a direct
    sum) at every resnext_50 shape (``bench_int8``). -> (N, Ho, Wo, O)
    int32."""
    k = kq.shape[-1]
    cols = _im2col(xq, k, stride)
    n, ho, wo, kk = cols.shape
    a = cols.reshape(n * ho * wo, kk)
    b = _int_mm_weight(kq, groups)
    m = a.shape[0]
    pad_m = 32 - m if m <= 16 else 0
    if pad_m or b.shape[0] != kk:
        a = F.pad(a, (0, b.shape[0] - kk, 0, pad_m))
    y = torch._int_mm(a, b)
    return y[:m, :kq.shape[0]].reshape(n, ho, wo, kq.shape[0])


def int8_conv2d_plain(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                      groups: int = 1) -> torch.Tensor:
    """``int8_conv2d_int_mm``'s plain version: ``F.conv2d`` in float64 on
    the int8 values (every sum exact below 2^53) -> int32 NHWC."""
    y = conv2d_same_nhwc(xq.to(torch.float64), kq.to(torch.float64), stride,
                         groups=groups)
    return y.to(torch.int32)


def int8_conv2d_nhwc(xq: torch.Tensor, kq: torch.Tensor, stride: int,
                     groups: int = 1,
                     out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """W8A8 SAME conv: NHWC int8 ``xq``, OIHW int8 ``kq`` (O, C / groups,
    kh, kw), int32 accumulation -> NHWC ``out_dtype``: int32, or a float
    type the exact sum is rounded to as XLA's ``preferred_element_type``
    does (through f32: int32 -> f32 -> bf16, two roundings past 2^24).

    On a CUDA tensor it runs ``int8_conv2d_int_mm`` (the card's int8
    tensor cores) and counts the call in ``int8_conv2d_nhwc.launches``;
    there is no other route there. On the host it runs the plain
    version."""
    if xq.dtype != torch.int8 or kq.dtype != torch.int8:
        raise TypeError(f"int8 conv wants int8 operands, got {xq.dtype} "
                        f"and {kq.dtype}")
    if xq.is_cuda:
        y = int8_conv2d_int_mm(xq, kq, stride, groups)
        int8_conv2d_nhwc.launches += 1
    else:
        y = int8_conv2d_plain(xq, kq, stride, groups)
    if out_dtype == torch.int32:
        return y
    return y.to(torch.float32).to(out_dtype)


int8_conv2d_nhwc.launches = 0


# the f32 reciprocal of 127: XLA folds a division by the constant 127
# into a product with it (JAX's scales are max / 127.0), so the port
# multiplies by it too
INV127 = 1.0 / 127.0     # rounded to f32 where it is used


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127.0`` as XLA computes it: ``t * f32(1 / 127)``, a tensor
    product (a host-scalar operand would not round the same everywhere)."""
    return t * torch.full((), INV127, dtype=torch.float32, device=t.device)


def quantize_weight(weight: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW kernel: (kq int8,
    ks (O,) f32), ``ks = max(max|w| / 127, 1e-12)``, ``kq = round(w /
    ks)`` (half to even, as ``jnp.round``)."""
    w = weight.detach().to(torch.float32)
    amax = w.abs().amax(dim=(1, 2, 3))
    ks = torch.clamp_min(_over_127(amax), 1e-12)
    return torch.round(w / ks[:, None, None, None]).to(torch.int8), ks


def quantize_activation(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / xs), -127, 127)`` as int8; ``xs`` broadcasts."""
    return torch.clamp(torch.round(x / xs), -127, 127).to(torch.int8)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
              groups: int = 1,
              act_scale: torch.Tensor | None = None) -> torch.Tensor:
    """JAX ``layers.int8_conv``: W8A8 conv of NHWC ``x`` -> f32 NHWC.

    ``act_scale`` None: a dynamic per-sample scale, ``max(max|x| over (H,
    W, C) / 127, 1e-12)``; the int32 product, as f32, times ``(xs *
    ks)`` (computed first, in f32). Else the frozen per-tensor scale
    (``max(act_scale, 1e-12)``) and ``int8_conv_prequant``'s bf16 path.
    """
    kq, ks = quantize_weight(weight)
    x = x.to(torch.float32)
    if act_scale is None:
        amax = x.abs().amax(dim=(1, 2, 3), keepdim=True)
        xs = torch.clamp_min(_over_127(amax), 1e-12)
        y = int8_conv2d_nhwc(quantize_activation(x, xs), kq, stride, groups)
        return y.to(torch.float32) * (xs * ks.view(1, 1, 1, -1))
    xs = torch.clamp_min(act_scale, 1e-12)
    return int8_conv_prequant(quantize_activation(x, xs), xs, weight, stride,
                              groups, _ks=(kq, ks))


def int8_conv_prequant(xq: torch.Tensor, xs: torch.Tensor,
                       weight: torch.Tensor, stride: int, groups: int = 1,
                       _ks=None) -> torch.Tensor:
    """JAX ``layers.int8_conv_prequant``: the int8 conv of an already
    quantized activation (scale ``xs``, a 0-d f32 tensor), its exact sum
    rounded to bf16, times ``(xs * ks)`` rounded to bf16, in bf16 -> f32.
    The static-int8 residual carry's consumers read ``xq`` this way."""
    kq, ks = quantize_weight(weight) if _ks is None else _ks
    y = int8_conv2d_nhwc(xq, kq, stride, groups, out_dtype=torch.bfloat16)
    scale = (xs * ks.view(1, 1, 1, -1)).to(torch.bfloat16)
    return (y * scale).to(torch.float32)


def fake_quant_ste(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 fake quantization with a straight-through gradient:
    forward ``x + (round(clip(x / scale)) * scale - x)``, the value grid
    of the int8 serving path (as JAX computes it: not exactly ``q``);
    backward the identity."""
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


def fake_quant_scale(x: torch.Tensor, dims=None) -> torch.Tensor:
    """QAT's scale: ``max(max|x| / 127, 1e-12)`` over ``dims`` (all: a
    per-tensor scale) of the detached value, keeping dims."""
    a = x.detach().abs()
    amax = a.amax() if dims is None else a.amax(dim=dims, keepdim=True)
    return torch.clamp_min(_over_127(amax), 1e-12)


QUANT_MODES = (False, True, "dynamic", "calibrate", "static",
               "static_dense", "qat")
# modes that record or read each conv's act_max (calibration records it
# for every conv, grouped ones too; static_dense serves those in fp)
CALIBRATED = ("calibrate", "static", "static_dense")


def check_quant_mode(quantized) -> None:
    if quantized not in QUANT_MODES:
        raise ValueError(f"unknown quantized mode {quantized!r}; have "
                         "False, True/'dynamic', 'calibrate', 'static', "
                         "'static_dense', 'qat'")


STATIC_NEEDS_STATS = ("quantized='static' needs calibrated quant_stats; "
                      "run models.calibrate_quant_stats(...) first")


def check_calibrated(module: nn.Module, stat: torch.Tensor) -> None:
    """Raise JAX's error for a static scale never calibrated nor loaded:
    ``module.stats_loaded``, a host flag that ``load_jax_variables`` and
    ``load_state_dict`` set, is False (no sync on the card), or, on a
    host tensor, the scale is still NaN."""
    if not module.stats_loaded or (not stat.is_cuda and torch.isnan(stat)):
        raise ValueError(STATIC_NEEDS_STATS)


class FrozenStats(nn.Module):
    """A module with calibrated scale buffers (``stat_names``): its
    ``stats_loaded`` flag starts False and turns True when a
    ``load_state_dict`` carries every one of them
    (``interop.port.load_jax_variables`` sets it itself)."""

    stat_names: tuple = ()
    stats_loaded = False

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        if self.stat_names and all(prefix + name in state_dict
                                   for name in self.stat_names):
            self.stats_loaded = True


class QuantConv(FrozenStats):
    """What ConvBN and DenseNet's pre-activation conv share: the conv of
    one f32 ``weight`` (OIHW) in every ``quantized`` mode, so one
    checkpoint loads into all of them, and an ``act_max`` buffer (JAX
    key ``quant_stats/<path>/act_max``) in the calibrated modes.

    ``act_max`` starts as NaN: a static forward before calibration or a
    load raises, as JAX's does without the variable. A calibrate forward
    (eval) folds ``max|x|`` of its input into it.
    """

    def _init_quant(self, quantized, groups: int) -> None:
        check_quant_mode(quantized)
        self.quantized = quantized
        mode = "dynamic" if quantized is True else quantized
        if mode == "static_dense":
            # grouped convs (ResNeXt's width-4 groups) stay fp; calibration
            # still records their act_max
            mode = "static" if groups == 1 else False
        self.mode = mode
        if quantized in CALIBRATED:
            self.register_buffer("act_max",
                                 torch.full((), float("nan")))
            self.stat_names = ("act_max",)

    def quant_conv(self, x: torch.Tensor, stride: int, groups: int,
                   dtype: torch.dtype, train, prequant=None) -> torch.Tensor:
        """The conv of ``x`` (or of the int8 carry ``prequant = (xq,
        xs)``) in this module's mode, in ``dtype`` (before BatchNorm)."""
        mode = self.mode
        weight = self.weight
        if mode == "qat" and train is not None:
            # fake-quantized in f32, cast to the compute dtype for the conv
            xf = x.to(torch.float32)
            x = fake_quant_ste(xf, fake_quant_scale(xf))
            weight = fake_quant_ste(weight,
                                    fake_quant_scale(weight, (1, 2, 3)))
        if mode == "calibrate" and train is None:
            with torch.no_grad():
                self.act_max.copy_(torch.fmax(
                    self.act_max, x.detach().to(torch.float32).abs().amax()))
        if mode == "static" and train is None:
            if prequant is not None:
                y = int8_conv_prequant(prequant[0], prequant[1], weight,
                                       stride, groups)
            else:
                check_calibrated(self, self.act_max)
                y = int8_conv(x, weight, stride, groups,
                              act_scale=_over_127(self.act_max))
            return y.to(dtype)
        if mode == "dynamic" and train is None:
            return int8_conv(x, weight, stride, groups).to(dtype)
        return conv2d_same_nhwc(x.to(dtype), weight.to(dtype), stride,
                                groups=groups)


def max_pool_same_nhwc(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """SAME max pool of NHWC ``x``; the padding is -inf."""
    top, bottom, left, right = same_pad(x.shape[1], x.shape[2], k, s)
    x = F.pad(x, (0, 0, left, right, top, bottom), value=float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, s)
    return y.permute(0, 2, 3, 1).contiguous()


class TrainContext:
    """What a train-mode forward threads through the modules.

    ``stats``: BatchNorm module -> its updated (running_mean,
    running_var), filled by the forward. A module already in it starts
    from those values, not its buffers, so micro-batches that share one
    context advance the statistics one after another.
    ``generator``: what dropout draws from.
    """

    def __init__(self, generator: torch.Generator | None = None):
        self.stats: dict[nn.Module, tuple[torch.Tensor, torch.Tensor]] = {}
        self.generator = generator


class _TrainNorm(torch.autograd.Function):
    """flax's train-mode normalization over every axis but the last.

    Statistics in f32 over N*H*W: the mean and the biased variance in
    flax's fast form, max(0, E[x^2] - E[x]^2). The output is (x - mean)
    * (rsqrt(var + eps) * scale) + bias, rounded to ``out_dtype``.
    Saves only the input and the per-channel statistics: backward
    recomputes the normalized values (the f32 intermediates of a
    bf16 net would otherwise stay alive until backward).
    """

    @staticmethod
    def forward(ctx, x, weight, bias, out_dtype):
        dims = tuple(range(x.ndim - 1))
        xf = x.to(torch.float32)
        mean = xf.mean(dims)
        var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        invstd = torch.rsqrt(var + BN_EPS)
        y = (xf - mean) * (invstd * weight) + bias
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.mark_non_differentiable(mean, var)
        return y.to(out_dtype), mean, var

    @staticmethod
    def backward(ctx, grad_y, _grad_mean, _grad_var):
        x, mean, invstd, weight = ctx.saved_tensors
        dims = tuple(range(x.ndim - 1))
        n = x.numel() // x.shape[-1]
        g = grad_y.to(torch.float32)
        xhat = (x.to(torch.float32) - mean) * invstd
        grad_bias = g.sum(dims)
        grad_weight = (g * xhat).sum(dims)
        grad_x = (weight * invstd / n) * (n * g - grad_bias
                                          - xhat * grad_weight)
        return grad_x.to(x.dtype), grad_weight, grad_bias, None


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax ``nn.BatchNorm``, momentum 0.9:
    running = 0.9 * running + 0.1 * batch, with the biased variance)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype,
                train: TrainContext | None = None) -> torch.Tensor:
        if train is not None:
            y, mean, var = _TrainNorm.apply(x, self.weight, self.bias,
                                            out_dtype)
            old_mean, old_var = train.stats.get(
                self, (self.running_mean, self.running_var))
            train.stats[self] = (MOMENTUM * old_mean + (1 - MOMENTUM) * mean,
                               MOMENTUM * old_var + (1 - MOMENTUM) * var)
            return y
        # flax order: (x - mean) * (rsqrt(var + eps) * scale) + bias, in f32
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * mul + self.bias
        return y.to(out_dtype)


def conv_weight(in_features: int, features: int, kernel_size: int,
                 groups: int = 1) -> nn.Parameter:
    fan_in = in_features // groups * kernel_size * kernel_size
    return nn.Parameter(
        torch.randn(features, in_features // groups, kernel_size, kernel_size)
        * math.sqrt(2.0 / fan_in))


class Conv(nn.Module):
    """Bias-free SAME conv in the compute dtype (flax ``nn.Conv(...,
    use_bias=False)``): its kernel is the module's own ``weight``, JAX
    key ``.../kernel``."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = strides
        self.dtype = dtype
        self.weight = conv_weight(in_features, features, kernel_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same_nhwc(x.to(self.dtype), self.weight.to(self.dtype),
                                self.strides)


class ConvBN(QuantConv):
    """Conv (no bias; ``groups`` splits the channels as
    ``feature_group_count`` does) -> BatchNorm -> optional ReLU, NHWC.

    ``quantized`` (JAX's ``ConvBN`` modes; the int8 ones serve in eval
    only, a train forward runs the fp conv): False; True / "dynamic"
    (W8A8, per-sample scales); "calibrate" (fp, records ``act_max``);
    "static" (W8A8 with the frozen scale, or the int8 carry given as
    ``prequant``); "static_dense" (static for dense convs, fp for
    grouped ones); "qat" (a train forward fake-quantizes the input per
    tensor and the kernel per output channel; eval is fp).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 strides: int = 1, relu: bool = True,
                 dtype: torch.dtype = torch.float32, groups: int = 1,
                 quantized: bool | str = False):
        super().__init__()
        self.strides = strides
        self.relu = relu
        self.dtype = dtype
        self.groups = groups
        self.weight = conv_weight(in_features, features, kernel_size, groups)
        self.BatchNorm_0 = BatchNorm(features)
        self._init_quant(quantized, groups)

    def forward(self, x: torch.Tensor, train: TrainContext | None = None,
                prequant: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
        y = self.quant_conv(x, self.strides, self.groups, self.dtype, train,
                            prequant)
        y = self.BatchNorm_0(y, self.dtype, train)
        return torch.relu(y) if self.relu else y


def squeeze_excite(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """Squeeze-and-excitation gate of NHWC ``x``: mean over H, W ->
    Dense -> ReLU -> Dense -> sigmoid -> ``x * s``, all in ``x.dtype``
    with flax ``nn.Dense(dtype=x.dtype)``'s rounding points (the product
    rounds before the bias add). Weights are (out, in)."""
    dt = x.dtype
    # jnp.mean of a bf16 map sums in f32 and returns bf16
    s = x.to(torch.float32).mean(dim=(1, 2)).to(dt)
    s = torch.relu(s @ w0.to(dt).T + b0.to(dt))
    s = torch.sigmoid(s @ w1.to(dt).T + b1.to(dt))
    return x * s[:, None, None, :]


class SqueezeExcite(nn.Module):
    """flax ``SqueezeExcite``: a hidden width of max(C // reduction, 8),
    its two Dense layers computed in the compute dtype."""

    def __init__(self, features: int, reduction: int = 16):
        super().__init__()
        hidden = max(features // reduction, 8)
        self.Dense_0 = nn.Linear(features, hidden)
        self.Dense_1 = nn.Linear(hidden, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return squeeze_excite(x, self.Dense_0.weight, self.Dense_0.bias,
                              self.Dense_1.weight, self.Dense_1.bias)


class EmbeddingHead(nn.Module):
    """pool/flatten -> Dense(dim) -> BN, f32 output (flax EmbeddingHead).

    ``gap``: global average pool -> Dense -> BN.
    ``flatten``: BN -> dropout (train mode) -> flatten (NHWC order) ->
    Dense -> BN; needs the final map's ``spatial`` (h, w) to size the
    Dense.
    """

    def __init__(self, in_features: int, embedding_dim: int = 512,
                 variant: str = "gap", spatial: tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.variant = variant
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        if variant == "gap":
            dense_in = in_features
            self.BatchNorm_0 = BatchNorm(embedding_dim)
        elif variant == "flatten":
            dense_in = in_features * spatial[0] * spatial[1]
            self.BatchNorm_0 = BatchNorm(in_features)
            self.BatchNorm_1 = BatchNorm(embedding_dim)
        else:
            raise ValueError(f"unknown head variant: {variant}")
        self.Dense_0 = nn.Linear(dense_in, embedding_dim)

    def forward(self, x: torch.Tensor,
                train: TrainContext | None = None) -> torch.Tensor:
        if self.variant == "gap":
            # jnp.mean of a bf16 map sums in f32 and returns bf16
            x = x.to(torch.float32).mean(dim=(1, 2)).to(self.dtype)
            final_bn = self.BatchNorm_0
        else:
            x = self.BatchNorm_0(x, self.dtype, train)
            if train is not None and self.dropout_rate > 0:
                x = dropout(x, self.dropout_rate, train.generator)
            x = x.reshape(x.shape[0], -1)
            final_bn = self.BatchNorm_1
        x = F.linear(x.to(self.dtype), self.Dense_0.weight.to(self.dtype),
                     self.Dense_0.bias.to(self.dtype))
        # final BN and the embedding are f32 under any compute dtype
        return final_bn(x, torch.float32, train)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and divide the
    kept values by it; the mask comes from ``generator``."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(sum(x^2) + eps): safe at zero. Not F.normalize, which
    divides by max(norm, eps)."""
    return x / torch.sqrt(torch.sum(torch.square(x), dim=dim, keepdim=True)
                          + eps)
