"""PyTorch building blocks of the detector zoo (port of
yolov7_tracker_tpu/models/blocks.py): Conv(+BN)+act, max pools, ReOrg,
SPPCSPC, nearest upsampling, RepConv, DownC, the darknet / ResNet
bottlenecks and the CSP family, SPP, Stem, Focus, and the YOLOv5 / YOLOv8
blocks C3, C2f and SPPF. Tensors are NCHW inside the detector. Submodule
names follow the Flax tree (``m{j}``, ``m{j}_cv1``, ``rbr_dense_conv``
...), which keeps models/from_jax.py a renaming; models/convert.py maps
the reference's checkpoint names onto them. The tail of the zoo follows:
the Ghost blocks, Contract / Expand / Chuncat / Foldcut, the Swin v1 / v2
blocks and their ST(2)CSP wrappers, RepConv_OREPA, RobustConv(2), and the
blocks no cfg reaches (CrossConv, Sum, MixConv2d, TransformerBlock,
Classify), each computing what its Flax twin computes. ``fused="int8"``
builds the W8A8 form of ConvBnAct and RepConv (``QuantConv``,
models/quant.py).

The JAX package's ReOrg-folded stem conv and width-packed convs are TPU
layout tricks with the same outputs; the port runs the plain ``reorg``
followed by the 3x3 conv.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, List, Optional, Sequence

import numpy as np

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOM = 0.9  # Flax's momentum (blocks.py:20), 1 - torch's 0.1
LN_EPS = 1e-6  # Flax LayerNorm's default epsilon
# fused="int8": the W8A8 serving form of ConvBnAct and RepConv (JAX
# blocks.INT8); composite blocks pass it on through their fused argument
INT8 = "int8"

_STATS_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "batch_stats_sink", default=None)


@contextlib.contextmanager
def batch_stats_sink(sink: List, group=None):
    """Inside the block every BatchNorm2d in training mode normalises by
    its batch statistics and appends ``(module, mean, invstd)`` (float32,
    detached) to ``sink`` instead of updating its running statistics;
    ``update_running_stats(sink)`` then applies Flax's update.

    ``group``: a process group whose ranks each hold a shard of the batch.
    With more than one rank the statistics are the global batch's, as
    under the JAX package's GSPMD (``_global_batch_norm``), and every rank
    reports the same ones."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    token = _STATS_SINK.set((sink, group))
    try:
        yield sink
    finally:
        _STATS_SINK.reset(token)


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all_reduce(SUM) of the
    incoming gradient: every rank's loss depends on the summed value, so
    each rank's share of its gradient is the sum of all ranks' gradients
    with respect to it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous(), ctx.group), None


def _global_batch_norm(x, weight, bias, eps, group):
    """Flax's training-mode BatchNorm (``_compute_stats``: mean(x) and
    mean(x^2) in float32 at least, var = mean(x^2) - mean^2) over the
    batch that the ranks of ``group`` hold together: one differentiable
    all_reduce of the local sums, sums of squares and count, so that the
    backward of the global mean and variance is global too. Returns (y,
    mean, invstd)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    c = x.shape[1]
    local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                       xf.new_full((1,), float(xf.numel() // c))])
    tot = _AllReduceSum.apply(local, group)
    mean = tot[:c] / tot[2 * c]
    var = torch.clamp_min(tot[c:2 * c] / tot[2 * c] - mean * mean, 0.0)
    invstd = torch.rsqrt(var + eps)
    scale = (invstd * weight.to(dt))[None, :, None, None]
    y = (xf - mean[None, :, None, None]) * scale + bias.to(dt)[
        None, :, None, None]
    return y.to(x.dtype), mean, invstd


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training-mode forward inside
    ``batch_stats_sink`` reports its batch statistics rather than folding
    them into the running ones: torch updates ``running_var`` with the
    unbiased batch variance, Flax (``_compute_stats``) with the biased
    one, a factor n / (n - 1) apart. With a process group in the sink its
    statistics are the ranks' global batch's. Anywhere else it is
    nn.BatchNorm2d."""

    def forward(self, x):
        sink, group = _STATS_SINK.get() or (None, None)
        if not self.training or sink is None:
            return super().forward(x)
        if group is None:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        else:
            y, mean, invstd = _global_batch_norm(x, self.weight, self.bias,
                                                 self.eps, group)
        sink.append((self, mean.detach(), invstd.detach()))
        return y


def update_running_stats(sink, momentum: float = BN_MOM) -> None:
    """Flax BatchNorm's running-statistics update from the batch
    statistics a training forward reported into ``sink``: ra = m * ra +
    (1 - m) * batch, with the biased batch variance (1 / invstd^2 - eps),
    in the running statistics' dtype (float32) and on the device (no host
    sync)."""
    if not sink:
        return
    with torch.no_grad():
        ra_mean = [m.running_mean for m, _, _ in sink]
        ra_var = [m.running_var for m, _, _ in sink]
        var = [torch.clamp_min(invstd.to(m.running_var.dtype).pow(-2)
                               - m.eps, 0.0) for m, _, invstd in sink]
        torch._foreach_mul_(ra_mean, momentum)
        torch._foreach_add_(ra_mean, [mean.to(m.running_mean.dtype)
                                      for m, mean, _ in sink],
                            alpha=1.0 - momentum)
        torch._foreach_mul_(ra_var, momentum)
        torch._foreach_add_(ra_var, var, alpha=1.0 - momentum)


def activation(name: str) -> Callable:
    if name == "silu":
        return F.silu
    if name.startswith("leaky:"):
        slope = float(name.split(":")[1])
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if name == "id":
        return lambda x: x
    if name == "relu":
        return F.relu
    if name == "mish":
        return F.mish
    if name == "hardswish":
        return F.hardswish
    raise ValueError(name)


def quant_accumulate(q: torch.Tensor, weight: torch.Tensor, stride: int,
                     padding: int, groups: int) -> torch.Tensor:
    """The exact sums of a conv of int8 values ``q`` (float, -127..127)
    with int8 ``weight``, as float64: every partial sum is an integer
    below 127^2 * fan_in < 2^53, so any order of a float64 sum is exact
    (a float32 one stops being so past 2^24). cuDNN is off for it, so no
    FFT or Winograd transform rounds on the card: the conv is im2col and
    a float64 GEMM on either device."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    if 127 * 127 * fan_in >= 2 ** 53:
        raise ValueError(f"a fan-in of {fan_in} is too wide for an exact "
                         "float64 accumulation")
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(q.double(), weight.double(), None, stride, padding,
                        1, groups)


class QuantConv(nn.Module):
    """W8A8 static-PTQ conv (JAX blocks._QuantConv). Buffers, written by
    models/quant.quantize_state_dict: ``weight`` int8 (c2, c1/g, k, k),
    per-output-channel symmetric; ``w_scale`` (c2,) and ``bias`` (c2,),
    float32; ``a_scale`` (), float32, the input's static scale.

    q = clip(round(x_f32 / a_scale), -127, 127), the exact integer conv
    (``quant_accumulate``), then acc_f32 * (w_scale * a_scale) + bias in
    float32, cast back to x's dtype. The division is by the tensor
    ``a_scale`` on x's device, never by a Python float, which the card
    would turn into a multiply by its reciprocal."""

    def __init__(self, c1: int, c2: int, k: int, s: int, p: int, g: int):
        super().__init__()
        self.stride, self.padding, self.groups = s, p, g
        self.register_buffer("weight", torch.zeros((c2, c1 // g, k, k),
                                                   dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(c2))
        self.register_buffer("bias", torch.zeros(c2))
        self.register_buffer("a_scale", torch.ones(()))

    def quantize(self, x):
        return torch.clamp(torch.round(x.float() / self.a_scale), -127, 127)

    def forward(self, x):
        acc = quant_accumulate(self.quantize(x), self.weight, self.stride,
                               self.padding, self.groups).float()
        y = (acc * (self.w_scale * self.a_scale)[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)


def quant_act(act: Callable, y: torch.Tensor) -> torch.Tensor:
    """The activation after a QuantConv, computed in float64 and rounded
    back to y's dtype. The next QuantConv rounds its input to a step of
    its a_scale, so a one-ulp difference in a float32 SiLU (CUDA's and
    the CPU's part by that much) flips q wherever the value sits on a
    rounding boundary, and through a deep model those flips cascade to
    the size of a quantization step in the output. Rounded from float64,
    the activation is the same on either device."""
    return act(y.double()).to(y.dtype)


class ConvBnAct(nn.Module):
    """Conv (pad k//2 or explicit p) + BatchNorm + activation; fused=True
    is one biased conv with BN folded in (models/fuse.py), fused="int8"
    its W8A8 form (QuantConv, then ``quant_act``)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: str = "silu", fused=False,
                 p: Optional[int] = None):
        super().__init__()
        pad = k // 2 if p is None else p
        if fused == INT8:
            self.conv = QuantConv(c1, c2, k, s, pad, g)
        else:
            self.conv = nn.Conv2d(c1, c2, k, s, pad, groups=g,
                                  bias=bool(fused))
        self.bn = None if fused else BatchNorm2d(c2, eps=BN_EPS)
        self.act = activation(act)

    def forward(self, x):
        x = self.conv(x)
        if isinstance(self.conv, QuantConv):
            return quant_act(self.act, x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


_ROW_HALO: contextvars.ContextVar = contextvars.ContextVar(
    "row_halo", default=None)


@contextlib.contextmanager
def row_halo(halo: Callable):
    """Inside the block ``x`` is one band of an image's rows
    (parallel/spatial.py): ``max_pool`` takes the rows beyond the band's
    edges from ``halo(x, top, bottom, fill)`` (x with ``top`` rows above
    and ``bottom`` below, the neighbours' or ``fill`` beyond the image)
    instead of padding there."""
    token = _ROW_HALO.set(halo)
    try:
        yield halo
    finally:
        _ROW_HALO.reset(token)


def halo_rows(k: int, s: int, p: int, d: int = 1):
    """The rows a window op (kernel k, stride s, padding p, dilation d)
    reads above and below a band whose edges are multiples of s: output
    row o reads input rows o * s - p .. o * s - p + d * (k - 1)."""
    return p, max(d * (k - 1) - p - s + 1, 0)


def max_pool(x, k: int, s: int, pad: int):
    halo = _ROW_HALO.get()
    if halo is None or (pad == 0 and k <= s):
        return F.max_pool2d(x, k, s, pad)
    h = x.shape[2]
    top, bottom = halo_rows(k, s, pad)
    y = F.max_pool2d(halo(x, top, bottom, float("-inf")), k, s, (0, pad))
    return y[:, :, :h // s]


def mp(x, k: int = 2):
    """MaxPool k=s=2 (models/common.py:30-36)."""
    return max_pool(x, k, k, 0)


def sp(x, k: int = 3, s: int = 1):
    """Same-size max pool (models/common.py:39-45)."""
    return max_pool(x, k, s, k // 2)


def reorg(x):
    """Space-to-depth x4 (models/common.py:48-53) in the reference's
    channel order, which the JAX NHWC reorg also keeps."""
    return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                      x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1)


class SPPCSPC(nn.Module):
    """CSP spatial pyramid pooling (models/common.py:262-280)."""

    def __init__(self, c1: int, c2: int, e: float = 0.5,
                 k: Sequence[int] = (5, 9, 13), fused: bool = False):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv3 = ConvBnAct(c_, c_, 3, 1, fused=fused)
        self.cv4 = ConvBnAct(c_, c_, 1, 1, fused=fused)
        self.cv5 = ConvBnAct(4 * c_, c_, 1, 1, fused=fused)
        self.cv6 = ConvBnAct(c_, c_, 3, 1, fused=fused)
        self.cv7 = ConvBnAct(2 * c_, c2, 1, 1, fused=fused)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = torch.cat([x1] + [sp(x1, k) for k in self.k], dim=1)
        y1 = self.cv6(self.cv5(y1))
        return self.cv7(torch.cat([y1, self.cv2(x)], dim=1))


def upsample_nearest(x, factor: int):
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class RepConv(nn.Module):
    """RepVGG conv (models/common.py:463-508): 3x3+BN, 1x1+BN and, when
    c1 == c2 and s == 1, an identity BN, summed. fused=True is the deploy
    form, one biased 3x3 ``rbr_reparam`` (models/fuse.py folds it)."""

    def __init__(self, c1: int, c2: int, s: int = 1, act: str = "silu",
                 g: int = 1, fused=False):
        super().__init__()
        self.act = activation(act)
        if fused == INT8:
            self.rbr_reparam = QuantConv(c1, c2, 3, s, 1, g)
            return
        if fused:
            self.rbr_reparam = nn.Conv2d(c1, c2, 3, s, 1, groups=g,
                                         bias=True)
            return
        self.rbr_dense_conv = nn.Conv2d(c1, c2, 3, s, 1, groups=g,
                                        bias=False)
        self.rbr_dense_bn = BatchNorm2d(c2, eps=BN_EPS)
        self.rbr_1x1_conv = nn.Conv2d(c1, c2, 1, s, 0, groups=g, bias=False)
        self.rbr_1x1_bn = BatchNorm2d(c2, eps=BN_EPS)
        self.rbr_identity = (BatchNorm2d(c1, eps=BN_EPS)
                             if c1 == c2 and s == 1 else None)

    def forward(self, x):
        if isinstance(getattr(self, "rbr_reparam", None), QuantConv):
            return quant_act(self.act, self.rbr_reparam(x))
        if hasattr(self, "rbr_reparam"):
            return self.act(self.rbr_reparam(x))
        out = (self.rbr_dense_bn(self.rbr_dense_conv(x))
               + self.rbr_1x1_bn(self.rbr_1x1_conv(x)))
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return self.act(out)


class DownC(nn.Module):
    """Two-path downsample (models/common.py:181-192)."""

    def __init__(self, c1: int, c2: int, k: int = 2, fused: bool = False):
        super().__init__()
        self.k = k
        self.cv1 = ConvBnAct(c1, c1, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c1, c2 // 2, 3, k, fused=fused)
        self.cv3 = ConvBnAct(c1, c2 // 2, 1, 1, fused=fused)

    def forward(self, x):
        return torch.cat([self.cv2(self.cv1(x)),
                          self.cv3(max_pool(x, self.k, self.k, 0))], dim=1)


class Bottleneck(nn.Module):
    """Darknet bottleneck (models/common.py:209-220). n > 1 stacks the
    repeats in one module (parse_model's nn.Sequential), named m{j}_cv1,
    m{j}_cv2 as in the Flax tree."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, fused: bool = False):
        super().__init__()
        self.n = n
        self.add = []
        c_ = int(c2 * e)
        for j in range(n):
            pre = f"m{j}_" if n > 1 else ""
            cin = c1 if j == 0 else c2
            self.add_module(f"{pre}cv1", ConvBnAct(cin, c_, 1, 1,
                                                   fused=fused))
            self.add_module(f"{pre}cv2", ConvBnAct(c_, c2, 3, 1, g=g,
                                                   fused=fused))
            self.add.append(shortcut and cin == c2)

    def forward(self, x):
        for j in range(self.n):
            pre = f"m{j}_" if self.n > 1 else ""
            y = getattr(self, f"{pre}cv2")(getattr(self, f"{pre}cv1")(x))
            x = x + y if self.add[j] else y
        return x


class Res(nn.Module):
    """ResNet bottleneck (models/common.py:223-234)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_, c_, 3, 1, g=g, fused=fused)
        self.cv3 = ConvBnAct(c_, c2, 1, 1, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return x + y if self.add else y


class RepBottleneck(nn.Module):
    """Bottleneck with a RepConv second conv (models/common.py:646-651;
    the reference pins cv1's expansion to 0.5 and keeps the residual for
    c1 == c2 whatever ``shortcut`` says)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * 0.5)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = RepConv(c_, c2, 1, g=g, fused=fused)
        self.add = c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepRes(nn.Module):
    """Res with a RepConv middle conv (models/common.py:678-683, 710-715
    for the g=32 ResX variant)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = RepConv(c_, c_, 1, g=g, fused=fused)
        self.cv3 = ConvBnAct(c_, c2, 1, 1, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv3(self.cv2(self.cv1(x)))
        return x + y if self.add else y


def _ghost_inner(c1, c2, shortcut, g, e, fused=False):
    return Ghost(c1, c2, fused=fused)


# the CSP inner blocks other than Bottleneck, whose signature adds n
_CSP_INNER = {"res": Res, "rep_bottleneck": RepBottleneck, "rep_res": RepRes,
              "ghost": _ghost_inner}


class CSP(nn.Module):
    """CSP wrapper over the A/B/C split topologies (models/common.py:
    307-404: BottleneckCSPA/B/C, ResCSPA/B/C, ResXCSPA/B/C, their
    RepConv variants and GhostCSPA/B/C), inner blocks m{j}:

      A: y1 = m(cv1(x)),      y2 = cv2(x)   -> cv3(cat)
      B: x1 = cv1(x); y1 = m(x1), y2 = cv2(x1) -> cv3(cat)  (c_ = c2)
      C: y1 = cv3(m(cv1(x))), y2 = cv2(x)   -> cv4(cat)
    """

    def __init__(self, c1: int, c2: int, n: int = 1, variant: str = "a",
                 inner: str = "bottleneck", shortcut: bool = True,
                 g: int = 1, inner_e: float = 1.0, fused: bool = False):
        super().__init__()
        self.n, self.variant = n, variant
        c_ = c2 if variant == "b" else c2 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        for j in range(n):
            if inner == "bottleneck":
                m = Bottleneck(c_, c_, 1, shortcut, g, inner_e, fused=fused)
            else:
                m = _CSP_INNER[inner](c_, c_, shortcut, g, inner_e,
                                      fused=fused)
            self.add_module(f"m{j}", m)
        if variant == "c":
            self.cv3 = ConvBnAct(c_, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_ if variant == "b" else c1, c_, 1, 1,
                             fused=fused)
        self.add_module("cv4" if variant == "c" else "cv3",
                        ConvBnAct(2 * c_, c2, 1, 1, fused=fused))

    def forward(self, x):
        x1 = self.cv1(x)
        y1 = x1
        for j in range(self.n):
            y1 = getattr(self, f"m{j}")(y1)
        if self.variant == "c":
            y1 = self.cv3(y1)
        y2 = self.cv2(x1 if self.variant == "b" else x)
        out = self.cv4 if self.variant == "c" else self.cv3
        return out(torch.cat([y1, y2], dim=1))


class SPP(nn.Module):
    """YOLOv3-SPP pyramid pooling (models/common.py:195-206)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 fused: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_ * (len(self.k) + 1), c2, 1, 1, fused=fused)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [sp(x, k) for k in self.k], dim=1))


class Stem(nn.Module):
    """4x-downsampling stem (models/common.py:165-178): a stride-2 conv,
    then a conv branch and a max-pool branch, concatenated."""

    def __init__(self, c1: int, c2: int, fused: bool = False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, 3, 2, fused=fused)
        self.cv2 = ConvBnAct(c_, c_, 1, 1, fused=fused)
        self.cv3 = ConvBnAct(c_, c_, 3, 2, fused=fused)
        self.cv4 = ConvBnAct(2 * c_, c2, 1, 1, fused=fused)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv4(torch.cat([self.cv3(self.cv2(x)), mp(x)], dim=1))


class C3(nn.Module):
    """YOLOv5 CSP bottleneck with 3 convs: n darknet bottlenecks (e=1.0)
    on the cv1 branch, cv2 beside it, cv3 over the concat."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.n = n
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        for j in range(n):
            self.add_module(f"m{j}", Bottleneck(c_, c_, 1, shortcut, e=1.0,
                                                fused=fused))
        self.cv2 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv3 = ConvBnAct(2 * c_, c2, 1, 1, fused=fused)

    def forward(self, x):
        y1 = self.cv1(x)
        for j in range(self.n):
            y1 = getattr(self, f"m{j}")(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class BottleneckV8(nn.Module):
    """YOLOv8 bottleneck: 3x3 -> 3x3, residual when shortcut and c1 ==
    c2 (C2f's inner block)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 fused: bool = False):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 3, 1, fused=fused)
        self.cv2 = ConvBnAct(c2, c2, 3, 1, fused=fused)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """YOLOv8 'fast' CSP: cv1 makes 2c channels split in two along the
    channel axis, n BottleneckV8 stages each append their output, cv2
    over the (2 + n) c concat."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False,
                 e: float = 0.5, fused: bool = False):
        super().__init__()
        self.c = int(c2 * e)
        self.n = n
        self.cv1 = ConvBnAct(c1, 2 * self.c, 1, 1, fused=fused)
        for j in range(n):
            self.add_module(f"m{j}", BottleneckV8(self.c, self.c, shortcut,
                                                  fused=fused))
        self.cv2 = ConvBnAct((2 + n) * self.c, c2, 1, 1, fused=fused)

    def forward(self, x):
        ys = list(self.cv1(x).split(self.c, dim=1))
        for j in range(self.n):
            ys.append(getattr(self, f"m{j}")(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class SPPF(nn.Module):
    """Fast SPP (yolov5 v6+ / yolov8): three chained same-size k x k
    max pools, the four stages concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 5, fused: bool = False):
        super().__init__()
        c_ = c1 // 2
        self.k = k
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(4 * c_, c2, 1, 1, fused=fused)

    def forward(self, x):
        ys = [self.cv1(x)]
        for _ in range(3):
            ys.append(sp(ys[-1], self.k))
        return self.cv2(torch.cat(ys, dim=1))


class Focus(nn.Module):
    """Space-to-depth, then a conv (models/common.py:796-805): the slice
    order is ReOrg's, so this is conv(reorg(x))."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: str = "silu", fused: bool = False):
        super().__init__()
        self.conv = ConvBnAct(4 * c1, c2, k, s, g, act, fused=fused)

    def forward(self, x):
        return self.conv(reorg(x))


# ---------------------------------------------------------------------------
# the tail of the zoo (JAX blocks.py:749-1486)
# ---------------------------------------------------------------------------

class GhostConv(nn.Module):
    """Half the channels from a dense conv, the other half from a 5x5
    depthwise conv on them (models/common.py:152-162)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: str = "silu", fused=False):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s, g, act, fused=fused)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, c_, act, fused=fused)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class Ghost(nn.Module):
    """Ghost bottleneck (models/common.py:243-255): GhostConv -> (a
    stride-2 depthwise conv) -> linear GhostConv, plus the identity at
    s = 1 or a depthwise + pointwise shortcut at s = 2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 fused=False):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.conv0 = GhostConv(c1, c_, 1, 1, fused=fused)
        if s == 2:
            self.conv1 = ConvBnAct(c_, c_, k, 2, c_, "id", fused=fused)
        self.conv2 = GhostConv(c_, c2, 1, 1, act="id", fused=fused)
        if s == 2:
            self.shortcut0 = ConvBnAct(c1, c1, k, 2, c1, "id", fused=fused)
            self.shortcut1 = ConvBnAct(c1, c2, 1, 1, act="id", fused=fused)

    def forward(self, x):
        y = self.conv0(x)
        if self.s == 2:
            y = self.conv1(y)
        y = self.conv2(y)
        sc = self.shortcut1(self.shortcut0(x)) if self.s == 2 else x
        return y + sc


class GhostSPPCSPC(nn.Module):
    """SPPCSPC with every conv a GhostConv (models/common.py
    GhostSPPCSPC); c_ = c2 (e = 0.5)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13),
                 fused=False):
        super().__init__()
        c_ = c2
        self.k = tuple(k)
        self.cv1 = GhostConv(c1, c_, 1, 1, fused=fused)
        self.cv3 = GhostConv(c_, c_, 3, 1, fused=fused)
        self.cv4 = GhostConv(c_, c_, 1, 1, fused=fused)
        self.cv5 = GhostConv((len(self.k) + 1) * c_, c_, 1, 1, fused=fused)
        self.cv6 = GhostConv(c_, c_, 3, 1, fused=fused)
        self.cv2 = GhostConv(c1, c_, 1, 1, fused=fused)
        self.cv7 = GhostConv(2 * c_, c2, 1, 1, fused=fused)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = self.cv6(self.cv5(torch.cat(
            [x1] + [max_pool(x1, k, 1, k // 2) for k in self.k], dim=1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], dim=1))


def contract(x, gain: int = 2):
    """Width and height into channels (models/common.py:824-835), NCHW:
    output channel (i_sh * gain + i_sw) * C + c, as the JAX NHWC one."""
    n, c, h, w = x.shape
    s = gain
    x = x.reshape(n, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * s * s, h // s, w // s)


def expand(x, gain: int = 2):
    """Channels into width and height (models/common.py:838-849), the
    inverse of ``contract``."""
    n, c, h, w = x.shape
    s = gain
    x = x.reshape(n, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // s ** 2, h * s, w * s)


def chuncat(parts):
    """The first channel halves of every input, then the second halves
    (models/common.py Chuncat on the channel axis)."""
    halves = [p.chunk(2, dim=1) for p in parts]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=1)


def foldcut(x):
    """The two channel halves summed (models/common.py Foldcut on the
    channel axis, parse_model's c2 = ch // 2; JAX blocks.foldcut)."""
    a, b = x.chunk(2, dim=1)
    return a + b


class Classify(nn.Module):
    """Global average pool -> biased conv -> flatten (models/common.py:
    1015-1025); a list input concatenates its pooled features."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=True)

    def forward(self, x):
        xs = x if isinstance(x, (list, tuple)) else [x]
        z = torch.cat([y.mean((2, 3), keepdim=True) for y in xs], dim=1)
        return self.conv(z).flatten(1)


class TransformerLayer(nn.Module):
    """q / k / v projections, torch MultiheadAttention's in- and
    out-projections, then a two-layer MLP, both with residuals, no norm
    (models/common.py:746-760). (B, L, C) in and out."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.h = num_heads
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)

    def forward(self, x):
        b, l, c = x.shape
        h, hd = self.h, c // self.h
        wi, bi = self.in_proj_weight, self.in_proj_bias
        q = self.q(x) @ wi[:c].T + bi[:c]
        k = self.k(x) @ wi[c:2 * c].T + bi[c:2 * c]
        v = self.v(x) @ wi[2 * c:].T + bi[2 * c:]

        def split(t):
            return t.reshape(b, l, h, hd).permute(0, 2, 1, 3)

        attn = torch.softmax(split(q) @ split(k).transpose(-2, -1)
                             / math.sqrt(hd), dim=-1)
        o = (attn @ split(v)).permute(0, 2, 1, 3).reshape(b, l, c)
        x = self.out_proj(o) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """ViT block over the flattened map with a learned position embedding
    (models/common.py:763-790)."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int,
                 fused=False):
        super().__init__()
        self.n = num_layers
        if c1 != c2:
            self.conv = ConvBnAct(c1, c2, 1, 1, fused=fused)
        self.linear = nn.Linear(c2, c2)
        for j in range(num_layers):
            self.add_module(f"tr{j}", TransformerLayer(c2, num_heads))

    def forward(self, x):
        if hasattr(self, "conv"):
            x = self.conv(x)
        b, c, h, w = x.shape
        p = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = p + self.linear(p)
        for j in range(self.n):
            x = getattr(self, f"tr{j}")(x)
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


# Swin v1 / v2 (JAX blocks.py:967-1224). The layers work in NHWC, as the
# Flax ones do; SwinBlock turns the detector's NCHW maps around.

def _rel_pos_index(ws: int) -> np.ndarray:
    """Pairwise relative-position index inside a (ws, ws) window
    (common.py:1382-1393), (ws^2, ws^2)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(win, ws: int, h: int, w: int):
    b = win.shape[0] // (h * w // ws // ws)
    x = win.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _shift_mask_np(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """SW-MSA mask (common.py:1500-1520): -100 between the tokens of a
    window that the cyclic shift brought from different regions."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    mw = mw.reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _shift_mask(h: int, w: int, ws: int, shift: int, device: torch.device):
    """The mask on ``device``, copied there once per map size."""
    return torch.from_numpy(_shift_mask_np(h, w, ws, shift)).to(device)


def _masked(attn, mask):
    if mask is None:
        return attn
    bw, h, n, _ = attn.shape
    nw = mask.shape[0]
    return (attn.reshape(bw // nw, nw, h, n, n)
            + mask.to(attn.dtype)[None, :, None]).reshape(bw, h, n, n)


class WindowAttention(nn.Module):
    """Swin v1 window attention with a learned relative-position bias
    table (common.py:1367-1435), as matmul, softmax, matmul."""

    def __init__(self, dim: int, ws: int, num_heads: int):
        super().__init__()
        self.h = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", torch.from_numpy(
            _rel_pos_index(ws).reshape(-1)), persistent=False)

    def forward(self, x, mask=None):
        bw, n, c = x.shape
        h, hd = self.h, c // self.h
        qkv = self.qkv(x).reshape(bw, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        bias = self.relative_position_bias_table[self.index].reshape(
            n, n, h).permute(2, 0, 1)
        attn = _masked(q @ k.transpose(-2, -1) + bias[None], mask)
        out = torch.softmax(attn, dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


def _cpb_table(ws: int) -> np.ndarray:
    """Swin v2's log-spaced relative coordinates, ((2 ws - 1)^2, 2)."""
    r = np.arange(-(ws - 1), ws, dtype=np.float32)
    t = np.stack(np.meshgrid(r, r, indexing="ij"), -1) / (ws - 1) * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)
    return t.reshape(-1, 2).astype(np.float32)


class WindowAttentionV2(nn.Module):
    """Swin v2 window attention (common.py:1662-1765): cosine attention
    with a learned temperature clamped at log(100), and the log-CPB MLP's
    bias through 16 * sigmoid. ``qkv_kernel`` is the Flax (in, out)
    layout; q and v have biases, k none."""

    def __init__(self, dim: int, ws: int, num_heads: int):
        super().__init__()
        self.h = num_heads
        self.qkv_kernel = nn.Parameter(torch.zeros(dim, 3 * dim))
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("index", torch.from_numpy(
            _rel_pos_index(ws).reshape(-1)), persistent=False)
        self.register_buffer("table", torch.from_numpy(_cpb_table(ws)),
                             persistent=False)

    def forward(self, x, mask=None):
        bw, n, c = x.shape
        h, hd = self.h, c // self.h
        bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias),
                          self.v_bias])
        qkv = (x @ self.qkv_kernel + bias).reshape(bw, n, 3, h, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)

        def l2n(t):
            return t / torch.clamp_min(
                torch.linalg.vector_norm(t, dim=-1, keepdim=True), 1e-12)

        attn = l2n(q) @ l2n(k).transpose(-2, -1)
        attn = attn * torch.exp(torch.clamp(self.logit_scale,
                                            max=math.log(1.0 / 0.01)))
        t = self.cpb_fc2(torch.relu(self.cpb_fc1(
            self.table.to(self.cpb_fc1.weight.dtype))))
        bias_t = t[self.index].reshape(n, n, h).permute(2, 0, 1)
        attn = _masked(attn + 16.0 * torch.sigmoid(bias_t)[None], mask)
        out = torch.softmax(attn, dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(bw, n, c))


class SwinTransformerLayer(nn.Module):
    """One (shifted-)window attention layer, NHWC (common.py:1472-1582,
    v1 pre-norm; 1816-1942, v2 post-norm): the map is padded to a window
    multiple before norm1, shifted by a cyclic roll, and cut back at the
    end."""

    def __init__(self, dim: int, num_heads: int, ws: int = 8, shift: int = 0,
                 mlp_ratio: float = 4.0, v2: bool = False):
        super().__init__()
        self.ws, self.shift, self.v2 = ws, shift, v2
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = (WindowAttentionV2 if v2 else WindowAttention)(
            dim, ws, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        hid = int(dim * mlp_ratio)
        self.mlp_fc1 = nn.Linear(dim, hid)
        self.mlp_fc2 = nn.Linear(hid, dim)

    def forward(self, x):
        b, h0, w0, c = x.shape
        ws, shift = self.ws, self.shift
        pad_b, pad_r = (ws - h0 % ws) % ws, (ws - w0 % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        h, w = x.shape[1], x.shape[2]
        mask = _shift_mask(h, w, ws, shift, x.device) if shift > 0 else None
        shortcut = x.reshape(b, h * w, c)
        y = x if self.v2 else self.norm1(x)
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = _window_reverse(self.attn(_window_partition(y, ws), mask),
                            ws, h, w)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        y = y.reshape(b, h * w, c)
        if self.v2:
            y = self.norm1(y)
        x = shortcut + y
        if self.v2:
            x = x + self.norm2(self.mlp_fc2(F.silu(self.mlp_fc1(x))))
        else:
            x = x + self.mlp_fc2(F.silu(self.mlp_fc1(self.norm2(x))))
        return x.reshape(b, h, w, c)[:, :h0, :w0]


class SwinBlock(nn.Module):
    """SwinTransformer(2)Block (common.py:1584-1599, 1946-1961): a 1x1
    conv where the widths differ, then layers alternating between the
    plain and the shifted (ws // 2) windows. NCHW in and out."""

    def __init__(self, c1: int, c2: int, num_heads: int, num_layers: int,
                 ws: int = 8, v2: bool = False, fused=False):
        super().__init__()
        self.n = num_layers
        if c1 != c2:
            self.conv = ConvBnAct(c1, c2, 1, 1, fused=fused)
        for i in range(num_layers):
            self.add_module(f"blocks{i}", SwinTransformerLayer(
                c2, num_heads, ws, 0 if i % 2 == 0 else ws // 2, v2=v2))

    def forward(self, x):
        if hasattr(self, "conv"):
            x = self.conv(x)
        x = x.permute(0, 2, 3, 1)
        for i in range(self.n):
            x = getattr(self, f"blocks{i}")(x)
        return x.permute(0, 3, 1, 2)


class STCSP(nn.Module):
    """ST(2)CSPA/B/C: the CSP topologies with a Swin block as the inner
    stack, num_heads = c_ // 32 (common.py:1602-1659, 1964-2006)."""

    def __init__(self, c1: int, c2: int, n: int = 1, variant: str = "a",
                 v2: bool = False, fused=False):
        super().__init__()
        self.variant = variant
        c_ = c2 if variant == "b" else c2 // 2
        self.cv1 = ConvBnAct(c1, c_, 1, 1, fused=fused)
        self.m = SwinBlock(c_, c_, max(c_ // 32, 1), n, ws=7 if v2 else 8,
                           v2=v2, fused=fused)
        if variant == "c":
            self.cv3 = ConvBnAct(c_, c_, 1, 1, fused=fused)
        self.cv2 = ConvBnAct(c_ if variant == "b" else c1, c_, 1, 1,
                             fused=fused)
        self.add_module("cv4" if variant == "c" else "cv3",
                        ConvBnAct(2 * c_, c2, 1, 1, fused=fused))

    def forward(self, x):
        x1 = self.cv1(x)
        y1 = self.m(x1)
        if self.variant == "c":
            y1 = self.cv3(y1)
        y2 = self.cv2(x1 if self.variant == "b" else x)
        out = self.cv4 if self.variant == "c" else self.cv3
        return out(torch.cat([y1, y2], dim=1))


def _orepa_prior(o: int, k: int) -> np.ndarray:
    """fre_init's cosine prior (common.py:1143-1153), (o, k, k)."""
    prior = np.zeros((o, k, k), np.float32)
    half = o / 2
    for i in range(o):
        for h in range(k):
            for w in range(k):
                prior[i, h, w] = (
                    math.cos(math.pi * (h + 0.5) * (i + 1) / 3) if i < half
                    else math.cos(math.pi * (w + 0.5) * (i + 1 - half) / 3))
    return prior


class OREPA3x3RepConv(nn.Module):
    """OREPA_3x3_RepConv (groups 1, the identity 1x1 path): five weight
    branches, OIHW as in the Flax tree, weighted per output channel by
    the rows of ``vector`` and summed into one k x k kernel on every
    forward, then conv + BN (+ activation). ``vector`` has a sixth row
    when c1 == c2 and s == 1, which nothing reads."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1,
                 act: str = "id"):
        super().__init__()
        o, self.k, self.s = c2, k, s
        self.act = activation(act)
        self.weight_rbr_origin = nn.Parameter(torch.zeros(o, c1, k, k))
        self.weight_rbr_avg_conv = nn.Parameter(torch.zeros(o, c1, 1, 1))
        self.weight_rbr_pfir_conv = nn.Parameter(torch.zeros(o, c1, 1, 1))
        self.weight_rbr_1x1_kxk_idconv1 = nn.Parameter(
            torch.zeros(c1, c1, 1, 1))
        self.weight_rbr_1x1_kxk_conv2 = nn.Parameter(torch.zeros(o, c1, k, k))
        self.weight_rbr_gconv_dw = nn.Parameter(torch.zeros(c1 * 8, 1, k, k))
        self.weight_rbr_gconv_pw = nn.Parameter(torch.zeros(o, c1 * 8, 1, 1))
        self.vector = nn.Parameter(torch.zeros(
            6 if (o == c1 and s == 1) else 5, o))
        self.bn = BatchNorm2d(o, eps=BN_EPS)
        self.register_buffer("prior", torch.from_numpy(_orepa_prior(o, k)),
                             persistent=False)
        self.register_buffer("eye", torch.eye(c1), persistent=False)

    def composed_weight(self):
        """The five branches summed into one (c2, c1, k, k) kernel."""
        o, c1, k, _ = self.weight_rbr_origin.shape
        vec = self.vector
        w0 = self.weight_rbr_origin * vec[0][:, None, None, None]
        w1 = (self.weight_rbr_avg_conv * (1.0 / (k * k))).expand(
            o, c1, k, k) * vec[1][:, None, None, None]
        w2 = (self.weight_rbr_pfir_conv * self.prior[:, None]) \
            * vec[2][:, None, None, None]
        conv1 = self.weight_rbr_1x1_kxk_idconv1[:, :, 0, 0] + self.eye
        w3 = torch.einsum("ti,othw->oihw", conv1,
                          self.weight_rbr_1x1_kxk_conv2) \
            * vec[3][:, None, None, None]
        dw = self.weight_rbr_gconv_dw.reshape(c1, 8, 1, k, k)
        pw = self.weight_rbr_gconv_pw[:, :, 0, 0].reshape(o, c1, 8)
        w4 = torch.einsum("gtihw,ogt->ogihw", dw, pw).reshape(o, c1, k, k) \
            * vec[4][:, None, None, None]
        return w0 + w1 + w2 + w3 + w4

    def forward(self, x):
        y = F.conv2d(x, self.composed_weight().to(x.dtype), None, self.s,
                     self.k // 2)
        return self.act(self.bn(y))


class RepConvOREPA(nn.Module):
    """RepConv_OREPA (common.py:1224-1264): the OREPA 3x3, a 1x1 conv +
    BN and, when c1 == c2 and s == 1, an identity BN, summed, SiLU. It
    has no fused form, in JAX or here: fuse_state_dict leaves it as it
    is."""

    def __init__(self, c1: int, c2: int, s: int = 1, act: str = "silu"):
        super().__init__()
        self.act = activation(act)
        self.rbr_dense = OREPA3x3RepConv(c1, c2, 3, s)
        self.rbr_1x1_conv = nn.Conv2d(c1, c2, 1, s, 0, bias=False)
        self.rbr_1x1_bn = BatchNorm2d(c2, eps=BN_EPS)
        self.rbr_identity = (BatchNorm2d(c1, eps=BN_EPS)
                             if c1 == c2 and s == 1 else None)

    def forward(self, x):
        out = self.rbr_dense(x) + self.rbr_1x1_bn(self.rbr_1x1_conv(x))
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return self.act(out)


class RobustConv(nn.Module):
    """Large-kernel depthwise conv + biased pointwise conv, times a
    LayerScale ``gamma`` (models/common.py RobustConv)."""

    def __init__(self, c1: int, c2: int, k: int = 7, s: int = 1,
                 fused=False):
        super().__init__()
        self.conv_dw = ConvBnAct(c1, c1, k, s, c1, fused=fused)
        self.conv1x1 = nn.Conv2d(c1, c2, 1, bias=True)
        self.gamma = nn.Parameter(torch.full((c2,), 1e-6))

    def forward(self, x):
        return self.conv1x1(self.conv_dw(x)) * self.gamma[:, None, None]


class FlaxConvTranspose(nn.Module):
    """Flax's ConvTranspose with kernel = stride = s, VALID padding, as
    torch's conv_transpose2d. ``weight`` is the Flax (kh, kw, in, out)
    kernel as (out, in, kh, kw), the layout of every other kernel in the
    port; Flax does not flip the kernel (transpose_kernel=False), which
    in torch's terms is a flipped one."""

    def __init__(self, c1: int, c2: int, s: int):
        super().__init__()
        self.s = s
        self.weight = nn.Parameter(torch.zeros(c2, c1, s, s))
        self.bias = nn.Parameter(torch.zeros(c2))

    def forward(self, x):
        return F.conv_transpose2d(
            x, self.weight.transpose(0, 1).flip(2, 3), self.bias, self.s)


class RobustConv2(nn.Module):
    """Strided large-kernel depthwise conv, a transposed conv back to the
    input size, times a LayerScale ``gamma`` (models/common.py
    RobustConv2)."""

    def __init__(self, c1: int, c2: int, k: int = 7, s: int = 4,
                 fused=False):
        super().__init__()
        self.conv_strided = ConvBnAct(c1, c1, k, s, c1, fused=fused)
        self.conv_deconv = FlaxConvTranspose(c1, c2, s)
        self.gamma = nn.Parameter(torch.full((c2,), 1e-6))

    def forward(self, x):
        return (self.conv_deconv(self.conv_strided(x))
                * self.gamma[:, None, None])


class CrossConv(nn.Module):
    """Cross convolution: (1, k) then (k, 1) convs, SiLU, an optional
    residual (models/experimental.py:9-21). Unfused, each conv has its BN
    (cv{1,2}_conv, cv{1,2}_bn); fused, each is one biased conv."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1,
                 e: float = 1.0, shortcut: bool = False, fused=False):
        super().__init__()
        c_ = int(c2 * e)
        self.add = shortcut and c1 == c2
        self.cv1_conv = nn.Conv2d(c1, c_, (1, k), (1, s), (0, k // 2),
                                  bias=bool(fused))
        self.cv2_conv = nn.Conv2d(c_, c2, (k, 1), (s, 1), (k // 2, 0),
                                  groups=g, bias=bool(fused))
        self.cv1_bn = None if fused else BatchNorm2d(c_, eps=BN_EPS)
        self.cv2_bn = None if fused else BatchNorm2d(c2, eps=BN_EPS)

    def forward(self, x):
        y = x
        for j in (1, 2):
            y = getattr(self, f"cv{j}_conv")(y)
            bn = getattr(self, f"cv{j}_bn")
            y = F.silu(y if bn is None else bn(y))
        return x + y if self.add else y


class Sum(nn.Module):
    """The (optionally weighted: 2 * sigmoid(w)) sum of n inputs
    (models/experimental.py:23-41)."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        self.w = (nn.Parameter(-torch.arange(1.0, n) / 2) if weight
                  else None)

    def forward(self, xs):
        y = xs[0]
        w = None if self.w is None else torch.sigmoid(self.w) * 2
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if w is None else xs[i + 1] * w[i])
        return y


class MixConv2d(nn.Module):
    """Mixed kernels over an equal channel split, concatenated, BN,
    LeakyReLU(0.1), residual (models/experimental.py:44-65)."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (1, 3),
                 s: int = 1):
        super().__init__()
        groups = len(k)
        idx = torch.linspace(0, groups - 1e-6, c2).floor()
        self.k = tuple(k)
        for g, kk in enumerate(self.k):
            self.add_module(f"m{g}", nn.Conv2d(
                c1, int((idx == g).sum()), kk, s, kk // 2, bias=False))
        self.bn = BatchNorm2d(c2, eps=BN_EPS)

    def forward(self, x):
        y = torch.cat([getattr(self, f"m{g}")(x)
                       for g in range(len(self.k))], dim=1)
        return x + F.leaky_relu(self.bn(y), 0.1)
