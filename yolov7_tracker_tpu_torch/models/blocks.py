"""PyTorch building blocks of the detector zoo (port of
yolov7_tracker_tpu/models/blocks.py): Conv(+BN)+act, max pools, ReOrg,
SPPCSPC, nearest upsampling, RepConv, DownC, the darknet / ResNet
bottlenecks and the CSP family, SPP, Stem, Focus, and the YOLOv5 / YOLOv8
blocks C3, C2f and SPPF. Tensors are NCHW inside the detector. Submodule
names follow the Flax tree (``m{j}``, ``m{j}_cv1``, ``rbr_dense_conv``
...), which keeps models/from_jax.py a renaming; models/convert.py maps
the reference's checkpoint names onto them. Not ported yet: the Ghost,
Swin / Transformer, OREPA and RobustConv blocks.

The JAX package's ReOrg-folded stem conv and width-packed convs are TPU
layout tricks with the same outputs; the port runs the plain ``reorg``
followed by the 3x3 conv.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
BN_MOM = 0.9  # Flax's momentum (blocks.py:20), 1 - torch's 0.1

_STATS_SINK: contextvars.ContextVar = contextvars.ContextVar(
    "batch_stats_sink", default=None)


@contextlib.contextmanager
def batch_stats_sink(sink: List):
    """Inside the block every BatchNorm2d in training mode normalises by
    its batch statistics and appends ``(module, mean, invstd)`` (float32,
    detached) to ``sink`` instead of updating its running statistics;
    ``update_running_stats(sink)`` then applies Flax's update."""
    token = _STATS_SINK.set(sink)
    try:
        yield sink
    finally:
        _STATS_SINK.reset(token)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose training-mode forward inside
    ``batch_stats_sink`` reports its batch statistics rather than folding
    them into the running ones: torch updates ``running_var`` with the
    unbiased batch variance, Flax (``_compute_stats``) with the biased
    one, a factor n / (n - 1) apart. Anywhere else it is nn.BatchNorm2d."""

    def forward(self, x):
        sink = _STATS_SINK.get()
        if not self.training or sink is None:
            return super().forward(x)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
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


class ConvBnAct(nn.Module):
    """Conv (pad k//2 or explicit p) + BatchNorm + activation; fused=True
    is one biased conv with BN folded in (models/fuse.py)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: str = "silu", fused: bool = False,
                 p: Optional[int] = None):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p,
                              groups=g, bias=fused)
        self.bn = None if fused else BatchNorm2d(c2, eps=BN_EPS)
        self.act = activation(act)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


def max_pool(x, k: int, s: int, pad: int):
    return F.max_pool2d(x, k, s, pad)


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
                 g: int = 1, fused: bool = False):
        super().__init__()
        self.act = activation(act)
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


# the CSP inner blocks other than Bottleneck, whose signature adds n
_CSP_INNER = {"res": Res, "rep_bottleneck": RepBottleneck, "rep_res": RepRes}


class CSP(nn.Module):
    """CSP wrapper over the A/B/C split topologies (models/common.py:
    307-404: BottleneckCSPA/B/C, ResCSPA/B/C, ResXCSPA/B/C and their
    RepConv variants), inner blocks m{j}:

      A: y1 = m(cv1(x)),      y2 = cv2(x)   -> cv3(cat)
      B: x1 = cv1(x); y1 = m(x1), y2 = cv2(x1) -> cv3(cat)  (c_ = c2)
      C: y1 = cv3(m(cv1(x))), y2 = cv2(x)   -> cv4(cat)
    """

    def __init__(self, c1: int, c2: int, n: int = 1, variant: str = "a",
                 inner: str = "bottleneck", shortcut: bool = True,
                 g: int = 1, inner_e: float = 1.0, fused: bool = False):
        super().__init__()
        if inner != "bottleneck" and inner not in _CSP_INNER:
            raise NotImplementedError(f"CSP inner {inner!r} is not ported "
                                      "yet")
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
