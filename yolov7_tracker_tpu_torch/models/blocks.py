"""PyTorch building blocks for the YOLOv7 subset the w6 family uses (port
of yolov7_tracker_tpu/models/blocks.py): Conv(+BN)+act, max pools, ReOrg,
SPPCSPC and nearest upsampling. Tensors are NCHW inside the detector.

The JAX package's ReOrg-folded stem conv and width-packed convs are TPU
layout tricks with the same outputs; the port runs the plain ``reorg``
followed by the 3x3 conv.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


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
        self.bn = None if fused else nn.BatchNorm2d(c2, eps=BN_EPS)
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
