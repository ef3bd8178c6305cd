"""OSNet, the omni-scale ReID backbone, as an nn.Module (port of
yolov7_tracker_tpu/reid/osnet.py; the reference's
tracker/reid_models/OSNet.py:28-598).

ConvLayer 7x7/2 -> max pool -> three stages of OSBlocks (four streams of
1 to 4 LightConv3x3 fused by one shared ChannelGate) with 1x1 + average
pool transitions -> Conv1x1 -> global average pool -> fc (Linear, BN,
ReLU) to a 512-d embedding (the torchreid module's output when not
training). Module and parameter names are torchreid's, so a torchreid
checkpoint loads with ``load_reid_state_dict``. NCHW, float32.

A forward opens the tracer's spans (utils/trace.py) ``reid.osnet.stem``
(conv1 and the max pool), ``reid.osnet.conv2``, ``reid.osnet.conv3``,
``reid.osnet.conv4`` (the OSBlock stages with their transitions) and
``reid.osnet.head`` (conv5, the global pool and fc), timed on the
input's device.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..utils import trace

OSNET_CONFIGS = {
    "osnet_x1_0": (64, 256, 384, 512),
    "osnet_x0_75": (48, 192, 288, 384),
    "osnet_x0_5": (32, 128, 192, 256),
    "osnet_x0_25": (16, 64, 96, 128),
}


class ConvLayer(nn.Module):
    """conv + BN + ReLU."""

    def __init__(self, c_in, c_out, k, stride=1, padding=0, groups=1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding,
                              bias=False, groups=groups)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class Conv1x1Linear(nn.Module):
    """1x1 conv + BN, no activation."""

    def __init__(self, c_in, c_out, stride=1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        return self.bn(self.conv(x))


class LightConv3x3(nn.Module):
    """1x1 conv -> 3x3 depthwise conv -> BN -> ReLU."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 1, bias=False)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1, bias=False,
                               groups=c_out)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        return torch.relu(self.bn(self.conv2(self.conv1(x))))


class ChannelGate(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // reduction, 1, bias=True)
        self.fc2 = nn.Conv2d(c // reduction, c, 1, bias=True)

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(g))))


class OSBlock(nn.Module):
    def __init__(self, c_in, c_out, reduction=4):
        super().__init__()
        mid = c_out // reduction
        self.conv1 = ConvLayer(c_in, mid, 1)
        self.conv2a = LightConv3x3(mid, mid)
        self.conv2b = nn.Sequential(*(LightConv3x3(mid, mid)
                                      for _ in range(2)))
        self.conv2c = nn.Sequential(*(LightConv3x3(mid, mid)
                                      for _ in range(3)))
        self.conv2d = nn.Sequential(*(LightConv3x3(mid, mid)
                                      for _ in range(4)))
        self.gate = ChannelGate(mid)
        self.conv3 = Conv1x1Linear(mid, c_out)
        self.downsample = (Conv1x1Linear(c_in, c_out) if c_in != c_out
                           else None)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = sum(self.gate(branch(x1)) for branch in
                 (self.conv2a, self.conv2b, self.conv2c, self.conv2d))
        x3 = self.conv3(x2)
        ident = x if self.downsample is None else self.downsample(x)
        return torch.relu(x3 + ident)


class OSNet(nn.Module):
    """(B, 3, H, W) normalised crops -> (B, 512); two OSBlocks a stage."""

    def __init__(self, channels: Sequence[int] = OSNET_CONFIGS["osnet_x1_0"]):
        super().__init__()
        ch = channels
        self.conv1 = ConvLayer(3, ch[0], 7, stride=2, padding=3)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        for stage in range(3):
            c_in = ch[stage]
            blocks = [OSBlock(c_in if i == 0 else ch[stage + 1],
                              ch[stage + 1]) for i in range(2)]
            if stage < 2:   # transition: Conv1x1 + average pool
                blocks.append(nn.Sequential(
                    ConvLayer(ch[stage + 1], ch[stage + 1], 1),
                    nn.AvgPool2d(2, stride=2)))
            setattr(self, f"conv{stage + 2}", nn.Sequential(*blocks))
        self.conv5 = ConvLayer(ch[3], ch[3], 1)
        self.fc = nn.Sequential(nn.Linear(ch[3], 512), nn.BatchNorm1d(512),
                                nn.ReLU())

    def forward(self, x):
        with trace.span("reid.osnet.stem", x):
            x = self.maxpool(self.conv1(x))
        for stage in ("conv2", "conv3", "conv4"):
            with trace.span("reid.osnet." + stage, x):
                x = getattr(self, stage)(x)
        with trace.span("reid.osnet.head", x):
            return self.fc(self.conv5(x).mean(dim=(2, 3)))


def build_osnet(name: str = "osnet_x0_25") -> OSNet:
    return OSNet(channels=OSNET_CONFIGS[name])
