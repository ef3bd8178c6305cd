"""OSNet x1_0 ("Omni-Scale Feature Learning for Person Re-Identification",
Zhou et al., ICCV 2019, arXiv:1905.00953; torchreid's ``osnet_x1_0``,
github.com/KaiyangZhou/deep-person-reid ``torchreid/models/osnet.py``) at
its published widths, in plain ``torch.nn`` and float32.

- Stem: a 7x7 stride-2 conv + BN + ReLU to 64 channels, a 3x3 stride-2
  max pool.
- Three stages ``conv2``, ``conv3``, ``conv4`` of two OSBlocks each,
  widening to 256, 384 and 512 channels; ``conv2`` and ``conv3`` end in a
  transition, a 1x1 conv + BN + ReLU and a 2x2 average pool.
- An OSBlock (bottleneck reduction 4): a 1x1 conv + BN + ReLU to c/4
  channels; four streams of 1, 2, 3 and 4 LightConv3x3 (a 1x1 conv, a
  depthwise 3x3 conv, BN, ReLU), each scaled by one ChannelGate that the
  four share (a global average pool, a 1x1 conv with bias down to c/64,
  ReLU, a 1x1 conv with bias back up, a sigmoid); the four summed, a 1x1
  conv + BN to c, the input added (through a 1x1 conv + BN where the
  width changes), ReLU.
- ``conv5``, a 1x1 conv + BN + ReLU at 512; the global average pool;
  ``fc``: Linear 512 -> 512, BatchNorm1d, ReLU. The output is ``fc``'s,
  the 512-d embedding torchreid's module returns when not training.

Module and parameter names are torchreid's (and the program's), so one
state dict serves both. Departures: the crop is 128 h x 256 w, the
reference tracker's ``dsize=(256, 128)`` quirk (torchreid trains on
256 h x 128 w: the same 32,768 pixels and the same operations); the
classifier, which only training uses, is left out. ``Net()`` comes out
of its constructor in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

CROP_HW = (128, 256)
FEATURE_DIM = 512
WIDTHS = (64, 256, 384, 512)


class ConvLayer(nn.Module):
    """conv (no bias) + BN + ReLU; ``relu=False`` is Conv1x1Linear."""

    def __init__(self, c_in, c_out, k=1, stride=1, padding=0, relu=True):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return torch.relu(y) if self.relu else y


class LightConv3x3(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 1, bias=False)
        self.conv2 = nn.Conv2d(c, c, 3, 1, 1, bias=False, groups=c)
        self.bn = nn.BatchNorm2d(c)

    def forward(self, x):
        return torch.relu(self.bn(self.conv2(self.conv1(x))))


class ChannelGate(nn.Module):
    def __init__(self, c, reduction=16):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // reduction, 1)
        self.fc2 = nn.Conv2d(c // reduction, c, 1)

    def forward(self, x):
        w = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(w))))


class OSBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        mid = c_out // 4
        self.conv1 = ConvLayer(c_in, mid)
        self.conv2a = LightConv3x3(mid)
        self.conv2b = nn.Sequential(*[LightConv3x3(mid) for _ in range(2)])
        self.conv2c = nn.Sequential(*[LightConv3x3(mid) for _ in range(3)])
        self.conv2d = nn.Sequential(*[LightConv3x3(mid) for _ in range(4)])
        self.gate = ChannelGate(mid)
        self.conv3 = ConvLayer(mid, c_out, relu=False)
        self.downsample = (ConvLayer(c_in, c_out, relu=False)
                           if c_in != c_out else None)

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = (self.gate(self.conv2a(x1)) + self.gate(self.conv2b(x1))
              + self.gate(self.conv2c(x1)) + self.gate(self.conv2d(x1)))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv3(x2) + identity)


def stage(c_in, c_out, transition):
    layers = [OSBlock(c_in, c_out), OSBlock(c_out, c_out)]
    if transition:
        layers.append(nn.Sequential(ConvLayer(c_out, c_out),
                                    nn.AvgPool2d(2, stride=2)))
    return nn.Sequential(*layers)


class Net(nn.Module):
    """(N, 3, 128, 256) normalised crops -> (N, 512) embeddings."""

    STAGES = ("conv2", "conv3", "conv4")

    def __init__(self):
        super().__init__()
        c = WIDTHS
        self.conv1 = ConvLayer(3, c[0], 7, 2, 3)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        self.conv2 = stage(c[0], c[1], True)
        self.conv3 = stage(c[1], c[2], True)
        self.conv4 = stage(c[2], c[3], False)
        self.conv5 = ConvLayer(c[3], c[3])
        self.fc = nn.Sequential(nn.Linear(c[3], FEATURE_DIM),
                                nn.BatchNorm1d(FEATURE_DIM), nn.ReLU())
        self.eval()

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.conv5(self.conv4(self.conv3(self.conv2(x))))
        return self.fc(x.mean(dim=(2, 3)))
