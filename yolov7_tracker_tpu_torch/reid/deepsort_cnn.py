"""The DeepSORT ReID CNN as an nn.Module (port of
yolov7_tracker_tpu/reid/deepsort_cnn.py; the reference's
tracker/reid_models/deepsort_reid.py:14-113).

A small ResNet: conv 3x3 (64) + BN + ReLU + max pool 3/2 -> four stages
of two BasicBlocks (64, 128/2, 256/2, 512/2) -> average pool (8, 4) ->
L2-normalised 512-d embedding (the reid=True path). Crops are 128h x 64w.
Module and parameter names are the reference's ``Net`` (``conv.0``,
``layer1.0.conv1``, ``layer2.0.downsample.0``, ...), so its ckpt.t7
``net_dict`` loads with ``load_reid_state_dict``. NCHW, float32.
"""

from __future__ import annotations

import torch
from torch import nn


class BasicBlock(nn.Module):
    def __init__(self, c_in, c_out, is_downsample=False):
        super().__init__()
        stride = 2 if is_downsample else 1
        self.conv1 = nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, stride=1, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(c_out)
        self.downsample = None
        if is_downsample or c_in != c_out:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(c_out))

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class DeepSortCNN(nn.Module):
    """(B, 3, 128, 64) normalised crops -> (B, 512), L2-normalised."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(3, 64, 3, stride=1, padding=1), nn.BatchNorm2d(64),
            nn.ReLU(), nn.MaxPool2d(3, 2, padding=1))
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, True),
                                    BasicBlock(128, 128))
        self.layer3 = nn.Sequential(BasicBlock(128, 256, True),
                                    BasicBlock(256, 256))
        self.layer4 = nn.Sequential(BasicBlock(256, 512, True),
                                    BasicBlock(512, 512))

    def forward(self, x):
        x = self.layer4(self.layer3(self.layer2(self.layer1(self.conv(x)))))
        x = x.mean(dim=(2, 3))          # the (8, 4) average pool at 128x64
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                    + 1e-12)
