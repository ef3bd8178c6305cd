"""The DeepSORT CNN (the reference tracker's ``tracker/reid_models/
deepsort_reid.py`` ``Net``) at its published widths: a conv stem, four
stages of two BasicBlocks, an average pool, an L2-normalised 512-d
embedding of a 128 x 64 crop. The module names are the checkpoint's, so
one state dict serves the program and this reference."""

from __future__ import annotations

import torch
from torch import nn

CROP_HW = (128, 64)
FEATURE_DIM = 512


class Block(nn.Module):
    def __init__(self, c_in, c_out, down=False):
        super().__init__()
        s = 2 if down else 1
        self.conv1 = nn.Conv2d(c_in, c_out, 3, s, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(c_out)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(c_out)
        self.downsample = (nn.Sequential(nn.Conv2d(c_in, c_out, 1, s,
                                                   bias=False),
                                         nn.BatchNorm2d(c_out))
                           if down or c_in != c_out else None)

    def forward(self, x):
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        return torch.relu(y + (x if self.downsample is None
                               else self.downsample(x)))


class Net(nn.Module):
    """(N, 3, 128, 64) crops -> (N, 512) unit embeddings."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(3, 64, 3, 1, 1),
                                  nn.BatchNorm2d(64), nn.ReLU(),
                                  nn.MaxPool2d(3, 2, 1))
        self.layer1 = nn.Sequential(Block(64, 64), Block(64, 64))
        self.layer2 = nn.Sequential(Block(64, 128, True), Block(128, 128))
        self.layer3 = nn.Sequential(Block(128, 256, True), Block(256, 256))
        self.layer4 = nn.Sequential(Block(256, 512, True), Block(512, 512))

    def forward(self, x):
        x = self.layer4(self.layer3(self.layer2(self.layer1(self.conv(x)))))
        x = x.mean(dim=(2, 3))
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                    + 1e-12)
