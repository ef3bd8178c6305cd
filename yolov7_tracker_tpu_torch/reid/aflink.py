"""AFLink's PostLinker, StrongSORT's offline track-linking net (port of
yolov7_tracker_tpu/reid/aflink.py; the reference's
tracker/reid_models/AFLink.py:15-98).

Two temporal towers over 30-step (frame, x, y) snippets: four (7, 1)
VALID convs (32, 64, 128, 256 channels), each followed by a BatchNorm per
column (f, x and y, each over the C channels) and a ReLU; a (1, 3) fusion
conv with BatchNorm and ReLU; global average pooling. A 2-way classifier
(512 -> 128 -> 2, softmax) scores the two towers' embeddings. The layout
is NCHW: a snippet (B, 30, 3) enters as (B, 1, 30, 3).
"""

from __future__ import annotations

import torch
from torch import nn

EPS = 1e-5


class TemporalBlock(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, c, (7, 1), bias=False)
        self.bnf = nn.BatchNorm1d(c, eps=EPS)
        self.bnx = nn.BatchNorm1d(c, eps=EPS)
        self.bny = nn.BatchNorm1d(c, eps=EPS)

    def forward(self, x):                        # (B, C, L, 3)
        x = self.conv(x)
        cols = [bn(x[..., i]) for i, bn in
                enumerate((self.bnf, self.bnx, self.bny))]
        return torch.relu(torch.stack(cols, dim=-1))


class FusionBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, (1, 3), bias=False)
        self.bn = nn.BatchNorm2d(c, eps=EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class Tower(nn.Module):
    def __init__(self):
        super().__init__()
        chans = (1, 32, 64, 128, 256)
        for i in range(4):
            setattr(self, f"t{i}", TemporalBlock(chans[i], chans[i + 1]))
        self.fuse = FusionBlock(256)

    def forward(self, x):                        # (B, 30, 3)
        h = x[:, None]
        for i in range(4):
            h = getattr(self, f"t{i}")(h)
        return self.fuse(h).mean(dim=(2, 3))     # (B, 256)


class PostLinker(nn.Module):
    def __init__(self):
        super().__init__()
        self.m1 = Tower()
        self.m2 = Tower()
        self.fc1 = nn.Linear(512, 128)
        self.fc2 = nn.Linear(128, 2)

    def forward(self, x1, x2):
        """x1, x2: (B, 30, 3) snippets [frame, x, y] -> (B, 2) link
        probabilities."""
        z = torch.cat([self.m1(x1), self.m2(x2)], dim=1)
        z = self.fc2(torch.relu(self.fc1(z)))
        return torch.softmax(z, dim=1)


def load_postlinker(path: str, device="cpu") -> PostLinker:
    """A PostLinker from a Flax msgpack file of the JAX package's
    variables (params and batch_stats), on ``device``, in eval mode."""
    from ..models.from_jax import postlinker_state_dict
    from ..utils.flax_msgpack import load_variables

    model = PostLinker()
    model.load_state_dict(postlinker_state_dict(load_variables(path), model))
    return model.to(device).eval()
