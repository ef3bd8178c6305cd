"""Test-time augmentation (port of yolov7_tracker_tpu/models/tta.py; the
reference's Model.forward(augment=True), models/yolo.py:301-317): the
detector at scales (1, 0.83, 0.67) x flips (none, lr, none), each output
de-scaled (and un-flipped) and the three concatenated for NMS.

The resize is jax.image.resize's "linear" with its default antialias
(``data/letterbox.resize_linear``, JAX's weight matrices): shrinking by
0.83 or 0.67 low-pass filters, which plain bilinear sampling does not.
No CLI runs TTA, in JAX or here; it is a library call.
"""

from __future__ import annotations

from typing import List

import torch

from ..data.letterbox import resize_linear
from .yolo import YoloV7, decoded

SCALES = (1.0, 0.83, 0.67)
FLIPS = (None, "lr", None)
PAD_VALUE = 0.447


def _scale_img(x: torch.Tensor, ratio: float, gs: int = 64) -> torch.Tensor:
    """(B, H, W, C) resized by ``ratio`` and padded with 0.447 (bottom and
    right) up to a multiple of ``gs`` (utils/torch_utils.scale_img)."""
    if ratio == 1.0:
        return x
    b, h, w, c = x.shape
    nh, nw = int(h * ratio), int(w * ratio)
    y = resize_linear(x, nh, nw, antialias=True)
    ph = int((h * ratio // gs + 1) * gs) if nh % gs else nh
    pw = int((w * ratio // gs + 1) * gs) if nw % gs else nw
    out = torch.full((b, max(ph, nh), max(pw, nw), c), PAD_VALUE,
                     dtype=x.dtype, device=x.device)
    out[:, :nh, :nw] = y
    return out


def forward_tta(model: YoloV7, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, 3) in [0, 1] -> the three passes' decoded predictions
    (B, N_total, no), boxes in x's pixels."""
    w = x.shape[2]
    outs: List[torch.Tensor] = []
    for s, f in zip(SCALES, FLIPS):
        y = decoded(model, _scale_img(x.flip(2) if f == "lr" else x, s))
        y = torch.cat([y[..., :4] / s, y[..., 4:]], dim=-1)
        if f == "lr":
            y = torch.cat([w - y[..., 0:1], y[..., 1:]], dim=-1)
        outs.append(y)
    return torch.cat(outs, dim=1)
