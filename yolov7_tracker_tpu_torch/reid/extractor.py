"""ReID crops on the device (port of yolov7_tracker_tpu/reid/extractor.py).

The reference crops each detection on the host with a python slice and
cv2.resize, then batches the crops through the CNN (deepsort.py:19-40,
strongsort.py:47-72). Here crop + resize + normalise is one bilinear
gather over the D boxes of a frame, on the frame's device: the
half-pixel sample positions of the JAX package's ``_sample_coords``, four
taps, /255, ImageNet normalisation. (The JAX package's ``extract_crops``
computes the same values as two banded matmuls, a TPU layout; its test
pins the two forms as equal.)

DeepSORT takes 128h x 64w crops, OSNet 128h x 256w (the reference's
``dsize=(256, 128)`` quirk, strongsort.py:56-58). The frame is used as
given (BGR), as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sample_coords(tlbr, out_hw: Tuple[int, int], src_hw: Tuple[int, int]):
    """Half-pixel-centre sample positions for (..., D, 4) boxes with int-
    truncated corners: ys (..., D, out_h), xs (..., D, out_w), clamped
    inside."""
    h, w = out_hw
    x1, y1, x2, y2 = torch.floor(tlbr).unbind(-1)
    cw = torch.clamp(x2 - x1, min=1.0)[..., None]
    ch = torch.clamp(y2 - y1, min=1.0)[..., None]
    ar = torch.arange(max(h, w), dtype=torch.float32, device=tlbr.device)
    ys = y1[..., None] + (ar[:h] + 0.5) * ch / h - 0.5
    xs = x1[..., None] + (ar[:w] + 0.5) * cw / w - 0.5
    return (ys.clamp(0.0, src_hw[0] - 1.0), xs.clamp(0.0, src_hw[1] - 1.0))


def extract_crops(frame, tlbr, out_hw: Tuple[int, int]):
    """frame (..., H, W, 3) uint8 + boxes (..., D, 4) tlbr -> normalised
    crops (..., D, out_h, out_w, 3) float32 (the JAX package's layout; the
    models take ``.permute(0, 3, 1, 2)``, which is channels_last memory).
    A leading stream axis gathers the crops of S frames in one go, each
    box from its own frame."""
    hgt, wid = frame.shape[-3], frame.shape[-2]
    ys, xs = sample_coords(tlbr.float(), out_hw, (hgt, wid))
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0)[..., :, None, None]
    wx = (xs - x0)[..., None, :, None]
    y0, x0 = y0.long(), x0.long()
    y1 = (y0 + 1).clamp(max=hgt - 1)
    x1 = (x0 + 1).clamp(max=wid - 1)
    flat = frame.reshape(-1, 3)
    lead = tlbr.shape[:-2]
    # each frame's first pixel in ``flat``, shaped to broadcast over
    # (..., D, h, w)
    base = (torch.arange(flat.shape[0] // (hgt * wid), device=frame.device)
            * (hgt * wid)).reshape(lead + (1, 1, 1))

    def tap(yi, xi):                    # (..., D, h, w, 3) float32
        return flat[base + yi[..., :, None] * wid + xi[..., None, :]].float()

    top = tap(y0, x0) * (1 - wx) + tap(y0, x1) * wx
    bot = tap(y1, x0) * (1 - wx) + tap(y1, x1) * wx
    crops = (top * (1 - wy) + bot * wy) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=crops.device)
    std = torch.tensor(IMAGENET_STD, device=crops.device)
    return (crops - mean) / std
