"""Letterbox preprocessing on the device (port of
yolov7_tracker_tpu/data/letterbox.py).

``device_preprocess`` resizes a (B, H, W, 3) uint8 batch to the letterbox
rectangle, pads it with 114 into the canvas, swaps BGR->RGB and scales to
[0, 1]. The resize is ``jax.image.resize(..., "linear", antialias=False)``
rebuilt exactly: two banded weight matrices computed the way JAX's
``scale_and_translate`` computes them (edge weights renormalised, not
clamped as in ``F.interpolate``), applied as matmuls.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

PAD_VALUE = 114.0


def letterbox_params(shape_hw: Tuple[int, int], new_shape: Tuple[int, int],
                     stride: int = 32, auto: bool = True,
                     scaleup: bool = True):
    """(ratio, unpadded (w, h), (dw, dh)) like the reference _letterbox."""
    h, w = shape_hw
    r = min(new_shape[0] / h, new_shape[1] / w)
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(w * r)), int(round(h * r)))
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    return r, new_unpad, (dw / 2, dh / 2)


def linear_resize_weights(in_size: int, out_size: int,
                          antialias: bool = False) -> np.ndarray:
    """(in_size, out_size) float32 triangle-kernel weights of
    jax.image.resize(method="linear") along one axis. antialias=True is
    jax.image.resize's default: when it shrinks, the kernel widens by
    the inverse scale (a low-pass filter), which F.interpolate's bilinear
    does not do in the same way."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.0) - np.float32(0.5))
    x = np.abs(sample[None, :]
               - np.arange(in_size, dtype=np.float32)[:, None])
    if antialias:
        x = x / np.maximum(inv_scale, np.float32(1.0))
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= np.float32(in_size) - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _weights_on(in_size: int, out_size: int, device: torch.device,
                dtype: torch.dtype, antialias: bool) -> torch.Tensor:
    """linear_resize_weights on the device, built once per camera geometry
    (a 1920 -> 1088 matrix takes tens of ms to build on the host)."""
    return torch.as_tensor(linear_resize_weights(in_size, out_size,
                                                 antialias),
                           device=device, dtype=dtype)


def resize_linear(x: torch.Tensor, uh: int, uw: int,
                  antialias: bool = False) -> torch.Tensor:
    """Bilinear (B, H, W, C) -> (B, uh, uw, C) in x's dtype, as
    jax.image.resize(..., "linear", antialias=antialias)."""
    b, h, w, c = x.shape
    wh = _weights_on(h, uh, x.device, x.dtype, antialias)
    ww = _weights_on(w, uw, x.device, x.dtype, antialias)
    y = torch.matmul(wh.T, x.reshape(b, h, w * c))          # (B, uh, W*C)
    y = y.reshape(b, uh, w, c).permute(0, 1, 3, 2)          # (B, uh, C, W)
    y = torch.matmul(y, ww)                                 # (B, uh, C, uw)
    return y.permute(0, 1, 3, 2)


def device_preprocess(frames: torch.Tensor, src_hw: Tuple[int, int],
                      out_hw: Tuple[int, int],
                      unpad_hw: Tuple[int, int] | None = None,
                      bgr_to_rgb: bool = True, dtype=torch.float32):
    """(B, H, W, 3) uint8 -> (normalised (B, outH, outW, 3) canvas in
    ``dtype``, (ratio, (dw, dh))). ``out_hw`` is the final stride-padded
    canvas; the image sits symmetrically in it. ``unpad_hw`` is the exact
    resize target (as letterbox_params gives it)."""
    if unpad_hw is None:
        r, (uw, uh), _ = letterbox_params(src_hw, out_hw, auto=False)
    else:
        uh, uw = unpad_hw
        r = min(uh / src_hw[0], uw / src_hw[1])
    dw = (out_hw[1] - uw) / 2
    dh = (out_hw[0] - uh) / 2
    x = resize_linear(frames.to(dtype), uh, uw)
    top = int(round(dh - 0.1))
    left = int(round(dw - 0.1))
    out = torch.full((frames.shape[0], out_hw[0], out_hw[1], 3), PAD_VALUE,
                     dtype=dtype, device=frames.device)
    out[:, top:top + uh, left:left + uw] = x
    if bgr_to_rgb:
        out = out.flip(-1)
    return out / 255.0, (r, (dw, dh))


def scale_coords_device(coords: torch.Tensor, img1_hw, img0_hw,
                        do_round: bool = True):
    """Map xyxy boxes from the letterboxed canvas back to the frame
    (utils/general.py:319-340, with post_process_v7's .round())."""
    gain = min(img1_hw[0] / img0_hw[0], img1_hw[1] / img0_hw[1])
    pad_x = (img1_hw[1] - img0_hw[1] * gain) / 2
    pad_y = (img1_hw[0] - img0_hw[0] * gain) / 2
    x1 = (coords[..., 0] - pad_x) / gain
    y1 = (coords[..., 1] - pad_y) / gain
    x2 = (coords[..., 2] - pad_x) / gain
    y2 = (coords[..., 3] - pad_y) / gain
    out = torch.stack([
        x1.clamp(0, img0_hw[1]), y1.clamp(0, img0_hw[0]),
        x2.clamp(0, img0_hw[1]), y2.clamp(0, img0_hw[0]),
    ], dim=-1)
    return torch.round(out) if do_round else out
