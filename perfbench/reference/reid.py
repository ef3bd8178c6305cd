"""Plain reference of the ReID stage: each detection's crop and the
configuration's ReID network (``pipeline.reid``, found by name in
``reference/models/``: its ``Net``, ``CROP_HW`` and ``FEATURE_DIM``), in
float32 with TF32 off.

A crop samples its box (corners truncated to whole pixels) at half-pixel
centres on an ``out_h`` x ``out_w`` grid, clamped inside the frame,
bilinearly from the four nearest pixels, then /255 and ImageNet's mean
and std, on the frame as given (BGR), as the program states it.
``dtype=torch.bfloat16`` is the check's control: the network one
precision below the float32 that the configuration states.
"""

from __future__ import annotations

from typing import Tuple

import torch

from perfbench.named import by_name

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def crops(frame_u8: torch.Tensor, tlbr: torch.Tensor,
          out_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W, 3) uint8 frame, (D, 4) boxes -> (D, 3, out_h, out_w)."""
    hgt, wid = frame_u8.shape[:2]
    oh, ow = out_hw
    x1, y1, x2, y2 = torch.floor(tlbr.double()).unbind(-1)
    ys = (y1[:, None] + (torch.arange(oh, device=tlbr.device) + 0.5)
          * torch.clamp(y2 - y1, min=1.0)[:, None] / oh - 0.5)
    xs = (x1[:, None] + (torch.arange(ow, device=tlbr.device) + 0.5)
          * torch.clamp(x2 - x1, min=1.0)[:, None] / ow - 0.5)
    ys, xs = ys.clamp(0, hgt - 1).float(), xs.clamp(0, wid - 1).float()
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[:, :, None, None], (xs - x0)[:, None, :, None]
    y0, x0 = y0.long(), x0.long()
    y1i, x1i = (y0 + 1).clamp(max=hgt - 1), (x0 + 1).clamp(max=wid - 1)
    f = frame_u8.float()

    def px(yi, xi):
        return f[yi[:, :, None], xi[:, None, :]]       # (D, oh, ow, 3)

    top = px(y0, x0) * (1 - wx) + px(y0, x1i) * wx
    bot = px(y1i, x0) * (1 - wx) + px(y1i, x1i) * wx
    c = (top * (1 - wy) + bot * wy) / 255.0
    c = (c - torch.tensor(MEAN, device=c.device)) / torch.tensor(
        STD, device=c.device)
    return c.permute(0, 3, 1, 2).contiguous()


def network(name: str):
    """The ReID architecture ``name`` (``reference/models/<name>.py``)."""
    return by_name("reference/models", name)


class Embedder:
    """Crops and the network: frame + boxes -> (D, F) embeddings."""

    def __init__(self, state_dict, device, name: str,
                 dtype: torch.dtype = torch.float32):
        arch = network(name)
        self.net = arch.Net()
        self.net.load_state_dict(state_dict)
        self.net = self.net.to(device, dtype).eval()
        self.dtype, self.crop_hw = dtype, tuple(arch.CROP_HW)

    @torch.no_grad()
    def __call__(self, frame_u8, tlbr, block: int = 512):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            c = crops(frame_u8, tlbr, self.crop_hw).to(self.dtype)
            return torch.cat([self.net(c[i:i + block]).float()
                              for i in range(0, len(c), block)])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
