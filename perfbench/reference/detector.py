"""Plain reference of the detector stage: letterbox, a yolov7-family
network and NMS.

Plain PyTorch in float32 with TF32 off, no fused weights and no kernels
of its own. It receives the benchmark's seeded UNFUSED weights (the key
names below) and the uint8 frames, and works out what the program derives
from them: the letterbox canvas, BatchNorm applied as it stands, the raw
head levels, the decode and a greedy NMS.

The architecture is the configuration's ``model``, found by name in
``reference/models/`` (yolov7-w6: the yolov7 repo's
``cfg/training/yolov7-w6.yaml`` at its published widths); at inference
the lead heads read their layers only, as the deploy cfg does, so the
auxiliary heads' layers and convs are built (the weights carry them) and
never run. Departures from the published description, each a setting
the configuration file states: BatchNorm's epsilon (``bn_eps``;
upstream's ``initialize_weights`` sets 1e-3) and the resize, JAX's
half-pixel ``linear`` with edge weights renormalised, where upstream
calls ``cv2.resize``; ``nms_top_k`` candidates enter the NMS.

``fp8=True`` is the correctness check's control: every conv's weight
(per output channel), input and output (per tensor) scaled into and
rounded to float8 e4m3, the next precision below the bf16 that the
configuration states; its NMS then runs on decoded rows rounded to
bfloat16, the next below float32.

The NMS takes its ``top_k`` candidates by a score computed in the raw
levels' own dtype, as the configuration's detector scores them (a bf16
network's sigmoids tie often near 1; the ties keep the rows' order), and
then picks greedily by the float32 confidence.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.named import by_name


def architecture(name: str):
    """The rows, heads, anchors and strides of the architecture
    ``name`` (``reference/models/<name>.py``)."""
    return by_name("reference/models", name)


MAX_WH = 4096.0          # NMS class offset (utils/general.py)
PAD_VALUE = 114.0


FP8_MAX = 448.0          # largest float8 e4m3 value


def _fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x scaled into float8 e4m3's range, rounded to it and scaled back,
    per tensor or per slice along ``dim``."""
    if dim is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=[d for d in range(x.dim()) if d != dim],
                            keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Conv2d(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return _fp8(self._conv_forward(_fp8(x), _fp8(self.weight, 0),
                                       self.bias))


class Conv(nn.Module):
    """Conv + BatchNorm + SiLU (models/common.py Conv)."""

    def __init__(self, c1, c2, k=1, s=1, eps=1e-5):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=eps)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class SPPCSPC(nn.Module):
    """models/common.py SPPCSPC, k = (5, 9, 13)."""

    def __init__(self, c1, c2, eps=1e-5):
        super().__init__()
        c_ = c2
        self.cv1 = Conv(c1, c_, 1, 1, eps)
        self.cv2 = Conv(c1, c_, 1, 1, eps)
        self.cv3 = Conv(c_, c_, 3, 1, eps)
        self.cv4 = Conv(c_, c_, 1, 1, eps)
        self.cv5 = Conv(4 * c_, c_, 1, 1, eps)
        self.cv6 = Conv(c_, c_, 3, 1, eps)
        self.cv7 = Conv(2 * c_, c2, 1, 1, eps)

    def forward(self, x):
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = torch.cat([x1] + [F.max_pool2d(x1, k, 1, k // 2)
                               for k in (5, 9, 13)], dim=1)
        y2 = self.cv2(x)
        return self.cv7(torch.cat([self.cv6(self.cv5(y1)), y2], dim=1))


def _reorg(x):
    return torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                      x[..., ::2, 1::2], x[..., 1::2, 1::2]], dim=1)


class Yolo(nn.Module):
    """A yolov7-family network built from an architecture's rows
    (``architecture``); ``forward`` gives the lead heads' raw levels,
    each (B, ny, nx, na, 5 + nc), before the sigmoid."""

    def __init__(self, arch, nc: int, bn_eps: float = 1e-5):
        super().__init__()
        self.arch = arch
        self.nc, self.na, self.no = nc, 3, nc + 5
        self.frm: List[List[int]] = []
        c_out: List[int] = []
        for i, (frm, kind, args) in enumerate(self.arch.ROWS):
            frm = [f if f >= 0 else i + f for f in
                   (frm if isinstance(frm, list) else [frm])]
            self.frm.append(frm)
            c_in = 3 if i == 0 else c_out[frm[0]]
            if kind == "Conv":
                self.add_module(f"layer{i}", Conv(c_in, args[0], args[1],
                                                  args[2], bn_eps))
                c_out.append(args[0])
            elif kind == "SPPCSPC":
                self.add_module(f"layer{i}", SPPCSPC(c_in, args[0], bn_eps))
                c_out.append(args[0])
            elif kind == "ReOrg":
                c_out.append(4 * c_in)
            elif kind == "Concat":
                c_out.append(sum(c_out[f] for f in frm))
            else:                                   # Upsample
                c_out.append(c_in)
        nl = len(self.arch.STRIDES)
        for i, src in enumerate(self.arch.HEAD_FROM):
            c = c_out[src]
            aux = "2" if i >= nl else ""
            self.add_module(f"head_m{aux}_{i % nl}",
                            Conv2d(c, self.na * self.no, 1, bias=True))
            if i < nl:
                self.register_parameter(f"head_ia_{i}",
                                        nn.Parameter(torch.zeros(c)))
                self.register_parameter(
                    f"head_im_{i}", nn.Parameter(torch.ones(self.na
                                                            * self.no)))
        # the rows the lead heads need (the deploy cfg)
        need = set(self.arch.HEAD_FROM[:nl])
        for i in range(len(self.arch.ROWS) - 1, -1, -1):
            if i in need:
                need.update(self.frm[i])
        self.needed = need

    def load_weights(self, state_dict):
        """The program's key names: ``head_ia_i.implicit`` is this
        module's ``head_ia_i`` parameter."""
        sd = {k.replace(".implicit", ""): v for k, v in state_dict.items()}
        self.load_state_dict(sd)

    def set_fp8(self, on: bool):
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.fp8 = on

    def forward(self, x):
        """x: (B, 3, H, W) float32 RGB in [0, 1]."""
        ys = {}
        y = x
        for i, (frm, (_, kind, args)) in enumerate(zip(self.frm, self.arch.ROWS)):
            if i not in self.needed:
                continue
            inp = x if i == 0 else ys[frm[0]]
            if kind == "ReOrg":
                y = _reorg(inp)
            elif kind == "Concat":
                y = torch.cat([ys[f] for f in frm], dim=1)
            elif kind == "Upsample":
                y = F.interpolate(inp, scale_factor=args[0], mode="nearest")
            else:
                y = getattr(self, f"layer{i}")(inp)
            ys[i] = y
        out = []
        for i, src in enumerate(self.arch.HEAD_FROM[:len(self.arch.STRIDES)]):
            feat = ys[src] + getattr(self, f"head_ia_{i}")[None, :, None,
                                                           None]
            p = getattr(self, f"head_m_{i}")(feat)
            p = p * getattr(self, f"head_im_{i}")[None, :, None, None]
            b, _, ny, nx = p.shape
            out.append(p.view(b, self.na, self.no, ny, nx)
                       .permute(0, 3, 4, 1, 2).contiguous())
        return out


# ---------------------------------------------------------------------------
# letterbox (utils/datasets.py letterbox, auto=True)
# ---------------------------------------------------------------------------

def letterbox_geometry(src_hw: Tuple[int, int], img_size: int, stride: int):
    """(canvas (h, w), resized (h, w), (top, left))."""
    h, w = src_hw
    r = min(img_size / h, img_size / w)
    uw, uh = int(round(w * r)), int(round(h * r))
    dw, dh = (img_size - uw) % stride / 2, (img_size - uh) % stride / 2
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    return (uh + top + bottom, uw + left + right), (uh, uw), (top, left)


def _resize_axis(x: torch.Tensor, dim: int, out: int) -> torch.Tensor:
    """Half-pixel linear resize along ``dim``: each output sample blends
    its two neighbours, weights outside the input dropped and the rest
    renormalised."""
    n = x.shape[dim]
    s = (torch.arange(out, dtype=torch.float64) + 0.5) * (n / out) - 0.5
    i0 = torch.floor(s)
    f = s - i0
    i0 = i0.long()
    i1 = i0 + 1
    w0 = torch.where(i0 >= 0, 1.0 - f, torch.zeros_like(f))
    w1 = torch.where(i1 <= n - 1, f, torch.zeros_like(f))
    tot = w0 + w1
    w0, w1 = (w0 / tot).float(), (w1 / tot).float()
    shape = [1] * x.dim()
    shape[dim] = out
    dev = x.device
    a = x.index_select(dim, i0.clamp(0, n - 1).to(dev))
    b = x.index_select(dim, i1.clamp(0, n - 1).to(dev))
    return a * w0.to(dev).view(shape) + b * w1.to(dev).view(shape)


def letterbox(frames_u8: torch.Tensor, img_size: int, stride: int):
    """(B, H, W, 3) uint8 BGR -> (B, 3, h, w) float32 RGB canvas / 255."""
    canvas, (uh, uw), (top, left) = letterbox_geometry(
        tuple(frames_u8.shape[1:3]), img_size, stride)
    x = frames_u8.float()
    x = _resize_axis(_resize_axis(x, 1, uh), 2, uw)
    out = torch.full((x.shape[0], canvas[0], canvas[1], 3), PAD_VALUE,
                     device=x.device)
    out[:, top:top + uh, left:left + uw] = x
    return (out.flip(-1) / 255.0).permute(0, 3, 1, 2).contiguous()


# ---------------------------------------------------------------------------
# decode + NMS (utils/general.py non_max_suppression, best class)
# ---------------------------------------------------------------------------

def decode(levels, anchors, strides) -> torch.Tensor:
    """Raw levels -> (B, N, 5 + nc) [xyxy, obj, class probabilities]."""
    rows = []
    for p, anc, s in zip(levels, anchors, strides):
        b, ny, nx, na, no = p.shape
        y = torch.sigmoid(p.float())
        gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                                torch.arange(nx, device=p.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[:, :, None, :].float()
        anc = torch.tensor(anc, dtype=torch.float32,
                           device=p.device).view(1, 1, na, 2)
        xy = (y[..., 0:2] * 2.0 - 0.5 + grid) * s
        wh = (y[..., 2:4] * 2.0) ** 2 * anc
        xyxy = torch.cat([xy - wh / 2, xy + wh / 2], -1)
        rows.append(torch.cat([xyxy, y[..., 4:]], -1).reshape(b, -1, no))
    return torch.cat(rows, 1)


def _iou(a, b):
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).prod(-1)
    area_b = (b[:, 2:] - b[:, :2]).prod(-1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def rank_scores(levels) -> torch.Tensor:
    """(B, N) sigmoid(obj) * sigmoid(best class logit) in the levels'
    dtype, rows in decode's order."""
    return torch.cat([(torch.sigmoid(p[..., 4])
                       * torch.sigmoid(p[..., 5:].max(-1).values))
                      .reshape(p.shape[0], -1) for p in levels], 1)


def nms_one(pred: torch.Tensor, rank: torch.Tensor, conf_thres: float,
            iou_thres: float, max_det: int, top_k: int) -> np.ndarray:
    """One image's decoded rows -> (n, 6) [xyxy, conf, cls] float32: the
    ``top_k`` rows by ``rank``, those above ``conf_thres`` in order of
    confidence, then greedy suppression."""
    conf_all = pred[:, 5:] * pred[:, 4:5]
    conf, cls = conf_all.max(1)
    cand = torch.sort(rank, descending=True, stable=True).indices[:top_k]
    c = conf[cand]
    order = cand[torch.sort(torch.where(c > conf_thres, c, -1.0),
                            descending=True, stable=True).indices]
    order = order[conf[order] > conf_thres]
    boxes, conf, cls = pred[order, :4], conf[order], cls[order].float()
    iou = (_iou(boxes + cls[:, None] * MAX_WH, boxes + cls[:, None] * MAX_WH)
           > iou_thres).cpu().numpy()
    dead = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if dead[i]:
            continue
        keep.append(i)
        if len(keep) == max_det:
            break
        dead |= iou[i]
    keep = torch.as_tensor(keep, dtype=torch.long, device=pred.device)
    return torch.cat([boxes[keep], conf[keep, None], cls[keep, None]],
                     1).cpu().numpy()


def scale_boxes(dets: np.ndarray, canvas_hw, src_hw) -> np.ndarray:
    """Canvas xyxy -> frame pixels, clipped and rounded (scale_coords and
    post_process's .round())."""
    gain = min(canvas_hw[0] / src_hw[0], canvas_hw[1] / src_hw[1])
    pad = ((canvas_hw[1] - src_hw[1] * gain) / 2,
           (canvas_hw[0] - src_hw[0] * gain) / 2)
    out = dets.copy()
    for c in range(4):
        out[:, c] = np.clip((dets[:, c] - pad[c % 2]) / gain, 0,
                            src_hw[1 - c % 2])
    out[:, :4] = np.round(out[:, :4])
    return out


class Detector:
    """The whole detector stage: uint8 frames -> raw head levels ->
    per-frame (n, 6) dets [x1, y1, x2, y2, score, cls] in frame pixels.
    ``q`` rounds the decoded rows before the NMS (the identity here; the
    check's control passes bfloat16)."""

    def __init__(self, state_dict, cfg: dict, device, fp8: bool = False):
        p = cfg["pipeline"]
        self.img_size, self.cfg = p["img_size"], p
        self.arch = architecture(p["model"])
        self.model = Yolo(self.arch, p["nc"], cfg["weights"]["bn_eps"])
        self.model.load_weights(state_dict)
        self.model = self.model.to(device).eval()
        self.model.set_fp8(fp8)

    @torch.no_grad()
    def raw(self, frames_u8: torch.Tensor, block: int = 2):
        """The lead heads' raw levels of a batch, in float32."""
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            parts = [self.model(letterbox(frames_u8[i:i + block],
                                          self.img_size, max(self.arch.STRIDES)))
                     for i in range(0, frames_u8.shape[0], block)]
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        return [torch.cat(p) for p in zip(*parts)]

    @torch.no_grad()
    def nms(self, levels, src_hw, q=None):
        """Raw levels (any float dtype) -> per-frame dets."""
        canvas = (levels[0].shape[1] * self.arch.STRIDES[0],
                  levels[0].shape[2] * self.arch.STRIDES[0])
        rank = rank_scores(levels)
        pred = decode(levels, self.arch.ANCHORS, self.arch.STRIDES)
        if q is not None:
            pred = q(pred)
        c = self.cfg
        return [scale_boxes(nms_one(p, r, c["conf_thres"], c["iou_thres"],
                                    c["max_det"], c["nms_top_k"]), canvas,
                            src_hw) for p, r in zip(pred, rank)]

    def __call__(self, frames_u8: torch.Tensor):
        return self.nms(self.raw(frames_u8), tuple(frames_u8.shape[1:3]))
