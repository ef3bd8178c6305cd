"""Box format conversions and pairwise IoU (port of
yolov7_tracker_tpu/ops/boxes.py).

Formats (float32, last axis = 4): tlwh, tlbr, xyah (center, w/h, h),
xyar (center, area, h/w), xywh (center, w, h). The floor-division quirk
of the reference's tlwh<->xywh and the max(0, .) clamp of xywh2tlbr are
kept, since they feed the association costs.
"""

from __future__ import annotations

import math

import torch


def tlbr_to_tlwh(tlbr):
    return torch.cat([tlbr[..., :2], tlbr[..., 2:] - tlbr[..., :2]], dim=-1)


def tlwh_to_tlbr(tlwh):
    return torch.cat([tlwh[..., :2], tlwh[..., :2] + tlwh[..., 2:]], dim=-1)


def tlwh_to_xyah(tlwh):
    cxy = tlwh[..., :2] + tlwh[..., 2:] / 2.0
    a = tlwh[..., 2:3] / tlwh[..., 3:4]
    return torch.cat([cxy, a, tlwh[..., 3:4]], dim=-1)


def xyah_to_tlwh(xyah):
    h = xyah[..., 3:4]
    w = xyah[..., 2:3] * h
    xy = xyah[..., :2] - torch.cat([w, h], dim=-1) / 2.0
    return torch.cat([xy, w, h], dim=-1)


def tlwh_to_xyar(tlwh):
    cxy = tlwh[..., :2] + tlwh[..., 2:] / 2.0
    area = tlwh[..., 2:3] * tlwh[..., 3:4]
    r = tlwh[..., 3:4] / tlwh[..., 2:3]
    return torch.cat([cxy, area, r], dim=-1)


def xyar_to_cxcywh(xyar):
    """(xc, yc, area, r=h/w) -> (xc, yc, w, h); center-anchored like the
    reference's 'naive' STrack.tlwh (see the JAX docstring)."""
    h = torch.sqrt(xyar[..., 2:3] * xyar[..., 3:4])
    w = xyar[..., 2:3] / h
    return torch.cat([xyar[..., :2], w, h], dim=-1)


def tlwh_to_xywh(tlwh):
    cxy = tlwh[..., :2] + torch.floor(tlwh[..., 2:] / 2.0)
    return torch.cat([cxy, tlwh[..., 2:]], dim=-1)


def xywh_to_tlwh(xywh):
    xy = xywh[..., :2] - torch.floor(xywh[..., 2:] / 2.0)
    return torch.cat([xy, xywh[..., 2:]], dim=-1)


def xywh_to_tlbr(xywh):
    tl = xywh[..., :2] - torch.floor(xywh[..., 2:] / 2.0)
    br = tl + xywh[..., 2:]
    return torch.clamp(torch.cat([tl, br], dim=-1), min=0.0)


def xywh_to_xyxy(xywh):
    tl = xywh[..., :2] - xywh[..., 2:] / 2.0
    br = xywh[..., :2] + xywh[..., 2:] / 2.0
    return torch.cat([tl, br], dim=-1)


def iou_matrix(a_tlbr, b_tlbr):
    """Pairwise IoU (N,4) x (M,4) -> (N,M) with the +1 pixel convention
    of cython_bbox.bbox_overlaps."""
    a = a_tlbr[..., :, None, :]
    b = b_tlbr[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0]) + 1.0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1]) + 1.0)
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def iou_matrix_xyxy(a, b, eps: float = 1e-7):
    """Pairwise IoU without the +1 convention (detector-side box_iou)."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    iw = torch.clamp(torch.minimum(a_[..., 2], b_[..., 2])
                     - torch.maximum(a_[..., 0], b_[..., 0]), min=0.0)
    ih = torch.clamp(torch.minimum(a_[..., 3], b_[..., 3])
                     - torch.maximum(a_[..., 1], b_[..., 1]), min=0.0)
    inter = iw * ih
    area_a = (a_[..., 2] - a_[..., 0]) * (a_[..., 3] - a_[..., 1])
    area_b = (b_[..., 2] - b_[..., 0]) * (b_[..., 3] - b_[..., 1])
    return inter / (area_a + area_b - inter + eps)


def iou_distance(a_tlbr, b_tlbr):
    """1 - IoU cost matrix (tracker/matching.py:64-82)."""
    return 1.0 - iou_matrix(a_tlbr, b_tlbr)


def buffered_tlwh(tlwh, scale: float):
    """Expand a tlwh box by ``scale`` on each side, keeping the center
    (C-BIoU buffered boxes, tracker/c_biou_tracker.py:48-62):
    [x - b*w, y - b*h, (1+2b)*w, (1+2b)*h]."""
    xy = tlwh[..., :2] - scale * tlwh[..., 2:]
    wh = (1.0 + 2.0 * scale) * tlwh[..., 2:]
    return torch.cat([xy, wh], dim=-1)


def bbox_iou(box1, box2, *, xywh: bool = True, giou: bool = False,
             diou: bool = False, ciou: bool = False, eps: float = 1e-7):
    """Elementwise IoU / GIoU / DIoU / CIoU of broadcast-compatible boxes
    (the detector loss's box term, utils/general.py bbox_iou). Clamps are
    ``torch.maximum`` against 0, as ``jnp.maximum``, so a tie splits the
    gradient in halves as JAX's does; CIoU's alpha carries no gradient."""
    if xywh:
        b1, b2 = xywh_to_xyxy(box1), xywh_to_xyxy(box2)
    else:
        b1, b2 = box1, box2
    zero = b1.new_zeros(())
    iw = torch.maximum(torch.minimum(b1[..., 2], b2[..., 2])
                       - torch.maximum(b1[..., 0], b2[..., 0]), zero)
    ih = torch.maximum(torch.minimum(b1[..., 3], b2[..., 3])
                       - torch.maximum(b1[..., 1], b2[..., 1]), zero)
    inter = iw * ih
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not (giou or diou or ciou):
        return iou
    cw = (torch.maximum(b1[..., 2], b2[..., 2])
          - torch.minimum(b1[..., 0], b2[..., 0]))
    ch = (torch.maximum(b1[..., 3], b2[..., 3])
          - torch.minimum(b1[..., 1], b2[..., 1]))
    if giou:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2[..., 0] + b2[..., 2] - b1[..., 0] - b1[..., 2]) ** 2
            + (b2[..., 1] + b2[..., 3] - b1[..., 1] - b1[..., 3]) ** 2) / 4.0
    if diou:
        return iou - rho2 / c2
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                                - torch.atan(w1 / (h1 + eps))) ** 2
    with torch.no_grad():
        alpha = v / (v - iou + (1.0 + eps))
    return iou - (rho2 / c2 + v * alpha)
