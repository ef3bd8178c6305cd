"""Detection mAP metrics (port of yolov7_tracker_tpu/train/metrics.py, a
copy; reference utils/metrics.py:18-106 + test.py correctness matrix) —
host numpy, evaluation-time only."""

from __future__ import annotations

from typing import Dict

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, xyxy."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    iw = np.maximum(
        0,
        np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]),
    )
    ih = np.maximum(
        0,
        np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]),
    )
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-16)


def correctness_matrix(dets: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """(n_det, 10) bool: det is TP at each IoU 0.5:0.95 (test.py:~140-210
    matching: per gt class, greedy by detected iou>threshold unique)."""
    correct = np.zeros((len(dets), len(IOUV)), bool)
    if len(labels) == 0 or len(dets) == 0:
        return correct
    iou = box_iou_np(labels[:, 1:5], dets[:, :4])
    cls_match = labels[:, 0:1] == dets[:, 5][None, :]
    for k, t in enumerate(IOUV):
        cand = np.nonzero((iou >= t) & cls_match)
        if len(cand[0]):
            m = np.stack(
                [cand[0], cand[1], iou[cand[0], cand[1]]], axis=1
            )
            m = m[m[:, 2].argsort()[::-1]]
            m = m[np.unique(m[:, 1], return_index=True)[1]]
            m = m[np.unique(m[:, 0], return_index=True)[1]]
            correct[m[:, 1].astype(int), k] = True
    return correct


def ap_per_class(tp, conf, pred_cls, target_cls, return_curves=False):
    """101-point interpolated AP per class (utils/metrics.py:18-106).

    Returns (p, r, ap (nc, 10), f1, unique_classes); like the reference,
    p/r/f1 are the per-class values at the confidence maximizing mean F1
    (metrics.py:57-59) — return_curves=True yields the full (nc, 1000)
    curves over the confidence grid instead (for PR plotting).
    """
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]
    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_l = (target_cls == c).sum()
        n_p = mask.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_l + 1e-16)
        r[ci] = np.interp(-px, -conf[mask], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p[ci] = np.interp(-px, -conf[mask], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j] = compute_ap(recall[:, j], precision[:, j])
    f1 = 2 * p * r / (p + r + 1e-16)
    if return_curves:
        return p, r, ap, f1, unique_classes.astype(int)
    i = f1.mean(0).argmax()
    return p[:, i], r[:, i], ap, f1[:, i], unique_classes.astype(int)


def compute_ap(recall, precision):
    """101-point interp AP (utils/metrics.py:69-106)."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return np.trapezoid(np.interp(x, mrec, mpre), x)


def fitness(metrics: Dict[str, float]) -> float:
    """Weighted fitness [P, R, mAP@.5, mAP@.5:.95] x [0, 0, 0.1, 0.9]
    (utils/metrics.py:12-16)."""
    return 0.1 * metrics.get("map50", 0.0) + 0.9 * metrics.get("map", 0.0)


class ConfusionMatrix:
    """Detection confusion matrix (utils/metrics.py:109-170)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.matrix = np.zeros((nc + 1, nc + 1))
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres

    def process_batch(self, detections, labels):
        """Mirror of the reference's match-dedup order exactly
        (utils/metrics.py:117-157): sort by IoU, unique per detection,
        RE-sort by IoU, unique per gt; correct cell is [gc, dc]."""
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = labels[:, 0].astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = box_iou_np(labels[:, 1:5], detections[:, :4])
        x = np.nonzero(iou > self.iou_thres)
        if len(x[0]):
            m = np.stack([x[0], x[1], iou[x[0], x[1]]], axis=1)
            if len(x[0]) > 1:
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 1], return_index=True)[1]]
                m = m[m[:, 2].argsort()[::-1]]
                m = m[np.unique(m[:, 0], return_index=True)[1]]
        else:
            m = np.zeros((0, 3))
        matched = len(m) > 0
        m0, m1 = m[:, 0].astype(int), m[:, 1].astype(int)
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if matched and j.sum() == 1:
                self.matrix[gc, det_classes[m1[j]][0]] += 1  # correct
            else:
                self.matrix[self.nc, gc] += 1  # missed gt
        if matched:
            for i, dc in enumerate(det_classes):
                if not (m1 == i).any():
                    self.matrix[dc, self.nc] += 1  # unmatched detection
