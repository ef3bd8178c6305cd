"""First-party COCO bbox evaluation (pycocotools.cocoeval replacement).

The reference scores its COCO-format detection dump with pycocotools
(test.py:173-193: loadRes + COCOeval(annType='bbox') + the 12-number
summarize). pycocotools is absent on this box, so cli/test.py could
only EMIT the json. This module implements the same protocol in plain
numpy so the json can be scored in-process:

- 10 IoU thresholds 0.50:0.05:0.95, 101-point recall interpolation;
- greedy per-image matching of score-sorted detections to the
  best-IoU unconsumed GT, with pycocotools' exact tie rules (ignored
  GTs sorted last and only matchable once no real GT qualifies; crowd
  GTs reusable, IoU against crowd = intersection / det area);
- area ranges all/small/medium/large on the GT `area` field and
  maxDets (1, 10, 100) truncation;
- accumulate() -> precision[T,R,K,A,M] / recall[T,K,A,M] and the
  standard 12-number summary.

Matches pycocotools semantics for detections; the `ignore` flag and
crowd handling follow cocoeval.py's evaluateImg. Mask/keypoint modes
are out of scope (the reference only scores bbox).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """IoU matrix for xywh boxes; crowd GT uses intersection/det-area
    (maskUtils.iou semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(0)
    ih = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(0)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOevalLite:
    """Evaluate COCO-format detections against COCO-format ground truth.

    gt: dict with 'images' [{'id'}], 'annotations' [{'image_id',
        'category_id', 'bbox' xywh, optional 'area', 'iscrowd',
        'ignore'}], optional 'categories' [{'id'}].
    dt: list of {'image_id', 'category_id', 'bbox' xywh, 'score'}
        (exactly what cli/test.py --save_json emits / loadRes takes).
    """

    def __init__(self, gt: Dict, dt: Sequence[Dict]):
        self.img_ids = sorted({im["id"] for im in gt["images"]})
        if gt.get("categories"):
            self.cat_ids = sorted({c["id"] for c in gt["categories"]})
        else:
            self.cat_ids = sorted(
                {a["category_id"] for a in gt["annotations"]}
                | {d["category_id"] for d in dt})
        self._gts: Dict = {}
        for a in gt["annotations"]:
            area = a.get("area")
            if area is None:
                area = float(a["bbox"][2]) * float(a["bbox"][3])
            rec = {
                "bbox": np.asarray(a["bbox"], np.float64),
                "area": float(area),
                "iscrowd": int(a.get("iscrowd", 0)),
                "ignore": int(a.get("ignore", 0)) or int(
                    a.get("iscrowd", 0)),
            }
            self._gts.setdefault(
                (a["image_id"], a["category_id"]), []).append(rec)
        self._dts: Dict = {}
        for d in dt:
            rec = {
                "bbox": np.asarray(d["bbox"], np.float64),
                "score": float(d["score"]),
                "area": float(d["bbox"][2]) * float(d["bbox"][3]),
            }
            self._dts.setdefault(
                (d["image_id"], d["category_id"]), []).append(rec)
        self.precision = None  # (T, R, K, A, M)
        self.recall = None     # (T, K, A, M)

    # -- per (image, category, area range, maxDet) matching ------------
    def _evaluate_img(self, img_id, cat_id, a_rng, max_det):
        gts = self._gts.get((img_id, cat_id), [])
        dts = self._dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        g_ignore = np.array(
            [g["ignore"] or not (a_rng[0] <= g["area"] <= a_rng[1])
             for g in gts], bool)
        # ignored GTs sort last (stable), cocoeval.py evaluateImg
        g_order = np.argsort(g_ignore, kind="stable")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        g_crowd = np.array([g["iscrowd"] for g in gts], np.int64)
        d_scores = np.array([d["score"] for d in dts], np.float64)
        d_order = np.argsort(-d_scores, kind="stable")[:max_det]
        dts = [dts[i] for i in d_order]
        d_scores = d_scores[d_order]

        ious = bbox_iou_xywh(
            np.array([d["bbox"] for d in dts]).reshape(-1, 4),
            np.array([g["bbox"] for g in gts]).reshape(-1, 4),
            g_crowd)
        T, D, G = len(IOU_THRS), len(dts), len(gts)
        dtm = np.zeros((T, D), np.int64)     # matched gt index + 1
        gtm = np.zeros((T, G), np.int64)
        dt_ig = np.zeros((T, D), bool)
        for ti, t in enumerate(IOU_THRS):
            for di in range(D):
                best_iou = min(t, 1.0 - 1e-10)
                m = -1
                for gi in range(G):
                    if gtm[ti, gi] > 0 and not g_crowd[gi]:
                        continue
                    # past all real GTs with a real match in hand: stop
                    if m > -1 and not g_ignore[m] and g_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dtm[ti, di] = m + 1
                gtm[ti, m] = di + 1
                dt_ig[ti, di] = g_ignore[m]
        # unmatched dets outside the area range are ignored, not FPs
        d_out = np.array(
            [not (a_rng[0] <= d["area"] <= a_rng[1]) for d in dts], bool)
        dt_ig |= (dtm == 0) & d_out[None]
        return {
            "scores": d_scores,
            "dtm": dtm,
            "dt_ig": dt_ig,
            "n_gt": int((~g_ignore).sum()),
        }

    def accumulate(self) -> "COCOevalLite":
        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNGS), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai, a_rng in enumerate(AREA_RNGS.values()):
                for mi, max_det in enumerate(MAX_DETS):
                    evals = [
                        self._evaluate_img(i, cat, a_rng, max_det)
                        for i in self.img_ids
                    ]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate(
                        [e["scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtm"] for e in evals], 1)[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ig"] for e in evals], 1)[:, order]
                    n_gt = sum(e["n_gt"] for e in evals)
                    if n_gt == 0:
                        continue
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp = np.cumsum(tps, 1).astype(np.float64)
                    fp = np.cumsum(fps, 1).astype(np.float64)
                    for ti in range(T):
                        if tp.shape[1] == 0:
                            continue
                        rc = tp[ti] / n_gt
                        pr = tp[ti] / np.maximum(
                            tp[ti] + fp[ti], np.spacing(1))
                        recall[ti, ki, ai, mi] = (
                            rc[-1] if len(rc) else 0.0)
                        # monotone envelope then 101-point sample
                        q = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        p = np.zeros(R)
                        valid = inds < len(q)
                        p[valid] = q[inds[valid]]
                        precision[ti, :, ki, ai, mi] = p
        self.precision, self.recall = precision, recall
        return self

    def _summarize(self, ap=True, iou=None, area="all", max_dets=100):
        ai = list(AREA_RNGS).index(area)
        mi = MAX_DETS.index(max_dets)
        if ap:
            s = self.precision[..., ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        else:
            s = self.recall[..., ai, mi]
            if iou is not None:
                s = s[np.isclose(IOU_THRS, iou)]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def summarize(self) -> Dict[str, float]:
        """The standard 12 numbers (cocoeval.summarize order)."""
        if self.precision is None:
            self.accumulate()
        return {
            "AP": self._summarize(True),
            "AP50": self._summarize(True, iou=0.5),
            "AP75": self._summarize(True, iou=0.75),
            "AP_small": self._summarize(True, area="small"),
            "AP_medium": self._summarize(True, area="medium"),
            "AP_large": self._summarize(True, area="large"),
            "AR1": self._summarize(False, max_dets=1),
            "AR10": self._summarize(False, max_dets=10),
            "AR100": self._summarize(False),
            "AR_small": self._summarize(False, area="small"),
            "AR_medium": self._summarize(False, area="medium"),
            "AR_large": self._summarize(False, area="large"),
        }


def evaluate_json(gt_path: str, dt_path: str) -> Dict[str, float]:
    """Score a detection json (cli/test.py --save_json output) against a
    COCO ground-truth json; returns the 12-number summary."""
    import json

    with open(gt_path) as f:
        gt = json.load(f)
    with open(dt_path) as f:
        dt = json.load(f)
    if isinstance(dt, dict):  # tolerate {'annotations': [...]} dumps
        dt = dt.get("annotations", [])
    return COCOevalLite(gt, dt).accumulate().summarize()
