"""RobMOTS baseline trackers and detection post-processors
(tracker/trackeval/baselines/{stp,thresholder,non_overlap,
baseline_utils}.py): STP ("simplest tracker possible", greedy IoU
association with a timestep-decayed matching score), score
thresholding, and the score-ordered non-overlap mask enforcement, all
over the unified RobMOTS row format `t id cls score h w rle` using the
from-spec COCO RLE codec in eval/rle.py."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from . import rle as RL


def load_robmots_dets(path: str) -> Dict[int, List[Dict]]:
    """baseline_utils.load_seq: rows grouped by class then timestep;
    missing timesteps are empty. data[cls][t] carries ids / scores /
    im_hs / im_ws / mask_rles arrays."""
    read: Dict[int, Dict[int, Dict[str, list]]] = {}
    num_t = 0
    with open(path) as f:
        for line in f:
            row = line.split()
            if len(row) < 7:
                continue
            t, cid, c, s, h, w, rle = row[:7]
            t, c = int(t), int(c)
            num_t = max(num_t, t + 1)
            td = read.setdefault(c, {}).setdefault(
                t, {"ids": [], "scores": [], "im_hs": [], "im_ws": [],
                    "mask_rles": []})
            td["ids"].append(cid)
            td["scores"].append(s)
            td["im_hs"].append(h)
            td["im_ws"].append(w)
            td["mask_rles"].append(rle)
    data: Dict[int, List[Dict]] = {}
    for c, by_t in read.items():
        data[c] = []
        for t in range(num_t):
            td = by_t.get(t)
            if td is None:
                data[c].append({
                    "ids": np.empty(0, int),
                    "scores": np.empty(0, float),
                    "im_hs": np.empty(0, int),
                    "im_ws": np.empty(0, int),
                    "mask_rles": np.empty(0, str)})
            else:
                data[c].append({
                    "ids": np.asarray(td["ids"], int),
                    "scores": np.asarray(td["scores"], float),
                    "im_hs": np.asarray(td["im_hs"], int),
                    "im_ws": np.asarray(td["im_ws"], int),
                    "mask_rles": np.asarray(td["mask_rles"], str)})
    return data


def threshold(t_data: Dict, thresh: float) -> Dict:
    keep = t_data["scores"] > thresh
    return {k: t_data[k][keep] for k in
            ("ids", "scores", "im_hs", "im_ws", "mask_rles")}


def sort_by_score(t_data: Dict) -> Dict:
    order = np.argsort(t_data["scores"])[::-1]
    return {k: v[order] for k, v in t_data.items()}


def _coco_masks(t_data):
    return [{"size": [int(h), int(w)], "counts": m.encode("utf-8")}
            for h, w, m in zip(t_data["im_hs"], t_data["im_ws"],
                               t_data["mask_rles"])]


def masks2boxes(t_data) -> np.ndarray:
    masks = _coco_masks(t_data)
    if not masks:
        return np.empty((0, 4))
    return np.stack([RL.to_bbox(m) for m in masks])


def box_iou_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    from .data import iou_tlwh

    return iou_tlwh(a, b)


def mask_nms(t_data: Dict, nms_threshold: float = 0.5,
             already_sorted: bool = False) -> Dict:
    """baseline_utils.mask_NMS: greedy score-ordered suppression of
    masks overlapping a higher-scoring survivor."""
    if not already_sorted:
        t_data = sort_by_score(t_data)
    masks = _coco_masks(t_data)
    n = len(masks)
    ious = RL.iou(masks, masks, [False] * n) if n else np.zeros((0, 0))
    removed = [False] * n
    for i in range(n):
        if removed[i]:
            continue
        for j in range(i + 1, n):
            if ious[i, j] > nms_threshold:
                removed[j] = True
    keep = np.logical_not(removed)
    return {k: v[keep] for k, v in t_data.items()}


def non_overlap(t_data: Dict, already_sorted: bool = False) -> Dict:
    """baseline_utils.non_overlap: paint masks lowest-score-first into
    one label image so higher scores occlude lower, then re-encode."""
    if not already_sorted:
        t_data = sort_by_score(t_data)
    masks = _coco_masks(t_data)
    if not masks:
        return t_data
    h, w = int(t_data["im_hs"][0]), int(t_data["im_ws"][0])
    canvas = np.zeros((h, w), np.uint8)
    for i, m in enumerate(masks[::-1]):
        canvas[RL.decode(m).astype(bool)] = i + 1
    n = len(masks)
    out_rles = []
    for i, j in enumerate(range(1, n + 1)[::-1]):
        out_rles.append(
            RL.encode((canvas == j).astype(np.uint8))["counts"]
            .decode("utf-8"))
    out = dict(t_data)
    out["mask_rles"] = np.asarray(out_rles, str)
    return out


def stp_track_sequence(data: Dict[int, List[Dict]],
                       detection_threshold: float = 0.5,
                       association_threshold: float = 1e-10,
                       max_frames_skip: int = 7) -> List[list]:
    """STP (stp.py:35-113): per class, greedily match current
    detections to tracks from up to max_frames_skip previous timesteps;
    the matching score is IoU scaled by 10^-age so recency dominates.
    Returns unified-format output rows."""
    out_rows: List[list] = []
    curr_max_id = 0
    for cls, cls_data in data.items():
        prev = {"boxes": np.empty((0, 4)),
                "ids": np.array([], int),
                "timesteps": np.array([])}
        for t, t_data in enumerate(cls_data):
            t_data = threshold(t_data, detection_threshold)
            boxes = masks2boxes(t_data)
            ious = box_iou_xywh(prev["boxes"], boxes)
            age_score = np.power(10.0, -1 * prev["timesteps"])
            match_scores = age_score[:, None] * ious
            rows, cols = linear_sum_assignment(-match_scores)
            ok = ious[rows, cols] > association_threshold
            rows, cols = rows[ok], cols[ok]
            ids = np.nan * np.ones(len(boxes))
            ids[cols] = prev["ids"][rows]
            n_new = len(ids) - len(cols)
            new_ids = np.arange(curr_max_id + 1, curr_max_id + n_new + 1)
            ids[np.isnan(ids)] = new_ids
            curr_max_id += n_new
            unmatched = [i for i in range(len(prev["ids"]))
                         if i not in rows
                         and prev["timesteps"][i] + 1 <= max_frames_skip]
            prev = {
                "ids": np.concatenate([ids.astype(int),
                                       prev["ids"][unmatched]]),
                "boxes": np.concatenate(
                    [np.atleast_2d(boxes),
                     np.atleast_2d(prev["boxes"][unmatched])]),
                "timesteps": np.concatenate(
                    [np.zeros(len(ids)),
                     prev["timesteps"][unmatched] + 1]),
            }
            for i in range(len(t_data["ids"])):
                out_rows.append([
                    t, int(ids[i]), cls, t_data["scores"][i],
                    t_data["im_hs"][i], t_data["im_ws"][i],
                    t_data["mask_rles"][i]])
    return out_rows


def write_rows(rows: List[list], out_file: str):
    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    with open(out_file, "w") as f:
        for r in rows:
            f.write(" ".join(str(x) for x in r) + "\n")


def thresholder_sequence(data: Dict[int, List[Dict]],
                         detection_threshold: float = 0.2) -> List[list]:
    """thresholder.py: drop detections under the threshold, keep ids."""
    out_rows: List[list] = []
    for cls, cls_data in data.items():
        for t, t_data in enumerate(cls_data):
            t_data = threshold(t_data, detection_threshold)
            for i in range(len(t_data["ids"])):
                out_rows.append([
                    t, int(t_data["ids"][i]), cls, t_data["scores"][i],
                    t_data["im_hs"][i], t_data["im_ws"][i],
                    t_data["mask_rles"][i]])
    return out_rows


def non_overlap_sequence(data: Dict[int, List[Dict]]) -> List[list]:
    """non_overlap.py: enforce non-overlapping masks per timestep
    ACROSS classes (classes are combined, sorted by score, painted,
    then re-emitted)."""
    # combine classes per timestep (baseline_utils.combine_classes)
    num_t = max(len(v) for v in data.values())
    out_rows: List[list] = []
    for t in range(num_t):
        fields = {"ids": [], "scores": [], "im_hs": [], "im_ws": [],
                  "mask_rles": [], "cls": []}
        for cls, cls_data in data.items():
            td = cls_data[t] if t < len(cls_data) else None
            if td is None:
                continue
            for i in range(len(td["ids"])):
                fields["ids"].append(td["ids"][i])
                fields["scores"].append(td["scores"][i])
                fields["im_hs"].append(td["im_hs"][i])
                fields["im_ws"].append(td["im_ws"][i])
                fields["mask_rles"].append(td["mask_rles"][i])
                fields["cls"].append(cls)
        td = {k: np.asarray(v) for k, v in fields.items()}
        if len(td["ids"]) == 0:
            continue
        td = non_overlap(td)
        for i in range(len(td["ids"])):
            out_rows.append([
                t, int(td["ids"][i]), int(td["cls"][i]),
                td["scores"][i], td["im_hs"][i], td["im_ws"][i],
                td["mask_rles"][i]])
    return out_rows


# ---------------------------------------------------------------------------
# Visualization (trackeval/baselines/vizualize.py + pascal_colormap.py):
# RobMOTS-format txt -> per-class and all-class DAVIS-style label PNGs.
# ---------------------------------------------------------------------------

def pascal_colormap() -> np.ndarray:
    """(256, 3) uint8 PASCAL VOC label colormap — the standard
    bit-reversal construction; reproduces the literal float table in
    trackeval/baselines/pascal_colormap.py (0.5020 = 128/255, ...)."""
    cmap = np.zeros((256, 3), np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def label_image(t_data: Dict, im_h: int, im_w: int) -> np.ndarray:
    """(H, W) uint8 label map: pixel = track id + 1, later masks painted
    over earlier ones (baseline_utils.save_as_png:288-300)."""
    png = np.zeros((im_h, im_w), np.uint8)
    for i in range(len(t_data.get("mask_rles", []))):
        m = RL.decode({
            "size": [int(t_data["im_hs"][i]), int(t_data["im_ws"][i])],
            "counts": str(t_data["mask_rles"][i]).encode()})
        png[m.astype(bool)] = int(t_data["ids"][i]) + 1
    return png


def save_as_png(t_data: Dict, out_file: str, im_h: int, im_w: int):
    """Write one timestep's masks as a palettized PNG (DAVIS format)."""
    from PIL import Image

    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    im = Image.fromarray(label_image(t_data, im_h, im_w), mode="P")
    im.putpalette(pascal_colormap().flatten().tolist())
    im.save(out_file)


def get_frame_size(data: Dict[int, List[Dict]]):
    """First available (h, w) in the data (baseline_utils:313-321)."""
    for cls_data in data.values():
        for td in cls_data:
            if len(td["im_hs"]) > 0:
                return int(td["im_hs"][0]), int(td["im_ws"][0])
    return None


def visualize_sequence(seq_file: str, out_fol: str,
                       class_names: Dict[int, str] | None = None):
    """vizualize.py:31-64: per-class PNG folders (ids < 100 only), then
    an 'all_classes' folder over the class-combined data."""
    data = load_robmots_dets(seq_file)
    size = get_frame_size(data)
    if size is None:
        return
    im_h, im_w = size
    for cls, cls_data in data.items():
        if cls >= 100:
            continue
        name = (class_names or {}).get(cls, str(cls))
        for t, td in enumerate(cls_data):
            save_as_png(td, os.path.join(out_fol, name,
                                         str(t).zfill(5) + ".png"),
                        im_h, im_w)
    # class-combined pass (baseline_utils.combine_classes)
    num_t = max(len(v) for v in data.values())
    for t in range(num_t):
        fields = {"ids": [], "im_hs": [], "im_ws": [], "mask_rles": []}
        for cls_data in data.values():
            if t >= len(cls_data):
                continue
            td = cls_data[t]
            for k in fields:
                fields[k].extend(list(td[k]))
        save_as_png(fields, os.path.join(out_fol, "all_classes",
                                         str(t).zfill(5) + ".png"),
                    im_h, im_w)
