"""Additional TrackEval benchmark readers: BDD100K, Head Tracking
Challenge (HT), PersonPath22.

Each reader mirrors the corresponding vendored-TrackEval dataset class
(tracker/trackeval/datasets/{bdd100k,head_tracking_challenge,
person_path_22}.py) in a load + per-class-preprocess pair, the same
shape as `eval.data` uses for MOT/VisDrone/KITTI. Outputs are the
metric-input dicts that `eval.metrics` consumes. Golden-tested against
the vendored TrackEval on synthetic fixtures (tests/test_readers.py).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

from .data import (EPS, MOT_CLASSES, iou_tlwh, load_raw_seq,
                   seq_length_from_seqinfo)

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def iou_xyxy_raw(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of x0y0x1y1 boxes (trackeval _calculate_box_ious,
    box_format='x0y0x1y1')."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    iw = np.maximum(
        0, np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]))
    ih = np.maximum(
        0, np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = np.maximum(area_a[:, None] + area_b[None, :] - inter, EPS)
    return inter / union


def ioa_boxes(a: np.ndarray, b: np.ndarray, fmt: str) -> np.ndarray:
    """Intersection over area-of-a (trackeval do_ioa=True)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    if fmt == "xywh":
        a = np.concatenate([a[:, :2], a[:, :2] + a[:, 2:4]], axis=1)
        b = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:4]], axis=1)
    iw = np.maximum(
        0, np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]))
    ih = np.maximum(
        0, np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = iw * ih
    area_a = np.maximum((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), EPS)
    return inter / area_a[:, None]


def _relabel(out: Dict, num_timesteps: int) -> Dict:
    """Contiguous id relabeling + overview stats (trackeval tail of every
    get_preprocessed_seq_data)."""
    uniq_gt, uniq_trk = set(), set()
    n_gt = n_trk = 0
    for t in range(num_timesteps):
        uniq_gt.update(np.asarray(out["gt_ids"][t]).tolist())
        uniq_trk.update(np.asarray(out["tracker_ids"][t]).tolist())
        n_gt += len(out["gt_ids"][t])
        n_trk += len(out["tracker_ids"][t])
    gmap = {v: i for i, v in enumerate(sorted(uniq_gt))}
    tmap = {v: i for i, v in enumerate(sorted(uniq_trk))}
    for t in range(num_timesteps):
        out["gt_ids"][t] = np.asarray(
            [gmap[v] for v in out["gt_ids"][t]], int)
        out["tracker_ids"][t] = np.asarray(
            [tmap[v] for v in out["tracker_ids"][t]], int)
    out.update(num_timesteps=num_timesteps, num_gt_ids=len(gmap),
               num_tracker_ids=len(tmap), num_gt_dets=n_gt,
               num_tracker_dets=n_trk)
    return out


# ---------------------------------------------------------------------------
# BDD100K (trackeval/datasets/bdd100k.py)
# ---------------------------------------------------------------------------

BDD_CLASSES = {
    "pedestrian": 1, "rider": 2, "other person": 3, "car": 4, "bus": 5,
    "truck": 6, "train": 7, "trailer": 8, "other vehicle": 9,
    "motorcycle": 10, "bicycle": 11,
}
BDD_EVAL_CLASSES = ["pedestrian", "rider", "car", "bus", "truck", "train",
                    "motorcycle", "bicycle"]
BDD_DISTRACTORS = ["other person", "trailer", "other vehicle"]
# reference super-category roll-up (bdd100k.py:60-62)
BDD_SUPER_CATEGORIES = {
    "HUMAN": ["pedestrian", "rider"],
    "VEHICLE": ["car", "truck", "bus", "train"],
    "BIKE": ["motorcycle", "bicycle"],
}


@dataclass
class BddRawSeq:
    seq: str
    num_timesteps: int
    gt_ids: List[np.ndarray]
    gt_dets: List[np.ndarray]           # x0y0x1y1
    gt_classes: List[np.ndarray]
    gt_crowd_ignore: List[np.ndarray]   # x0y0x1y1
    tracker_ids: List[np.ndarray]
    tracker_dets: List[np.ndarray]      # x0y0x1y1
    tracker_classes: List[np.ndarray]
    similarity: List[np.ndarray] = field(default_factory=list)


def _bdd_parse(path: str, is_gt: bool):
    """One BDD100K per-sequence json -> per-frame arrays
    (bdd100k.py:103-182: frames sorted by 'index'; gt labels of a
    distractor category or with the Crowd attribute become crowd-ignore
    regions)."""
    with open(path) as f:
        frames = sorted(json.load(f), key=lambda x: x["index"])
    ids, dets, classes, ignores = [], [], [], []
    for fr in frames:
        keep, ign = [], []
        for ann in fr.get("labels", []):
            if is_gt and (ann["category"] in BDD_DISTRACTORS
                          or ann.get("attributes", {}).get("Crowd")):
                ign.append(ann)
            else:
                keep.append(ann)
        def box(a):
            b = a["box2d"]
            return [b["x1"], b["y1"], b["x2"], b["y2"]]
        dets.append(np.asarray([box(a) for a in keep], float).reshape(-1, 4))
        ids.append(np.asarray([a["id"] for a in keep], float).astype(int))
        classes.append(np.asarray(
            [BDD_CLASSES[a["category"]] for a in keep], int))
        ignores.append(np.asarray(
            [box(a) for a in ign], float).reshape(-1, 4))
    return ids, dets, classes, ignores


def load_bdd100k_seq(seq: str, gt_path: str, result_path: str,
                     num_timesteps: int = 0) -> BddRawSeq:
    g_ids, g_dets, g_cls, g_ign = _bdd_parse(gt_path, True)
    t_ids, t_dets, t_cls, _ = _bdd_parse(result_path, False)
    n = len(g_ids)
    if len(t_ids) != n:
        raise ValueError(
            f"gt/tracker timestep mismatch for {seq}: {n} vs {len(t_ids)}")
    sim = [iou_xyxy_raw(g, t) for g, t in zip(g_dets, t_dets)]
    return BddRawSeq(seq=seq, num_timesteps=n, gt_ids=g_ids, gt_dets=g_dets,
                     gt_classes=g_cls, gt_crowd_ignore=g_ign,
                     tracker_ids=t_ids, tracker_dets=t_dets,
                     tracker_classes=t_cls, similarity=sim)


def preprocess_bdd100k(raw: BddRawSeq, cls: str) -> Dict:
    """bdd100k.py:185-297: class masks both sides, Hungarian match at
    0.5, unmatched tracker dets >50% inside a crowd-ignore region
    removed; no gt removal."""
    cls_id = BDD_CLASSES[cls]
    out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
           "tracker_dets": [], "similarity_scores": []}
    for t in range(raw.num_timesteps):
        gm = raw.gt_classes[t] == cls_id
        tm = raw.tracker_classes[t] == cls_id
        gt_ids, gt_dets = raw.gt_ids[t][gm], raw.gt_dets[t][gm]
        trk_ids, trk_dets = raw.tracker_ids[t][tm], raw.tracker_dets[t][tm]
        sim = raw.similarity[t][gm][:, tm]

        unmatched = np.arange(len(trk_ids))
        if len(gt_ids) and len(trk_ids):
            scores = sim.copy()
            scores[scores < 0.5 - EPS] = 0
            rows, cols = linear_sum_assignment(-scores)
            ok = scores[rows, cols] > EPS
            unmatched = np.delete(unmatched, cols[ok], axis=0)
        ioa = ioa_boxes(trk_dets[unmatched], raw.gt_crowd_ignore[t],
                        fmt="x0y0x1y1")
        in_crowd = np.any(ioa > 0.5 + EPS, axis=1)
        to_remove = unmatched[in_crowd]

        out["tracker_ids"].append(np.delete(trk_ids, to_remove, axis=0))
        out["tracker_dets"].append(np.delete(trk_dets, to_remove, axis=0))
        out["similarity_scores"].append(np.delete(sim, to_remove, axis=1))
        out["gt_ids"].append(gt_ids)
        out["gt_dets"].append(gt_dets)
    out = _relabel(out, raw.num_timesteps)
    out.update(seq=raw.seq, cls=cls)
    return out


# ---------------------------------------------------------------------------
# Head Tracking Challenge (trackeval/datasets/head_tracking_challenge.py,
# benchmark 'HT')
# ---------------------------------------------------------------------------

HT_CLASSES = {"pedestrian": 1, "static": 2, "ignore": 3,
              "person_on_vehicle": 4}
HT_DISTRACTORS = ["static", "ignore", "person_on_vehicle"]


@dataclass
class HtRawSeq:
    seq: str
    num_timesteps: int
    gt_ids: List[np.ndarray]
    gt_dets: List[np.ndarray]           # tlwh
    gt_classes: List[np.ndarray]
    gt_zero_marked: List[np.ndarray]
    gt_conf: List[np.ndarray]
    gt_visibility: List[np.ndarray]
    tracker_ids: List[np.ndarray]
    tracker_dets: List[np.ndarray]      # tlwh
    tracker_confidences: List[np.ndarray]
    similarity: List[np.ndarray] = field(default_factory=list)


def _read_ht_gt(path: str, num_timesteps: int):
    """HT gt rows: frame,id,x,y,w,h,conf,class,visibility
    (head_tracking_challenge.py:225-266: zero_marked=int(col6),
    gt_conf=float(col6), visibility=col8)."""
    per_frame: Dict[int, List[List[float]]] = {}
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                parts = line.replace(";", ",").split(",")
                if len(parts) < 9:
                    parts = line.split()
                if len(parts) < 9:
                    continue
                row = [float(x) for x in parts[:9]]
                per_frame.setdefault(int(row[0]), []).append(row)
    ids, dets, classes, zero, conf, vis = [], [], [], [], [], []
    for t in range(1, num_timesteps + 1):
        rows = np.asarray(per_frame.get(t, []), np.float64).reshape(-1, 9)
        ids.append(rows[:, 1].astype(int))
        dets.append(rows[:, 2:6])
        zero.append(rows[:, 6].astype(int))
        conf.append(rows[:, 6].astype(float))
        classes.append(rows[:, 7].astype(int))
        vis.append(rows[:, 8].astype(float))
    return ids, dets, classes, zero, conf, vis


def load_ht_seq(seq: str, gt_path: str, result_path: str,
                num_timesteps: int) -> HtRawSeq:
    g_ids, g_dets, g_cls, g_zero, g_conf, g_vis = _read_ht_gt(
        gt_path, num_timesteps)
    mot = load_raw_seq(seq, os.devnull, result_path, num_timesteps)
    sim = [iou_tlwh(g, t) for g, t in zip(g_dets, mot.tracker_dets)]
    return HtRawSeq(
        seq=seq, num_timesteps=num_timesteps, gt_ids=g_ids, gt_dets=g_dets,
        gt_classes=g_cls, gt_zero_marked=g_zero, gt_conf=g_conf,
        gt_visibility=g_vis, tracker_ids=mot.tracker_ids,
        tracker_dets=mot.tracker_dets,
        tracker_confidences=mot.tracker_confidences, similarity=sim)


def preprocess_ht(raw: HtRawSeq, cls: str = "pedestrian") -> Dict:
    """head_tracking_challenge.py:294-442: Hungarian match at 0.4;
    tracker dets matched to non-pedestrian OR invisible gt removed
    (the reference's 3-arg np.logical_or uses its third argument as the
    `out` buffer, so the low-confidence term does NOT join the OR —
    reproduced bug-for-bug); gt kept iff zero_marked!=0 & class==cls &
    visibility>0 & conf>0."""
    cls_id = HT_CLASSES[cls]
    out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
           "tracker_dets": [], "tracker_confidences": [],
           "similarity_scores": []}
    for t in range(raw.num_timesteps):
        gt_ids, gt_dets = raw.gt_ids[t], raw.gt_dets[t]
        gt_classes, vis = raw.gt_classes[t], raw.gt_visibility[t]
        gt_conf, zero = raw.gt_conf[t], raw.gt_zero_marked[t]
        trk_ids, trk_dets = raw.tracker_ids[t], raw.tracker_dets[t]
        trk_conf = raw.tracker_confidences[t]
        sim = raw.similarity[t]

        to_remove = np.array([], int)
        if len(gt_ids) and len(trk_ids):
            scores = sim.copy()
            scores[scores < 0.4 - EPS] = 0
            rows, cols = linear_sum_assignment(-scores)
            ok = scores[rows, cols] > EPS
            rows, cols = rows[ok], cols[ok]
            is_distractor = np.logical_not(np.isin(gt_classes[rows], cls_id))
            is_invisible = vis[rows] < EPS
            to_remove = cols[is_invisible | is_distractor]

        out["tracker_ids"].append(np.delete(trk_ids, to_remove, axis=0))
        out["tracker_dets"].append(np.delete(trk_dets, to_remove, axis=0))
        out["tracker_confidences"].append(
            np.delete(trk_conf, to_remove, axis=0))
        sim = np.delete(sim, to_remove, axis=1)

        keep = (zero != 0) & (gt_classes == cls_id) & (vis > 0.0) \
            & (gt_conf > 0.0)
        out["gt_ids"].append(gt_ids[keep])
        out["gt_dets"].append(gt_dets[keep])
        out["similarity_scores"].append(sim[keep])
    out = _relabel(out, raw.num_timesteps)
    out.update(seq=raw.seq, cls=cls)
    return out


# ---------------------------------------------------------------------------
# PersonPath22 (trackeval/datasets/person_path_22.py)
# ---------------------------------------------------------------------------

PP22_DISTRACTORS = ["person_on_vehicle", "static_person", "distractor",
                    "reflection"]


@dataclass
class Pp22RawSeq:
    seq: str
    num_timesteps: int
    gt_ids: List[np.ndarray]
    gt_dets: List[np.ndarray]           # tlwh
    gt_classes: List[np.ndarray]
    gt_zero_marked: List[np.ndarray]
    gt_crowd_ignore: List[np.ndarray]   # tlwh
    tracker_ids: List[np.ndarray]
    tracker_dets: List[np.ndarray]
    tracker_confidences: List[np.ndarray]
    similarity: List[np.ndarray] = field(default_factory=list)


def load_personpath_seq(seq: str, gt_path: str, result_path: str,
                        num_timesteps: int) -> Pp22RawSeq:
    """person_path_22.py:174-290: MOT txt where gt rows of class 13
    (crowd) split off as crowd-ignore regions."""
    per_frame: Dict[int, List[List[float]]] = {}
    ign_frame: Dict[int, List[List[float]]] = {}
    if os.path.isfile(gt_path):
        with open(gt_path) as f:
            for line in f:
                parts = line.replace(";", ",").split(",")
                if len(parts) < 8:
                    parts = line.split()
                if len(parts) < 8:
                    continue
                row = [float(x) for x in parts[:9]] \
                    + [0.0] * max(0, 9 - len(parts))
                dst = (ign_frame if int(row[7]) == 13 else per_frame)
                dst.setdefault(int(row[0]), []).append(row)
    g_ids, g_dets, g_cls, g_zero, g_ign = [], [], [], [], []
    for t in range(1, num_timesteps + 1):
        rows = np.asarray(per_frame.get(t, []), np.float64).reshape(-1, 9)
        g_ids.append(rows[:, 1].astype(int))
        g_dets.append(rows[:, 2:6])
        g_cls.append(rows[:, 7].astype(int))
        g_zero.append(rows[:, 6].astype(int))
        irows = np.asarray(ign_frame.get(t, []), np.float64).reshape(-1, 9)
        g_ign.append(irows[:, 2:6])
    mot = load_raw_seq(seq, os.devnull, result_path, num_timesteps)
    sim = [iou_tlwh(g, t) for g, t in zip(g_dets, mot.tracker_dets)]
    return Pp22RawSeq(
        seq=seq, num_timesteps=num_timesteps, gt_ids=g_ids, gt_dets=g_dets,
        gt_classes=g_cls, gt_zero_marked=g_zero, gt_crowd_ignore=g_ign,
        tracker_ids=mot.tracker_ids, tracker_dets=mot.tracker_dets,
        tracker_confidences=mot.tracker_confidences, similarity=sim)


def preprocess_personpath(raw: Pp22RawSeq, cls: str = "pedestrian") -> Dict:
    """person_path_22.py:293-448: Hungarian at 0.5, distractor-matched
    tracker dets removed, plus ANY tracker det >95% inside a crowd-ignore
    region (not just unmatched ones); gt kept iff zero_marked!=0 &
    class==pedestrian."""
    cls_id = MOT_CLASSES[cls]
    distractors = [MOT_CLASSES[d] for d in PP22_DISTRACTORS]
    out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
           "tracker_dets": [], "tracker_confidences": [],
           "similarity_scores": []}
    for t in range(raw.num_timesteps):
        gt_ids, gt_dets = raw.gt_ids[t], raw.gt_dets[t]
        gt_classes, zero = raw.gt_classes[t], raw.gt_zero_marked[t]
        ignore = raw.gt_crowd_ignore[t]
        trk_ids, trk_dets = raw.tracker_ids[t], raw.tracker_dets[t]
        trk_conf = raw.tracker_confidences[t]
        sim = raw.similarity[t]

        to_remove = np.array([], int)
        if (len(gt_ids) or len(ignore)) and len(trk_ids):
            scores = sim.copy()
            scores[scores < 0.5 - EPS] = 0
            rows, cols = linear_sum_assignment(-scores)
            ok = scores[rows, cols] > EPS
            rows, cols = rows[ok], cols[ok]
            is_distractor = np.isin(gt_classes[rows], distractors)
            to_remove = cols[is_distractor]
            ioa = ioa_boxes(trk_dets, ignore, fmt="xywh")
            in_crowd = np.any(ioa > 0.95 + EPS, axis=1)
            to_remove = np.unique(np.concatenate(
                [to_remove, np.where(in_crowd)[0]]))

        out["tracker_ids"].append(np.delete(trk_ids, to_remove, axis=0))
        out["tracker_dets"].append(np.delete(trk_dets, to_remove, axis=0))
        out["tracker_confidences"].append(
            np.delete(trk_conf, to_remove, axis=0))
        sim = np.delete(sim, to_remove, axis=1)

        keep = (zero != 0) & (gt_classes == cls_id)
        out["gt_ids"].append(gt_ids[keep])
        out["gt_dets"].append(gt_dets[keep])
        out["similarity_scores"].append(sim[keep])
    out = _relabel(out, raw.num_timesteps)
    out.update(seq=raw.seq, cls=cls)
    return out


# ---------------------------------------------------------------------------
# MOTS Challenge / KITTI MOTS (trackeval/datasets/{mots_challenge,
# kitti_mots}.py) — mask tracking on COCO-RLE annotations
# ---------------------------------------------------------------------------

MOTS_CLASSES = {"pedestrian": 2, "ignore": 10}
KITTI_MOTS_CLASSES = {"car": 1, "pedestrian": 2, "ignore": 10}


@dataclass
class MotsRawSeq:
    seq: str
    num_timesteps: int
    gt_ids: List[np.ndarray]
    gt_classes: List[np.ndarray]
    gt_dets: List[list]                # list of RLE dicts per timestep
    gt_ignore_region: List[dict]       # one merged RLE per timestep
    tracker_ids: List[np.ndarray]
    tracker_classes: List[np.ndarray]
    tracker_dets: List[list]
    similarity: List[np.ndarray] = field(default_factory=list)


def _read_mots_txt(path: str, num_timesteps: int, is_gt: bool,
                   frame_base: int = 1):
    """MOTS txt rows: `frame id class h w rle` (space-separated,
    mots_challenge.py:228-246); gt rows of class 10 split off as
    crowd-ignore masks. MOTS Challenge frames are 1-based, KITTI MOTS
    0-based (kitti_mots.py:200)."""
    from . import rle as RL

    per_frame: Dict[int, list] = {}
    ign_frame: Dict[int, list] = {}
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 6:
                    continue
                dst = (ign_frame if is_gt and parts[2] == "10"
                       else per_frame)
                dst.setdefault(int(parts[0]), []).append(parts)
    ids, classes, dets, ignores = [], [], [], []
    for t in range(frame_base, num_timesteps + frame_base):
        rows = per_frame.get(t, [])
        ids.append(np.asarray([int(r[1]) for r in rows], int))
        classes.append(np.asarray([int(r[2]) for r in rows], int))
        dets.append([{"size": [int(r[3]), int(r[4])],
                      "counts": r[5].encode("utf-8")} for r in rows])
        irows = ign_frame.get(t, [])
        ignores.append(RL.merge(
            [{"size": [int(r[3]), int(r[4])],
              "counts": r[5].encode("utf-8")} for r in irows],
            intersect=False))
    return ids, classes, dets, ignores


def load_mots_seq(seq: str, gt_path: str, result_path: str,
                  num_timesteps: int, frame_base: int = 1) -> MotsRawSeq:
    from . import rle as RL

    g_ids, g_cls, g_dets, g_ign = _read_mots_txt(
        gt_path, num_timesteps, True, frame_base)
    t_ids, t_cls, t_dets, _ = _read_mots_txt(
        result_path, num_timesteps, False, frame_base)
    sim = [RL.iou(g, t, [False] * len(t)) if len(g) and len(t)
           else np.zeros((len(g), len(t)))
           for g, t in zip(g_dets, t_dets)]
    return MotsRawSeq(
        seq=seq, num_timesteps=num_timesteps, gt_ids=g_ids,
        gt_classes=g_cls, gt_dets=g_dets, gt_ignore_region=g_ign,
        tracker_ids=t_ids, tracker_classes=t_cls, tracker_dets=t_dets,
        similarity=sim)


def preprocess_mots(raw: MotsRawSeq, cls: str = "pedestrian",
                    class_map: Dict[str, int] = MOTS_CLASSES) -> Dict:
    """mots_challenge.py:299-404 / kitti_mots.py same flow: class masks
    both sides, Hungarian at 0.5 (sub-threshold scores set to -10000),
    unmatched tracker masks >50% inside the merged ignore region
    removed; all gt kept."""
    from . import rle as RL

    cls_id = class_map[cls]
    out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
           "tracker_dets": [], "similarity_scores": []}
    for t in range(raw.num_timesteps):
        gm = raw.gt_classes[t] == cls_id
        tm = raw.tracker_classes[t] == cls_id
        gt_ids = raw.gt_ids[t][gm]
        gt_dets = [d for d, m in zip(raw.gt_dets[t], gm) if m]
        trk_ids = raw.tracker_ids[t][tm]
        trk_dets = [d for d, m in zip(raw.tracker_dets[t], tm) if m]
        sim = raw.similarity[t][gm][:, tm]

        unmatched = np.arange(len(trk_ids))
        if len(gt_ids) and len(trk_ids):
            scores = sim.copy()
            scores[scores < 0.5 - EPS] = -10000
            rows, cols = linear_sum_assignment(-scores)
            ok = scores[rows, cols] > EPS
            unmatched = np.delete(unmatched, cols[ok], axis=0)
        um_dets = [trk_dets[i] for i in unmatched]
        ioa = RL.iou(um_dets, [raw.gt_ignore_region[t]], [True]) \
            if um_dets else np.zeros((0, 1))
        in_ignore = np.any(ioa > 0.5 + EPS, axis=1)
        to_remove = unmatched[in_ignore]

        out["tracker_ids"].append(np.delete(trk_ids, to_remove, axis=0))
        out["tracker_dets"].append(
            [d for i, d in enumerate(trk_dets) if i not in set(to_remove)])
        out["similarity_scores"].append(np.delete(sim, to_remove, axis=1))
        out["gt_ids"].append(gt_ids)
        out["gt_dets"].append(gt_dets)
    out = _relabel(out, raw.num_timesteps)
    out.update(seq=raw.seq, cls=cls)
    return out


def load_kitti_mots_seq(seq: str, gt_path: str, result_path: str,
                        num_timesteps: int) -> MotsRawSeq:
    return load_mots_seq(seq, gt_path, result_path, num_timesteps,
                         frame_base=0)


def preprocess_kitti_mots(raw: MotsRawSeq, cls: str) -> Dict:
    return preprocess_mots(raw, cls, class_map=KITTI_MOTS_CLASSES)


# ---------------------------------------------------------------------------
# DAVIS unsupervised (trackeval/datasets/davis.py) — per-frame indexed
# PNGs, void-pixel handling, J&F-ready dense masks
# ---------------------------------------------------------------------------


@dataclass
class DavisRawSeq:
    seq: str
    num_timesteps: int
    mask_shape: tuple
    num_gt_ids: int
    num_tracker_ids: int
    gt_ids: List[np.ndarray]
    gt_dets: List[list]                # RLE dicts
    masks_void: List[dict]             # RLE per timestep
    tracker_ids: List[np.ndarray]
    tracker_dets: List[list]
    similarity: List[np.ndarray] = field(default_factory=list)


def _davis_frames(seq_dir: str):
    from PIL import Image

    out = []
    for name in sorted(os.listdir(seq_dir)):
        out.append(np.array(Image.open(os.path.join(seq_dir, name))))
    return out


def load_davis_seq(seq: str, gt_dir: str, result_dir: str,
                   num_timesteps: int = 0) -> DavisRawSeq:
    """davis.py:108-175: ids are the nonzero pixel values of each
    indexed PNG; gt pixels of value 255 form the void mask (zeroed in
    the id frame). Similarity is mask IoU on the RAW (un-voided)
    tracker masks — the reference computes it before the void zeroing."""
    from . import rle as RL

    g_frames = _davis_frames(gt_dir)
    t_frames = _davis_frames(result_dir)
    n = len(g_frames)
    if num_timesteps and num_timesteps != n:
        raise ValueError(f"{seq}: {n} gt frames != {num_timesteps}")
    if len(t_frames) != n:
        raise ValueError(
            f"{seq}: tracker frames {len(t_frames)} != gt {n}")

    def split(frame):
        ids = np.unique(frame)
        ids = ids[ids != 0]
        dets = [RL.encode((frame == v).astype(np.uint8)) for v in ids]
        return ids.astype(int), dets

    gt_ids, gt_dets, voids = [], [], []
    g_all, t_all = [], []
    for fr in g_frames:
        fr = fr.copy()
        void = fr == 255
        fr[void] = 0
        voids.append(RL.encode(void.astype(np.uint8)))
        ids, dets = split(fr)
        gt_ids.append(ids)
        gt_dets.append(dets)
        g_all += list(ids)
    trk_ids, trk_dets = [], []
    for fr in t_frames:
        ids, dets = split(fr)
        trk_ids.append(ids)
        trk_dets.append(dets)
        t_all += list(ids)
    sim = [RL.iou(g, t, [False] * len(t)) if len(g) and len(t)
           else np.zeros((len(g), len(t)))
           for g, t in zip(gt_dets, trk_dets)]
    return DavisRawSeq(
        seq=seq, num_timesteps=n, mask_shape=g_frames[0].shape,
        num_gt_ids=len(np.unique(g_all)),
        num_tracker_ids=len(np.unique(t_all)),
        gt_ids=gt_ids, gt_dets=gt_dets, masks_void=voids,
        tracker_ids=trk_ids, tracker_dets=trk_dets, similarity=sim)


def preprocess_davis(raw: DavisRawSeq, cls: str = "general",
                     dense: bool = False) -> Dict:
    """davis.py:186-272: no class split, no det removal; tracker-mask
    pixels inside the gt void mask are zeroed (similarity stays the raw
    pre-voiding IoU, as in the reference); contiguous relabel. With
    dense=True dets decode to (H, W) arrays, the form eval.metrics.jandf
    consumes."""
    from . import rle as RL

    out = {"gt_ids": [list(x) for x in raw.gt_ids],
           "tracker_ids": [list(x) for x in raw.tracker_ids],
           "gt_dets": [list(x) for x in raw.gt_dets],
           "tracker_dets": [], "similarity_scores": raw.similarity}
    for t in range(raw.num_timesteps):
        dets = list(raw.tracker_dets[t])
        void = raw.masks_void[t]
        if RL.area(void) > 0 and dets:
            ious = RL.iou(dets, [void], [False])
            vm = RL.decode(void).astype(bool)
            for r in np.where(ious[:, 0] > 0)[0]:
                m = RL.decode(dets[r])
                m[vm] = 0
                dets[r] = RL.encode(np.asarray(m, order="F"))
        out["tracker_dets"].append(dets)
    out = _relabel(out, raw.num_timesteps)
    if dense:
        out["gt_dets"] = [[RL.decode(d) for d in dts]
                          for dts in out["gt_dets"]]
        out["tracker_dets"] = [[RL.decode(d) for d in dts]
                               for dts in out["tracker_dets"]]
    out.update(seq=raw.seq, cls=cls, mask_shape=raw.mask_shape)
    return out


# ---------------------------------------------------------------------------
# TAO (trackeval/datasets/tao.py) — dataset-level jsons, per-class eval
# with negative / not-exhaustively-labeled category handling, TrackMAP
# track representations
# ---------------------------------------------------------------------------


class TaoData:
    """Parsed TAO gt + one tracker result json (tao.py:35-133).

    The gt json carries videos/images/annotations/tracks/categories;
    the tracker json is a flat annotation list. Construction applies the
    reference's normalization chain: category merging, per-image
    detection cap (300), missing-video-id fill, cross-video track-id
    uniquification."""

    def __init__(self, gt_json, tracker_json,
                 max_detections: int = 300):
        if isinstance(gt_json, str):
            with open(gt_json) as f:
                self.gt = json.load(f)
        else:
            self.gt = gt_json
        self.gt = self._filter_gt(self.gt)   # TAO-OW subset hook
        merge_map = {}
        for cat in self.gt["categories"]:
            for sub in cat.get("merged", []):
                merge_map[sub["id"]] = cat["id"]

        def merge_cats(anns):
            for a in anns:
                a["category_id"] = merge_map.get(
                    a["category_id"], a["category_id"])

        merge_cats(self.gt["annotations"])
        merge_cats(self.gt["tracks"])

        self.images = {im["id"]: im for im in self.gt["images"]}
        self.seq_ids = {v["name"].replace("/", "-"): v["id"]
                        for v in self.gt["videos"]}
        self.seq_lengths = {v["id"]: 0 for v in self.gt["videos"]}
        for im in self.gt["images"]:
            self.seq_lengths[im["video_id"]] += 1

        self.gt_tracks, self.gt_images = self._vid_mappings(
            self.gt["annotations"])
        # image -> timestep: gt-annotated images sorted by frame_index
        self.img_to_t = {}
        for vid in self.seq_ids.values():
            imgs = sorted((im["id"] for im in self.gt_images[vid]),
                          key=lambda i: self.images[i]["frame_index"])
            self.img_to_t[vid] = {img: i for i, img in enumerate(imgs)}
        self.seq_classes = {
            v["id"]: {
                "pos": sorted({t["category_id"]
                               for t in self.gt_tracks[v["id"]]}),
                "neg": v.get("neg_category_ids", []),
                "not_exhaustive": v.get("not_exhaustive_category_ids", []),
            } for v in self.gt["videos"]}
        self.class_name_to_id = {c["name"]: c["id"]
                                 for c in self.gt["categories"]}
        seen = {c for v in self.gt["videos"]
                for c in self.seq_classes[v["id"]]["pos"]}
        # only classes with ground truth are evaluated (tao.py:82-84)
        self.eval_classes = [c["name"] for c in self.gt["categories"]
                             if c["id"] in seen]

        if isinstance(tracker_json, str):
            with open(tracker_json) as f:
                trk = json.load(f)
        else:
            trk = tracker_json
        if max_detections:
            by_img: Dict[int, list] = {}
            for a in trk:
                by_img.setdefault(a["image_id"], []).append(a)
            trk = []
            for anns in by_img.values():
                if len(anns) > max_detections:
                    anns = sorted(anns, key=lambda x: x["score"],
                                  reverse=True)[:max_detections]
                trk.extend(anns)
        img_to_vid = {im["id"]: im["video_id"] for im in self.gt["images"]}
        for a in trk:
            if "video_id" not in a:
                a["video_id"] = img_to_vid[a["image_id"]]
        merge_cats(trk)
        self._uniquify_track_ids(trk)
        self.trk_tracks, self.trk_images = self._vid_mappings(trk)

    def _filter_gt(self, gt):
        return gt

    def _ann_area(self, a):
        return a["bbox"][2] * a["bbox"][3]

    @staticmethod
    def _uniquify_track_ids(anns):
        """tao.py:538-561: a track id reused across videos gets fresh
        ids per (track, video) pair."""
        first_vid, clashing = {}, set()
        max_id = 0
        for a in anns:
            t = a["track_id"]
            first_vid.setdefault(t, a["video_id"])
            if a["video_id"] != first_vid[t]:
                clashing.add(t)
            max_id = max(max_id, t)
        if clashing:
            fresh = iter(range(max_id + 1, max_id + 1 + 10 ** 9))
            remap: Dict[tuple, int] = {}
            for a in anns:
                t = a["track_id"]
                if t in clashing:
                    key = (t, a["video_id"])
                    if key not in remap:
                        remap[key] = next(fresh)
                    a["track_id"] = remap[key]

    def _vid_mappings(self, anns):
        vids_to_tracks: Dict[int, list] = {v: [] for v in
                                           self.seq_lengths}
        vids_to_imgs: Dict[int, list] = {v: [] for v in self.seq_lengths}
        track_index: Dict[tuple, dict] = {}
        img_index: Dict[tuple, dict] = {}
        for a in anns:
            a["area"] = self._ann_area(a)
            vid = a["video_id"]
            tkey = (vid, a["track_id"])
            if tkey not in track_index:
                track_index[tkey] = {"id": a["track_id"],
                                     "category_id": a["category_id"],
                                     "video_id": vid, "annotations": []}
                vids_to_tracks[vid].append(track_index[tkey])
            track_index[tkey]["annotations"].append(a)
            ikey = (vid, a["image_id"])
            if ikey not in img_index:
                img_index[ikey] = {"id": a["image_id"], "annotations": []}
                vids_to_imgs[vid].append(img_index[ikey])
            img_index[ikey]["annotations"].append(a)
        for tracks in vids_to_tracks.values():
            for tr in tracks:
                tr["annotations"].sort(
                    key=lambda x: self.images[x["image_id"]]["frame_index"])
                tr["area"] = (sum(x["area"] for x in tr["annotations"])
                              / len(tr["annotations"]))
        return vids_to_tracks, vids_to_imgs


_TAO_CACHE: Dict[tuple, TaoData] = {}


def _tao_data(gt_json: str, tracker_json: str) -> TaoData:
    key = (os.path.abspath(gt_json), os.path.abspath(tracker_json))
    if key not in _TAO_CACHE:
        if len(_TAO_CACHE) > 4:
            _TAO_CACHE.clear()
        _TAO_CACHE[key] = TaoData(*key)
    return _TAO_CACHE[key]


def load_tao_seq(seq: str, gt_json: str, tracker_json: str,
                 num_timesteps: int = 0) -> Dict:
    """tao.py:142-257 _load_raw_file for both sides + similarity."""
    data = _tao_data(gt_json, tracker_json)
    vid = data.seq_ids[seq]
    T = data.seq_lengths[vid]
    img_to_t = data.img_to_t[vid]

    def frames(images, with_conf):
        ids = [np.empty(0, int)] * T
        cls = [np.empty(0, int)] * T
        dets = [np.empty((0, 4))] * T
        conf = [np.empty(0)] * T
        for img in images:
            t = img_to_t.get(img["id"])
            if t is None:   # tracker-only images are ignored
                continue
            anns = img["annotations"]
            dets[t] = np.atleast_2d(
                [a["bbox"] for a in anns]).astype(float)
            ids[t] = np.atleast_1d(
                [a["track_id"] for a in anns]).astype(int)
            cls[t] = np.atleast_1d(
                [a["category_id"] for a in anns]).astype(int)
            if with_conf:
                conf[t] = np.atleast_1d(
                    [a["score"] for a in anns]).astype(float)
        return ids, cls, dets, conf

    g_ids, g_cls, g_dets, _ = frames(data.gt_images[vid], False)
    t_ids, t_cls, t_dets, t_conf = frames(data.trk_images[vid], True)
    sim = [iou_tlwh(g, t) for g, t in zip(g_dets, t_dets)]

    all_cls = sorted(data.class_name_to_id.values())
    sc = data.seq_classes[vid]

    def tracks_by_class(all_tracks, considered):
        return {c: [tr for tr in all_tracks if tr["category_id"] == c]
                if c in considered else [] for c in all_cls}

    gt_by_cls = tracks_by_class(data.gt_tracks[vid], all_cls)
    dt_by_cls = tracks_by_class(
        data.trk_tracks[vid], sc["pos"] + sc["neg"])

    def track_repr(by_cls, with_scores):
        out = {
            "tracks": {c: [{a["image_id"]: np.atleast_1d(a["bbox"])
                            for a in tr["annotations"]} for tr in trs]
                       for c, trs in by_cls.items()},
            "ids": {c: [tr["id"] for tr in trs]
                    for c, trs in by_cls.items()},
            "areas": {c: [tr["area"] for tr in trs]
                      for c, trs in by_cls.items()},
            "lengths": {c: [len(tr["annotations"]) for tr in trs]
                        for c, trs in by_cls.items()},
        }
        if with_scores:
            out["scores"] = {
                c: np.array([np.mean([float(a["score"])
                                      for a in tr["annotations"]])
                             for tr in trs])
                for c, trs in by_cls.items()}
        return out

    return {
        "seq": seq, "num_timesteps": T,
        "gt_ids": g_ids, "gt_classes": g_cls, "gt_dets": g_dets,
        "tracker_ids": t_ids, "tracker_classes": t_cls,
        "tracker_dets": t_dets, "tracker_confidences": t_conf,
        "similarity": sim,
        "neg_cat_ids": sc["neg"],
        "not_exhaustive": sc["not_exhaustive"],
        "gt_track_repr": track_repr(gt_by_cls, False),
        "dt_track_repr": track_repr(dt_by_cls, True),
        "class_name_to_id": data.class_name_to_id,
    }


def preprocess_tao(raw: Dict, cls: str) -> Dict:
    """tao.py:259-399: class masks both sides; Hungarian at 0.5; ALL
    unmatched tracker dets removed when the frame has no gt of the class
    (unless the class is sequence-negative) or the class is not
    exhaustively labeled; no gt removal. Track representations sorted by
    descending mean score for TrackMAP."""
    cls_id = raw["class_name_to_id"][cls]
    not_exh = cls_id in raw["not_exhaustive"]
    is_neg = cls_id in raw["neg_cat_ids"]
    T = raw["num_timesteps"]
    out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
           "tracker_dets": [], "tracker_confidences": [],
           "similarity_scores": []}
    for t in range(T):
        gm = raw["gt_classes"][t] == cls_id
        tm = raw["tracker_classes"][t] == cls_id
        gt_ids, gt_dets = raw["gt_ids"][t][gm], raw["gt_dets"][t][gm]
        trk_ids = raw["tracker_ids"][t][tm]
        trk_dets = raw["tracker_dets"][t][tm]
        trk_conf = raw["tracker_confidences"][t][tm]
        sim = raw["similarity"][t][gm][:, tm]

        unmatched = np.arange(len(trk_ids))
        if len(gt_ids) and len(trk_ids):
            scores = sim.copy()
            scores[scores < 0.5 - EPS] = 0
            rows, cols = linear_sum_assignment(-scores)
            ok = scores[rows, cols] > EPS
            unmatched = np.delete(unmatched, cols[ok], axis=0)
        if len(gt_ids) == 0 and not is_neg:
            to_remove = unmatched
        elif not_exh:
            to_remove = unmatched
        else:
            to_remove = np.array([], int)

        out["tracker_ids"].append(np.delete(trk_ids, to_remove, axis=0))
        out["tracker_dets"].append(np.delete(trk_dets, to_remove, axis=0))
        out["tracker_confidences"].append(
            np.delete(trk_conf, to_remove, axis=0))
        out["similarity_scores"].append(np.delete(sim, to_remove, axis=1))
        out["gt_ids"].append(gt_ids)
        out["gt_dets"].append(gt_dets)
    out = _relabel(out, T)

    g, d = raw["gt_track_repr"], raw["dt_track_repr"]
    out.update(
        gt_tracks=g["tracks"][cls_id], gt_track_ids=g["ids"][cls_id],
        gt_track_lengths=g["lengths"][cls_id],
        gt_track_areas=g["areas"][cls_id],
        dt_tracks=list(d["tracks"][cls_id]),
        dt_track_ids=list(d["ids"][cls_id]),
        dt_track_lengths=list(d["lengths"][cls_id]),
        dt_track_areas=list(d["areas"][cls_id]),
        dt_track_scores=list(d["scores"][cls_id]),
        not_exhaustively_labeled=not_exh, iou_type="bbox",
        seq=raw["seq"], cls=cls,
    )
    if out["dt_tracks"]:
        idx = np.argsort([-s for s in out["dt_track_scores"]],
                         kind="mergesort")
        for k in ("dt_track_scores", "dt_tracks", "dt_track_ids",
                  "dt_track_lengths", "dt_track_areas"):
            out[k] = [out[k][i] for i in idx]
    return out


# ---------------------------------------------------------------------------
# TAO-OW (trackeval/datasets/tao_ow.py) — open-world TAO: gt filtered to
# a known/distractor/unknown category subset, then evaluated
# class-agnostically as a single "object" class
# ---------------------------------------------------------------------------

# category-id splits from "Opening up Open-World Tracking" (tao_ow.py:
# 583-596); unknowns = everything else below id 2000
TAO_OW_KNOWNS = frozenset({
    4, 13, 1038, 544, 1057, 34, 35, 36, 41, 45, 58, 60, 579, 1091, 1097,
    1099, 78, 79, 81, 91, 1115, 1117, 95, 1122, 99, 1132, 621, 1135, 625,
    118, 1144, 126, 642, 1155, 133, 1162, 139, 154, 174, 185, 699, 1215,
    714, 717, 1229, 211, 729, 221, 229, 747, 235, 237, 779, 276, 805, 299,
    829, 852, 347, 371, 382, 896, 392, 926, 937, 428, 429, 961, 452, 979,
    980, 982, 475, 480, 993, 1001, 502, 1018})
TAO_OW_DISTRACTORS = frozenset({
    20, 63, 108, 180, 188, 204, 212, 247, 303, 403, 407, 415, 490, 504,
    507, 513, 529, 567, 569, 588, 672, 691, 702, 708, 711, 720, 736, 737,
    798, 813, 815, 827, 831, 851, 877, 883, 912, 971, 976, 1130, 1133,
    1134, 1169, 1184, 1220})


def _tao_ow_subset_ids(subset: str):
    if subset == "known":
        return TAO_OW_KNOWNS
    if subset == "distractor":
        return TAO_OW_DISTRACTORS
    if subset == "unknown":
        return frozenset(range(1, 2000)) - TAO_OW_KNOWNS \
            - TAO_OW_DISTRACTORS
    raise ValueError(f"bad TAO-OW subset {subset!r}")


class TaoOwData(TaoData):
    """TAO json pair filtered to one open-world subset, with every
    category collapsed to the class-agnostic "object" id 1
    (tao_ow.py:55-120, 196-198)."""

    def __init__(self, gt_json: str, tracker_json: str, subset: str,
                 max_detections: int = 300):
        self._subset = subset
        super().__init__(gt_json, tracker_json, max_detections)
        self.class_name_to_id = {"object": 1}
        self.eval_classes = ["object"]

    def _filter_gt(self, gt):
        if self._subset == "all":
            return gt
        valid = _tao_ow_subset_ids(self._subset)
        gt["annotations"] = [a for a in gt["annotations"]
                             if a["category_id"] in valid]
        gt["tracks"] = [t for t in gt["tracks"]
                        if t["category_id"] in valid]
        gt["categories"] = [c for c in gt["categories"]
                            if c["id"] in valid]
        return gt


def load_tao_ow_seq(seq: str, gt_json: str, tracker_json: str,
                    num_timesteps: int = 0, subset: str = "known") -> Dict:
    """TAO-OW raw load: the TAO flow on the subset-filtered gt, with all
    per-frame classes forced to 1 and all tracks pooled under the
    "object" class (tao_ow.py:152-270)."""
    key = (os.path.abspath(gt_json), os.path.abspath(tracker_json),
           subset)
    if key not in _TAO_CACHE:
        if len(_TAO_CACHE) > 4:
            _TAO_CACHE.clear()
        _TAO_CACHE[key] = TaoOwData(gt_json, tracker_json, subset)
    data = _TAO_CACHE[key]
    vid = data.seq_ids[seq]
    T = data.seq_lengths[vid]
    img_to_t = data.img_to_t[vid]

    def frames(images, with_conf):
        ids = [np.empty(0, int)] * T
        cls = [np.empty(0, int)] * T
        dets = [np.empty((0, 4))] * T
        conf = [np.empty(0)] * T
        for img in images:
            t = img_to_t.get(img["id"])
            if t is None:
                continue
            anns = img["annotations"]
            dets[t] = np.atleast_2d(
                [a["bbox"] for a in anns]).astype(float)
            ids[t] = np.atleast_1d(
                [a["track_id"] for a in anns]).astype(int)
            cls[t] = np.ones(len(anns), int)     # class-agnostic
            if with_conf:
                conf[t] = np.atleast_1d(
                    [a["score"] for a in anns]).astype(float)
        return ids, cls, dets, conf

    g_ids, g_cls, g_dets, _ = frames(data.gt_images[vid], False)
    t_ids, t_cls, t_dets, t_conf = frames(data.trk_images[vid], True)
    sim = [iou_tlwh(g, t) for g, t in zip(g_dets, t_dets)]
    sc = data.seq_classes[vid]

    def track_repr(all_tracks, with_scores):
        by_cls = {1: list(all_tracks)}           # all tracks pooled
        out = {
            "tracks": {c: [{a["image_id"]: np.atleast_1d(a["bbox"])
                            for a in tr["annotations"]} for tr in trs]
                       for c, trs in by_cls.items()},
            "ids": {c: [tr["id"] for tr in trs]
                    for c, trs in by_cls.items()},
            "areas": {c: [tr["area"] for tr in trs]
                      for c, trs in by_cls.items()},
            "lengths": {c: [len(tr["annotations"]) for tr in trs]
                        for c, trs in by_cls.items()},
        }
        if with_scores:
            out["scores"] = {
                c: np.array([np.mean([float(a["score"])
                                      for a in tr["annotations"]])
                             for tr in trs])
                for c, trs in by_cls.items()}
        return out

    return {
        "seq": seq, "num_timesteps": T,
        "gt_ids": g_ids, "gt_classes": g_cls, "gt_dets": g_dets,
        "tracker_ids": t_ids, "tracker_classes": t_cls,
        "tracker_dets": t_dets, "tracker_confidences": t_conf,
        "similarity": sim,
        # class-agnostic: neg/not-exhaustive stay in raw category ids,
        # which never equal the "object" id 1 unless present
        "neg_cat_ids": sc["neg"], "not_exhaustive": sc["not_exhaustive"],
        "gt_track_repr": track_repr(data.gt_tracks[vid], False),
        "dt_track_repr": track_repr(data.trk_tracks[vid], True),
        "class_name_to_id": {"object": 1},
    }


def preprocess_tao_ow(raw: Dict, cls: str = "object") -> Dict:
    return preprocess_tao(raw, cls)


# ---------------------------------------------------------------------------
# YouTube-VIS (trackeval/datasets/youtube_vis.py) — track-level jsons
# with per-frame RLE segmentations, mask IoU, TrackMAP(mask)
# ---------------------------------------------------------------------------


class YouTubeVisData:
    """Parsed YT-VIS gt + tracker jsons (youtube_vis.py:28-116).

    gt: {videos, annotations (one per TRACK with per-frame
    segmentations/areas/iscrowd), categories}; tracker json is a flat
    track list with score + per-frame segmentations. Segmentations must
    be RLE (uncompressed-list or compressed); polygons are unsupported
    (eval/rle.fr_uncompressed)."""

    def __init__(self, gt_json: str, tracker_json: str):
        from . import rle as RL

        with open(gt_json) as f:
            self.gt = json.load(f)
        self.classes = {c["name"]: c["id"] for c in self.gt["categories"]}
        self.eval_classes = list(self.classes)
        self.seq_ids = {v["file_names"][0].split("/")[0]: v["id"]
                        for v in self.gt["videos"]}
        self.seq_lengths = {v["id"]: len(v["file_names"])
                            for v in self.gt["videos"]}

        def prep(track):
            segs = track["segmentations"]
            track["segmentations"] = [
                RL.fr_uncompressed(s) if s else None for s in segs]
            areas = [RL.area(s) for s in track["segmentations"]
                     if s is not None]
            track["area"] = float(np.mean(areas)) if areas else 0

        for tr in self.gt["annotations"]:
            prep(tr)
        with open(tracker_json) as f:
            self.trk = json.load(f)
        # tracker track ids: a global counter in video order
        # (youtube_vis.py:294-300 assigns lazily per sequence; eager
        # assignment in ascending video order matches when sequences are
        # evaluated in that order)
        tid = 0
        for vid in sorted(self.seq_lengths):
            for tr in self.trk:
                if tr["video_id"] == vid:
                    prep(tr)
                    tr["id"] = tid
                    tid += 1


_YTVIS_CACHE: Dict[tuple, YouTubeVisData] = {}


def load_ytvis_seq(seq: str, gt_json: str, tracker_json: str,
                   num_timesteps: int = 0) -> Dict:
    from . import rle as RL

    key = (os.path.abspath(gt_json), os.path.abspath(tracker_json))
    if key not in _YTVIS_CACHE:
        if len(_YTVIS_CACHE) > 4:
            _YTVIS_CACHE.clear()
        _YTVIS_CACHE[key] = YouTubeVisData(*key)
    data = _YTVIS_CACHE[key]
    vid = data.seq_ids[seq]
    T = data.seq_lengths[vid]
    gt_tracks = [a for a in data.gt["annotations"]
                 if a["video_id"] == vid]
    dt_tracks = [a for a in data.trk if a["video_id"] == vid]

    def frames(tracks, with_conf):
        ids, cls, dets, conf = [], [], [], []
        for t in range(T):
            live = [tr for tr in tracks if tr["segmentations"][t]]
            ids.append(np.atleast_1d(
                [tr["id"] for tr in live]).astype(int))
            cls.append(np.atleast_1d(
                [tr["category_id"] for tr in live]).astype(int))
            dets.append([tr["segmentations"][t] for tr in live])
            conf.append(np.atleast_1d(
                [tr["score"] for tr in live]).astype(float)
                if with_conf else np.empty(0))
        return ids, cls, dets, conf

    g_ids, g_cls, g_dets, _ = frames(gt_tracks, False)
    t_ids, t_cls, t_dets, t_conf = frames(dt_tracks, True)
    sim = [RL.iou(g, d, [False] * len(d)) if len(g) and len(d)
           else np.zeros((len(g), len(d)))
           for g, d in zip(g_dets, t_dets)]

    def track_repr(tracks, is_gt):
        by_cls = {c: [tr for tr in tracks if tr["category_id"] == c]
                  for c in data.classes.values()}
        out = {
            "tracks": {c: [{i: tr["segmentations"][i]
                            for i in range(len(tr["segmentations"]))}
                           for tr in trs]
                       for c, trs in by_cls.items()},
            "ids": {c: [tr["id"] for tr in trs]
                    for c, trs in by_cls.items()},
            "areas": {c: [tr["area"] for tr in trs]
                      for c, trs in by_cls.items()},
        }
        if is_gt:
            out["iscrowd"] = {c: [tr.get("iscrowd", 0) for tr in trs]
                              for c, trs in by_cls.items()}
        else:
            out["scores"] = {c: np.array([tr["score"] for tr in trs])
                             for c, trs in by_cls.items()}
        return out

    return {
        "seq": seq, "num_timesteps": T,
        "gt_ids": g_ids, "gt_classes": g_cls, "gt_dets": g_dets,
        "tracker_ids": t_ids, "tracker_classes": t_cls,
        "tracker_dets": t_dets, "tracker_confidences": t_conf,
        "similarity": sim,
        "gt_track_repr": track_repr(gt_tracks, True),
        "dt_track_repr": track_repr(dt_tracks, False),
        "class_name_to_id": dict(data.classes),
    }


def preprocess_ytvis(raw: Dict, cls: str) -> Dict:
    """youtube_vis.py:160-282: pure class split (no det removal at
    all), contiguous relabel, TrackMAP(mask) track representations
    sorted by score."""
    cls_id = raw["class_name_to_id"][cls]
    T = raw["num_timesteps"]
    out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
           "tracker_dets": [], "similarity_scores": []}
    for t in range(T):
        gm = raw["gt_classes"][t] == cls_id
        tm = raw["tracker_classes"][t] == cls_id
        out["gt_ids"].append(raw["gt_ids"][t][gm])
        out["gt_dets"].append(
            [d for d, m in zip(raw["gt_dets"][t], gm) if m])
        out["tracker_ids"].append(raw["tracker_ids"][t][tm])
        out["tracker_dets"].append(
            [d for d, m in zip(raw["tracker_dets"][t], tm) if m])
        out["similarity_scores"].append(raw["similarity"][t][gm][:, tm])
    out = _relabel(out, T)
    g, d = raw["gt_track_repr"], raw["dt_track_repr"]
    out.update(
        gt_tracks=g["tracks"][cls_id], gt_track_ids=g["ids"][cls_id],
        gt_track_areas=g["areas"][cls_id],
        gt_track_iscrowd=g["iscrowd"][cls_id],
        dt_tracks=list(d["tracks"][cls_id]),
        dt_track_ids=list(d["ids"][cls_id]),
        dt_track_areas=list(d["areas"][cls_id]),
        dt_track_scores=list(d["scores"][cls_id]),
        iou_type="mask", seq=raw["seq"], cls=cls,
    )
    if out["dt_tracks"]:
        idx = np.argsort([-s for s in out["dt_track_scores"]],
                         kind="mergesort")
        for k in ("dt_track_scores", "dt_tracks", "dt_track_ids",
                  "dt_track_areas"):
            out[k] = [out[k][i] for i in idx]
    return out


# ---------------------------------------------------------------------------
# BURST / BURST-OW (trackeval/datasets/burst.py + burst_helpers/) —
# BURST-format jsons converted to TAO form, evaluated TAO-style with
# mask track representations. Frame-level similarity is BOX IoU: the
# upstream flow feeds per-frame bbox arrays into pycocotools mask.iou,
# which silently dispatches to its bbox branch (burst_base.py:202 +
# burst.py:36) — reproduced deliberately.
# ---------------------------------------------------------------------------


def _burst_frame_index(img_path: str) -> int:
    stripped = img_path.replace(".jpg", "").replace(".png", "") \
        .replace("frame", "")
    return int(stripped.split("_")[-1])


def burst_gt_to_tao(burst_gt: Dict, categories: List[Dict]) -> Dict:
    """GroundTruthBURSTFormatToTAOFormatConverter (format_converter.py:
    15-134): global track ids in sequence/declaration order, distractor-
    category annotations dropped, bboxes from the masks (int-cast)."""
    from . import rle as RL

    split = burst_gt["split"]
    id_map: Dict[str, Dict[str, int]] = {}
    next_tid = 1
    for seq in burst_gt["sequences"]:
        m = {}
        for local in seq["track_category_ids"]:
            m[str(local)] = next_tid
            next_tid += 1
        id_map[str(seq["id"])] = m

    videos, images, annotations = [], [], []
    tracks: Dict[int, Dict] = {}
    next_img = next_ann = 0
    for seq in burst_gt["sequences"]:
        vid = seq["id"]
        name = f"{split}/{seq['dataset']}/{seq['seq_name']}"
        videos.append({
            "id": vid, "width": seq["width"], "height": seq["height"],
            "neg_category_ids": seq["neg_category_ids"],
            "not_exhaustive_category_ids":
                seq["not_exhaustive_category_ids"],
            "name": name, "metadata": {"dataset": seq["dataset"]}})
        imgs = []
        for img_path in seq["annotated_image_paths"]:
            img = {"id": next_img, "video": name,
                   "width": seq["width"], "height": seq["height"],
                   "file_name": f"{name}/{img_path}",
                   "frame_index": _burst_frame_index(img_path),
                   "video_id": vid}
            next_img += 1
            images.append(img)
            imgs.append(img)
        for frame_segs, img in zip(seq["segmentations"], imgs):
            for local, seg in frame_segs.items():
                cat = int(seq["track_category_ids"][local])
                if cat in TAO_OW_DISTRACTORS:
                    continue
                gtid = id_map[str(vid)][str(local)]
                segmentation = {"counts": seg["rle"],
                                "size": [img["height"], img["width"]]}
                annotations.append({
                    "segmentation": segmentation, "id": next_ann,
                    "image_id": img["id"], "category_id": cat,
                    "track_id": gtid, "video_id": vid,
                    "bbox": [int(x) for x in RL.to_bbox(segmentation)]})
                next_ann += 1
                tracks.setdefault(gtid, {
                    "id": gtid, "category_id": cat, "video_id": vid})
    return {"videos": videos, "annotations": annotations,
            "tracks": sorted(tracks.values(), key=lambda t: t["id"]),
            "images": images, "categories": categories,
            "track_id_mapping": id_map, "split": split}


def burst_pred_to_tao(tao_gt: Dict, burst_pred: Dict,
                      exemplar_guided: bool = False) -> List[Dict]:
    """PredictionBURSTFormatToTAOFormatConverter (format_converter.py:
    137-258): flat TAO-style detection list; exemplar-guided runs remap
    to the gt's global track ids (dropping unknown tracks) and inherit
    the gt category."""
    from . import rle as RL

    split = burst_pred.get("split", tao_gt["split"])
    img_by_name = {im["file_name"]: im for im in tao_gt["images"]}
    gt_tracks = {int(t["id"]): t for t in tao_gt["tracks"]}
    out = []
    next_id = 0
    for seq in burst_pred["sequences"]:
        name = f"{split}/{seq['dataset']}/{seq['seq_name']}"
        for frame_segs, img_path in zip(seq["segmentations"],
                                        seq["annotated_image_paths"]):
            for local_str, det in frame_segs.items():
                fn = f"{name}/{img_path}"
                img = img_by_name.get(fn)
                if img is None:   # predictions at a higher frame rate
                    continue
                segmentation = {"counts": det["rle"],
                                "size": [img["height"], img["width"]]}
                local = int(local_str)
                if exemplar_guided:
                    gtid = tao_gt["track_id_mapping"][
                        str(seq["id"])][str(local)]
                    if gtid not in gt_tracks:
                        continue
                    cat = gt_tracks[gtid]["category_id"]
                    tid = gtid
                else:
                    tid = local
                    cat = det.get(
                        "category_id",
                        seq["track_category_ids"][local_str])
                out.append({
                    "id": next_id, "image_id": img["id"],
                    "track_id": tid, "category_id": cat,
                    "bbox": [int(x) for x in RL.to_bbox(segmentation)],
                    "segmentation": segmentation,
                    "score": det.get("score", 1.0),
                    "video_id": seq["id"]})
                next_id += 1
    return out


class BurstData(TaoData):
    """TAO-format container whose annotation areas come from the masks
    (burst.py _calculate_area_for_ann)."""

    def _ann_area(self, a):
        from . import rle as RL

        return float(RL.area(a["segmentation"]))


def load_burst_seq(seq: str, gt_json, tracker_json, num_timesteps: int = 0,
                   categories=None, exemplar_guided: bool = False) -> Dict:
    """BURST raw load: convert both jsons to TAO form, then the TAO flow
    with mask track representations. `categories` is the TAO category
    list (or a path to tao_categories.json — a public TAO artifact the
    BURST tooling ships)."""
    if isinstance(categories, str):
        with open(categories) as f:
            categories = json.load(f)
    key = (os.path.abspath(gt_json) if isinstance(gt_json, str) else
           id(gt_json),
           os.path.abspath(tracker_json) if isinstance(tracker_json, str)
           else id(tracker_json), exemplar_guided)
    if key not in _TAO_CACHE:
        if len(_TAO_CACHE) > 4:
            _TAO_CACHE.clear()
        if isinstance(gt_json, str):
            with open(gt_json) as f:
                burst_gt = json.load(f)
        else:
            burst_gt = gt_json
        if isinstance(tracker_json, str):
            with open(tracker_json) as f:
                burst_pred = json.load(f)
        else:
            burst_pred = tracker_json
        tao_gt = burst_gt_to_tao(burst_gt, categories or [])
        tao_pred = burst_pred_to_tao(tao_gt, burst_pred,
                                     exemplar_guided)
        _TAO_CACHE[key] = BurstData(tao_gt, tao_pred, max_detections=0)
    data = _TAO_CACHE[key]
    vid = data.seq_ids[seq]
    T = data.seq_lengths[vid]
    img_to_t = data.img_to_t[vid]

    def frames(images, with_conf):
        ids = [np.empty(0, int)] * T
        cls = [np.empty(0, int)] * T
        dets = [np.empty((0, 4))] * T
        conf = [np.empty(0)] * T
        for img in images:
            t = img_to_t.get(img["id"])
            if t is None:
                continue
            anns = img["annotations"]
            dets[t] = np.atleast_2d(
                [a["bbox"] for a in anns]).astype(float)
            ids[t] = np.atleast_1d(
                [a["track_id"] for a in anns]).astype(int)
            cls[t] = np.atleast_1d(
                [a["category_id"] for a in anns]).astype(int)
            if with_conf:
                conf[t] = np.atleast_1d(
                    [a["score"] for a in anns]).astype(float)
        return ids, cls, dets, conf

    g_ids, g_cls, g_dets, _ = frames(data.gt_images[vid], False)
    t_ids, t_cls, t_dets, t_conf = frames(data.trk_images[vid], True)
    # frame-level similarity is BOX IoU (see section header)
    sim = [iou_tlwh(g, t) for g, t in zip(g_dets, t_dets)]

    all_cls = sorted(data.class_name_to_id.values())
    sc = data.seq_classes[vid]

    def tracks_by_class(all_tracks, considered):
        return {c: [tr for tr in all_tracks if tr["category_id"] == c]
                if c in considered else [] for c in all_cls}

    gt_by_cls = tracks_by_class(data.gt_tracks[vid], all_cls)
    dt_by_cls = tracks_by_class(
        data.trk_tracks[vid], sc["pos"] + sc["neg"])

    def track_repr(by_cls, with_scores):
        out = {
            "tracks": {c: [{a["image_id"]: a["segmentation"]
                            for a in tr["annotations"]} for tr in trs]
                       for c, trs in by_cls.items()},
            "ids": {c: [tr["id"] for tr in trs]
                    for c, trs in by_cls.items()},
            "areas": {c: [tr["area"] for tr in trs]
                      for c, trs in by_cls.items()},
            "lengths": {c: [len(tr["annotations"]) for tr in trs]
                        for c, trs in by_cls.items()},
        }
        if with_scores:
            out["scores"] = {
                c: np.array([np.mean([float(a["score"])
                                      for a in tr["annotations"]])
                             for tr in trs])
                for c, trs in by_cls.items()}
        return out

    return {
        "seq": seq, "num_timesteps": T,
        "gt_ids": g_ids, "gt_classes": g_cls, "gt_dets": g_dets,
        "tracker_ids": t_ids, "tracker_classes": t_cls,
        "tracker_dets": t_dets, "tracker_confidences": t_conf,
        "similarity": sim,
        "neg_cat_ids": sc["neg"], "not_exhaustive": sc["not_exhaustive"],
        "gt_track_repr": track_repr(gt_by_cls, False),
        "dt_track_repr": track_repr(dt_by_cls, True),
        "class_name_to_id": data.class_name_to_id,
        "exemplar_guided": exemplar_guided,
    }


def preprocess_burst(raw: Dict, cls: str) -> Dict:
    """burst_base.py:279-421: the TAO preproc; exemplar-guided runs skip
    det removal entirely. Track reprs are masks -> iou_type 'mask'."""
    if not raw.get("exemplar_guided"):
        out = preprocess_tao(raw, cls)
    else:
        cls_id = raw["class_name_to_id"][cls]
        T = raw["num_timesteps"]
        out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
               "tracker_dets": [], "tracker_confidences": [],
               "similarity_scores": []}
        for t in range(T):
            gm = raw["gt_classes"][t] == cls_id
            tm = raw["tracker_classes"][t] == cls_id
            out["gt_ids"].append(raw["gt_ids"][t][gm])
            out["gt_dets"].append(raw["gt_dets"][t][gm])
            out["tracker_ids"].append(raw["tracker_ids"][t][tm])
            out["tracker_dets"].append(raw["tracker_dets"][t][tm])
            out["tracker_confidences"].append(
                raw["tracker_confidences"][t][tm])
            out["similarity_scores"].append(
                raw["similarity"][t][gm][:, tm])
        out = _relabel(out, T)
        g, d = raw["gt_track_repr"], raw["dt_track_repr"]
        out.update(
            gt_tracks=g["tracks"][cls_id],
            gt_track_ids=g["ids"][cls_id],
            gt_track_lengths=g["lengths"][cls_id],
            gt_track_areas=g["areas"][cls_id],
            dt_tracks=list(d["tracks"][cls_id]),
            dt_track_ids=list(d["ids"][cls_id]),
            dt_track_lengths=list(d["lengths"][cls_id]),
            dt_track_areas=list(d["areas"][cls_id]),
            dt_track_scores=list(d["scores"][cls_id]),
            not_exhaustively_labeled=False,
            seq=raw["seq"], cls=cls,
        )
        if out["dt_tracks"]:
            idx = np.argsort([-s for s in out["dt_track_scores"]],
                             kind="mergesort")
            for k in ("dt_track_scores", "dt_tracks", "dt_track_ids",
                      "dt_track_lengths", "dt_track_areas"):
                out[k] = [out[k][i] for i in idx]
    out["iou_type"] = "mask"
    return out


class BurstOwData(BurstData):
    """BURST-OW: BURST-converted TAO gt filtered to an open-world subset
    (burst_ow_base.py:76-119), class-agnostic."""

    def __init__(self, gt, pred, subset: str = "known"):
        self._subset = subset
        super().__init__(gt, pred, max_detections=0)
        self.class_name_to_id = {"object": 1}
        self.eval_classes = ["object"]

    _filter_gt = TaoOwData._filter_gt


def load_burst_ow_seq(seq: str, gt_json, tracker_json,
                      num_timesteps: int = 0, categories=None,
                      subset: str = "known") -> Dict:
    """BURST-OW raw load: BURST conversion, open-world subset filter,
    class-agnostic frames and pooled mask track representations
    (burst_ow_base.py:167-285)."""
    if isinstance(categories, str):
        with open(categories) as f:
            categories = json.load(f)
    key = ("burst_ow",
           os.path.abspath(gt_json) if isinstance(gt_json, str)
           else id(gt_json),
           os.path.abspath(tracker_json) if isinstance(tracker_json, str)
           else id(tracker_json), subset)
    if key not in _TAO_CACHE:
        if len(_TAO_CACHE) > 4:
            _TAO_CACHE.clear()
        if isinstance(gt_json, str):
            with open(gt_json) as f:
                burst_gt = json.load(f)
        else:
            burst_gt = gt_json
        if isinstance(tracker_json, str):
            with open(tracker_json) as f:
                burst_pred = json.load(f)
        else:
            burst_pred = tracker_json
        tao_gt = burst_gt_to_tao(burst_gt, categories or [])
        tao_pred = burst_pred_to_tao(tao_gt, burst_pred, False)
        _TAO_CACHE[key] = BurstOwData(tao_gt, tao_pred, subset)
    data = _TAO_CACHE[key]
    vid = data.seq_ids[seq]
    T = data.seq_lengths[vid]
    img_to_t = data.img_to_t[vid]

    def frames(images, with_conf):
        ids = [np.empty(0, int)] * T
        cls = [np.empty(0, int)] * T
        dets = [np.empty((0, 4))] * T
        conf = [np.empty(0)] * T
        for img in images:
            t = img_to_t.get(img["id"])
            if t is None:
                continue
            anns = img["annotations"]
            dets[t] = np.atleast_2d(
                [a["bbox"] for a in anns]).astype(float)
            ids[t] = np.atleast_1d(
                [a["track_id"] for a in anns]).astype(int)
            cls[t] = np.ones(len(anns), int)
            if with_conf:
                conf[t] = np.atleast_1d(
                    [a["score"] for a in anns]).astype(float)
        return ids, cls, dets, conf

    g_ids, g_cls, g_dets, _ = frames(data.gt_images[vid], False)
    t_ids, t_cls, t_dets, t_conf = frames(data.trk_images[vid], True)
    sim = [iou_tlwh(g, t) for g, t in zip(g_dets, t_dets)]
    sc = data.seq_classes[vid]

    def track_repr(all_tracks, with_scores):
        by_cls = {1: list(all_tracks)}
        out = {
            "tracks": {c: [{a["image_id"]: a["segmentation"]
                            for a in tr["annotations"]} for tr in trs]
                       for c, trs in by_cls.items()},
            "ids": {c: [tr["id"] for tr in trs]
                    for c, trs in by_cls.items()},
            "areas": {c: [tr["area"] for tr in trs]
                      for c, trs in by_cls.items()},
            "lengths": {c: [len(tr["annotations"]) for tr in trs]
                        for c, trs in by_cls.items()},
        }
        if with_scores:
            out["scores"] = {
                c: np.array([np.mean([float(a["score"])
                                      for a in tr["annotations"]])
                             for tr in trs])
                for c, trs in by_cls.items()}
        return out

    return {
        "seq": seq, "num_timesteps": T,
        "gt_ids": g_ids, "gt_classes": g_cls, "gt_dets": g_dets,
        "tracker_ids": t_ids, "tracker_classes": t_cls,
        "tracker_dets": t_dets, "tracker_confidences": t_conf,
        "similarity": sim,
        "neg_cat_ids": sc["neg"], "not_exhaustive": sc["not_exhaustive"],
        "gt_track_repr": track_repr(data.gt_tracks[vid], False),
        "dt_track_repr": track_repr(data.trk_tracks[vid], True),
        "class_name_to_id": {"object": 1},
    }


def preprocess_burst_ow(raw: Dict, cls: str = "object") -> Dict:
    out = preprocess_tao(raw, cls)
    out["iou_type"] = "mask"
    return out


# ---------------------------------------------------------------------------
# RobMOTS (trackeval/datasets/rob_mots.py) — the unified multi-benchmark
# format: one txt per sequence (`t id cls [score] h w rle`, 0-based
# frames), per-sequence frame sizes and ignore classes from the seqmap,
# COCO class ids (+100 offset marks ignore regions), 'all' superclass.
# ---------------------------------------------------------------------------

ROBMOTS_BOX_GT = ("waymo", "tao")   # sub-benchmarks with box gt
COCO_CLASSES = {
    1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
    6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
    11: "fire hydrant", 12: "stop sign", 13: "parking meter",
    14: "bench", 15: "bird", 16: "cat", 17: "dog", 18: "horse",
    19: "sheep", 20: "cow", 21: "elephant", 22: "bear", 23: "zebra",
    24: "giraffe", 25: "backpack", 26: "umbrella", 27: "handbag",
    28: "tie", 29: "suitcase", 30: "frisbee", 31: "skis",
    32: "snowboard", 33: "sports ball", 34: "kite", 35: "baseball bat",
    36: "baseball glove", 37: "skateboard", 38: "surfboard",
    39: "tennis racket", 40: "bottle", 41: "wine glass", 42: "cup",
    43: "fork", 44: "knife", 45: "spoon", 46: "bowl", 47: "banana",
    48: "apple", 49: "sandwich", 50: "orange", 51: "broccoli",
    52: "carrot", 53: "hot dog", 54: "pizza", 55: "donut", 56: "cake",
    57: "chair", 58: "couch", 59: "potted plant", 60: "bed",
    61: "dining table", 62: "toilet", 63: "tv", 64: "laptop",
    65: "mouse", 66: "remote", 67: "keyboard", 68: "cell phone",
    69: "microwave", 70: "oven", 71: "toaster", 72: "sink",
    73: "refrigerator", 74: "book", 75: "clock", 76: "vase",
    77: "scissors", 78: "teddy bear", 79: "hair drier",
    80: "toothbrush",
}
COCO_NAME_TO_ID = {v: k for k, v in COCO_CLASSES.items()}


@dataclass
class RobMotsRawSeq:
    seq: str
    sub_benchmark: str
    num_timesteps: int
    frame_size: tuple                   # (h, w)
    ignore_class_ids: tuple
    valid_class_ids: tuple
    gt_ids: List[np.ndarray]
    gt_classes: List[np.ndarray]
    gt_dets: List                       # RLE lists (or (K,4) x0y0x1y1)
    tracker_ids: List[np.ndarray]
    tracker_classes: List[np.ndarray]
    tracker_dets: List[list]            # RLE lists
    tracker_confidences: List[np.ndarray]
    similarity: List[np.ndarray] = field(default_factory=list)


def _read_robmots_txt(path: str, num_timesteps: int, is_gt: bool,
                      box_dets: bool):
    ids = [np.empty(0, int) for _ in range(num_timesteps)]
    classes = [np.empty(0, int) for _ in range(num_timesteps)]
    dets = [(np.empty((0, 4)) if box_dets else [])
            for _ in range(num_timesteps)]
    conf = [np.empty(0) for _ in range(num_timesteps)]
    per_frame: Dict[int, list] = {}
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 7:
                    continue
                per_frame.setdefault(int(parts[0]), []).append(parts)
    for t, rows in per_frame.items():
        if t >= num_timesteps:
            continue
        ids[t] = np.asarray([int(r[1]) for r in rows], int)
        classes[t] = np.asarray([int(r[2]) for r in rows], int)
        if not is_gt:
            conf[t] = np.asarray([float(r[3]) for r in rows], float)
        # the unified layout is identical for gt and tracker rows
        # (`t id cls score h w rle`; rob_mots.py indexes both with
        # region[4:7] / det[4:8])
        if box_dets:
            dets[t] = np.asarray(
                [[float(x) for x in r[4:8]] for r in rows],
                float).reshape(-1, 4)
        else:
            dets[t] = [{"size": [int(r[4]), int(r[5])],
                        "counts": r[6].encode("utf-8")}
                       for r in rows]
    return ids, classes, dets, conf


def load_robmots_seq(seq: str, gt_path: str, result_path: str,
                     num_timesteps: int, frame_size,
                     sub_benchmark: str = "mots_challenge",
                     ignore_class_ids=(), valid_class_ids=None
                     ) -> RobMotsRawSeq:
    """rob_mots.py:137-215. gt rows `t id cls h w rle` (waymo/tao gt
    carry x0y0x1y1 boxes in cols 4:8 instead); tracker rows
    `t id cls score h w rle`; 0-based frames. Gt columns differ from
    the tracker's by the missing score (the reference indexes both with
    region[4:7] because gt rows simply have no score column — the h/w/
    rle land at 3:6 for gt). Similarity is mask IoU, except box-gt
    sub-benchmarks compare gt boxes with toBbox of the tracker masks."""
    # gt and tracker rows share one column layout; the gt score column
    # is ignored
    from . import rle as RL

    box_gt = sub_benchmark in ROBMOTS_BOX_GT
    g_ids, g_cls, g_dets, _ = _read_robmots_txt(
        gt_path, num_timesteps, True, box_gt)
    t_ids, t_cls, t_dets, t_conf = _read_robmots_txt(
        result_path, num_timesteps, False, False)
    sim = []
    for g, tt in zip(g_dets, t_dets):
        if box_gt:
            if len(tt):
                tb = np.stack([RL.to_bbox(d) for d in tt])
                tb[:, 2] += tb[:, 0]
                tb[:, 3] += tb[:, 1]
            else:
                tb = np.empty((0, 4))
            sim.append(iou_xyxy_raw(np.asarray(g, float).reshape(-1, 4),
                                    tb))
        else:
            sim.append(RL.iou(g, tt, [False] * len(tt))
                       if len(g) and len(tt)
                       else np.zeros((len(g), len(tt))))
    if valid_class_ids is None:
        valid_class_ids = tuple(sorted(COCO_CLASSES))
    return RobMotsRawSeq(
        seq=seq, sub_benchmark=sub_benchmark,
        num_timesteps=num_timesteps, frame_size=tuple(frame_size),
        ignore_class_ids=tuple(ignore_class_ids),
        valid_class_ids=tuple(valid_class_ids),
        gt_ids=g_ids, gt_classes=g_cls, gt_dets=g_dets,
        tracker_ids=t_ids, tracker_classes=t_cls, tracker_dets=t_dets,
        tracker_confidences=t_conf, similarity=sim)


def preprocess_robmots(raw: RobMotsRawSeq, cls: str) -> Dict:
    """rob_mots.py:251-398: class masks ('all' = ids < 100; waymo 'car'
    pools the vehicle ids), ignore regions from class cls_id+100 and
    100, Hungarian at 0.5 keeps matched dets, unmatched dets removed
    when the class is sequence-ignored, too small (<= min(frame)/8) or
    >50% inside the merged ignore region; 'all' additionally drops
    unmatched dets of ignored/not-evaluated classes."""
    from . import rle as RL

    box_gt = raw.sub_benchmark in ROBMOTS_BOX_GT
    cls_id = -1 if cls == "all" else COCO_NAME_TO_ID[cls]
    ignore_id = cls_id + 100
    h_sz, w_sz = raw.frame_size
    min_size = min(raw.frame_size) / 8
    out = {"gt_ids": [], "tracker_ids": [], "gt_dets": [],
           "tracker_dets": [], "tracker_confidences": [],
           "similarity_scores": []}
    for t in range(raw.num_timesteps):
        gcls = raw.gt_classes[t]
        if cls == "all":
            gm = gcls < 100
            ig = gcls >= 100
        elif raw.sub_benchmark == "waymo" and cls == "car":
            gm = np.isin(gcls, np.array([3, 4, 6, 8]))
            ig = (gcls == ignore_id) | (gcls == 100)
        else:
            gm = gcls == cls_id
            ig = (gcls == ignore_id) | (gcls == 100)
        gt_ids = raw.gt_ids[t][gm]
        if box_gt:
            gt_dets = np.asarray(raw.gt_dets[t], float).reshape(-1, 4)[gm]
            ig_boxes = np.asarray(
                raw.gt_dets[t], float).reshape(-1, 4)[ig]
            ignore_regions = [
                RL.from_bbox([b[0], b[1], b[2] - b[0], b[3] - b[1]],
                             h_sz, w_sz) for b in ig_boxes]
        else:
            gt_dets = [d for d, m in zip(raw.gt_dets[t], gm) if m]
            ignore_regions = [d for d, m in zip(raw.gt_dets[t], ig) if m]

        tcls = raw.tracker_classes[t]
        tm = (np.ones(len(tcls), bool) if cls == "all"
              else tcls == cls_id)
        trk_ids = raw.tracker_ids[t][tm]
        trk_dets = [d for d, m in zip(raw.tracker_dets[t], tm) if m]
        trk_conf = raw.tracker_confidences[t][tm]
        trk_cls = tcls[tm]
        sim = raw.similarity[t][gm][:, tm]

        if len(trk_ids):
            unmatched = np.arange(len(trk_ids))
            if len(gt_ids):
                scores = sim.copy()
                scores[scores < 0.5 - EPS] = 0
                rows, cols = linear_sum_assignment(-scores)
                ok = scores[rows, cols] > EPS
                unmatched = np.delete(unmatched, cols[ok], axis=0)
            if cls_id in raw.ignore_class_ids:
                to_remove = unmatched
            else:
                um_dets = [trk_dets[i] for i in unmatched]
                if um_dets:
                    bb = np.stack([RL.to_bbox(d) for d in um_dets])
                    too_small = np.maximum(bb[:, 2], bb[:, 3]) \
                        <= min_size + EPS
                else:
                    too_small = np.zeros(0, bool)
                if ignore_regions:
                    merged = RL.merge(ignore_regions, intersect=False)
                    ioa = RL.iou(um_dets, [merged], [True]) \
                        if um_dets else np.zeros((0, 1))
                    in_ign = np.any(ioa > 0.5 + EPS, axis=1)
                    to_remove = unmatched[too_small | in_ign]
                else:
                    to_remove = unmatched[too_small]
            if cls == "all":
                um_cls = np.asarray(
                    [trk_cls[i] for i in unmatched], int)
                bad = np.isin(um_cls, raw.ignore_class_ids) \
                    | ~np.isin(um_cls, raw.valid_class_ids)
                to_remove = np.concatenate(
                    [to_remove, unmatched[bad]], axis=0)
        else:
            to_remove = np.array([], int)
        rm = set(int(x) for x in to_remove)
        out["tracker_ids"].append(np.delete(trk_ids, to_remove, axis=0))
        out["tracker_dets"].append(
            [d for i, d in enumerate(trk_dets) if i not in rm])
        out["tracker_confidences"].append(
            np.delete(trk_conf, to_remove, axis=0))
        out["similarity_scores"].append(
            np.delete(sim, to_remove, axis=1))
        out["gt_ids"].append(gt_ids)
        out["gt_dets"].append(gt_dets)
    out = _relabel(out, raw.num_timesteps)
    out.update(seq=raw.seq, cls=cls, frame_size=raw.frame_size)
    return out


def read_robmots_seqmap(path: str):
    """seqmap.txt rows: `seq length h w [ignore_class_ids...]`
    (rob_mots.py:108-135)."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                out[parts[0]] = {
                    "length": int(parts[1]),
                    "size": (int(parts[2]), int(parts[3])),
                    "ignore_class_ids": [int(x) for x in parts[4:]],
                }
    return out
