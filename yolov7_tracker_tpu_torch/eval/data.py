"""Benchmark data loading + preprocessing for evaluation.

Equivalent of trackeval's MotChallenge2DBox / VisDrone2DBox readers
(tracker/trackeval/datasets/mot_challenge_2d_box.py:174-435,
visdrone.py:12-90 + :300-420): parse MOT-format txt (frame, id, x, y, w,
h, conf, class, ...), per-class preprocessing (Hungarian-match tracker
dets to distractor-class gt and drop them; drop zero-marked gt), and
contiguous id relabeling. Similarity is box IoU on tlwh.
"""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

EPS = np.finfo("float").eps

MOT_CLASSES = {
    "pedestrian": 1, "person_on_vehicle": 2, "car": 3, "bicycle": 4,
    "motorbike": 5, "non_mot_vehicle": 6, "static_person": 7,
    "distractor": 8, "occluder": 9, "occluder_on_ground": 10,
    "occluder_full": 11, "reflection": 12, "crowd": 13,
}
VISDRONE_CLASSES = {
    "ignored": 0, "pedestrian": 1, "people": 2, "bicycle": 3, "car": 4,
    "van": 5, "truck": 6, "tricycle": 7, "awning-tricycle": 8, "bus": 9,
    "motor": 10, "other": 11,
}

BENCHMARKS = {
    "MOT17": {
        "classes": MOT_CLASSES,
        "eval_classes": ["pedestrian"],
        "distractors": ["person_on_vehicle", "static_person", "distractor",
                        "reflection"],
    },
    "MOT20": {
        "classes": MOT_CLASSES,
        "eval_classes": ["pedestrian"],
        "distractors": ["person_on_vehicle", "static_person", "distractor",
                        "reflection", "non_mot_vehicle"],
    },
    "VisDrone": {
        "classes": VISDRONE_CLASSES,
        "eval_classes": ["pedestrian", "people", "bicycle", "car", "van",
                         "truck", "tricycle", "awning-tricycle", "bus",
                         "motor"],
        "distractors": ["ignored", "other"],
    },
    # KITTI uses its own reader/preproc (load_kitti_seq +
    # preprocess_kitti below); this entry supplies eval_classes for the
    # evaluator dispatch
    "KITTI": {
        "classes": {"car": 1, "pedestrian": 4},
        "eval_classes": ["car", "pedestrian"],
        "distractors": [],
    },
    # the following use their own readers in eval/readers.py; entries
    # here supply eval_classes for the evaluator dispatch
    "BDD100K": {
        "classes": {
            "pedestrian": 1, "rider": 2, "other person": 3, "car": 4,
            "bus": 5, "truck": 6, "train": 7, "trailer": 8,
            "other vehicle": 9, "motorcycle": 10, "bicycle": 11,
        },
        "eval_classes": ["pedestrian", "rider", "car", "bus", "truck",
                         "train", "motorcycle", "bicycle"],
        "distractors": ["other person", "trailer", "other vehicle"],
    },
    "HT": {
        "classes": {"pedestrian": 1, "static": 2, "ignore": 3,
                    "person_on_vehicle": 4},
        "eval_classes": ["pedestrian"],
        "distractors": ["static", "ignore", "person_on_vehicle"],
    },
    "PersonPath22": {
        "classes": MOT_CLASSES,
        "eval_classes": ["pedestrian"],
        "distractors": ["person_on_vehicle", "static_person", "distractor",
                        "reflection"],
    },
    "MOTS": {
        "classes": {"pedestrian": 2, "ignore": 10},
        "eval_classes": ["pedestrian"],
        "distractors": [],
    },
    "KittiMOTS": {
        "classes": {"car": 1, "pedestrian": 2, "ignore": 10},
        "eval_classes": ["car", "pedestrian"],
        "distractors": [],
    },
    "DAVIS": {
        "classes": {"general": 1},
        "eval_classes": ["general"],
        "distractors": [],
    },
    # TAO eval classes come from the gt json (classes with ground
    # truth); callers pass classes= explicitly
    "TAO": {"classes": {}, "eval_classes": [], "distractors": []},
    "TAO_OW": {"classes": {"object": 1}, "eval_classes": ["object"],
               "distractors": []},
    # YouTube-VIS / BURST eval classes come from the gt json
    "YouTubeVIS": {"classes": {}, "eval_classes": [], "distractors": []},
    "BURST": {"classes": {}, "eval_classes": [], "distractors": []},
    "BURST_OW": {"classes": {"object": 1}, "eval_classes": ["object"],
                 "distractors": []},
    # RobMOTS (trackeval/datasets/rob_mots.py:68-108): valid classes
    # come from the split's clsmap.txt at runtime; 'all' (ids < 100) is
    # always evaluable. The CLI expands eval_classes from the clsmap.
    "RobMOTS": {"classes": {"all": -1}, "eval_classes": ["all"],
                "distractors": []},
}


@dataclass
class RawSeq:
    seq: str
    num_timesteps: int
    gt_ids: List[np.ndarray]
    gt_dets: List[np.ndarray]       # tlwh
    gt_classes: List[np.ndarray]
    gt_zero_marked: List[np.ndarray]
    tracker_ids: List[np.ndarray]
    tracker_dets: List[np.ndarray]  # tlwh
    tracker_classes: List[np.ndarray]
    tracker_confidences: List[np.ndarray]


def _read_mot_txt(path: str, num_timesteps: int, is_gt: bool):
    """Parse a MOT txt into per-frame arrays (mot_challenge_2d_box.py:
    174-290 semantics; missing frames are empty)."""
    per_frame: Dict[int, List[List[float]]] = {}
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                parts = line.replace(";", ",").split(",")
                if len(parts) < 6:
                    parts = line.split()
                if len(parts) < 6:
                    continue
                row = [float(x) for x in parts[:9]] + [0.0] * max(
                    0, 9 - len(parts)
                )
                per_frame.setdefault(int(row[0]), []).append(row)
    ids, dets, classes, extra = [], [], [], []
    for t in range(1, num_timesteps + 1):
        rows = np.asarray(per_frame.get(t, np.empty((0, 9))), np.float64)
        if rows.size == 0:
            rows = np.empty((0, 9))
        ids.append(rows[:, 1].astype(int))
        dets.append(rows[:, 2:6])
        if rows.shape[1] >= 8 and (is_gt or rows[:, 7].any()):
            classes.append(rows[:, 7].astype(int))
        else:
            classes.append(np.ones(len(rows), int))
        extra.append(rows[:, 6])
    return ids, dets, classes, extra


def seq_length_from_seqinfo(seq_dir: str) -> Optional[int]:
    ini = os.path.join(seq_dir, "seqinfo.ini")
    if os.path.isfile(ini):
        cp = configparser.ConfigParser()
        cp.read(ini)
        return int(cp["Sequence"]["seqLength"])
    return None


def load_raw_seq(seq: str, gt_path: str, result_path: str,
                 num_timesteps: int) -> RawSeq:
    g_ids, g_dets, g_cls, g_zero = _read_mot_txt(gt_path, num_timesteps, True)
    t_ids, t_dets, t_cls, t_conf = _read_mot_txt(
        result_path, num_timesteps, False
    )
    return RawSeq(
        seq=seq, num_timesteps=num_timesteps,
        gt_ids=g_ids, gt_dets=g_dets, gt_classes=g_cls,
        gt_zero_marked=[z.astype(int) for z in g_zero],
        tracker_ids=t_ids, tracker_dets=t_dets, tracker_classes=t_cls,
        tracker_confidences=t_conf,
    )


def iou_tlwh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of tlwh boxes (trackeval _base_dataset
    _calculate_box_ious, box_format='xywh')."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    a_xyxy = np.concatenate([a[:, :2], a[:, :2] + a[:, 2:4]], axis=1)
    b_xyxy = np.concatenate([b[:, :2], b[:, :2] + b[:, 2:4]], axis=1)
    iw = np.maximum(
        0,
        np.minimum(a_xyxy[:, None, 2], b_xyxy[None, :, 2])
        - np.maximum(a_xyxy[:, None, 0], b_xyxy[None, :, 0]),
    )
    ih = np.maximum(
        0,
        np.minimum(a_xyxy[:, None, 3], b_xyxy[None, :, 3])
        - np.maximum(a_xyxy[:, None, 1], b_xyxy[None, :, 1]),
    )
    inter = iw * ih
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = np.maximum(area_a[:, None] + area_b[None, :] - inter, EPS)
    return inter / union


def preprocess_sequence(raw: RawSeq, benchmark: str, cls: str,
                        do_preproc: bool = True) -> Dict:
    """Per-class preprocessing + contiguous relabeling
    (mot_challenge_2d_box.py:300-420 / visdrone.py equivalent)."""
    bench = BENCHMARKS[benchmark]
    cls_id = bench["classes"][cls]
    distractors = [bench["classes"][d] for d in bench["distractors"]]

    out = {
        "gt_ids": [], "tracker_ids": [], "gt_dets": [], "tracker_dets": [],
        "similarity_scores": [],
    }
    uniq_gt, uniq_trk = set(), set()
    n_gt_dets = n_trk_dets = 0
    for t in range(raw.num_timesteps):
        gt_ids = raw.gt_ids[t]
        gt_dets = raw.gt_dets[t]
        gt_classes = raw.gt_classes[t]
        zero = raw.gt_zero_marked[t]
        trk_ids = raw.tracker_ids[t]
        trk_dets = raw.tracker_dets[t]
        sim = iou_tlwh(gt_dets, trk_dets)

        to_remove = np.array([], int)
        if do_preproc and len(gt_ids) and len(trk_ids):
            scores = sim.copy()
            scores[scores < 0.5 - EPS] = 0
            rows, cols = linear_sum_assignment(-scores)
            ok = scores[rows, cols] > EPS
            rows, cols = rows[ok], cols[ok]
            is_distractor = np.isin(gt_classes[rows], distractors)
            to_remove = cols[is_distractor]

        trk_ids = np.delete(trk_ids, to_remove, axis=0)
        trk_dets = np.delete(trk_dets, to_remove, axis=0)
        sim = np.delete(sim, to_remove, axis=1)

        if do_preproc:
            keep = (zero != 0) & (gt_classes == cls_id)
        else:
            keep = zero != 0
        gt_ids = gt_ids[keep]
        gt_dets = gt_dets[keep]
        sim = sim[keep]

        out["gt_ids"].append(gt_ids)
        out["gt_dets"].append(gt_dets)
        out["tracker_ids"].append(trk_ids)
        out["tracker_dets"].append(trk_dets)
        out["similarity_scores"].append(sim)
        uniq_gt.update(gt_ids.tolist())
        uniq_trk.update(trk_ids.tolist())
        n_gt_dets += len(gt_ids)
        n_trk_dets += len(trk_ids)

    gt_map = {v: i for i, v in enumerate(sorted(uniq_gt))}
    trk_map = {v: i for i, v in enumerate(sorted(uniq_trk))}
    for t in range(raw.num_timesteps):
        out["gt_ids"][t] = np.asarray(
            [gt_map[v] for v in out["gt_ids"][t]], int
        )
        out["tracker_ids"][t] = np.asarray(
            [trk_map[v] for v in out["tracker_ids"][t]], int
        )
    out.update(
        num_timesteps=raw.num_timesteps,
        num_gt_ids=len(gt_map),
        num_tracker_ids=len(trk_map),
        num_gt_dets=n_gt_dets,
        num_tracker_dets=n_trk_dets,
        seq=raw.seq,
        cls=cls,
    )
    return out


# ---------------------------------------------------------------------------
# KITTI 2D-box benchmark reader
# (trackeval/datasets/kitti_2d_box.py semantics: 0-based frames, space-
# separated label rows `frame id type trunc occ alpha x1 y1 x2 y2 ...
# [score]`, x0y0x1y1 boxes, DontCare crowd-ignore regions, occlusion<=2 /
# truncation<=0 gates, 25px min unmatched-height filter)
# ---------------------------------------------------------------------------

KITTI_CLASSES = {
    "car": 1, "van": 2, "truck": 3, "pedestrian": 4, "person": 5,
    "person_sitting": 5, "cyclist": 6, "tram": 7, "misc": 8, "dontcare": 9,
}
KITTI_EVAL_CLASSES = ["car", "pedestrian"]
# per-class distractors (kitti_2d_box.py:273-276)
KITTI_DISTRACTORS = {"car": [2], "pedestrian": [5]}  # van / person-sitting
KITTI_MAX_OCCLUSION = 2
KITTI_MAX_TRUNCATION = 0
KITTI_MIN_HEIGHT = 25


@dataclass
class KittiRawSeq:
    seq: str
    num_timesteps: int
    gt_ids: List[np.ndarray]
    gt_dets: List[np.ndarray]        # x0y0x1y1
    gt_classes: List[np.ndarray]
    gt_truncation: List[np.ndarray]
    gt_occlusion: List[np.ndarray]
    gt_ignore_regions: List[np.ndarray]  # DontCare boxes, x0y0x1y1
    tracker_ids: List[np.ndarray]
    tracker_dets: List[np.ndarray]   # x0y0x1y1
    tracker_classes: List[np.ndarray]
    tracker_confidences: List[np.ndarray]


def _read_kitti_txt(path: str, num_timesteps: int, is_gt: bool):
    per_frame: Dict[int, List[List[float]]] = {}
    ignore: Dict[int, List[List[float]]] = {}
    if os.path.isfile(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 10:
                    continue
                t = int(float(parts[0]))
                cls_name = parts[2].lower()
                cls_id = KITTI_CLASSES.get(cls_name)
                if cls_id is None:
                    continue
                tid = int(float(parts[1]))
                box = [float(x) for x in parts[6:10]]
                if is_gt and cls_id == KITTI_CLASSES["dontcare"]:
                    ignore.setdefault(t, []).append(box)
                    continue
                if tid < 0:  # remove_negative_ids (ignored gt rows)
                    continue
                conf = float(parts[17]) if len(parts) > 17 else 1.0
                per_frame.setdefault(t, []).append(
                    [tid, cls_id, float(parts[3]), float(parts[4])]
                    + box + [conf]
                )
    ids, dets, classes, trunc, occ, conf, ign = [], [], [], [], [], [], []
    for t in range(num_timesteps):  # KITTI frames are 0-based
        rows = np.asarray(per_frame.get(t, []), np.float64).reshape(-1, 9)
        ids.append(rows[:, 0].astype(int))
        classes.append(rows[:, 1].astype(int))
        trunc.append(rows[:, 2].astype(int))
        occ.append(rows[:, 3].astype(int))
        dets.append(rows[:, 4:8])
        conf.append(rows[:, 8])
        ign.append(np.asarray(ignore.get(t, []),
                              np.float64).reshape(-1, 4))
    return ids, dets, classes, trunc, occ, conf, ign


def load_kitti_seq(seq: str, gt_path: str, result_path: str,
                   num_timesteps: int) -> KittiRawSeq:
    g = _read_kitti_txt(gt_path, num_timesteps, True)
    r = _read_kitti_txt(result_path, num_timesteps, False)
    return KittiRawSeq(
        seq=seq, num_timesteps=num_timesteps,
        gt_ids=g[0], gt_dets=g[1], gt_classes=g[2], gt_truncation=g[3],
        gt_occlusion=g[4], gt_ignore_regions=g[6],
        tracker_ids=r[0], tracker_dets=r[1], tracker_classes=r[2],
        tracker_confidences=r[5],
    )


def iou_xyxy(a: np.ndarray, b: np.ndarray, do_ioa: bool = False):
    """Pairwise IoU (or intersection-over-area-of-a) for x0y0x1y1 boxes
    (trackeval _calculate_box_ious box_format='x0y0x1y1')."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    iw = np.maximum(0, np.minimum(a[:, None, 2], b[None, :, 2])
                    - np.maximum(a[:, None, 0], b[None, :, 0]))
    ih = np.maximum(0, np.minimum(a[:, None, 3], b[None, :, 3])
                    - np.maximum(a[:, None, 1], b[None, :, 1]))
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    if do_ioa:
        return inter / np.maximum(area_a[:, None], EPS)
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = np.maximum(area_a[:, None] + area_b[None, :] - inter, EPS)
    return inter / union


def preprocess_kitti(raw: KittiRawSeq, cls: str) -> Dict:
    """KITTI per-class preprocessing (kitti_2d_box.py
    get_preprocessed_seq_data): distractor/occluded/truncated gt match
    removal, DontCare-region and min-height unmatched filtering,
    contiguous relabeling."""
    cls_id = KITTI_CLASSES[cls]
    distractors = KITTI_DISTRACTORS[cls]

    out = {
        "gt_ids": [], "tracker_ids": [], "gt_dets": [], "tracker_dets": [],
        "similarity_scores": [],
    }
    uniq_gt, uniq_trk = set(), set()
    n_gt_dets = n_trk_dets = 0
    for t in range(raw.num_timesteps):
        gmask = np.isin(raw.gt_classes[t], [cls_id] + distractors)
        gt_ids = raw.gt_ids[t][gmask]
        gt_dets = raw.gt_dets[t][gmask]
        gt_classes = raw.gt_classes[t][gmask]
        gt_occ = raw.gt_occlusion[t][gmask]
        gt_trunc = raw.gt_truncation[t][gmask]

        tmask = raw.tracker_classes[t] == cls_id
        trk_ids = raw.tracker_ids[t][tmask]
        trk_dets = raw.tracker_dets[t][tmask]
        sim = iou_xyxy(gt_dets, trk_dets)

        to_remove_matched = np.array([], int)
        unmatched = np.arange(len(trk_ids))
        if len(gt_ids) and len(trk_ids):
            scores = sim.copy()
            scores[scores < 0.5 - EPS] = 0
            rows, cols = linear_sum_assignment(-scores)
            ok = scores[rows, cols] > EPS
            rows, cols = rows[ok], cols[ok]
            bad = (np.isin(gt_classes[rows], distractors)
                   | (gt_occ[rows] > KITTI_MAX_OCCLUSION + EPS)
                   | (gt_trunc[rows] > KITTI_MAX_TRUNCATION + EPS))
            to_remove_matched = cols[bad]
            unmatched = np.delete(unmatched, cols, axis=0)

        udets = trk_dets[unmatched]
        too_small = (udets[:, 3] - udets[:, 1]) <= KITTI_MIN_HEIGHT + EPS
        in_ignore = np.any(
            iou_xyxy(udets, raw.gt_ignore_regions[t], do_ioa=True)
            > 0.5 + EPS,
            axis=1,
        ) if len(udets) else np.zeros(0, bool)
        to_remove = np.concatenate(
            [to_remove_matched, unmatched[too_small | in_ignore]]
        ).astype(int)

        trk_ids = np.delete(trk_ids, to_remove, axis=0)
        trk_dets = np.delete(trk_dets, to_remove, axis=0)
        sim = np.delete(sim, to_remove, axis=1)

        keep = ((gt_occ <= KITTI_MAX_OCCLUSION)
                & (gt_trunc <= KITTI_MAX_TRUNCATION)
                & (gt_classes == cls_id))
        gt_ids = gt_ids[keep]
        gt_dets = gt_dets[keep]
        sim = sim[keep]

        out["gt_ids"].append(gt_ids)
        out["gt_dets"].append(gt_dets)
        out["tracker_ids"].append(trk_ids)
        out["tracker_dets"].append(trk_dets)
        out["similarity_scores"].append(sim)
        uniq_gt.update(gt_ids.tolist())
        uniq_trk.update(trk_ids.tolist())
        n_gt_dets += len(gt_ids)
        n_trk_dets += len(trk_ids)

    gt_map = {v: i for i, v in enumerate(sorted(uniq_gt))}
    trk_map = {v: i for i, v in enumerate(sorted(uniq_trk))}
    for t in range(raw.num_timesteps):
        out["gt_ids"][t] = np.asarray(
            [gt_map[v] for v in out["gt_ids"][t]], int)
        out["tracker_ids"][t] = np.asarray(
            [trk_map[v] for v in out["tracker_ids"][t]], int)
    out.update(
        num_timesteps=raw.num_timesteps,
        num_gt_ids=len(gt_map),
        num_tracker_ids=len(trk_map),
        num_gt_dets=n_gt_dets,
        num_tracker_dets=n_trk_dets,
        seq=raw.seq,
        cls=cls,
    )
    return out
