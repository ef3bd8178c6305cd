"""py-motmetrics-style fallback evaluator (reference tracker/evaluate.py).

The reference keeps two redundant scoring harnesses: TrackEval (our
eval.metrics) and py-motmetrics (absent from this image). This module is
a compact first-party reimplementation of the MOTAccumulator event model
used there:

- per frame, previous gt->hyp correspondences are kept if still within
  the IoU gate, the remainder are matched by Hungarian on 1-IoU
  (max_iou 0.5, distances.iou_matrix semantics);
- events MATCH / SWITCH / MISS / FP accumulate MOTA/MOTP/IDSW;
- ignore handling mirrors SeqEvaluator.eval_frame (evaluate.py:94-151):
  tracker boxes greedily matched to ignore-region boxes are dropped
  before accumulation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from .data import iou_tlwh


class MOTAccumulatorLite:
    def __init__(self, max_iou: float = 0.5):
        self.max_iou = max_iou
        self.prev: Dict[int, int] = {}       # gt id -> hyp id (last frame)
        self.last_match: Dict[int, int] = {}  # gt id -> hyp id (ever)
        self.n_matches = 0
        self.n_switches = 0
        self.n_misses = 0
        self.n_fp = 0
        self.n_gt = 0
        self.dist_sum = 0.0
        self.frames = 0
        # per-id stats for IDF1 (global trajectory matching)
        self.gt_frames: Dict[int, int] = {}
        self.hyp_frames: Dict[int, int] = {}
        self.pair_overlap: Dict[tuple, int] = {}

    def update(self, gt_ids: Sequence[int], gt_tlwh: np.ndarray,
               hyp_ids: Sequence[int], hyp_tlwh: np.ndarray):
        self.frames += 1
        gt_ids = list(map(int, gt_ids))
        hyp_ids = list(map(int, hyp_ids))
        self.n_gt += len(gt_ids)
        for g in gt_ids:
            self.gt_frames[g] = self.gt_frames.get(g, 0) + 1
        for h in hyp_ids:
            self.hyp_frames[h] = self.hyp_frames.get(h, 0) + 1

        dist = 1.0 - iou_tlwh(np.asarray(gt_tlwh).reshape(-1, 4),
                              np.asarray(hyp_tlwh).reshape(-1, 4))
        valid = dist <= self.max_iou
        matched_g, matched_h = set(), set()
        pairs = []
        # 1. keep previous correspondences that are still valid
        for gi, g in enumerate(gt_ids):
            h = self.prev.get(g)
            if h is not None and h in hyp_ids:
                hi = hyp_ids.index(h)
                if valid[gi, hi]:
                    pairs.append((gi, hi))
                    matched_g.add(gi)
                    matched_h.add(hi)
        # 2. Hungarian over the rest
        rem_g = [i for i in range(len(gt_ids)) if i not in matched_g]
        rem_h = [j for j in range(len(hyp_ids)) if j not in matched_h]
        if rem_g and rem_h:
            sub = dist[np.ix_(rem_g, rem_h)].copy()
            sub[sub > self.max_iou] = 1e9
            rows, cols = linear_sum_assignment(sub)
            for r, c in zip(rows, cols):
                if sub[r, c] < 1e9 / 2:
                    pairs.append((rem_g[r], rem_h[c]))
        # 3. events
        for gi, hi in pairs:
            g, h = gt_ids[gi], hyp_ids[hi]
            if g in self.last_match and self.last_match[g] != h:
                self.n_switches += 1
            else:
                self.n_matches += 1
            self.last_match[g] = h
            self.dist_sum += dist[gi, hi]
            key = (g, h)
            self.pair_overlap[key] = self.pair_overlap.get(key, 0) + 1
        matched_gids = {gt_ids[gi] for gi, _ in pairs}
        matched_hids = {hyp_ids[hi] for _, hi in pairs}
        self.n_misses += len(gt_ids) - len(matched_gids)
        self.n_fp += len(hyp_ids) - len(matched_hids)
        self.prev = {gt_ids[gi]: hyp_ids[hi] for gi, hi in pairs}

    # -- metrics -------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        tp = self.n_matches + self.n_switches
        mota = 1.0 - (self.n_misses + self.n_fp + self.n_switches) / max(
            1, self.n_gt
        )
        motp = self.dist_sum / max(1, tp)
        idtp = self._idtp()
        n_hyp = sum(self.hyp_frames.values())
        idf1 = 2 * idtp / max(1, self.n_gt + n_hyp)
        return {
            "MOTA": mota, "MOTP": motp, "IDSW": self.n_switches,
            "FP": self.n_fp, "FN": self.n_misses, "IDF1": idf1,
            "TP": tp, "GT": self.n_gt, "Frames": self.frames,
        }

    def _idtp(self) -> int:
        """Global trajectory bipartite matching for IDF1 (same extended
        fn+fp construction as eval.metrics.identity, with per-pair
        co-occurrence counts)."""
        gts = sorted(self.gt_frames)
        hyps = sorted(self.hyp_frames)
        if not gts or not hyps:
            return 0
        n, m = len(gts), len(hyps)
        gc = np.array([self.gt_frames[g] for g in gts], float)
        hc = np.array([self.hyp_frames[h] for h in hyps], float)
        pot = np.zeros((n, m))
        for (g, h), ov in self.pair_overlap.items():
            pot[gts.index(g), hyps.index(h)] = ov
        size = n + m
        fp_mat = np.zeros((size, size))
        fn_mat = np.zeros((size, size))
        fp_mat[n:, :m] = 1e10
        fn_mat[:n, m:] = 1e10
        fn_mat[:n, :m] += gc[:, None]
        fn_mat[np.arange(n), m + np.arange(n)] = gc
        fp_mat[:n, :m] += hc[None, :]
        fp_mat[n + np.arange(m), np.arange(m)] = hc
        fn_mat[:n, :m] -= pot
        fp_mat[:n, :m] -= pot
        rows, cols = linear_sum_assignment(fn_mat + fp_mat)
        idfn = fn_mat[rows, cols].sum()
        return int(round(gc.sum() - idfn))


def evaluate_files(result_files: Sequence[str], gt_files: Sequence[str],
                   data_type: str = "mot",
                   ignore_classes: Sequence[int] = ()) -> Dict[str, Dict]:
    """Score result txts against gt txts (evaluate.py:154-185 surface)."""
    out = {}
    for res_path, gt_path in zip(result_files, gt_files):
        acc = MOTAccumulatorLite()
        gt = _read_txt(gt_path, gt=True, data_type=data_type,
                       ignore_classes=set(ignore_classes))
        res = _read_txt(res_path, gt=False, data_type=data_type)
        frames = sorted(set(gt) | set(res))
        for f in frames:
            g = gt.get(f, [])
            r = res.get(f, [])
            acc.update(
                [x[1] for x in g], np.array([x[0] for x in g]).reshape(-1, 4),
                [x[1] for x in r], np.array([x[0] for x in r]).reshape(-1, 4),
            )
        out[res_path] = acc.metrics()
    return out


def _read_txt(path, gt, data_type="mot", ignore_classes=frozenset()):
    valid = set(range(1, 12)) if data_type == "mot" else set(range(1, 11))
    valid -= set(ignore_classes)
    frames: Dict[int, List] = {}
    with open(path) as f:
        for line in f:
            parts = line.replace(" ", ",").split(",")
            if len(parts) < 6:
                continue
            fid = int(float(parts[0]))
            if gt and len(parts) >= 8:
                mark = int(float(parts[6]))
                label = int(float(parts[7]))
                if mark == 0 or label not in valid:
                    continue
            tlwh = tuple(map(float, parts[2:6]))
            tid = int(float(parts[1]))
            frames.setdefault(fid, []).append((tlwh, tid))
    return frames
