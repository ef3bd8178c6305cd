"""HOTA / CLEAR / Identity metrics over preprocessed sequence data.

Host numpy/scipy — evaluation is offline and not perf-critical (the
reference keeps it on host too). Algorithms match the vendored TrackEval
(tracker/trackeval/metrics/{hota,clear,identity}.py) field-for-field; a
sequence is the dict produced by eval.data.preprocess_sequence:

  gt_ids / tracker_ids : per-frame int arrays (contiguous relabeled)
  similarity_scores    : per-frame (n_gt, n_trk) IoU matrices
  num_gt_ids / num_tracker_ids / num_gt_dets / num_tracker_dets
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

ALPHAS = np.arange(0.05, 0.99, 0.05)
EPS = np.finfo("float").eps


def hota(data: Dict) -> Dict[str, np.ndarray]:
    """HOTA family over 19 alpha thresholds
    (trackeval/metrics/hota.py:24-128)."""
    na = len(ALPHAS)
    res = {
        k: np.zeros(na)
        for k in ("HOTA_TP", "HOTA_FN", "HOTA_FP", "LocA", "AssA", "AssRe",
                  "AssPr")
    }
    if data["num_tracker_dets"] == 0:
        res["HOTA_FN"] += data["num_gt_dets"]
        res["LocA"] += 1.0
        return _hota_finalize(res)
    if data["num_gt_dets"] == 0:
        res["HOTA_FP"] += data["num_tracker_dets"]
        res["LocA"] += 1.0
        return _hota_finalize(res)

    n_gt, n_trk = data["num_gt_ids"], data["num_tracker_ids"]
    potential = np.zeros((n_gt, n_trk))
    gt_count = np.zeros((n_gt, 1))
    trk_count = np.zeros((1, n_trk))
    for gt_ids, trk_ids, sim in zip(
        data["gt_ids"], data["tracker_ids"], data["similarity_scores"]
    ):
        denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
        sim_iou = np.where(denom > EPS, sim / np.maximum(denom, EPS), 0.0)
        potential[gt_ids[:, None], trk_ids[None, :]] += sim_iou
        gt_count[gt_ids] += 1
        trk_count[0, trk_ids] += 1

    global_align = potential / (gt_count + trk_count - potential)
    match_counts = [np.zeros((n_gt, n_trk)) for _ in ALPHAS]

    for gt_ids, trk_ids, sim in zip(
        data["gt_ids"], data["tracker_ids"], data["similarity_scores"]
    ):
        if len(gt_ids) == 0:
            res["HOTA_FP"] += len(trk_ids)
            continue
        if len(trk_ids) == 0:
            res["HOTA_FN"] += len(gt_ids)
            continue
        score = global_align[gt_ids[:, None], trk_ids[None, :]] * sim
        rows, cols = linear_sum_assignment(-score)
        for a, alpha in enumerate(ALPHAS):
            ok = sim[rows, cols] >= alpha - EPS
            r, c = rows[ok], cols[ok]
            res["HOTA_TP"][a] += len(r)
            res["HOTA_FN"][a] += len(gt_ids) - len(r)
            res["HOTA_FP"][a] += len(trk_ids) - len(r)
            if len(r):
                res["LocA"][a] += sim[r, c].sum()
                match_counts[a][gt_ids[r], trk_ids[c]] += 1

    for a in range(na):
        mc = match_counts[a]
        union = np.maximum(1, gt_count + trk_count - mc)
        res["AssA"][a] = np.sum(mc * (mc / union)) / max(1, res["HOTA_TP"][a])
        res["AssRe"][a] = np.sum(mc * (mc / np.maximum(1, gt_count))) / max(
            1, res["HOTA_TP"][a]
        )
        res["AssPr"][a] = np.sum(mc * (mc / np.maximum(1, trk_count))) / max(
            1, res["HOTA_TP"][a]
        )
    res["LocA"] = np.maximum(1e-10, res["LocA"]) / np.maximum(
        1e-10, res["HOTA_TP"]
    )
    return _hota_finalize(res)


def _hota_finalize(res):
    tp, fn, fp = res["HOTA_TP"], res["HOTA_FN"], res["HOTA_FP"]
    res["DetRe"] = tp / np.maximum(1, tp + fn)
    res["DetPr"] = tp / np.maximum(1, tp + fp)
    res["DetA"] = tp / np.maximum(1, tp + fn + fp)
    res["HOTA"] = np.sqrt(res["DetA"] * res["AssA"])
    res["OWTA"] = np.sqrt(res["DetRe"] * res["AssA"])
    res["HOTA(0)"] = res["HOTA"][0]
    res["LocA(0)"] = res["LocA"][0]
    res["HOTALocA(0)"] = res["HOTA"][0] * res["LocA"][0]
    return res


def clear(data: Dict, threshold: float = 0.5) -> Dict:
    """CLEAR/MOT metrics (trackeval/metrics/clear.py:36-137)."""
    res = {k: 0.0 for k in (
        "CLR_TP", "CLR_FN", "CLR_FP", "IDSW", "MT", "PT", "ML", "Frag",
        "MOTP_sum", "CLR_Frames",
    )}
    res["CLR_Frames"] = data["num_timesteps"]
    if data["num_tracker_dets"] == 0:
        res["CLR_FN"] = data["num_gt_dets"]
        res["ML"] = data["num_gt_ids"]
        out = _clear_finalize(res)
        out["MLR"] = 1.0  # trackeval clear.py:47-49 sets MLR directly
        return out
    if data["num_gt_dets"] == 0:
        res["CLR_FP"] = data["num_tracker_dets"]
        # trackeval clear.py:51-54 short-circuits WITHOUT the final-field
        # formulas: every derived field stays 0 (MOTA is 0, not -FP) and
        # MLR is set to 1.0
        out = _clear_finalize(res)
        for k in ("MODA", "MOTA", "sMOTA", "MOTAL", "FP_per_frame"):
            out[k] = 0.0
        out["MLR"] = 1.0
        return out

    n_gt = data["num_gt_ids"]
    gt_count = np.zeros(n_gt)
    gt_matched = np.zeros(n_gt)
    gt_frag = np.zeros(n_gt)
    prev_tracker = np.full(n_gt, np.nan)
    prev_step_tracker = np.full(n_gt, np.nan)

    for gt_ids, trk_ids, sim in zip(
        data["gt_ids"], data["tracker_ids"], data["similarity_scores"]
    ):
        if len(gt_ids) == 0:
            res["CLR_FP"] += len(trk_ids)
            continue
        if len(trk_ids) == 0:
            res["CLR_FN"] += len(gt_ids)
            gt_count[gt_ids] += 1
            continue
        score = 1000.0 * (
            trk_ids[None, :] == prev_step_tracker[gt_ids[:, None]]
        ) + sim
        score[sim < threshold - EPS] = 0
        rows, cols = linear_sum_assignment(-score)
        ok = score[rows, cols] > EPS
        rows, cols = rows[ok], cols[ok]
        m_gt, m_trk = gt_ids[rows], trk_ids[cols]

        prev_m = prev_tracker[m_gt]
        res["IDSW"] += np.sum(~np.isnan(prev_m) & (m_trk != prev_m))

        gt_count[gt_ids] += 1
        gt_matched[m_gt] += 1
        not_prev = np.isnan(prev_step_tracker)
        prev_tracker[m_gt] = m_trk
        prev_step_tracker[:] = np.nan
        prev_step_tracker[m_gt] = m_trk
        gt_frag += not_prev & ~np.isnan(prev_step_tracker)

        res["CLR_TP"] += len(m_gt)
        res["CLR_FN"] += len(gt_ids) - len(m_gt)
        res["CLR_FP"] += len(trk_ids) - len(m_gt)
        if len(rows):
            res["MOTP_sum"] += sim[rows, cols].sum()

    ratio = gt_matched[gt_count > 0] / gt_count[gt_count > 0]
    res["MT"] = np.sum(ratio > 0.8)
    res["PT"] = np.sum(ratio >= 0.2) - res["MT"]
    res["ML"] = n_gt - res["MT"] - res["PT"]
    res["Frag"] = np.sum(gt_frag[gt_frag > 0] - 1)
    return _clear_finalize(res)


def _clear_finalize(res):
    tp, fn, fp = res["CLR_TP"], res["CLR_FN"], res["CLR_FP"]
    num_gt = max(1.0, tp + fn)
    res["CLR_Re"] = tp / num_gt
    res["CLR_Pr"] = tp / max(1.0, tp + fp)
    res["MODA"] = (tp - fp) / num_gt
    res["MOTA"] = (tp - fp - res["IDSW"]) / num_gt
    res["MOTP"] = res["MOTP_sum"] / max(1.0, tp)
    res["sMOTA"] = (res["MOTP_sum"] - fp - res["IDSW"]) / num_gt
    res["CLR_F1"] = tp / max(1.0, tp + 0.5 * fn + 0.5 * fp)
    res["FP_per_frame"] = fp / max(1.0, res["CLR_Frames"])
    safe_log = np.log10(res["IDSW"]) if res["IDSW"] > 0 else res["IDSW"]
    res["MOTAL"] = (tp - fp - safe_log) / num_gt
    num_ids = res["MT"] + res["PT"] + res["ML"]
    res["MTR"] = res["MT"] / max(1.0, num_ids)
    res["PTR"] = res["PT"] / max(1.0, num_ids)
    res["MLR"] = res["ML"] / max(1.0, num_ids)
    return res


def identity(data: Dict, threshold: float = 0.5) -> Dict:
    """IDF1/IDP/IDR via global bipartite trajectory matching
    (trackeval/metrics/identity.py:31-90)."""
    res = {"IDTP": 0, "IDFN": 0, "IDFP": 0}
    if data["num_tracker_dets"] == 0:
        res["IDFN"] = data["num_gt_dets"]
        return _id_finalize(res)
    if data["num_gt_dets"] == 0:
        res["IDFP"] = data["num_tracker_dets"]
        return _id_finalize(res)

    n_gt, n_trk = data["num_gt_ids"], data["num_tracker_ids"]
    potential = np.zeros((n_gt, n_trk))
    gt_count = np.zeros(n_gt)
    trk_count = np.zeros(n_trk)
    for gt_ids, trk_ids, sim in zip(
        data["gt_ids"], data["tracker_ids"], data["similarity_scores"]
    ):
        gi, ti = np.nonzero(sim >= threshold)
        potential[gt_ids[gi], trk_ids[ti]] += 1
        gt_count[gt_ids] += 1
        trk_count[trk_ids] += 1

    size = n_gt + n_trk
    fp_mat = np.zeros((size, size))
    fn_mat = np.zeros((size, size))
    fp_mat[n_gt:, :n_trk] = 1e10
    fn_mat[:n_gt, n_trk:] = 1e10
    fn_mat[:n_gt, :n_trk] += gt_count[:, None]
    fn_mat[np.arange(n_gt), n_trk + np.arange(n_gt)] = gt_count
    fp_mat[:n_gt, :n_trk] += trk_count[None, :]
    fp_mat[n_gt + np.arange(n_trk), np.arange(n_trk)] = trk_count
    fn_mat[:n_gt, :n_trk] -= potential
    fp_mat[:n_gt, :n_trk] -= potential
    rows, cols = linear_sum_assignment(fn_mat + fp_mat)
    res["IDFN"] = int(fn_mat[rows, cols].sum())
    res["IDFP"] = int(fp_mat[rows, cols].sum())
    res["IDTP"] = int(gt_count.sum()) - res["IDFN"]
    return _id_finalize(res)


def _id_finalize(res):
    tp, fn, fp = res["IDTP"], res["IDFN"], res["IDFP"]
    res["IDR"] = tp / max(1.0, tp + fn)
    res["IDP"] = tp / max(1.0, tp + fp)
    res["IDF1"] = tp / max(1.0, tp + 0.5 * fn + 0.5 * fp)
    return res


def count(data: Dict) -> Dict:
    return {
        "Dets": data["num_tracker_dets"],
        "GT_Dets": data["num_gt_dets"],
        "IDs": data["num_tracker_ids"],
        "GT_IDs": data["num_gt_ids"],
        "Frames": data["num_timesteps"],
    }


def vace(data: Dict, threshold: float = 0.5) -> Dict:
    """VACE metrics — relaxed STDA/ATA (track-level temporal IoU under
    an optimal track correspondence) and FDA/SFDA (per-frame spatial
    overlap), trackeval vace.py:7-131 semantics."""
    n_gt, n_tr = data["num_gt_ids"], data["num_tracker_ids"]
    potential = np.zeros((n_gt, n_tr))
    gt_count = np.zeros(n_gt)
    tr_count = np.zeros(n_tr)
    both = np.zeros((n_gt, n_tr))
    fda, non_empty = 0.0, 0
    for t in range(data["num_timesteps"]):
        g, d = data["gt_ids"][t], data["tracker_ids"][t]
        sim = np.asarray(data["similarity_scores"][t])
        ig, id_ = np.nonzero(sim >= threshold)
        potential[g[ig], d[id_]] += 1
        gt_count[g] += 1
        tr_count[d] += 1
        both[g[:, None], d[None, :]] += 1
        if len(g) or len(d):
            non_empty += 1
            if len(g) and len(d):
                r, c = linear_sum_assignment(-sim)
                fda += sim[r, c].sum() / (0.5 * (len(g) + len(d)))
    union = gt_count[:, None] + tr_count[None, :] - both
    stda = 0.0
    if n_gt and n_tr:
        tiou = potential / np.maximum(union, 1e-10)
        r, c = linear_sum_assignment(-tiou)
        stda = float(tiou[r, c].sum())
    res = {
        "STDA": stda, "VACE_IDs": n_tr, "VACE_GT_IDs": n_gt,
        "FDA": fda, "num_non_empty_timesteps": non_empty,
    }
    return _vace_finalize(res)


def _vace_finalize(res):
    denom = 0.5 * (res["VACE_IDs"] + res["VACE_GT_IDs"])
    res["ATA"] = res["STDA"] / denom if denom else 0.0
    n = res["num_non_empty_timesteps"]
    res["SFDA"] = res["FDA"] / n if n else 0.0
    return res


def ideucl(data: Dict, threshold: float = 0.4) -> Dict:
    """IDEucl — ratio of GT trajectory length covered by the optimally
    assigned tracker id (trackeval ideucl.py:33-88). Centroids follow
    the reference's (box[:2]+box[2:4])/2 formula on the stored det
    arrays, preserving its behavior on tlwh inputs."""
    if data["num_tracker_dets"] == 0 or data["num_gt_dets"] == 0:
        return {"IDEucl": 0.0}
    cent = [
        (np.asarray(d, float)[:, 0:2] + np.asarray(d, float)[:, 2:4]) / 2.0
        for d in data["gt_dets"]
    ]
    pair_pts: Dict[tuple, list] = {}
    gt_pts: Dict[int, list] = {}
    for t in range(data["num_timesteps"]):
        g, d = data["gt_ids"][t], data["tracker_ids"][t]
        for i, gid in enumerate(g):
            gt_pts.setdefault(int(gid), []).append(cent[t][i])
        sim = np.asarray(data["similarity_scores"][t])
        ig, id_ = np.nonzero(sim >= threshold)
        for i, j in zip(ig, id_):
            pair_pts.setdefault(
                (int(g[i]), int(d[j])), []
            ).append(cent[t][i])

    def path_len(pts):
        a = np.asarray(pts)
        return float(np.sum(np.linalg.norm(np.diff(a, axis=0), axis=1))) \
            if len(a) > 1 else 0.0

    gt_len = {k: path_len(v) for k, v in gt_pts.items()}
    pair_len = {k: path_len(v) for k, v in pair_pts.items()}
    if not pair_len:
        return {"IDEucl": 0.0}
    oids = sorted({k[0] for k in pair_len})
    hids = sorted({k[1] for k in pair_len})
    dist = np.zeros((len(oids), len(hids)))
    for (o, h), v in pair_len.items():
        dist[oids.index(o), hids.index(h)] = v
    r, c = linear_sum_assignment(dist.max() - dist)
    covered = dict.fromkeys(gt_len, 0.0)
    for i, j in zip(r, c):
        covered[oids[i]] = dist[i, j]
    total_gt = sum(gt_len.values())
    return {
        "IDEucl": sum(covered.values()) / total_gt if total_gt else 0.0
    }


def combine_sequences(per_seq: List[Dict]) -> Dict:
    """Combine per-sequence results: integer fields sum, derived fields
    recompute, HOTA association fields TP-weighted
    (trackeval hota.py:130-144, clear.py:139-145, identity.py:92-98)."""
    out = {}
    keys = per_seq[0].keys()
    sum_keys = {
        "HOTA_TP", "HOTA_FN", "HOTA_FP", "CLR_TP", "CLR_FN", "CLR_FP",
        "IDSW", "MT", "PT", "ML", "Frag", "MOTP_sum", "CLR_Frames",
        "IDTP", "IDFN", "IDFP", "Dets", "GT_Dets", "IDs", "GT_IDs",
        "Frames", "STDA", "FDA", "VACE_IDs", "VACE_GT_IDs",
        "num_non_empty_timesteps",
    }
    for k in keys & sum_keys:
        out[k] = sum(r[k] for r in per_seq)
    if "HOTA_TP" in keys:
        tp_total = np.maximum(1, out["HOTA_TP"])
        for k in ("AssA", "AssRe", "AssPr", "LocA"):
            out[k] = (
                sum(np.maximum(1e-10, r["HOTA_TP"]) * r[k] for r in per_seq)
                / np.maximum(
                    1e-10, sum(np.maximum(1e-10, r["HOTA_TP"]) for r in per_seq)
                )
            )
        out = _hota_finalize(out)
    if "CLR_TP" in keys:
        out = _clear_finalize(out)
    if "IDTP" in keys:
        out = _id_finalize(out)
    if "STDA" in keys:
        out = _vace_finalize(out)
    if "IDEucl" in keys:
        # sequence combine is the mean (ideucl.py:113-118)
        out["IDEucl"] = float(np.mean([r["IDEucl"] for r in per_seq]))
    return out

# ---------------------------------------------------------------------------
# TrackMAP — track-level COCO-style AP (trackeval track_map.py:9-310, the
# TAO/YouTubeVIS protocol): spatio-temporal track IoU, greedy score-ordered
# matching per IoU threshold, 101-point interpolated AP, with "all" plus
# area-range and time-range ignore splits.
# ---------------------------------------------------------------------------

TRACKMAP_IOU_THRS = np.arange(0.5, 0.96, 0.05)
TRACKMAP_REC_THRS = np.linspace(0.0, 1.0, 101)
TRACKMAP_AREA_RANGES = {
    "area_s": (0.0, 32.0 ** 2),
    "area_m": (32.0 ** 2, 96.0 ** 2),
    "area_l": (96.0 ** 2, 1e5 ** 2),
}
TRACKMAP_TIME_RANGES = {
    "time_s": (0.0, 3.0),
    "time_m": (3.0, 10.0),
    "time_l": (10.0, 1e5),
}
TRACKMAP_LABELS = ("all",) + tuple(TRACKMAP_AREA_RANGES) + tuple(
    TRACKMAP_TIME_RANGES
)


def track_iou_xywh(dt_track: Dict[int, np.ndarray],
                   gt_track: Dict[int, np.ndarray]) -> float:
    """Spatio-temporal track IoU: frame intersections summed over the
    union of both tracks' frames, divided by summed unions (frames where
    only one track exists contribute their full area to the union)
    (track_map.py:349-398, xywh branch)."""
    inter = union = 0.0
    for f in set(dt_track) | set(gt_track):
        d, g = dt_track.get(f), gt_track.get(f)
        if d is not None and g is not None:
            w = max(min(d[0] + d[2], g[0] + g[2]) - max(d[0], g[0]), 0.0)
            h = max(min(d[1] + d[3], g[1] + g[3]) - max(d[1], g[1]), 0.0)
            i = w * h
            inter += i
            union += d[2] * d[3] + g[2] * g[3] - i
        elif g is not None:
            union += g[2] * g[3]
        elif d is not None:
            union += d[2] * d[3]
    return inter / union if union > 0 else 0.0


def track_iou_mask(dt_track: Dict[int, dict],
                   gt_track: Dict[int, dict]) -> float:
    """Spatio-temporal track IoU on RLE masks (track_map.py:400-431,
    _compute_mask_track_iou): per-frame mask intersections/unions summed
    over the union of both tracks' frames."""
    from . import rle as RL

    inter = union = 0.0
    for f in set(dt_track) | set(gt_track):
        d, g = dt_track.get(f), gt_track.get(f)
        if d is not None and g is not None:
            inter += RL.area(RL.merge([d, g], intersect=True))
            union += RL.area(RL.merge([d, g], intersect=False))
        elif g is not None:
            union += RL.area(g)
        elif d is not None:
            union += RL.area(d)
    return inter / union if union > 0 else 0.0


def _trackmap_ig_masks(n, lengths, areas, iscrowd=None,
                       ignore_all=False):
    """One 0/1 ignore vector per split: 'all' keeps everything; range
    splits ignore tracks outside [lo, hi] (track_map.py:313-346).
    lengths=None (YouTube-VIS ships no per-track lengths) keeps every
    track in the time splits; ignore_all covers the TAO
    not-exhaustively-labeled case where every dt track is ignored."""
    if ignore_all:
        return [np.ones(n)] * len(TRACKMAP_LABELS)
    masks = [np.zeros(n)]
    for lo, hi in TRACKMAP_AREA_RANGES.values():
        a = np.asarray(areas, float)
        masks.append(((a < lo - EPS) | (a > hi + EPS)).astype(float))
    for lo, hi in TRACKMAP_TIME_RANGES.values():
        if lengths is None:
            masks.append(np.zeros(n))
        else:
            t = np.asarray(lengths, float)
            masks.append(((t < lo - EPS) | (t > hi + EPS)).astype(float))
    if iscrowd is not None:
        crowd = np.asarray(iscrowd, float) > 0
        masks = [np.maximum(m, crowd) for m in masks]
    return masks


def trackmap_sequence(data: Dict) -> Dict:
    """Per-sequence TrackMAP matching (track_map.py:62-168). Input keys
    (same shapes as the reference): gt_track_ids / dt_track_ids,
    gt_tracks / dt_tracks ({frame: xywh box} dicts), gt_track_areas /
    dt_track_areas, gt_track_lengths / dt_track_lengths, dt_track_scores,
    optional gt_track_iscrowd. Returns per-split match-state dicts that
    trackmap_combine() turns into AP/AR."""
    gt_ids = list(data["gt_track_ids"])
    dt_ids = list(data["dt_track_ids"])
    n_splits = len(TRACKMAP_LABELS)
    if not gt_ids and not dt_ids:
        return {i: None for i in range(n_splits)}

    gt_ig_masks = _trackmap_ig_masks(
        len(gt_ids), data.get("gt_track_lengths"),
        data["gt_track_areas"], data.get("gt_track_iscrowd"),
    )
    dt_ig_masks = _trackmap_ig_masks(
        len(dt_ids), data.get("dt_track_lengths"),
        data["dt_track_areas"],
        ignore_all=bool(data.get("not_exhaustively_labeled")),
    )
    track_iou = (track_iou_mask if data.get("iou_type") == "mask"
                 else track_iou_xywh)
    ious = np.zeros((len(dt_ids), len(gt_ids)))
    for i, dt in enumerate(data["dt_tracks"]):
        for j, gt in enumerate(data["gt_tracks"]):
            ious[i, j] = track_iou(dt, gt)

    n_thrs = len(TRACKMAP_IOU_THRS)
    res = {}
    for s in range(n_splits):
        order = np.argsort(gt_ig_masks[s], kind="mergesort")
        gt_ids_s = [gt_ids[i] for i in order]
        ious_s = ious[:, order] if len(ious) else ious
        gt_ig = gt_ig_masks[s][order]
        gt_m = -np.ones((n_thrs, len(gt_ids)))
        dt_m = -np.ones((n_thrs, len(dt_ids)))
        dt_ig = np.zeros((n_thrs, len(dt_ids)))
        for ti, thr in enumerate(TRACKMAP_IOU_THRS):
            if not len(ious_s):
                break
            for di in range(len(dt_ids)):
                best_iou = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(len(gt_ids_s)):
                    if gt_m[ti, gi] > 0:
                        continue
                    # matched a real gt already and the rest are ignores
                    if m > -1 and gt_ig[m] == 0 and gt_ig[gi] == 1:
                        break
                    if ious_s[di, gi] < best_iou - EPS:
                        continue
                    best_iou = ious_s[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_ig[ti, di] = gt_ig[m]
                dt_m[ti, di] = gt_ids_s[m]
                gt_m[ti, m] = dt_ids[di]
        dmask = np.repeat(
            np.asarray(dt_ig_masks[s]).reshape(1, -1), n_thrs, 0
        )
        dt_ig = np.logical_or(dt_ig, np.logical_and(dt_m == -1, dmask))
        res[s] = {
            "dt_matches": dt_m,
            "gt_ignore": gt_ig,
            "dt_ignore": dt_ig,
            "dt_scores": np.asarray(data["dt_track_scores"], float),
        }
    return res


def trackmap_combine(per_seq: List[Dict]) -> Dict:
    """Pool track matches over sequences, compute 101-point interpolated
    precision per IoU threshold and split -> AP_<split>/AR_<split>
    arrays (track_map.py:170-249). -1 marks undefined splits."""
    n_thrs = len(TRACKMAP_IOU_THRS)
    n_rec = len(TRACKMAP_REC_THRS)
    n_splits = len(TRACKMAP_LABELS)
    precision = -np.ones((n_thrs, n_rec, n_splits))
    recall = -np.ones((n_thrs, n_splits))
    for s in range(n_splits):
        rs = [r[s] for r in per_seq if r[s] is not None]
        if not rs:
            continue
        scores = np.concatenate([r["dt_scores"] for r in rs])
        order = np.argsort(-scores, kind="mergesort")
        dt_m = np.concatenate([r["dt_matches"] for r in rs], axis=1)[:, order]
        dt_ig = np.concatenate([r["dt_ignore"] for r in rs], axis=1)[:, order]
        gt_ig = np.concatenate([r["gt_ignore"] for r in rs])
        num_gt = int(np.count_nonzero(gt_ig == 0))
        if num_gt == 0:
            continue
        tps = np.cumsum((dt_m != -1) & ~dt_ig.astype(bool), axis=1).astype(float)
        fps = np.cumsum((dt_m == -1) & ~dt_ig.astype(bool), axis=1).astype(float)
        for ti in range(n_thrs):
            tp, fp = tps[ti], fps[ti]
            rc = tp / num_gt
            recall[ti, s] = rc[-1] if len(tp) else 0.0
            pr = (tp / (fp + tp + np.spacing(1))).tolist()
            for i in range(len(pr) - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            idxs = np.searchsorted(rc, TRACKMAP_REC_THRS, side="left")
            pr_at = np.zeros(n_rec)
            for k, pi in enumerate(idxs):
                if pi >= len(pr):
                    break
                pr_at[k] = pr[pi]
            precision[ti, :, s] = pr_at
    out = {}
    for s, lbl in enumerate(TRACKMAP_LABELS):
        ap = np.zeros(n_thrs)
        for ti in range(n_thrs):
            p = precision[ti, :, s]
            valid = p[p > -1]
            ap[ti] = np.mean(valid) if len(valid) else -1
        out["AP_" + lbl] = ap
        out["AR_" + lbl] = recall[:, s]
    return out


def tracks_from_frames(data: Dict) -> Dict:
    """Build TrackMAP's track-level inputs from a preprocessed per-frame
    sequence dict (the adapter the TAO dataset classes provide,
    tao.py get_raw_seq_data): per-id {frame: xywh}, mean area, length,
    and mean-confidence track scores (1.0 when no confidences stored)."""
    gt_tracks: Dict[int, Dict[int, np.ndarray]] = {}
    dt_tracks: Dict[int, Dict[int, np.ndarray]] = {}
    dt_conf: Dict[int, list] = {}
    confs = data.get("tracker_confidences")
    for t in range(data["num_timesteps"]):
        for i, gid in enumerate(data["gt_ids"][t]):
            gt_tracks.setdefault(int(gid), {})[t] = np.asarray(
                data["gt_dets"][t][i], float
            )
        for i, did in enumerate(data["tracker_ids"][t]):
            dt_tracks.setdefault(int(did), {})[t] = np.asarray(
                data["tracker_dets"][t][i], float
            )
            dt_conf.setdefault(int(did), []).append(
                float(confs[t][i]) if confs is not None else 1.0
            )
    gt_ids = sorted(gt_tracks)
    dt_ids = sorted(dt_tracks)
    area = lambda trk: float(
        np.mean([b[2] * b[3] for b in trk.values()])
    ) if trk else 0.0
    return {
        "gt_track_ids": gt_ids,
        "dt_track_ids": dt_ids,
        "gt_tracks": [gt_tracks[i] for i in gt_ids],
        "dt_tracks": [dt_tracks[i] for i in dt_ids],
        "gt_track_areas": [area(gt_tracks[i]) for i in gt_ids],
        "dt_track_areas": [area(dt_tracks[i]) for i in dt_ids],
        "gt_track_lengths": [len(gt_tracks[i]) for i in gt_ids],
        "dt_track_lengths": [len(dt_tracks[i]) for i in dt_ids],
        "dt_track_scores": [float(np.mean(dt_conf[i])) for i in dt_ids],
    }


# ---------------------------------------------------------------------------
# J&F — MOTS/DAVIS segmentation quality (trackeval j_and_f.py:9-310).
# Operates on DENSE binary masks (H, W) instead of pycocotools RLE; the
# reference's math (per-track J = mask IoU under an optimal track
# matching, F = boundary F-measure with disk-dilated 1px boundaries,
# 4-bin decay) is reproduced exactly.
# ---------------------------------------------------------------------------

def _disk(radius: int) -> np.ndarray:
    """Disk structuring element (skimage.morphology.disk)."""
    r = int(radius)
    y, x = np.ogrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def _seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1px-wide boundary map offset 1/2px toward the origin
    (j_and_f.py:147-205, the David Martin construction)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _boundary_f(gt_mask: np.ndarray, tr_mask: np.ndarray,
                bound_th: float = 0.008) -> float:
    """Boundary F-measure of one mask pair (j_and_f.py:208-273)."""
    import cv2

    bound_pix = bound_th if bound_th >= 1 - EPS else int(
        np.ceil(bound_th * np.linalg.norm(tr_mask.shape))
    )
    fg_b = _seg2bmap(tr_mask)
    gt_b = _seg2bmap(gt_mask)
    k = _disk(bound_pix)
    fg_dil = cv2.dilate(fg_b.astype(np.uint8), k)
    gt_dil = cv2.dilate(gt_b.astype(np.uint8), k)
    n_fg, n_gt = fg_b.sum(), gt_b.sum()
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = float((fg_b * gt_dil).sum()) / n_fg
        recall = float((gt_b * fg_dil).sum()) / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def jandf(data: Dict, bound_th: float = 0.008) -> Dict:
    """J&F over dense masks. data needs per-frame gt_ids/tracker_ids and
    gt_dets/tracker_dets as lists of (H, W) binary masks, plus
    num_gt_ids / num_tracker_ids / num_timesteps (j_and_f.py:20-122,
    optim_type='J')."""
    T = data["num_timesteps"]
    n_gt, n_tr = data["num_gt_ids"], data["num_tracker_ids"]
    shape = None
    for t in range(T):
        for dets in (data["gt_dets"][t], data["tracker_dets"][t]):
            if len(dets):
                shape = np.asarray(dets[0]).shape
                break
        if shape:
            break
    if shape is None:
        shape = (1, 1)
    zero = np.zeros(shape, np.uint8)

    # dense per-id mask grids, zero-padded where a track has no det
    gt = [[zero] * n_gt for _ in range(T)]
    tr_n = max(n_tr, n_gt)
    tr = [[zero] * tr_n for _ in range(T)]
    for t in range(T):
        for i, gid in enumerate(data["gt_ids"][t]):
            gt[t][int(gid)] = np.asarray(data["gt_dets"][t][i], np.uint8)
        for i, did in enumerate(data["tracker_ids"][t]):
            tr[t][int(did)] = np.asarray(
                data["tracker_dets"][t][i], np.uint8
            )

    j = np.zeros((tr_n, n_gt, T))
    for t in range(T):
        a_tr = np.array([m.sum() for m in tr[t]], float)
        a_gt = np.array([m.sum() for m in gt[t]], float)
        for k in range(tr_n):
            for i in range(n_gt):
                inter = float(np.logical_and(tr[t][k], gt[t][i]).sum())
                union = a_tr[k] + a_gt[i] - inter
                j[k, i, t] = inter / union if union > 0 else 0.0
        both_zero = np.isclose(a_tr[:, None], 0) & np.isclose(
            a_gt[None, :], 0
        )
        j[..., t] = np.where(both_zero, 1.0, j[..., t])

    rows, cols = linear_sum_assignment(-np.mean(j, axis=2))
    j_m = j[rows, cols, :]
    f_m = np.zeros_like(j_m)
    for i, (tk, gi) in enumerate(zip(rows, cols)):
        for t in range(T):
            f_m[i, t] = _boundary_f(gt[t][gi], tr[t][tk], bound_th)

    if j_m.shape[0] < n_gt:
        diff = n_gt - j_m.shape[0]
        j_m = np.concatenate([j_m, np.zeros((diff, T))])
        f_m = np.concatenate([f_m, np.zeros((diff, T))])

    res = {
        "J-Mean": [np.nanmean(j_m[i]) for i in range(len(j_m))],
        "J-Recall": [np.nanmean(j_m[i] > 0.5 + EPS) for i in range(len(j_m))],
        "F-Mean": [np.nanmean(f_m[i]) for i in range(len(f_m))],
        "F-Recall": [np.nanmean(f_m[i] > 0.5 + EPS) for i in range(len(f_m))],
        "J-Decay": [], "F-Decay": [],
    }
    n_bins = 4
    ids = (np.round(np.linspace(1, T, n_bins + 1) + 1e-10) - 1).astype(int)
    for k in range(len(j_m)):
        bins = [j_m[k][ids[i]:ids[i + 1] + 1] for i in range(n_bins)]
        res["J-Decay"].append(np.nanmean(bins[0]) - np.nanmean(bins[3]))
    for k in range(len(f_m)):
        bins = [f_m[k][ids[i]:ids[i + 1] + 1] for i in range(n_bins)]
        res["F-Decay"].append(np.nanmean(bins[0]) - np.nanmean(bins[3]))
    res["num_gt_tracks"] = len(res["J-Mean"])
    for k in ("J-Mean", "J-Recall", "J-Decay", "F-Mean", "F-Recall",
              "F-Decay"):
        res[k] = float(np.mean(res[k]))
    res["J&F"] = (res["J-Mean"] + res["F-Mean"]) / 2
    return res
