"""What the plain tracker references share (the reference tracker's
``tracker/basetrack.py``, ``matching.py`` and ``kalman_filter.py``): the
track table's states, box conversions, the xyah Kalman filter, IoU
distance with the +1 pixel convention of cython_bbox, and the exact
``lapjv(extend_cost=True, cost_limit=thresh)`` of the upstream
``linear_assignment``, here through scipy, with the judge of a pairing
that ties with it (``Judge``).

The state is a dict of arrays, one entry a slot: ``mean`` (T, 8) and
``cov`` (T, 8, 8) of the Kalman filter, ``det_tlwh``, ``score``,
``state`` (0 new, 1 tracked, 2 lost, 3 removed), ``occupied``,
``is_activated``, ``track_id``, ``frame_id``, ``start_frame``,
``tracklet_len``, and the scalars ``next_id`` and ``frame``. ``q``
rounds what is stored: the identity for the reference, bfloat16 for the
check's control.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

TRACKED, LOST, REMOVED = 1, 2, 3
STD_POS, STD_VEL = 1.0 / 20, 1.0 / 160
F_MOTION = np.eye(8) + np.eye(8, k=4)


def identity(x):
    return x


def max_time_lost(cfg: dict) -> int:
    """Frames a lost track is kept (the trackers' buffer_size)."""
    return int(cfg["frame_rate"] / 30.0 * cfg["track_buffer"])


def lapjv_extended(cost: np.ndarray, thresh: float):
    """Optimal matches of a (n, m) cost with leaving a row and a column
    unmatched costing ``thresh`` together; returns [(row, col)]."""
    n, m = cost.shape
    if n == 0 or m == 0:
        return []
    ext = np.full((n + m, n + m), thresh / 2.0)
    ext[n:, m:] = 0.0
    ext[:n, :m] = np.where(cost > thresh, 1e9, cost)
    rows, cols = linear_sum_assignment(ext)
    return [(r, c) for r, c in zip(rows, cols)
            if r < n and c < m and cost[r, c] <= thresh]


def extended_cost(cost: np.ndarray, thresh: float, pairs) -> float:
    """What ``lapjv_extended`` minimises: the matched costs plus half the
    threshold for each row and each column left unmatched."""
    n, m = cost.shape
    return (sum(float(cost[i, j]) for i, j in pairs)
            + (n + m - 2 * len(pairs)) * thresh / 2.0)


class Judge:
    """The pairing of a step under judgement, {slot: det}, read from the
    state the program's step returned. At each stage the reference takes
    it in place of its own exact pairing where it is a matching of the
    stage's rows and columns that costs at most ``slack`` more than the
    exact optimum: two pairings that close are a tie, which the exact
    solver and an auction may break apart, and every later id would then
    differ. A pairing that costs more is refused and the reference goes
    on with its own, so the rows and the state then differ.

    ``ties``: stage problems where a pairing other than the exact one
    was taken; ``tie_excess``: the most that one cost over the optimum;
    ``refused`` and ``refused_excess``: the same of those refused."""

    def __init__(self, pairs: dict, slack: float):
        self.pairs, self.slack = pairs, slack
        self.ties = self.refused = 0
        self.tie_excess = self.refused_excess = 0.0


def assign(cost, thresh, rows, cols, judge=None):
    """The exact pairing of ``cost`` (len(rows), len(cols)) as {row
    slot: column index}, or the judged one where it ties with it
    (``Judge``); ``rows`` and ``cols`` are the problem's slots and
    detection indices."""
    best = lapjv_extended(cost, thresh)
    pick = best
    if judge is not None and len(rows) and len(cols):
        at = {int(c): j for j, c in enumerate(cols)}
        theirs = sorted((i, at[judge.pairs[int(r)]])
                        for i, r in enumerate(rows)
                        if judge.pairs.get(int(r), -1) in at)
        theirs = [(i, j) for i, j in theirs if cost[i, j] <= thresh]
        if theirs != sorted(best):
            excess = (extended_cost(cost, thresh, theirs)
                      - extended_cost(cost, thresh, best))
            if (len({j for _, j in theirs}) == len(theirs)
                    and excess <= judge.slack):
                judge.ties += 1
                judge.tie_excess = max(judge.tie_excess, excess)
                pick = theirs
            else:
                judge.refused += 1
                judge.refused_excess = max(judge.refused_excess, excess)
    return {int(rows[i]): int(cols[j]) for i, j in pick}


def judged_pairs(before: dict, after: dict, dets: dict,
                 tol: float = 0.01) -> dict:
    """The pairing a step made, {slot: det}, from the state it returned:
    the tracks that were in the table before, keep their id and were
    updated on this frame, each with the detection whose box (within
    ``tol`` pixels) and score it stored; of equal boxes, the nearest
    score."""
    out = {}
    upd = np.flatnonzero(after["occupied"] & before["occupied"]
                         & (after["track_id"] == before["track_id"])
                         & (after["frame_id"] == after["frame"])
                         & (after["start_frame"] < after["frame"]))
    if not len(upd) or not len(dets["tlwh"]):
        return out
    box = np.abs(after["det_tlwh"][upd][:, None] - dets["tlwh"][None]
                 ).max(-1)
    score = np.abs(after["score"][upd][:, None] - dets["score"][None])
    near = np.where(box <= tol, score, np.inf).argmin(1)
    for s, d, g in zip(upd, near, box[np.arange(len(upd)), near]):
        if g <= tol:
            out[int(s)] = int(d)
    return out


def iou_distance(a_tlbr, b_tlbr):
    """1 - IoU with the +1 pixel convention of cython_bbox."""
    iw = (np.minimum(a_tlbr[:, None, 2], b_tlbr[None, :, 2])
          - np.maximum(a_tlbr[:, None, 0], b_tlbr[None, :, 0]) + 1)
    ih = (np.minimum(a_tlbr[:, None, 3], b_tlbr[None, :, 3])
          - np.maximum(a_tlbr[:, None, 1], b_tlbr[None, :, 1]) + 1)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    area_a = (a_tlbr[:, 2] - a_tlbr[:, 0] + 1) * (a_tlbr[:, 3] - a_tlbr[:, 1]
                                                  + 1)
    area_b = (b_tlbr[:, 2] - b_tlbr[:, 0] + 1) * (b_tlbr[:, 3] - b_tlbr[:, 1]
                                                  + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)
    return 1.0 - iou


def tlwh_to_xyah(tlwh):
    xy = tlwh[:, :2] + tlwh[:, 2:] / 2
    return np.concatenate([xy, tlwh[:, 2:3] / tlwh[:, 3:4], tlwh[:, 3:4]], 1)


def xyah_to_tlwh(xyah):
    w = xyah[:, 2] * xyah[:, 3]
    h = xyah[:, 3]
    return np.stack([xyah[:, 0] - w / 2, xyah[:, 1] - h / 2, w, h], 1)


def tlwh_to_tlbr(tlwh):
    return np.concatenate([tlwh[:, :2], tlwh[:, :2] + tlwh[:, 2:]], 1)


def kf_initiate(meas):
    mean = np.concatenate([meas, np.zeros_like(meas)], 1)
    h = meas[:, 3]
    std = np.stack([2 * STD_POS * h, 2 * STD_POS * h, np.full_like(h, 1e-2),
                    2 * STD_POS * h, 10 * STD_VEL * h, 10 * STD_VEL * h,
                    np.full_like(h, 1e-5), 10 * STD_VEL * h], 1)
    return mean, np.stack([np.diag(s ** 2) for s in std]) if len(std) \
        else np.zeros((0, 8, 8))


def kf_predict(mean, cov):
    h = mean[:, 3]
    std = np.stack([STD_POS * h, STD_POS * h, np.full_like(h, 1e-2),
                    STD_POS * h, STD_VEL * h, STD_VEL * h,
                    np.full_like(h, 1e-5), STD_VEL * h], 1)
    q = np.stack([np.diag(s ** 2) for s in std]) if len(std) \
        else np.zeros((0, 8, 8))
    return mean @ F_MOTION.T, F_MOTION @ cov @ F_MOTION.T + q


def kf_update(mean, cov, meas):
    h = mean[:, 3]
    std = np.stack([STD_POS * h, STD_POS * h, np.full_like(h, 1e-1),
                    STD_POS * h], 1)
    proj_mean = mean[:, :4]
    proj_cov = cov[:, :4, :4] + np.stack([np.diag(s ** 2) for s in std])
    # K = P H^T S^-1, solved against S
    gain = np.linalg.solve(proj_cov, cov[:, :, :4].transpose(0, 2, 1)
                           ).transpose(0, 2, 1)
    innov = meas - proj_mean
    new_mean = mean + np.einsum("tij,tj->ti", gain, innov)
    new_cov = cov - gain @ proj_cov @ gain.transpose(0, 2, 1)
    return new_mean, new_cov


def track_tlbr(st):
    tlwh = np.where(st["occupied"][:, None], xyah_to_tlwh(st["mean"][:, :4]),
                    st["det_tlwh"])
    return tlwh_to_tlbr(tlwh)


def match_iou(st, dets, rows, cols, thresh, q, judge=None):
    """Solve rows x cols (masks) on the current boxes; returns
    {slot: det}."""
    r = np.flatnonzero(rows)
    c = np.flatnonzero(cols)
    cost = q(iou_distance(track_tlbr(st)[r], dets["tlbr"][c]))
    return assign(cost, thresh, r, c, judge)


def apply(st, dets, pairs, q):
    """STrack.update for tracked slots, re_activate for lost ones."""
    if not pairs:
        return
    slots = np.array(list(pairs.keys()))
    d = np.array(list(pairs.values()))
    tlwh = dets["tlwh"][d]
    mean, cov = kf_update(st["mean"][slots], st["cov"][slots],
                          tlwh_to_xyah(tlwh))
    st["mean"][slots], st["cov"][slots] = q(mean), q(cov)
    was = st["state"][slots] == TRACKED
    st["det_tlwh"][slots] = tlwh
    st["score"][slots] = dets["score"][d]
    st["tracklet_len"][slots] = np.where(was, st["tracklet_len"][slots] + 1,
                                         0)
    st["state"][slots] = TRACKED
    st["is_activated"][slots] = True
    st["frame_id"][slots] = st["frame"]


def remove(st, mask):
    st["state"][mask] = REMOVED
    st["occupied"][mask] = False
    st["is_activated"][mask] = False
