"""Plain reference of one ByteTrack step (ByteTrack's
``BYTETracker.update`` as yolov7-tracker's ``tracker/byte_tracker.py``
runs it), in float64 numpy over the slots of a fixed-capacity track
table (track_common.py).

The configuration's capacity is part of the semantics: the k-th new
track of a frame (in detection order) takes the k-th free slot and the
id ``next_id + 1 + k``; births beyond the free slots are dropped.
Removed tracks free their slot. The thresholds of the three stages are
the published tracker's constants, which the program holds as its own.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference.track_common import (
    LOST, TRACKED, apply, identity, iou_distance, kf_initiate,
    kf_predict, match_iou, max_time_lost, remove, tlwh_to_xyah, track_tlbr,
    xyah_to_tlwh)

# stage 1 (the pool against high detections), stage 2 (tracked tracks
# left against low ones), stage 3 (unconfirmed tracks against the high
# ones left)
MATCH_THRESH = (0.9, 0.5, 0.7)


def solves_per_frame(cfg: dict) -> int:
    """Association problems a frame, as the algorithm states them."""
    return len(MATCH_THRESH)


def step(state: dict, dets: dict, cfg: dict, q=identity, judge=None):
    """One frame. ``dets``: ``tlbr`` (D, 4), ``score`` (D,), ``cls`` (D,)
    of the frame's valid detections in their order; ``cfg``: the tracker
    section of the configuration; ``judge``: the pairing under judgement
    (track_common.Judge), or None for the exact one. Returns (new state,
    emitted rows {track id: tlwh}). A box clipped to a line at the
    frame's edge has no height, so its aspect is not a number, as in the
    upstream filter."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _step(state, dets, cfg, q, judge)


def _step(state: dict, dets: dict, cfg: dict, q, judge):
    st = {k: np.array(v, copy=True) for k, v in state.items()}
    dets = dict(dets)
    dets["tlbr"] = q(np.asarray(dets["tlbr"], np.float64))
    dets["tlwh"] = np.concatenate(
        [dets["tlbr"][:, :2], dets["tlbr"][:, 2:] - dets["tlbr"][:, :2]], 1)
    score = np.asarray(dets["score"], np.float64)
    st["frame"] = st["frame"] + 1
    thr = cfg["conf_thresh"]
    high = score >= thr
    low = ~high & (score > max(0.15, thr - 0.3))

    occ, s = st["occupied"], st["state"]
    pool = occ & (((s == TRACKED) & st["is_activated"]) | (s == LOST))
    # multi_predict over the pool; a track not tracked loses its h speed
    mean = st["mean"].copy()
    mean[:, 7] = np.where(s == TRACKED, mean[:, 7], 0.0)
    p_mean, p_cov = kf_predict(mean[pool], st["cov"][pool])
    st["mean"][pool], st["cov"][pool] = q(p_mean), q(p_cov)

    m1 = match_iou(st, dets, pool, high, MATCH_THRESH[0], q,
                   judge)
    was_tracked = st["state"] == TRACKED
    apply(st, dets, m1, q)
    matched1 = np.zeros(len(occ), bool)
    matched1[list(m1)] = True
    used_high = np.zeros(len(score), bool)
    used_high[list(m1.values())] = True

    u_tracks0 = pool & ~matched1 & was_tracked
    unconf = st["occupied"] & (st["state"] == TRACKED) & ~st["is_activated"]
    m2 = match_iou(st, dets, u_tracks0, low, MATCH_THRESH[1], q, judge)
    m3 = match_iou(st, dets, unconf, high & ~used_high, MATCH_THRESH[2],
                   q, judge)
    apply(st, dets, m2, q)
    lost = u_tracks0.copy()
    lost[list(m2)] = False
    st["state"][lost] = LOST
    apply(st, dets, m3, q)
    gone = unconf.copy()
    gone[list(m3)] = False
    remove(st, gone)

    # births, in detection order, into free slots
    used3 = np.zeros(len(score), bool)
    used3[list(m3.values())] = True
    new = np.flatnonzero(high & ~used_high & ~used3 & (score > thr + 0.1))
    free = np.flatnonzero(~st["occupied"])
    new = new[:len(free)]
    if len(new):
        slots = free[:len(new)]
        m0, c0 = kf_initiate(tlwh_to_xyah(dets["tlwh"][new]))
        st["mean"][slots], st["cov"][slots] = q(m0), q(c0)
        st["det_tlwh"][slots] = dets["tlwh"][new]
        st["score"][slots] = score[new]
        st["cls"][slots] = np.asarray(dets["cls"])[new]
        st["state"][slots] = TRACKED
        st["occupied"][slots] = True
        st["is_activated"][slots] = st["frame"] == 1
        st["track_id"][slots] = st["next_id"] + 1 + np.arange(len(new))
        st["frame_id"][slots] = st["frame"]
        st["start_frame"][slots] = st["frame"]
        st["tracklet_len"][slots] = 0
        st["next_id"] = st["next_id"] + len(new)

    # lost too long
    remove(st, st["occupied"] & (st["state"] == LOST)
            & (st["frame"] - st["frame_id"] > max_time_lost(cfg)))
    # remove_duplicate_stracks: tracked vs lost at IoU distance < 0.15
    tlbr = track_tlbr(st)
    tracked = st["occupied"] & (st["state"] == TRACKED)
    lostm = st["occupied"] & (st["state"] == LOST)
    dup = (iou_distance(tlbr, tlbr) < 0.15) & tracked[:, None] & lostm[None]
    age = st["frame_id"] - st["start_frame"]
    older = age[:, None] > age[None, :]
    remove(st, (dup & ~older).any(1) | (dup & older).any(0))

    tlwh = np.where(st["occupied"][:, None], xyah_to_tlwh(st["mean"][:, :4]),
                    st["det_tlwh"])
    out = (st["occupied"] & (st["state"] == TRACKED) & st["is_activated"]
           & (tlwh[:, 2] * tlwh[:, 3] > cfg["min_area"]))
    return st, {int(st["track_id"][i]): tlwh[i] for i in np.flatnonzero(out)}
