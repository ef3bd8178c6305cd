"""Plain reference of one DeepMOT step (the reference tracker's
``tracker/deepmot.py:142-324``, ``DeepMOT.update``), in float64 numpy
over the slots of a fixed-capacity track table (track_common.py), with
the Deep Hungarian Net of reference/dhn.py (float64 torch on the CPU).

1. Stage 1: the pool (activated tracked tracks, then lost ones, in the
   reference's strack_pool order: tracked by ``ins_seq``, lost by
   ``lost_seq``) against the high detections (score >= conf_thresh) on
   the ``ecu_iou_distance`` blend, 0.5 * ((1 - exp(-5 * centre distance
   / diagonal)) + IoU distance) (matching.py:129-162); the DHN scores the
   blend and the stage matches on 1 - DHN at ``DHN_THRESH``.
2. Stages 2 and 3 as ByteTrack's: the tracked tracks left against the
   low detections on IoU at 0.5, the unconfirmed against the high ones
   left at 0.7. The reference marks lost the POOL members at the
   positions that the tracks stage 2 left unmatched hold in its list of
   tracks (``deepmot.py:268-272``, as DeepSORT's ``strack_pool[it]``).
3. Births above conf_thresh + 0.1, lost tracks pruned, duplicates
   removed.

The DHN reads its weights from the configuration's ``dhn_weights``
(``Munkrs``'s state dict). Departures from the published description,
which the program's static shapes impose:

- the DHN scores the cost compacted and padded to capacity x
  det_capacity with 1.0 (the pool's rows in strack_pool order, the high
  detections' columns in order, at the top-left), not the unpadded pool
  x high cost; the network is not permutation-equivariant and sees the
  padding, so this is part of the result;
- the centre distance is normalised by a 1080 x 1920 frame's diagonal,
  whatever the frame's size, as the reference's registry leaves it.

``q`` rounds what is stored and, besides, the DHN's input cost and its
scores.
"""

from __future__ import annotations

import hashlib

import numpy as np

from perfbench.reference import dhn as dhn_ref
from perfbench.reference.track_common import (
    LOST, TRACKED, apply, assign, identity, iou_distance, kf_initiate,
    kf_predict, match_iou, max_time_lost, remove, tlwh_to_xyah, track_tlbr,
    xyah_to_tlwh)

DHN_THRESH = 0.9
IOU_THRESH = 0.5
UNCONFIRMED_THRESH = 0.7
IMG_HW = (1080, 1920)
_SCORES: dict = {}         # the last costs' scores: exact and judged share


def solves_per_frame(cfg: dict) -> int:
    """Association problems a frame: the DHN's stage and two on IoU."""
    return 3


def ecu_iou_distance(a_tlbr, b_tlbr, img_hw=IMG_HW):
    """0.5 * ((1 - exp(-5 * centre distance / the frame's diagonal)) +
    IoU distance), rows of ``a_tlbr`` against rows of ``b_tlbr``."""
    ca = (a_tlbr[:, :2] + a_tlbr[:, 2:]) / 2
    cb = (b_tlbr[:, :2] + b_tlbr[:, 2:]) / 2
    ecu = np.linalg.norm(ca[:, None] - cb[None], axis=-1)
    ecu = 1.0 - np.exp(-5.0 * ecu / np.hypot(*img_hw))
    return 0.5 * (ecu + iou_distance(a_tlbr, b_tlbr))


def dhn_scores(path: str, cost: np.ndarray) -> np.ndarray:
    """The DHN of ``path`` on ``cost`` (H, W), float64; the last few
    costs' scores are kept, so the exact and the judged step of one frame
    run the network once."""
    key = (path, cost.shape, hashlib.sha1(cost.tobytes()).hexdigest())
    if key not in _SCORES:
        if len(_SCORES) >= 4:
            _SCORES.pop(next(iter(_SCORES)))
        _SCORES[key] = dhn_ref.forward(dhn_ref.load(path), cost).numpy()
    return _SCORES[key]


def step(state: dict, dets: dict, cfg: dict, q=identity, judge=None):
    """One frame: ``dets`` and the result as bytetrack.step's; ``cfg``:
    the tracker section of the configuration (``det_capacity`` and
    ``dhn_weights`` among it)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _step(state, dets, cfg, q, judge)


def _stage1(st, dets, pool_list, high, cfg, q, judge):
    """The DHN's stage: {slot: det}."""
    if not cfg.get("dhn_weights"):
        raise ValueError("the reference runs DeepMOT with its DHN only")
    cols = np.flatnonzero(high)
    tlbr = track_tlbr(st)
    cost = np.full((len(st["occupied"]), cfg["det_capacity"]), 1.0)
    cost[:, :len(high)] = ecu_iou_distance(tlbr, dets["tlbr"])
    in_pool = np.zeros(len(st["occupied"]), bool)
    in_pool[pool_list] = True
    col_mask = np.zeros(cfg["det_capacity"], bool)
    col_mask[:len(high)] = high
    rank = np.empty(len(in_pool), int)
    rank[pool_list] = np.arange(len(pool_list))
    comp, rows, ccols = dhn_ref.compact_cost(q(cost), in_pool, col_mask,
                                             row_key=rank)
    scores = q(dhn_scores(cfg["dhn_weights"], comp))
    full = dhn_ref.uncompact(scores, rows, ccols)
    return assign(1.0 - full[np.ix_(pool_list, cols)], DHN_THRESH,
                  pool_list, cols, judge)


def _step(state, dets, cfg, q, judge):
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
    mean = st["mean"].copy()
    mean[:, 7] = np.where(s == TRACKED, mean[:, 7], 0.0)
    p_mean, p_cov = kf_predict(mean[pool], st["cov"][pool])
    st["mean"][pool], st["cov"][pool] = q(p_mean), q(p_cov)
    # the reference's strack_pool order: tracked, then lost
    slots = np.flatnonzero(pool)
    is_lost = st["state"][slots] == LOST
    key = np.where(is_lost, st["lost_seq"][slots], st["ins_seq"][slots])
    pool_list = slots[np.lexsort((slots, key, is_lost))]

    m1 = _stage1(st, dets, pool_list, high, cfg, q, judge)
    was_tracked = st["state"] == TRACKED
    apply(st, dets, m1, q)
    used_high = np.zeros(len(score), bool)
    used_high[list(m1.values())] = True

    u_tracks0 = [t for t in pool_list if t not in m1 and was_tracked[t]]
    unconf = st["occupied"] & (st["state"] == TRACKED) & ~st["is_activated"]
    cost2 = q(iou_distance(track_tlbr(st)[u_tracks0],
                           dets["tlbr"][np.flatnonzero(low)]))
    m2 = assign(cost2, IOU_THRESH, np.asarray(u_tracks0, int),
                np.flatnonzero(low), judge)
    m3 = match_iou(st, dets, unconf, high & ~used_high, UNCONFIRMED_THRESH,
                   q, judge)
    apply(st, dets, m2, q)
    for pos, t in enumerate(u_tracks0):
        if t not in m2:
            st["state"][pool_list[pos]] = LOST
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

    remove(st, st["occupied"] & (st["state"] == LOST)
            & (st["frame"] - st["frame_id"] > max_time_lost(cfg)))
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
