"""Plain reference of one DeepSORT step (the reference tracker's
``tracker/deepsort.py``), in float64 numpy over the slots of a
fixed-capacity track table (track_common.py).

1. The matching cascade: level l (of ``max_time_lost``) pairs the pool's
   tracks unseen for l + 1 frames with the detections still free, on the
   least cosine distance to the track's stored embeddings, gated to 1e5
   above ``MAX_APPEARANCE`` or beyond the Kalman chi2 95% quantile of the
   xyah measurement, solved at ``CASCADE_THRESH``.
2. IoU at ``IOU_THRESH`` between the tracked tracks left and the
   detections left. The reference marks lost the POOL members at the
   positions that the tracks left unmatched hold in the list of step 2's
   tracks (its ``strack_pool[it]`` for ``it`` in ``u_track``); the pool is
   ordered tracked tracks first (by ``ins_seq``), then lost ones (by
   ``lost_seq``), as the state's keys give it.
3. Unconfirmed tracks against what is left, IoU at ``UNCONFIRMED_THRESH``;
   births above ``conf_thresh``; lost tracks pruned; duplicates removed.

An embedding enters a track's history (a ring of ``feature_hist``) L2
normalised when it updates the track, raw at its birth; a detection with
an all-zero embedding leaves the history alone.
"""

from __future__ import annotations

import numpy as np

from perfbench.reference.track_common import (
    LOST, STD_POS, TRACKED, assign, identity, iou_distance, kf_initiate,
    kf_predict, kf_update, max_time_lost, remove, tlwh_to_xyah, track_tlbr,
    xyah_to_tlwh)

CHI2INV95_4 = 9.4877
GATED = 1e5
MAX_APPEARANCE = 0.15       # the cosine distance gate
CASCADE_THRESH = 0.9
IOU_THRESH = 0.5
UNCONFIRMED_THRESH = 0.9


def solves_per_frame(cfg: dict) -> int:
    """Association problems a frame: a cascade level for each frame a
    track may stay lost, IoU on the tracked, then the unconfirmed."""
    return max_time_lost(cfg) + 2


def _unit(x):
    return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)


def _gating_distance(mean, cov, meas):
    """Squared Mahalanobis distance (T, D) of xyah measurements."""
    h = mean[:, 3]
    std = np.stack([STD_POS * h, STD_POS * h, np.full_like(h, 1e-1),
                    STD_POS * h], 1)
    s = cov[:, :4, :4] + np.stack([np.diag(v ** 2) for v in std])
    d = meas[None, :, :] - mean[:, None, :4]                   # (T, D, 4)
    sol = np.linalg.solve(s[:, None], d[..., None])[..., 0]
    return (d * sol).sum(-1)


def _update(st, dets, pairs, q):
    """STrack.update / re_activate, and the embedding history."""
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
    st["time_since_update"][slots] = 0
    feat = dets["feature"][d]
    has = np.abs(feat).sum(-1) > 0
    h = st["feat_hist"].shape[1]
    for slot, f, ok in zip(slots, _unit(feat), has):
        if ok:
            st["feat_hist"][slot, st["feat_count"][slot] % h] = f
            st["feat_count"][slot] += 1


def step(state: dict, dets: dict, cfg: dict, q=identity, judge=None):
    """One frame: ``dets`` as bytetrack.step's, with ``feature`` (D, F).
    Returns (new state, emitted rows {track id: tlwh})."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return _step(state, dets, cfg, q, judge)


def _step(state, dets, cfg, q, judge):
    st = {k: np.array(v, copy=True) for k, v in state.items()}
    dets = dict(dets)
    dets["tlbr"] = q(np.asarray(dets["tlbr"], np.float64))
    dets["tlwh"] = np.concatenate(
        [dets["tlbr"][:, :2], dets["tlbr"][:, 2:] - dets["tlbr"][:, :2]], 1)
    dets["feature"] = q(np.asarray(dets["feature"], np.float64))
    score = np.asarray(dets["score"], np.float64)
    st["frame"] = st["frame"] + 1
    n_dets = len(score)
    free_det = score > cfg["conf_thresh"]

    occ, s = st["occupied"], st["state"]
    pool = occ & (((s == TRACKED) & st["is_activated"]) | (s == LOST))
    mean = st["mean"].copy()
    mean[:, 7] = np.where(s == TRACKED, mean[:, 7], 0.0)
    p_mean, p_cov = kf_predict(mean[pool], st["cov"][pool])
    st["mean"][pool], st["cov"][pool] = q(p_mean), q(p_cov)
    st["time_since_update"][pool] += 1
    # the reference's strack_pool order: tracked, then lost
    slots = np.flatnonzero(pool)
    is_lost = st["state"][slots] == LOST
    key = np.where(is_lost, st["lost_seq"][slots], st["ins_seq"][slots])
    pool_list = slots[np.lexsort((slots, key, is_lost))]

    # 1. the matching cascade on the gated appearance cost
    h = st["feat_hist"].shape[1]
    sims = np.einsum("thf,df->thd", _unit(st["feat_hist"]),
                     _unit(dets["feature"]))
    valid = np.arange(h)[None, :] < np.minimum(st["feat_count"], h)[:, None]
    sims = np.where(valid[:, :, None], sims, -np.inf)
    app = q(1.0 - sims.max(1)) if n_dets else np.zeros((len(occ), 0))
    gd = _gating_distance(st["mean"], st["cov"], tlwh_to_xyah(dets["tlwh"]))
    cost = np.where((app > MAX_APPEARANCE) | (gd > CHI2INV95_4), GATED, app)
    matched = {}
    for lvl in range(max_time_lost(cfg)):
        rows = np.flatnonzero(pool & (st["time_since_update"] == 1 + lvl))
        cols = np.flatnonzero(free_det)
        m = assign(cost[np.ix_(rows, cols)], CASCADE_THRESH, rows, cols,
                   judge)
        matched.update(m)
        free_det[list(m.values())] = False
    was_tracked = st["state"] == TRACKED
    _update(st, dets, matched, q)

    # 2. IoU on the tracked tracks left; the reference's lost-marking
    u_tracks0 = [t for t in pool_list if t not in matched
                 and was_tracked[t]]
    cols = np.flatnonzero(free_det)
    cost2 = q(iou_distance(track_tlbr(st)[u_tracks0], dets["tlbr"][cols]))
    m2 = assign(cost2, IOU_THRESH, np.asarray(u_tracks0, int), cols, judge)
    for j in m2.values():
        free_det[j] = False
    _update(st, dets, m2, q)
    for pos, t in enumerate(u_tracks0):
        if t not in m2:
            st["state"][pool_list[pos]] = LOST

    # 3. unconfirmed tracks, births, pruning, duplicates
    unconf = np.flatnonzero(st["occupied"] & (st["state"] == TRACKED)
                            & ~st["is_activated"])
    cols = np.flatnonzero(free_det)
    cost3 = q(iou_distance(track_tlbr(st)[unconf], dets["tlbr"][cols]))
    m3 = assign(cost3, UNCONFIRMED_THRESH, unconf, cols, judge)
    for j in m3.values():
        free_det[j] = False
    _update(st, dets, m3, q)
    gone = np.zeros(len(occ), bool)
    gone[[u for u in unconf if u not in m3]] = True
    remove(st, gone)

    new = np.flatnonzero(free_det)
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
        st["time_since_update"][slots] = 0
        feat = dets["feature"][new]
        st["feat_hist"][slots] = 0.0
        st["feat_hist"][slots, 0] = feat
        st["feat_count"][slots] = (np.abs(feat).sum(-1) > 0).astype(int)
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
