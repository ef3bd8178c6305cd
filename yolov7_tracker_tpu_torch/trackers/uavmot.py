"""UAVMOT: ByteTrack-style association with an adaptive-motion rematch on
local structure similarity (port of yolov7_tracker_tpu/trackers/uavmot.py;
the reference's tracker/uavmot.py:106-279).

Stage 1 matches the pool against the high dets at 0.7; if anything
matched, the cost is fused with the structure distance at lambda = 0.98
and the match REDONE at 0.8, and the rematch commits. Track centres come
from the KF mean, det centres from the floor-div xywh quirk. Stages 2
and 3 run as one batch-2 launch: three solves a frame.

Reference quirks kept: the step-4 lost-marking indexes strack_pool with
u_tracks0-relative positions (slab.misindexed_lost_mask); the rematch
gate is ``matched_pair0.any()``, so a lone (pool[0], D_high[0]) match
counts as nothing matched.
"""

from __future__ import annotations

import torch

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from . import appearance as A
from . import slab as S
from .bytetrack import solve_pair
from .registry import register


@register("uavmot")
def uavmot_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
                solve_stage1=None):
    """One frame of one stream or of S stacked streams; ``solve_stage1``
    solves both stage-1 problems."""
    solve_stage1 = solve_stage1 or solve_assignment
    fmt = cfg.kalman_format
    slab = slab._replace(frame=slab.frame + 1)
    slab = S.rebase_seq_keys(slab)      # before any key is assigned

    low_conf = max(0.15, cfg.conf_thresh - 0.3)
    high = dets.valid & (dets.score >= cfg.conf_thresh)
    low = dets.valid & ~high & (dets.score > low_conf)

    pmask = S.pool_mask(slab)
    slab = S.predict_pool(slab, fmt, pmask)
    pool_rank = S.pool_order_rank(slab, pmask)

    # stage 1: IoU @0.7, then the structure-fused rematch @0.8
    cost = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    r2c_a, _ = solve_stage1(cost, pmask, high, 0.7)
    # matched_pair0.any(): some match with a NONZERO pool position or
    # high-det position
    high_pos = torch.cumsum(high.int(), -1) - 1
    det_idx_a = r2c_a.long().clamp(0, dets.tlbr.shape[-2] - 1)
    any_matched = ((r2c_a >= 0) & (
        (pool_rank > 0) | (high_pos.gather(-1, det_idx_a) > 0))).any(
            -1, keepdim=True)
    det_xy = boxops.tlwh_to_xywh(dets.tlwh)[..., :2]
    sdist = A.structure_distance(slab.mean[..., :2], pmask, det_xy, high)
    r2c_b, _ = solve_stage1(0.98 * cost + 0.02 * sdist, pmask, high, 0.8)
    r2c = torch.where(any_matched, r2c_b, r2c_a)
    c2r = A.rows_to_cols_inverse(r2c, dets.tlbr.shape[-2])
    was_tracked = slab.state == S.TRACKED
    slab = S.apply_matches(slab, dets, r2c, fmt, cfg, pool_rank=pool_rank)

    # stages 2 + 3 in one batch-2 solve (both depend on stage 1 only)
    u_tracks0 = pmask & (r2c < 0) & was_tracked
    umask = S.unconfirmed_mask(slab)
    u_high = high & (c2r < 0)
    cost23 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    (r2c2, r2c3), (_, c2r3) = solve_pair(cost23, (u_tracks0, umask),
                                         (low, u_high), (0.5, 0.7))
    slab = S.apply_matches(slab, dets, r2c2, fmt, cfg)
    # the reference's mis-indexed lost-marking (uavmot.py:227-230)
    wrong_lost = S.misindexed_lost_mask(slab, pool_rank, u_tracks0,
                                        u_tracks0 & (r2c2 < 0), pmask)
    slab = S.mark_lost_ordered(slab, wrong_lost, pool_rank)
    slab = S.apply_matches(slab, dets, r2c3, fmt, cfg)
    slab = S.mark_removed(slab, umask & (r2c3 < 0))

    # births
    new_mask = u_high & (c2r3 < 0) & (dets.score > cfg.conf_thresh + 0.1)
    slab = S.init_new_tracks(slab, dets, new_mask, fmt, cfg)

    slab = S.prune_lost(slab, cfg.max_time_lost)
    slab = S.remove_duplicates(slab, fmt)
    return slab, S.frame_output(slab, fmt, cfg)
