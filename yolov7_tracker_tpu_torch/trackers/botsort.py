"""BoT-SORT: ByteTrack association with camera-motion compensation and an
optional IoU/embedding min-fusion (port of
yolov7_tracker_tpu/trackers/botsort.py; the reference's
tracker/botsort.py:270-493).

The frame's 2x3 camera warp (``DetSlab.warp``, from trackers/gmc.py) is
applied to the pool's and the unconfirmed tracks' KF states after the
predict. With features, the cost is min(IoU, emb) where emb is half the
cosine distance, set to 1 where IoU distance > 0.5 or emb > 0.25.
Stage 2 runs over ALL stage-1-unmatched pool rows (Lost included) and
births come from the stage-1 leftovers (reference quirks). Stages 2 and 3
run as one batch-2 launch: two solves a frame.
"""

from __future__ import annotations

import torch

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from . import appearance as A
from . import slab as S
from .bytetrack import solve_pair
from .registry import register

THETA_IOU, THETA_EMB = 0.5, 0.25  # botsort.py:287-289


def _fused_cost(slab, dets, fmt, use_appearance):
    iou = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    if not use_appearance:
        return iou
    emb = 0.5 * A.cosine_distance(slab.feature, dets.feature)
    one = torch.ones_like(emb)
    emb = torch.where(iou > THETA_IOU, one, emb)
    emb = torch.where(emb > THETA_EMB, one, emb)
    return torch.minimum(iou, emb)


@register("botsort")
def botsort_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
                 solve_stage1=None):
    """One frame of one stream or of S stacked streams; ``solve_stage1``
    solves stage 1."""
    solve_stage1 = solve_stage1 or solve_assignment
    fmt = cfg.kalman_format  # forced 'botsort'
    use_app = cfg.feature_dim > 0
    slab = slab._replace(frame=slab.frame + 1)

    low_conf = max(0.15, cfg.conf_thresh - 0.3)
    high = dets.valid & (dets.score >= cfg.conf_thresh)
    low = dets.valid & ~high & (dets.score > low_conf)

    pmask = S.pool_mask(slab)
    umask0 = S.unconfirmed_mask(slab)
    slab = S.predict_pool(slab, fmt, pmask)
    slab = A.apply_gmc(slab, dets.warp, pmask | umask0)

    # stage 1: pool vs high @0.9
    cost = _fused_cost(slab, dets, fmt, use_app)
    r2c, c2r = solve_stage1(cost, pmask, high, 0.9)
    slab = S.apply_matches(slab, dets, r2c, fmt, cfg)

    # stages 2 + 3 in one batch-2 solve: stage 2 over all unmatched pool
    # rows vs low @0.5, stage 3 unconfirmed vs u_dets0 @0.7
    u_tracks0 = pmask & (r2c < 0)
    umask = S.unconfirmed_mask(slab)
    u_high = high & (c2r < 0)
    cost2 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    cost3 = _fused_cost(slab, dets, fmt, use_app)
    (r2c2, r2c3), _ = solve_pair((cost2, cost3), (u_tracks0, umask),
                                 (low, u_high), (0.5, 0.7))
    slab = S.apply_matches(slab, dets, r2c2, fmt, cfg)
    slab = S.mark_lost(slab, u_tracks0 & (r2c2 < 0))
    slab = S.apply_matches(slab, dets, r2c3, fmt, cfg)
    slab = S.mark_removed(slab, umask & (r2c3 < 0))

    # births from u_dets0, not after the unconfirmed stage
    new_mask = u_high & (dets.score > cfg.conf_thresh + 0.1)
    slab = S.init_new_tracks(slab, dets, new_mask, fmt, cfg)

    slab = S.prune_lost(slab, cfg.max_time_lost)
    slab = S.remove_duplicates(slab, fmt)
    return slab, S.frame_output(slab, fmt, cfg)
