"""StrongSORT: DeepSORT++ with the NSA Kalman filter, ECC camera
compensation and one fused motion + appearance stage (port of
yolov7_tracker_tpu/trackers/strongsort.py; the reference's
tracker/strongsort.py:20-250).

Schedule: 1. the frame's warp on the pool BEFORE the predict (unlike
BoT-SORT); 2. gamma * IoU + (1 - gamma) * euclidean embedding distance
over the pool at 0.7 (gamma 0.1; the NSA filter scales the measurement
noise by 1 - score); 3. unmatched Tracked rows vs leftovers by IoU at
0.5; 4. unconfirmed vs leftovers on the fused cost at 0.7, births above
conf_thresh + 0.1, prune lost, dedup. Three solves a frame.

Track features are EMA-smoothed; the distance is plain euclidean on the
det features' raw magnitude, as in the reference. Quirk kept: the
mis-indexed step-4 lost-marking (slab.misindexed_lost_mask).
"""

from __future__ import annotations

import torch

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from . import appearance as A
from . import slab as S
from .registry import register


def _fused(slab, dets, fmt, gamma):
    iou = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    emb = A.euclidean_distance(slab.feature, dets.feature)
    return gamma * iou + (1.0 - gamma) * emb


@register("strongsort", feature_dim=512)
def strongsort_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
                    solve_stage1=None):
    """One frame of one stream or of S stacked streams; ``solve_stage1``
    solves stage 1."""
    solve_stage1 = solve_stage1 or solve_assignment
    fmt = cfg.kalman_format  # forced 'strongsort' (NSA)
    slab = slab._replace(frame=slab.frame + 1)
    slab = S.rebase_seq_keys(slab)      # before any key is assigned
    dmask = dets.valid & (dets.score > cfg.conf_thresh)

    pmask = S.pool_mask(slab)
    slab = A.apply_gmc(slab, dets.warp, pmask)  # ECC before predict
    slab = S.predict_pool(slab, fmt, pmask)
    pool_rank = S.pool_order_rank(slab, pmask)

    # stage 1: fused motion + appearance @0.7
    cost = _fused(slab, dets, fmt, cfg.gamma)
    cost = torch.where(dmask[..., None, :], cost, torch.full_like(cost, 1e9))
    r2c, c2r = solve_stage1(cost, pmask, dmask, 0.7)
    was_tracked = slab.state == S.TRACKED
    slab = S.apply_matches(slab, dets, r2c, fmt, cfg, pool_rank=pool_rank)

    # stage 2: IoU @0.5 over unmatched Tracked rows
    u_tracks0 = pmask & (r2c < 0) & was_tracked
    u_dets0 = dmask & (c2r < 0)
    cost2 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    r2c2, c2r2 = solve_assignment(cost2, u_tracks0, u_dets0, 0.5)
    slab = S.apply_matches(slab, dets, r2c2, fmt, cfg)
    # the reference's mis-indexed lost-marking (strongsort.py:194-197)
    wrong_lost = S.misindexed_lost_mask(slab, pool_rank, u_tracks0,
                                        u_tracks0 & (r2c2 < 0), pmask)
    slab = S.mark_lost_ordered(slab, wrong_lost, pool_rank)

    # stage 3: unconfirmed with the fused cost @0.7
    umask = S.unconfirmed_mask(slab)
    u_dets1 = u_dets0 & (c2r2 < 0)
    cost3 = _fused(slab, dets, fmt, cfg.gamma)
    r2c3, c2r3 = solve_assignment(cost3, umask, u_dets1, 0.7)
    slab = S.apply_matches(slab, dets, r2c3, fmt, cfg)
    slab = S.mark_removed(slab, umask & (r2c3 < 0))

    new_mask = u_dets1 & (c2r3 < 0) & (dets.score > cfg.conf_thresh + 0.1)
    slab = S.init_new_tracks(slab, dets, new_mask, fmt, cfg)

    slab = S.prune_lost(slab, cfg.max_time_lost)
    slab = S.remove_duplicates(slab, fmt)
    return slab, S.frame_output(slab, fmt, cfg)
