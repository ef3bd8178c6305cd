"""DeepSORT: the appearance-first cascade tracker (port of
yolov7_tracker_tpu/trackers/deepsort.py; the reference's
tracker/deepsort.py:11-227).

Schedule: 1. matching cascade over the pool (one solve per age level,
``max_time_lost`` levels) on the gated metric: nearest-history cosine
distance, above 0.15 or beyond the Kalman chi2 gate set to 1e5;
2. unmatched Tracked rows vs the leftover dets by IoU at 0.5;
3. unconfirmed vs leftovers by IoU at 0.9, births above conf_thresh (no
+0.1), prune lost, dedup. max_time_lost + 2 solves a frame.

Reference quirk kept: step 4 marks lost the pool members at the
u_tracks0-relative positions (slab.misindexed_lost_mask). Features: a
ring buffer of ``feature_hist`` entries, no EMA.
"""

from __future__ import annotations

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from . import appearance as A
from . import slab as S
from .registry import register


@register("deepsort", feature_dim=512, feature_hist=32,
          use_avg_of_feature=False)
def deepsort_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
                  solve_stage1=None):
    """One frame of one stream or of S stacked streams; ``solve_stage1``
    solves every level of the cascade."""
    fmt = cfg.kalman_format
    slab = slab._replace(frame=slab.frame + 1)
    slab = S.rebase_seq_keys(slab)      # before any key is assigned
    dmask = dets.valid & (dets.score > cfg.conf_thresh)

    pmask = S.pool_mask(slab)
    slab = S.predict_pool(slab, fmt, pmask)
    pool_rank = S.pool_order_rank(slab, pmask)

    # stage 1: gated appearance cascade @0.9
    app = A.nearest_embedding_distance(slab.feat_hist, slab.feat_count,
                                       dets.feature)
    cost = A.gate_cost_matrix(app, slab, dets, fmt)
    r2c, c2r = A.matching_cascade(cost, slab, pmask, dmask, 0.9,
                                  cfg.max_time_lost, solve=solve_stage1)
    was_tracked = slab.state == S.TRACKED
    slab = S.apply_matches(slab, dets, r2c, fmt, cfg, pool_rank=pool_rank,
                           cascade_refind_order=True)

    # stage 2: IoU on unmatched Tracked rows @0.5
    u_tracks0 = pmask & (r2c < 0) & was_tracked
    u_dets0 = dmask & (c2r < 0)
    cost2 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    r2c2, c2r2 = solve_assignment(cost2, u_tracks0, u_dets0, 0.5)
    slab = S.apply_matches(slab, dets, r2c2, fmt, cfg)
    # the reference's mis-indexed lost-marking (deepsort.py:174-177)
    wrong_lost = S.misindexed_lost_mask(slab, pool_rank, u_tracks0,
                                        u_tracks0 & (r2c2 < 0), pmask)
    slab = S.mark_lost_ordered(slab, wrong_lost, pool_rank)

    # stage 3: unconfirmed @0.9
    umask = S.unconfirmed_mask(slab)
    u_dets1 = u_dets0 & (c2r2 < 0)
    cost3 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    r2c3, c2r3 = solve_assignment(cost3, umask, u_dets1, 0.9)
    slab = S.apply_matches(slab, dets, r2c3, fmt, cfg)
    slab = S.mark_removed(slab, umask & (r2c3 < 0))

    # births: score > conf_thresh (deepsort.py:197)
    new_mask = u_dets1 & (c2r3 < 0) & (dets.score > cfg.conf_thresh)
    slab = S.init_new_tracks(slab, dets, new_mask, fmt, cfg)

    slab = S.prune_lost(slab, cfg.max_time_lost)
    slab = S.remove_duplicates(slab, fmt)
    return slab, S.frame_output(slab, fmt, cfg)
