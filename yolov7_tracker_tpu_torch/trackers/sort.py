"""SORT: the base association schedule as one slab step (port of
yolov7_tracker_tpu/trackers/sort.py; the reference's BaseTracker.update,
tracker/basetrack.py:368-487).

Per frame: 1. gate detections at conf_thresh; 2. KF-predict the pool
(activated Tracked + Lost) and match it by IoU at iou_thresh;
3. unmatched Tracked pool members go Lost; 4. unconfirmed tracks against
the leftover detections at iou_thresh + 0.1, unmatched ones removed;
5. births above conf_thresh + 0.1; 6. prune old Lost tracks, dedup.
Two solves (K2 launches on the card) a frame.
"""

from __future__ import annotations

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from . import slab as S
from .registry import register


@register("sort")
def sort_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
              solve_stage1=None):
    """One frame of one stream, or of S stacked streams. ``solve_stage1``
    solves stage 1: the private-dummy auction (``solve_assignment``) by
    default; the streaming entry points pass the square auction."""
    solve_stage1 = solve_stage1 or solve_assignment
    fmt = cfg.kalman_format
    slab = slab._replace(frame=slab.frame + 1)
    dmask = dets.valid & (dets.score > cfg.conf_thresh)

    # stage 1: pool association
    pmask = S.pool_mask(slab)
    slab = S.predict_pool(slab, fmt, pmask)
    cost = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    r2c, c2r = solve_stage1(cost, pmask, dmask, cfg.iou_thresh)
    slab = S.apply_matches(slab, dets, r2c, fmt, cfg)
    slab = S.mark_lost(slab, pmask & (r2c < 0) & (slab.state == S.TRACKED))

    # stage 2: unconfirmed vs leftover dets at a looser threshold
    umask = S.unconfirmed_mask(slab)
    u_dets = dmask & (c2r < 0)
    cost2 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    r2c2, c2r2 = solve_assignment(cost2, umask, u_dets, cfg.iou_thresh + 0.1)
    slab = S.apply_matches(slab, dets, r2c2, fmt, cfg)
    slab = S.mark_removed(slab, umask & (r2c2 < 0))

    # stage 3: births
    new_mask = u_dets & (c2r2 < 0) & (dets.score > cfg.conf_thresh + 0.1)
    slab = S.init_new_tracks(slab, dets, new_mask, fmt, cfg)

    # stage 4: pruning + dedup
    slab = S.prune_lost(slab, cfg.max_time_lost)
    slab = S.remove_duplicates(slab, fmt)
    return slab, S.frame_output(slab, fmt, cfg)
