"""ByteTrack: two-stage high/low-confidence association as one slab step
(port of yolov7_tracker_tpu/trackers/bytetrack.py).

Stages: 1. pool (activated Tracked + Lost) vs high dets at 0.9 (with
``feature_dim > 0`` on gamma * IoU + (1 - gamma) * (1 - f.f'));
2. Tracked leftovers vs low dets at 0.5; 3. unconfirmed tracks vs
leftover high dets at 0.7 (2 and 3 solved as ONE batch-2 auction launch,
the JAX package's vmapped pair); 4. births; 5. prune and dedup.

The step also takes a stacked slab and DetSlab (S streams on a leading
axis, trackers/slab.py): stage 1 is then one S-problem solve and stages
2 + 3 one 2S-problem launch.
"""

from __future__ import annotations

import torch

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from . import slab as S
from .appearance import appearance_product
from .registry import register


def solve_pair(cost, rows, cols, thresh):
    """Two independent problems in ONE K4 launch (the JAX package's
    vmapped pair): ``cost`` is one (..., T, D) matrix for both or a
    tuple of two; ``rows`` / ``cols`` pairs of masks; ``thresh`` a pair.
    Stacked streams make 2S problems. Returns ((r2c_a, r2c_b),
    (c2r_a, c2r_b))."""
    rows = torch.stack(rows, dim=-2)                    # (..., 2, T)
    cols = torch.stack(cols, dim=-2)                    # (..., 2, D)
    if isinstance(cost, tuple):
        cost = torch.stack(cost, dim=-3)
    elif cost.dim() > 2:
        # stacked streams: each stream's cost matrix serves its pair
        cost = cost.unsqueeze(-3).expand(rows.shape[:-1] + cost.shape[-2:])
    if cost.dim() > 2:
        cost = cost.flatten(0, -3)
    r2c, c2r = solve_assignment(cost, rows.flatten(0, -2),
                                cols.flatten(0, -2), thresh)
    r2c, c2r = r2c.view(rows.shape), c2r.view(cols.shape)
    return (r2c[..., 0, :], r2c[..., 1, :]), (c2r[..., 0, :], c2r[..., 1, :])


@register("bytetrack")
def bytetrack_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
                   solve_stage1=None):
    """One frame of one stream, or of S stacked streams. ``solve_stage1``
    solves the pool-vs-high-dets problem: the private-dummy auction
    (``solve_assignment``) by default; the streaming modes pass the exact
    square auction (trackers/registry.stream_step)."""
    if solve_stage1 is None:
        solve_stage1 = solve_assignment
    fmt = cfg.kalman_format
    slab = slab._replace(frame=slab.frame + 1)

    low_conf = max(0.15, cfg.conf_thresh - 0.3)
    high = dets.valid & (dets.score >= cfg.conf_thresh)
    low = dets.valid & ~high & (dets.score > low_conf)

    # stage 1: pool vs high dets @0.9
    pmask = S.pool_mask(slab)
    slab = S.predict_pool(slab, fmt, pmask)
    cost = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    if cfg.feature_dim > 0:
        # appearance fusion gamma * IoU + (1 - gamma) * (1 - f.f')
        # (bytetrack.py:109-116)
        app = 1.0 - appearance_product(slab.feature, dets.feature)
        cost = cfg.gamma * cost + (1.0 - cfg.gamma) * app
    r2c, c2r = solve_stage1(cost, pmask, high, 0.9)
    was_tracked = slab.state == S.TRACKED
    slab = S.apply_matches(slab, dets, r2c, fmt, cfg)

    # stages 2 + 3 in one batch-2 solve: their rows are disjoint from
    # every row updated in stages 1-2, so both see the post-stage-1 IoU
    cost23 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    u_tracks0 = pmask & (r2c < 0) & was_tracked
    umask = S.unconfirmed_mask(slab)
    u_high = high & (c2r < 0)
    (r2c2, r2c3), (_, c2r3) = solve_pair(cost23, (u_tracks0, umask),
                                         (low, u_high), (0.5, 0.7))
    slab = S.apply_matches(slab, dets, r2c2, fmt, cfg)
    slab = S.mark_lost(slab, u_tracks0 & (r2c2 < 0))
    slab = S.apply_matches(slab, dets, r2c3, fmt, cfg)
    slab = S.mark_removed(slab, umask & (r2c3 < 0))

    # stage 4: births
    new_mask = u_high & (c2r3 < 0) & (dets.score > cfg.conf_thresh + 0.1)
    slab = S.init_new_tracks(slab, dets, new_mask, fmt, cfg)

    # stage 5
    slab = S.prune_lost(slab, cfg.max_time_lost)
    slab = S.remove_duplicates(slab, fmt)
    return slab, S.frame_output(slab, fmt, cfg)
