"""DeepMOT: the tracker of the differentiable Hungarian net (port of
yolov7_tracker_tpu/trackers/deepmot.py; the reference's
tracker/deepmot.py:142-324).

Stage 1: the blend of normalised centre distance and IoU distance
``ecu_iou_distance`` over the pool and the high dets, passed through the
DHN (reid/dhn.py) when the tracker has one and matched on 1 - DHN at 0.9;
without a DHN, on the blend itself, as the JAX package does. The DHN sees
the compacted cost, rows in the reference's strack_pool order. Stages 2
and 3 (Tracked leftovers vs low dets by IoU at 0.5, unconfirmed vs
leftover high dets at 0.7) are one batch-2 solve; then births above
conf_thresh + 0.1, prune lost, dedup.

Reference quirk kept: step 4 marks lost the pool members at the
u_tracks0-relative positions (slab.misindexed_lost_mask).

Tracing (utils/trace.py): the span ``tracker.dhn`` around the DHN's
compaction, network and uncompaction, on the row of spans that
``cli/track.py --profile`` writes beside the kernels; it opens in eager
steps only (inside a replayed graph the DHN's kernels run in the graph).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from ..reid import float32_exact
from ..reid import dhn as dhn_mod
from ..utils import trace
from . import slab as S
from .bytetrack import solve_pair
from .registry import register

# The JAX registry never passes img_hw, so the centre-distance normaliser
# is always that of a 1080 x 1920 frame, whatever the frame's size.
IMG_HW = (1080, 1920)


def ecu_iou_distance(slab, dets, fmt, img_hw: Tuple[int, int] = IMG_HW):
    """0.5 * ((1 - exp(-5 * centre distance / frame diagonal)) + IoU
    distance) (matching.py:129-162), over (..., T) tracks x (..., D)
    dets."""
    t_tlwh = S.track_tlwh(slab, fmt)
    d_tlwh = dets.tlwh
    t_c = t_tlwh[..., :2] + 0.5 * t_tlwh[..., 2:]
    d_c = d_tlwh[..., :2] + 0.5 * d_tlwh[..., 2:]
    ecu = torch.linalg.vector_norm(t_c[..., :, None, :] - d_c[..., None, :, :],
                                   dim=-1)
    norm = (img_hw[0] ** 2 + img_hw[1] ** 2) ** 0.5
    ecu = 1.0 - torch.exp(-5.0 * ecu / norm)
    iou = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    return 0.5 * (ecu + iou)


@register("deepmot", capacity=128, det_capacity=48)
def deepmot_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
                 solve_stage1=None, dhn=None):
    """One frame of one stream or of S stacked streams; ``solve_stage1``
    solves stage 1; ``dhn``: the DHN module (reid.dhn.load_dhn) on the
    slab's device, or None for the raw cost."""
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

    # stage 1: ecu + iou -> DHN -> match 1 - DHN @0.9
    cost = ecu_iou_distance(slab, dets, fmt)
    if dhn is not None:
        with trace.span("tracker.dhn", cost):
            comp, rperm, cperm = dhn_mod.compact_cost(cost, pmask, high,
                                                      row_key=pool_rank)
            with torch.no_grad(), float32_exact():
                scores = dhn(comp)
            cost = 1.0 - dhn_mod.uncompact(scores, rperm, cperm)
    r2c, c2r = solve_stage1(cost, pmask, high, 0.9)
    was_tracked = slab.state == S.TRACKED
    slab = S.apply_matches(slab, dets, r2c, fmt, cfg, pool_rank=pool_rank)

    # stages 2 + 3 in one batch-2 solve: both depend only on stage 1
    u_tracks0 = pmask & (r2c < 0) & was_tracked
    umask = S.unconfirmed_mask(slab)
    u_high = high & (c2r < 0)
    cost23 = boxops.iou_distance(S.track_tlbr(slab, fmt), dets.tlbr)
    (r2c2, r2c3), (_, c2r3) = solve_pair(cost23, (u_tracks0, umask),
                                         (low, u_high), (0.5, 0.7))
    slab = S.apply_matches(slab, dets, r2c2, fmt, cfg)
    # the reference's mis-indexed lost-marking (deepmot.py:268-272)
    wrong_lost = S.misindexed_lost_mask(slab, pool_rank, u_tracks0,
                                        u_tracks0 & (r2c2 < 0), pmask)
    slab = S.mark_lost_ordered(slab, wrong_lost, pool_rank)
    slab = S.apply_matches(slab, dets, r2c3, fmt, cfg)
    slab = S.mark_removed(slab, umask & (r2c3 < 0))

    new_mask = u_high & (c2r3 < 0) & (dets.score > cfg.conf_thresh + 0.1)
    slab = S.init_new_tracks(slab, dets, new_mask, fmt, cfg)

    slab = S.prune_lost(slab, cfg.max_time_lost)
    slab = S.remove_duplicates(slab, fmt)
    return slab, S.frame_output(slab, fmt, cfg)
