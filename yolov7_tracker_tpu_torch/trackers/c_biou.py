"""C-BIoU: the Kalman-free buffered-IoU cascade as one slab step (port of
yolov7_tracker_tpu/trackers/c_biou.py; the reference's
tracker/c_biou_tracker.py:17-353).

A track's state lives in the slab's ``extra`` columns: a ring of the last
6 raw tlwh boxes, the observation count and the two motion states
(buffered boxes at b1 = 0.3 and b2 = 0.5, max(0, .) clamped). The motion
state extrapolates ``o_t + (delta/n) (o_t - o_{t-n})`` only on a Tracked
match with time_since_update pending; re_activate takes the plain
buffered box and, as in the reference, keeps time_since_update.

Schedule: level 1 at 0.9 -> level 2 over Tracked leftovers at 0.5 ->
unconfirmed at 0.7 -> births; unmatched Tracked go Lost with
time_since_update = frame - end_frame; Lost tracks are never pruned by
age (the reference has no such sweep). Three solves a frame.
"""

from __future__ import annotations

import torch

from ..ops import boxes as boxops
from ..ops.assignment import solve_assignment
from . import slab as S
from .registry import register

N_BUF = 6  # deque of up to n + 1 = 6 boxes (n = 5)
N = 5
B1, B2 = 0.3, 0.5
EXTRA_DIM = N_BUF * 4 + 1 + 4 + 4  # ring(24) + count(1) + ms1(4) + ms2(4)


def _buf(extra):
    return extra[..., :N_BUF * 4].reshape(extra.shape[:-1] + (N_BUF, 4))


def _count(extra):
    return extra[..., N_BUF * 4].to(torch.int32)


def _ms(extra, level):
    off = N_BUF * 4 + 1 + (0 if level == 1 else 4)
    return extra[..., off:off + 4]


def _pack(buf, count, ms1, ms2):
    return torch.cat([buf.flatten(-2), count.float()[..., None], ms1, ms2],
                     dim=-1)


def _buffered(tlwh, b):
    """get_buffer_bbox with the reference's max(0, .) clamp."""
    return boxops.buffered_tlwh(tlwh, b).clamp(min=0.0)


def _ring_append(buf, count, new):
    """deque append: grow to 6, then shift left."""
    shifted = torch.cat([buf[..., 1:, :], new[..., None, :]], dim=-2)
    at = (torch.arange(N_BUF, device=buf.device)
          == count.clamp(0, N_BUF - 1)[..., None])
    grown = torch.where(at[..., None], new[..., None, :], buf)
    full = count > N
    return (torch.where(full[..., None, None], shifted, grown),
            torch.where(full, count, count + 1))


def _apply_matches_cbiou(slab, dets, row_to_col):
    """update / re_activate of the matched rows."""
    m = row_to_col >= 0
    det_idx = row_to_col.long().clamp(0, dets.tlbr.shape[-2] - 1)
    det_tlwh = torch.take_along_dim(dets.tlwh, det_idx[..., None], dim=-2)
    det_score = torch.take_along_dim(dets.score, det_idx, dim=-1)
    new_buf, new_count = _ring_append(_buf(slab.extra), _count(slab.extra),
                                      det_tlwh)
    was_tracked = slab.state == S.TRACKED
    tsu = slab.time_since_update.float()
    extrapolated = det_tlwh + (tsu[..., None] / N) * (det_tlwh
                                                     - new_buf[..., 0, :])
    use_extrap = (slab.time_since_update > 0) & (new_count >= N)
    motion_src = torch.where(use_extrap[..., None], extrapolated, det_tlwh)
    motion_src = torch.where(was_tracked[..., None], motion_src, det_tlwh)
    new_extra = _pack(new_buf, new_count, _buffered(motion_src, B1),
                      _buffered(motion_src, B2))
    one = torch.ones_like(slab.tracklet_len)
    return slab._replace(
        det_tlwh=torch.where(m[..., None], det_tlwh, slab.det_tlwh),
        score=torch.where(m, det_score, slab.score),
        state=torch.where(m, torch.full_like(slab.state, S.TRACKED),
                          slab.state),
        is_activated=slab.is_activated | m,
        frame_id=torch.where(m, slab.frame[..., None], slab.frame_id),
        tracklet_len=torch.where(
            m, torch.where(was_tracked, slab.tracklet_len + one,
                           torch.zeros_like(one)), slab.tracklet_len),
        # re_activate keeps time_since_update (reference quirk)
        time_since_update=torch.where(m & was_tracked, torch.zeros_like(one),
                                      slab.time_since_update),
        extra=torch.where(m[..., None], new_extra, slab.extra))


def _init_new_cbiou(slab, dets, new_mask, cfg):
    """Births and their fresh buffer state."""
    slab = S.init_new_tracks(slab, dets, new_mask, "none", cfg)
    fresh = (slab.occupied & (slab.start_frame == slab.frame[..., None])
             & (_count(slab.extra) == 0))
    tlwh = slab.det_tlwh
    buf0 = torch.zeros(tlwh.shape[:-1] + (N_BUF, 4), device=tlwh.device)
    buf0[..., 0, :] = tlwh
    extra0 = _pack(buf0, torch.ones_like(slab.tracklet_len),
                   _buffered(tlwh, B1),
                   _buffered(tlwh, B2))
    return slab._replace(
        extra=torch.where(fresh[..., None], extra0, slab.extra))


@register("c_bioutracker", kalman_format="none", extra_dim=EXTRA_DIM)
def c_biou_step(slab: S.TrackSlab, dets: S.DetSlab, cfg: S.TrackerConfig,
                solve_stage1=None):
    """One frame of one stream or of S stacked streams; ``solve_stage1``
    solves level 1."""
    solve_stage1 = solve_stage1 or solve_assignment
    slab = slab._replace(frame=slab.frame + 1)
    dmask = dets.valid & (dets.score > cfg.conf_thresh)
    det_bb1 = boxops.tlwh_to_tlbr(_buffered(dets.tlwh, B1))
    det_bb2 = boxops.tlwh_to_tlbr(_buffered(dets.tlwh, B2))

    # level 1: pool motion_state1 vs det buffer_bbox1 @0.9
    pmask = S.pool_mask(slab)
    ms1 = boxops.tlwh_to_tlbr(_ms(slab.extra, 1))
    cost1 = 1.0 - boxops.iou_matrix(ms1, det_bb1)
    r2c1, c2r1 = solve_stage1(cost1, pmask, dmask, 0.9)
    was_tracked = slab.state == S.TRACKED
    slab = _apply_matches_cbiou(slab, dets, r2c1)

    # level 2: Tracked leftovers vs leftover dets @0.5
    u_tracks0 = pmask & (r2c1 < 0) & was_tracked
    u_dets0 = dmask & (c2r1 < 0)
    ms2 = boxops.tlwh_to_tlbr(_ms(slab.extra, 2))
    cost2 = 1.0 - boxops.iou_matrix(ms2, det_bb2)
    r2c2, c2r2 = solve_assignment(cost2, u_tracks0, u_dets0, 0.5)
    slab = _apply_matches_cbiou(slab, dets, r2c2)

    # unconfirmed vs remaining dets @0.7 (level-1 boxes)
    umask = S.unconfirmed_mask(slab)
    u_dets1 = u_dets0 & (c2r2 < 0)
    ms1b = boxops.tlwh_to_tlbr(_ms(slab.extra, 1))
    cost3 = 1.0 - boxops.iou_matrix(ms1b, det_bb1)
    r2c3, c2r3 = solve_assignment(cost3, umask, u_dets1, 0.7)
    slab = _apply_matches_cbiou(slab, dets, r2c3)
    slab = S.mark_removed(slab, umask & (r2c3 < 0))

    # births
    new_mask = u_dets1 & (c2r3 < 0) & (dets.score > cfg.conf_thresh + 0.1)
    slab = _init_new_cbiou(slab, dets, new_mask, cfg)

    # unmatched Tracked -> Lost (or Removed if stale), tsu = frame -
    # end_frame; no lost-age sweep
    u_tracks1 = u_tracks0 & (r2c2 < 0)
    age = slab.frame[..., None] - slab.frame_id
    slab = S.mark_removed(slab, u_tracks1 & (age > cfg.max_time_lost))
    newly_lost = u_tracks1 & (age <= cfg.max_time_lost)
    slab = slab._replace(
        state=torch.where(newly_lost, torch.full_like(slab.state, S.LOST),
                          slab.state),
        time_since_update=torch.where(newly_lost, age,
                                      slab.time_since_update))
    slab = S.remove_duplicates(slab, "none")
    return slab, S.frame_output(slab, "none", cfg)
