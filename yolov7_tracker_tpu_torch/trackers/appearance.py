"""Appearance and motion costs of the ReID trackers (port of
yolov7_tracker_tpu/trackers/appearance.py): cosine and euclidean
embedding distances, the nearest-history distance, DeepSORT's Kalman
gate, the age-layered matching cascade, the GMC warp of Kalman states and
UAVMOT's local-structure similarity.

Each function also takes stacked inputs (S streams on leading axes, as
trackers/slab.py does). The embedding distances accumulate in float64 and
return float32 (slab.l2norm says why).
"""

from __future__ import annotations

import math

import torch

from ..ops import kalman
from ..ops.assignment import cascade_levels, solve_cascade
from . import slab as S

CHI2INV95_4 = 9.4877  # kalman_filter.py:11-20, 4 dof
GATED_COST = 1e5


def _t(x):
    return x.transpose(-1, -2)


def cosine_distance(track_feats, det_feats):
    """1 - cosine similarity, both sides row-normalised (matching.py:
    165-178). (..., T, F) x (..., D, F) -> (..., T, D)."""
    return (1.0 - S.l2norm(track_feats) @ _t(S.l2norm(det_feats))).float()


def euclidean_distance(track_feats, det_feats):
    """Pairwise euclidean distance, the square clipped at 0
    (matching.py:97-98)."""
    a, b = track_feats.double(), det_feats.double()
    d2 = ((a ** 2).sum(-1)[..., :, None] - 2.0 * a @ _t(b)
          + (b ** 2).sum(-1)[..., None, :])
    return torch.sqrt(d2.clamp(min=0.0)).float()


def appearance_product(track_feats, det_feats):
    """f . f' of every (track, det) pair, summed in float64."""
    return (track_feats.double() @ _t(det_feats.double())).float()


def nearest_embedding_distance(feat_hist, feat_count, det_feats):
    """Least cosine distance over each track's stored features
    (matching.py:105-127): feat_hist (..., T, H, F), feat_count (..., T),
    det_feats (..., D, F) -> (..., T, D); inf for a track with none."""
    h = feat_hist.shape[-2]
    sims = torch.einsum("...thf,...df->...thd", S.l2norm(feat_hist),
                        S.l2norm(det_feats)).float()
    slot_valid = (torch.arange(h, device=feat_count.device)
                  < feat_count.clamp(max=h)[..., None])
    sims = torch.where(slot_valid[..., None], sims,
                       torch.full_like(sims, -math.inf))
    return 1.0 - sims.amax(dim=-2)


def gate_cost_matrix(cost, slab: S.TrackSlab, dets: S.DetSlab, fmt: str,
                     max_appearance_thresh: float = 0.15):
    """DeepSORT's gate (deepsort.py:42-66): appearance cost above 0.15,
    or a Mahalanobis distance to the xyah measurement above the chi2 95%
    quantile, becomes GATED_COST."""
    meas = kalman.measurement_from_tlwh("default", dets.tlwh)
    gd = kalman.gating_distance(fmt, slab.mean, slab.cov, meas)
    gated = torch.full_like(cost, GATED_COST)
    cost = torch.where(cost > max_appearance_thresh, gated, cost)
    return torch.where(gd > CHI2INV95_4, gated, cost)


def matching_cascade(cost, slab: S.TrackSlab, row_mask, col_mask,
                     thresh: float, depth: int, solve=None):
    """Age-layered assignment (matching.py:216-277): level l matches the
    tracks with time_since_update == 1 + l against the detections still
    unmatched. Every one of the ``depth`` levels is solved, empty or not
    (the JAX package's lax.scan; no host test). With ``solve`` None every
    level is the trackers' solver, all in one call of
    ops/assignment.solve_cascade (one kernel launch on the card); a
    ``solve`` given is called level by level. Returns (row_to_col,
    col_to_row)."""
    if solve is None:
        return solve_cascade(cost, row_mask, col_mask,
                             slab.time_since_update, thresh, depth)
    return cascade_levels(cost, row_mask, col_mask, slab.time_since_update,
                          thresh, depth, solve)


def _turn_pairs(r, x, axis: int):
    """Apply the 2x2 matrices r (..., 2, 2) to the consecutive pairs of x
    along ``axis`` (negative), i.e. multiply x by kron(I4, r) there,
    written out as the 2-term sums XLA computes for the JAX package's
    product (the two agree bit for bit)."""
    pairs = x.unflatten(axis, (x.shape[axis] // 2, 2))
    a, b = pairs.select(axis, 0), pairs.select(axis, 1)
    expand = (None,) * (a.dim() - r.dim() + 2)
    r = r[(..., 0, 0) + expand], r[(..., 0, 1) + expand], \
        r[(..., 1, 0) + expand], r[(..., 1, 1) + expand]
    return torch.stack([r[0] * a + r[1] * b, r[2] * a + r[3] * b],
                       dim=axis).flatten(axis - 1, axis)


def apply_gmc(slab: S.TrackSlab, warp, mask) -> S.TrackSlab:
    """A (..., 2, 3) affine camera warp on the Kalman states of the masked
    slots (botsort.py multi_gmc:250-269): R8 = kron(I4, R),
    mean' = R8 mean + [t, 0, ...], cov' = R8 cov R8^T."""
    warp = warp.to(device=slab.mean.device, dtype=torch.float32)
    r = warp[..., None, :2, :2]                   # one warp for all slots
    mean = _turn_pairs(r, slab.mean, -1)
    mean = torch.cat([mean[..., :2] + warp[..., None, :2, 2],
                      mean[..., 2:]], dim=-1)
    cov = _turn_pairs(r, _turn_pairs(r, slab.cov, -2), -1)
    return slab._replace(
        mean=torch.where(mask[..., None], mean, slab.mean),
        cov=torch.where(mask[..., None, None], cov, slab.cov))


def structure_similarity(xy, valid, local_r: float = 400.0):
    """UAVMOT's local-topology vector per target (matching.py:344-386):
    [farthest neighbour distance, nearest neighbour distance, included
    angle in integer degrees] over the neighbours within local_r, with
    the reference's 1e-4 fallbacks. xy (..., N, 2), valid (..., N) ->
    (..., N, 3)."""
    diff = xy[..., :, None, :] - xy[..., None, :, :]
    d = torch.linalg.vector_norm(diff, dim=-1)
    ok = (valid[..., None, :] & valid[..., :, None] & (d > 0)
          & (d < local_r))
    neg = torch.where(ok, d, torch.full_like(d, -math.inf))
    pos = torch.where(ok, d, torch.full_like(d, math.inf))
    max_len, max_idx = neg.max(dim=-1)
    min_len, min_idx = pos.min(dim=-1)
    has = torch.isfinite(max_len)

    def int_deg(idx):
        v = torch.take_along_dim(xy, idx[..., None], dim=-2) - xy
        return torch.trunc(torch.atan2(v[..., 1], v[..., 0])
                           * (180.0 / math.pi))

    a1, a2 = int_deg(max_idx), int_deg(min_idx)
    same_sign = a1 * a2 >= 0
    inc = torch.where(same_sign, (a1 - a2).abs(), a1.abs() + a2.abs())
    inc = torch.where(~same_sign & (inc > 180.0), 360.0 - inc, inc)
    angle = torch.where(has & (max_len == min_len),
                        torch.full_like(inc, 1e-4), inc)
    small = torch.full_like(max_len, 1e-4)
    return torch.stack([torch.where(has, max_len, small),
                        torch.where(has, min_len, small),
                        torch.where(has, angle, small)], dim=-1)


def structure_distance(track_xy, track_valid, det_xy, det_valid):
    """Cosine distance between structure vectors, clipped at 0
    (matching.py:311-320)."""
    a = structure_similarity(track_xy, track_valid)
    b = structure_similarity(det_xy, det_valid)
    return (1.0 - S.l2norm(a) @ _t(S.l2norm(b))).clamp(min=0.0).float()
