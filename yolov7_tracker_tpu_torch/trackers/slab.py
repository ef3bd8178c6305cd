"""The track slab: fixed-capacity tracker state as a NamedTuple of tensors
(port of yolov7_tracker_tpu/trackers/slab.py).

Field names and shapes match the JAX TrackSlab, so a slab round-trips
through the same npz checkpoint layout. Every lifecycle event is a masked
update over the (T,) slot axis, so a tracker step is one function
``(slab, det_slab) -> (slab, frame_output)`` with no host sync.

Every helper also takes a STACKED slab and DetSlab, each field with the
same leading axes (the S streams of multistream serving: mean (S, T, 8),
next_id (S,), ...), and treats the streams independently; the shapes in
the comments below are those of one stream. This is the JAX package's
``jax.vmap`` of the step, written out.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import boxes as boxops
from ..ops import kalman

# TrackState (basetrack.py:14-18)
NEW, TRACKED, LOST, REMOVED = 0, 1, 2, 3

# the (2, 3) affine camera warp of a frame without GMC; a DetSlab built
# positionally without a warp carries it on the CPU, and the package's own
# builders make it on the detections' device (identity_warp)
IDENTITY_WARP = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


def identity_warp(device=None) -> torch.Tensor:
    """IDENTITY_WARP made on ``device``: a fill there, no host-to-device
    copy (which would be a host sync inside the tracker step)."""
    return torch.eye(2, 3, device=device)


class TrackSlab(NamedTuple):
    mean: torch.Tensor              # (T, 8) KF mean
    cov: torch.Tensor               # (T, 8, 8) KF covariance
    det_tlwh: torch.Tensor          # (T, 4) raw detection tlwh at last update
    score: torch.Tensor             # (T,)
    cls: torch.Tensor               # (T,)
    state: torch.Tensor             # (T,) int32 TrackState
    occupied: torch.Tensor          # (T,) bool
    is_activated: torch.Tensor      # (T,) bool
    track_id: torch.Tensor          # (T,) int32
    frame_id: torch.Tensor          # (T,) int32 last-updated frame
    start_frame: torch.Tensor       # (T,) int32
    tracklet_len: torch.Tensor      # (T,) int32
    time_since_update: torch.Tensor  # (T,) int32
    feature: torch.Tensor           # (T, F)
    feat_hist: torch.Tensor         # (T, H, F)
    feat_count: torch.Tensor        # (T,) int32
    extra: torch.Tensor             # (T, E)
    # the reference's list-order keys (deepsort, strongsort and uavmot
    # only; see pool_order_rank): ins_seq orders tracked_stracks, lost_seq
    # lost_stracks
    ins_seq: torch.Tensor           # (T,) int32
    lost_seq: torch.Tensor          # (T,) int32
    next_id: torch.Tensor           # () int32
    frame: torch.Tensor             # () int32

    @property
    def capacity(self) -> int:
        return self.score.shape[-1]


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static tracker options (the same fields as the JAX TrackerConfig)."""

    tracker: str = "sort"
    kalman_format: str = "default"
    conf_thresh: float = 0.2
    iou_thresh: float = 0.5
    track_buffer: int = 30
    frame_rate: int = 30
    capacity: int = 256
    det_capacity: int = 128
    feature_dim: int = 0
    feature_hist: int = 0
    use_avg_of_feature: bool = True
    extra_dim: int = 0
    gamma: float = 0.1
    min_area: float = 150.0
    dhn_weights: str = ""
    dhn_hidden: int = 256
    dhn_arch: str = "gru"

    @property
    def max_time_lost(self) -> int:
        return int(self.frame_rate / 30.0 * self.track_buffer)


class DetSlab(NamedTuple):
    """Padded per-frame detections, their ReID features and the frame's
    camera-motion warp. A (2, 3) warp also serves stacked streams."""

    tlbr: torch.Tensor     # (D, 4)
    score: torch.Tensor    # (D,)
    cls: torch.Tensor      # (D,)
    valid: torch.Tensor    # (D,) bool
    feature: torch.Tensor  # (D, F)
    warp: torch.Tensor = IDENTITY_WARP  # (2, 3) affine, identity = no GMC

    @property
    def tlwh(self):
        return boxops.tlbr_to_tlwh(self.tlbr)


def init_slab(cfg: TrackerConfig, device) -> TrackSlab:
    t, f, h = cfg.capacity, cfg.feature_dim, cfg.feature_hist
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackSlab(
        mean=torch.zeros((t, 8), **f32),
        cov=torch.eye(8, **f32).repeat(t, 1, 1),
        det_tlwh=torch.zeros((t, 4), **f32),
        score=torch.zeros((t,), **f32),
        cls=torch.zeros((t,), **f32),
        state=torch.full((t,), REMOVED, **i32),
        occupied=torch.zeros((t,), dtype=torch.bool, device=device),
        is_activated=torch.zeros((t,), dtype=torch.bool, device=device),
        track_id=torch.zeros((t,), **i32),
        frame_id=torch.zeros((t,), **i32),
        start_frame=torch.zeros((t,), **i32),
        tracklet_len=torch.zeros((t,), **i32),
        time_since_update=torch.zeros((t,), **i32),
        feature=torch.zeros((t, f), **f32),
        feat_hist=torch.zeros((t, h, f), **f32),
        feat_count=torch.zeros((t,), **i32),
        extra=torch.zeros((t, cfg.extra_dim), **f32),
        ins_seq=torch.zeros((t,), **i32),
        lost_seq=torch.zeros((t,), **i32),
        next_id=torch.zeros((), **i32),
        frame=torch.zeros((), **i32),
    )


def make_det_slab(cfg: TrackerConfig, tlbr, score, cls, valid,
                  device, feature=None, warp=None) -> DetSlab:
    """Pad (or cut) per-frame detections (and features) to the slab's
    det_capacity."""
    d = cfg.det_capacity

    def pad(x, dtype, fill=0):
        x = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)[:d]
        out = torch.full((d,) + tuple(x.shape[1:]), fill, dtype=dtype,
                         device=device)
        out[:x.shape[0]] = x
        return out

    return DetSlab(
        tlbr=pad(np.asarray(tlbr, np.float32).reshape(-1, 4), torch.float32),
        score=pad(score, torch.float32),
        cls=pad(cls, torch.float32),
        valid=pad(valid, torch.bool, False),
        feature=(torch.zeros((d, cfg.feature_dim), dtype=torch.float32,
                             device=device) if feature is None
                 else pad(np.asarray(feature, np.float32).reshape(
                     -1, cfg.feature_dim), torch.float32)),
        warp=(identity_warp(device) if warp is None else torch.as_tensor(
            np.asarray(warp, np.float32), device=device)),
    )


# ---------------------------------------------------------------------------
# masked views
# ---------------------------------------------------------------------------

def track_tlwh(slab: TrackSlab, fmt: str):
    if fmt == "none":
        return slab.det_tlwh
    kf_tlwh = kalman.tlwh_from_mean(fmt, slab.mean)
    return torch.where(slab.occupied[..., None], kf_tlwh, slab.det_tlwh)


def track_tlbr(slab: TrackSlab, fmt: str):
    return boxops.tlwh_to_tlbr(track_tlwh(slab, fmt))


def pool_mask(slab: TrackSlab):
    """strack_pool = activated Tracked + Lost."""
    return slab.occupied & (
        ((slab.state == TRACKED) & slab.is_activated) | (slab.state == LOST))


def unconfirmed_mask(slab: TrackSlab):
    return slab.occupied & (slab.state == TRACKED) & ~slab.is_activated


# ---------------------------------------------------------------------------
# the reference's list order (deepsort, strongsort and uavmot only)
#
# Their step 4 marks lost ``strack_pool[idx]`` for idx in positions of the
# filtered u_tracks0 list (deepsort.py:174-177, strongsort.py:198-201,
# uavmot.py:227-230), so which tracks go lost depends on the ORDER of the
# reference's tracked_stracks and lost_stracks lists. ins_seq and lost_seq
# are those orders as keys.
# ---------------------------------------------------------------------------

def _rank(key):
    """Dense ranks of key along the slot axis (stable: ties by slot)."""
    order = torch.argsort(key, dim=-1, stable=True)
    ranks = torch.arange(key.shape[-1], dtype=torch.int32,
                         device=key.device).expand(key.shape)
    return torch.empty(key.shape, dtype=torch.int32,
                       device=key.device).scatter_(-1, order, ranks)


def rebase_seq_keys(slab: TrackSlab) -> TrackSlab:
    """Compress ins_seq/lost_seq to their ranks (order kept, values in
    [0, T)), once per frame before any key is assigned, so that the keys
    never grow with the frame counter (int32 would wrap after ~125k
    frames and corrupt the order)."""
    return slab._replace(ins_seq=_rank(slab.ins_seq),
                         lost_seq=_rank(slab.lost_seq))


def _seq_base(slab: TrackSlab) -> int:
    """Base of this frame's keys: above every rebased key. Births take
    base + det slot (< D), refinds base + D + level * T + pool rank, the
    reference's append order."""
    return slab.capacity


def pool_order_rank(slab: TrackSlab, pmask):
    """(T,) rank of each slot in the reference's strack_pool order:
    tracked_stracks (ascending ins_seq), then lost_stracks (ascending
    lost_seq); slots outside the pool rank after all pool members."""
    is_lost = slab.state == LOST
    key = torch.where(is_lost, slab.lost_seq, slab.ins_seq).long()
    group = (~pmask).long() * 2 + is_lost.long()
    return _rank((group << 32) + key)


def misindexed_lost_mask(slab: TrackSlab, pool_rank, u0_mask,
                         unmatched2_mask, pmask):
    """The pool members the reference's step 4 marks lost: those at the
    POOL positions equal to the u_tracks0 positions of the tracks left
    unmatched by stage 2 (u0_mask: the u_tracks0 members; unmatched2_mask:
    the ones stage 2 left unmatched)."""
    t = slab.capacity
    rank = pool_rank.long()
    u0_by_rank = torch.zeros_like(u0_mask).scatter_(-1, rank, u0_mask)
    u0_int = u0_by_rank.long()
    pos = (torch.cumsum(u0_int, -1) - u0_int).gather(-1, rank)
    tgt = torch.zeros(u0_mask.shape[:-1] + (t + 1,), dtype=torch.bool,
                      device=u0_mask.device)
    tgt.scatter_(-1, torch.where(unmatched2_mask, pos, t),
                 torch.ones_like(u0_mask))
    return pmask & tgt[..., :t].gather(-1, rank)


def mark_lost_ordered(slab: TrackSlab, mask, pool_rank) -> TrackSlab:
    """mark_lost, and the lost-list key: newly lost tracks append in
    ascending pool position."""
    base = _seq_base(slab)
    return slab._replace(
        state=torch.where(mask, torch.full_like(slab.state, LOST),
                          slab.state),
        lost_seq=torch.where(mask, base + pool_rank, slab.lost_seq))


# ---------------------------------------------------------------------------
# lifecycle ops (all masked)
# ---------------------------------------------------------------------------

def predict_pool(slab: TrackSlab, fmt: str,
                 mask: Optional[torch.Tensor] = None) -> TrackSlab:
    """KF multi_predict over the pool + time_since_update bump."""
    if mask is None:
        mask = pool_mask(slab)
    mean = kalman.zero_stale_velocity(fmt, slab.mean, slab.state == TRACKED)
    new_mean, new_cov = kalman.predict(fmt, mean, slab.cov)
    return slab._replace(
        mean=torch.where(mask[..., None], new_mean, slab.mean),
        cov=torch.where(mask[..., None, None], new_cov, slab.cov),
        time_since_update=torch.where(mask, slab.time_since_update + 1,
                                      slab.time_since_update),
    )


def l2norm(x, eps=1e-12):
    """Rows normalised, in float64: a float32 sum over 512 features rounds
    differently on the card and on the CPU, and near-equal appearance
    costs (look-alike crops) would then pair differently; float64 sums
    round to the same float32. The stored features and the embedding
    distances (trackers/appearance.py) both use it."""
    x = x.double()
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def apply_matches(slab: TrackSlab, dets: DetSlab, row_to_col, fmt: str,
                  cfg: TrackerConfig, pool_rank=None,
                  cascade_refind_order: bool = False) -> TrackSlab:
    """Commit matched (track, det) pairs: STrack.update for Tracked rows,
    STrack.re_activate for Lost rows (tracklet_len restarts at 0).

    Features: the det feature is L2-normalised, then EMA-smoothed (0.9 /
    0.1, renormalised) with ``use_avg_of_feature`` or else taken as is,
    and appended to the ring buffer of ``feature_hist`` entries.
    ``pool_rank`` (list-order trackers only): refinds re-enter the tracked
    list at its tail, after this frame's births; a matching cascade
    (``cascade_refind_order``) appends them level by level."""
    upd = row_to_col >= 0
    det_idx = row_to_col.long().clamp(0, dets.tlbr.shape[-2] - 1)
    det_tlwh = torch.take_along_dim(dets.tlwh, det_idx[..., None], dim=-2)
    det_score = torch.take_along_dim(dets.score, det_idx, dim=-1)
    meas = kalman.measurement_from_tlwh(fmt, det_tlwh)
    conf = None
    if kalman.SPECS[fmt].nsa:
        # re_activate calls the NSA update without the det score
        conf = torch.where(slab.state == TRACKED, det_score,
                           torch.zeros_like(slab.score))
    new_mean, new_cov = kalman.update(fmt, slab.mean, slab.cov, meas, conf)
    was_tracked = slab.state == TRACKED
    one = torch.ones_like(slab.tracklet_len)
    feature, feat_hist, feat_count = (slab.feature, slab.feat_hist,
                                      slab.feat_count)
    if cfg.feature_dim > 0:
        det_feat = torch.take_along_dim(dets.feature, det_idx[..., None],
                                        dim=-2)
        fmask = upd & (det_feat.abs().sum(-1) > 0)
        det_feat_n = l2norm(det_feat).float()
        if cfg.use_avg_of_feature:
            smooth = l2norm(0.9 * slab.feature + 0.1 * det_feat_n).float()
        else:
            smooth = det_feat_n
        feature = torch.where(fmask[..., None], smooth, slab.feature)
        if cfg.feature_hist > 0:
            pos = slab.feat_count % cfg.feature_hist
            at = (torch.arange(cfg.feature_hist, device=pos.device)
                  == pos[..., None]) & fmask[..., None]
            feat_hist = torch.where(at[..., None], det_feat_n[..., None, :],
                                    slab.feat_hist)
            feat_count = torch.where(fmask, slab.feat_count + one,
                                     slab.feat_count)
    ins_seq = slab.ins_seq
    if pool_rank is not None:
        d_cap = dets.tlbr.shape[-2]
        level = (slab.time_since_update.clamp(0, cfg.max_time_lost + 1)
                 if cascade_refind_order else 0)
        ins_seq = torch.where(
            upd & ~was_tracked,
            _seq_base(slab) + d_cap + level * slab.capacity
            + pool_rank, slab.ins_seq)
    return slab._replace(
        mean=torch.where(upd[..., None], new_mean, slab.mean),
        cov=torch.where(upd[..., None, None], new_cov, slab.cov),
        det_tlwh=torch.where(upd[..., None], det_tlwh, slab.det_tlwh),
        score=torch.where(upd, det_score, slab.score),
        ins_seq=ins_seq,
        state=torch.where(upd, torch.full_like(slab.state, TRACKED),
                          slab.state),
        is_activated=slab.is_activated | upd,
        frame_id=torch.where(upd, slab.frame[..., None], slab.frame_id),
        tracklet_len=torch.where(
            upd, torch.where(was_tracked, slab.tracklet_len + one,
                             torch.zeros_like(one)), slab.tracklet_len),
        time_since_update=torch.where(upd, torch.zeros_like(one),
                                      slab.time_since_update),
        feature=feature,
        feat_hist=feat_hist,
        feat_count=feat_count,
    )


def mark_lost(slab: TrackSlab, mask) -> TrackSlab:
    return slab._replace(
        state=torch.where(mask, torch.full_like(slab.state, LOST),
                          slab.state))


def mark_removed(slab: TrackSlab, mask) -> TrackSlab:
    """Removed slots are freed for reuse."""
    return slab._replace(
        state=torch.where(mask, torch.full_like(slab.state, REMOVED),
                          slab.state),
        occupied=slab.occupied & ~mask,
        is_activated=slab.is_activated & ~mask,
    )


def init_new_tracks(slab: TrackSlab, dets: DetSlab, new_mask, fmt: str,
                    cfg: TrackerConfig) -> TrackSlab:
    """Activate new tracks: the k-th new det (in det order) takes the k-th
    free slot and id next_id + 1 + k; overflow past the free slots drops."""
    lead = new_mask.shape[:-1]          # () or the stream axes
    d = new_mask.shape[-1]
    t = slab.capacity
    dev = new_mask.device
    free = ~slab.occupied
    det_rank = torch.cumsum(new_mask.int(), -1) - 1
    free_rank = torch.cumsum(free.int(), -1) - 1
    n_free = free.int().sum(-1, keepdim=True)
    # slot_for_rank[k] = the k-th free slot; occupied slots write to a
    # spare entry t that is cut off
    slot_for_rank = torch.full(lead + (t + 1,), t, dtype=torch.long,
                               device=dev)
    slot_for_rank.scatter_(
        -1, torch.where(free, free_rank, t).long(),
        torch.arange(t, device=dev).expand(lead + (t,)))
    placeable = new_mask & (det_rank < n_free)
    target = torch.where(
        placeable,
        slot_for_rank.gather(-1, det_rank.clamp(0, t - 1).long()), t)

    det_tlwh = dets.tlwh
    if fmt == "none":
        mean0 = torch.zeros(lead + (d, 8), dtype=torch.float32, device=dev)
        cov0 = torch.eye(8, dtype=torch.float32, device=dev).expand(
            lead + (d, 8, 8))
    else:
        mean0, cov0 = kalman.initiate(
            fmt, kalman.measurement_from_tlwh(fmt, det_tlwh))
    ids = slab.next_id[..., None] + 1 + det_rank
    slot_dim = len(lead)

    def scat(dst, src):
        # rows aimed at slot t (not placeable) land in a spare row
        ext = torch.cat([dst, dst.narrow(slot_dim, 0, 1)], dim=slot_dim)
        idx = target.reshape(target.shape + (1,) * (src.dim() - target.dim()))
        ext.scatter_(slot_dim, idx.expand_as(src), src.to(dst.dtype))
        return ext.narrow(slot_dim, 0, t)

    def full(v, dtype):
        return torch.full(lead + (d,), v, dtype=dtype, device=dev)

    # is_activated only on the first frame
    frame1 = (slab.frame == 1)[..., None].expand(lead + (d,))
    frame = slab.frame[..., None].expand(lead + (d,))
    born = {}
    if cfg.feature_dim > 0:
        # raw features enter the slab at birth
        feat = dets.feature
        born = dict(feature=scat(slab.feature, feat),
                    feat_count=scat(slab.feat_count,
                                    (feat.abs().sum(-1) > 0).int()))
        if cfg.feature_hist > 0:
            hist0 = torch.zeros(lead + (d, cfg.feature_hist,
                                        cfg.feature_dim), device=dev)
            hist0[..., 0, :] = feat
            born["feat_hist"] = scat(slab.feat_hist, hist0)
    return slab._replace(
        **born,
        mean=scat(slab.mean, mean0),
        cov=scat(slab.cov, cov0),
        det_tlwh=scat(slab.det_tlwh, det_tlwh),
        extra=scat(slab.extra, torch.zeros(
            lead + (d,) + slab.extra.shape[slot_dim + 1:], device=dev)),
        score=scat(slab.score, dets.score),
        cls=scat(slab.cls, dets.cls),
        state=scat(slab.state, full(TRACKED, torch.int32)),
        occupied=scat(slab.occupied, full(True, torch.bool)),
        is_activated=scat(slab.is_activated, frame1),
        track_id=scat(slab.track_id, ids),
        frame_id=scat(slab.frame_id, frame),
        start_frame=scat(slab.start_frame, frame),
        tracklet_len=scat(slab.tracklet_len, full(0, torch.int32)),
        time_since_update=scat(slab.time_since_update, full(0, torch.int32)),
        # tracked-list key: births append in det order, before this
        # frame's refinds
        ins_seq=scat(slab.ins_seq, (_seq_base(slab) + torch.arange(
            d, dtype=torch.int32, device=dev)).expand(lead + (d,))),
        next_id=slab.next_id + placeable.int().sum(-1).to(torch.int32),
    )


def prune_lost(slab: TrackSlab, max_time_lost: int) -> TrackSlab:
    stale = (slab.occupied & (slab.state == LOST)
             & (slab.frame[..., None] - slab.frame_id > max_time_lost))
    return mark_removed(slab, stale)


def remove_duplicates(slab: TrackSlab, fmt: str) -> TrackSlab:
    """Tracked-vs-lost pairs with IoU distance < 0.15 drop the younger."""
    tlbr = track_tlbr(slab, fmt)
    tracked = slab.occupied & (slab.state == TRACKED)
    lost = slab.occupied & (slab.state == LOST)
    dist = 1.0 - boxops.iou_matrix(tlbr, tlbr)
    dup = (dist < 0.15) & tracked[..., :, None] & lost[..., None, :]
    age = slab.frame_id - slab.start_frame
    older_t = age[..., :, None] > age[..., None, :]
    drop_tracked = (dup & ~older_t).any(dim=-1)
    drop_lost = (dup & older_t).any(dim=-2)
    return mark_removed(slab, drop_tracked | drop_lost)


class FrameOutput(NamedTuple):
    """Per-frame emitted tracks (fixed width = slab capacity)."""

    track_id: torch.Tensor  # (T,) int32
    tlwh: torch.Tensor      # (T, 4)
    score: torch.Tensor     # (T,)
    cls: torch.Tensor       # (T,)
    valid: torch.Tensor     # (T,) bool


def frame_output(slab: TrackSlab, fmt: str, cfg: TrackerConfig) -> FrameOutput:
    """Activated tracked tracks passing the min-area filter."""
    tlwh = track_tlwh(slab, fmt)
    valid = (slab.occupied & (slab.state == TRACKED) & slab.is_activated
             & (tlwh[..., 2] * tlwh[..., 3] > cfg.min_area))
    return FrameOutput(track_id=slab.track_id, tlwh=tlwh, score=slab.score,
                       cls=slab.cls, valid=valid)


# ---------------------------------------------------------------------------
# checkpointing: one npz entry per slab field + the config fingerprint
# ---------------------------------------------------------------------------

_STATE_FINGERPRINT_FIELDS = (
    "tracker", "kalman_format", "capacity", "det_capacity",
    "feature_dim", "feature_hist", "extra_dim",
)


def _state_fingerprint(cfg: TrackerConfig) -> str:
    return ";".join(
        f"{k}={getattr(cfg, k)}" for k in _STATE_FINGERPRINT_FIELDS)


def save_slab(path: str, slab: TrackSlab, cfg: TrackerConfig,
              tag: str = "", aux: Optional[dict] = None) -> None:
    """Write tracker state to ``path`` atomically (npz, same layout as the
    JAX package's save_slab). ``aux``: extra numpy arrays stored beside
    the slab (the GMC's previous-frame state)."""
    arrays = {f: v.detach().cpu().numpy() for f, v in zip(slab._fields, slab)}
    arrays["_fingerprint"] = np.asarray(_state_fingerprint(cfg))
    if tag:
        arrays["_tag"] = np.asarray(tag)
    for k, v in (aux or {}).items():
        arrays["_aux_" + k] = np.asarray(v)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


def load_slab(path: str, cfg: TrackerConfig, device,
              expect_tag: str = "", with_aux: bool = False):
    """Load state saved by :func:`save_slab`; raises ValueError on a
    config- or tag-incompatible checkpoint. With ``with_aux`` returns
    (slab, aux dict)."""
    with np.load(path) as z:
        got, want = str(z["_fingerprint"]), _state_fingerprint(cfg)
        if got != want:
            raise ValueError(
                f"tracker state {path} was saved under a different "
                f"config:\n  saved:   {got}\n  current: {want}")
        if expect_tag:
            got_tag = str(z["_tag"]) if "_tag" in z else ""
            if got_tag != expect_tag:
                raise ValueError(
                    f"tracker state {path} belongs to a different stream:"
                    f"\n  saved:   {got_tag or '<untagged>'}"
                    f"\n  current: {expect_tag}")
        missing = [f for f in TrackSlab._fields if f not in z]
        if missing:
            raise ValueError(
                f"tracker state {path} is missing fields {missing}")
        slab = TrackSlab(**{f: torch.as_tensor(z[f], device=device)
                            for f in TrackSlab._fields})
        if with_aux:
            return slab, {k[len("_aux_"):]: np.asarray(z[k])
                          for k in z.files if k.startswith("_aux_")}
        return slab
