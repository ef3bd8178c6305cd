"""Batched constant-velocity Kalman filters for the track slab (port of
yolov7_tracker_tpu/ops/kalman.py).

Four formats keyed by ``kalman_format``: 'default' (xyah, DeepSORT),
'naive' (7-state SORT, padded to 8 with an inert state 7), 'botsort'
(xywh) and 'strongsort' (NSA: 'default' with measurement noise scaled by
1 - confidence). Every op is batched over the (T,) slab; the 4x4 and 2x2
innovation systems are inverted in closed form (block Schur complement),
float32 throughout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import boxes

CHI2INV95 = (3.8415, 5.9915, 7.8147, 9.4877, 11.070, 12.592, 14.067, 15.507,
             16.919)

STD_W_POS = 1.0 / 20
STD_W_VEL = 1.0 / 160


class KalmanSpec(NamedTuple):
    name: str
    ndim: int
    nsa: bool


SPECS = {
    "default": KalmanSpec("default", 8, False),
    "naive": KalmanSpec("naive", 7, False),
    "botsort": KalmanSpec("botsort", 8, False),
    "strongsort": KalmanSpec("strongsort", 8, True),
}


def motion_matrix(fmt: str, device=None) -> torch.Tensor:
    """8x8 constant-velocity transition, identity-padded for 'naive'."""
    f = torch.eye(8, dtype=torch.float32, device=device)
    if fmt == "naive":
        f[0, 4] = f[1, 5] = f[2, 6] = 1.0
    else:
        f = f + torch.diag(torch.ones(4, device=device), 4)
    return f


def update_matrix(device=None) -> torch.Tensor:
    return torch.eye(4, 8, dtype=torch.float32, device=device)


def _std_profile(fmt: str, mean, *, initiate: bool):
    pw = 2.0 * STD_W_POS if initiate else STD_W_POS
    vw = 10.0 * STD_W_VEL if initiate else STD_W_VEL
    z = torch.zeros_like(mean[..., 0])
    one = torch.ones_like(z)
    if fmt == "naive":
        h = torch.sqrt(torch.abs(mean[..., 2] * mean[..., 3]))
        vel_w = 10.0 * STD_W_VEL
        return torch.stack(
            [pw * h, pw * h, pw * h, 1e-5 * one, vel_w * h, vel_w * h,
             vel_w * h, z], dim=-1)
    if fmt == "botsort":
        w, h = mean[..., 2], mean[..., 3]
        return torch.stack(
            [pw * w, pw * h, pw * w, pw * h, vw * w, vw * h, vw * w, vw * h],
            dim=-1)
    h = mean[..., 3]
    return torch.stack(
        [pw * h, pw * h, 1e-2 * one, pw * h, vw * h, vw * h, 1e-5 * one,
         vw * h], dim=-1)


def _meas_std(fmt: str, mean, confidence=None):
    one = torch.ones_like(mean[..., 0])
    if fmt == "naive":
        h = torch.sqrt(torch.abs(mean[..., 2] * mean[..., 3]))
        std = torch.stack(
            [STD_W_POS * h, STD_W_POS * h, 1e-1 * one, STD_W_POS * h], dim=-1)
    elif fmt == "botsort":
        w, h = mean[..., 2], mean[..., 3]
        std = torch.stack(
            [STD_W_POS * w, STD_W_POS * h, STD_W_POS * w, STD_W_POS * h],
            dim=-1)
    else:
        h = mean[..., 3]
        std = torch.stack(
            [STD_W_POS * h, STD_W_POS * h, 1e-1 * one, STD_W_POS * h], dim=-1)
    if confidence is not None:
        std = std * (1.0 - confidence)[..., None]
    return std


def initiate(fmt: str, measurement):
    """New-track (mean (...,8), cov (...,8,8)); velocities start at 0."""
    pad = torch.zeros(measurement.shape[:-1] + (4,), dtype=measurement.dtype,
                      device=measurement.device)
    mean = torch.cat([measurement, pad], dim=-1)
    std = _std_profile(fmt, mean, initiate=True)
    if fmt == "naive":
        std = std.clone()
        std[..., 7] = 1.0
    return mean, torch.diag_embed(torch.square(std))


def predict(fmt: str, mean, cov):
    f = motion_matrix(fmt, mean.device)
    q_std = _std_profile(fmt, mean, initiate=False)
    new_mean = mean @ f.T
    new_cov = (torch.einsum("ij,...jk,lk->...il", f, cov, f)
               + torch.diag_embed(torch.square(q_std)))
    return new_mean, new_cov


def project(fmt: str, mean, cov, confidence=None):
    h = update_matrix(mean.device)
    r = torch.diag_embed(torch.square(_meas_std(fmt, mean, confidence)))
    proj_mean = mean @ h.T
    proj_cov = torch.einsum("ij,...jk,lk->...il", h, cov, h) + r
    return proj_mean, proj_cov


def _inv_sym2(m):
    a, b, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 1]
    det = a * d - b * b
    inv = torch.stack(
        [torch.stack([d, -b], -1), torch.stack([-b, a], -1)], -2)
    return inv / det[..., None, None]


def _inv_sym4(m):
    """Closed-form inverse of batched symmetric PD 4x4 matrices (2x2
    block Schur complement)."""
    a = m[..., :2, :2]
    b = m[..., :2, 2:]
    d = m[..., 2:, 2:]
    ai = _inv_sym2(a)
    aib = ai @ b
    schur = d - b.transpose(-1, -2) @ aib
    si = _inv_sym2(schur)
    aibsi = aib @ si
    top_left = ai + aibsi @ aib.transpose(-1, -2)
    bottom_left = -aibsi.transpose(-1, -2)
    return torch.cat(
        [torch.cat([top_left, -aibsi], -1), torch.cat([bottom_left, si], -1)],
        -2)


def update(fmt: str, mean, cov, measurement, confidence=None):
    """Batched correction step; `confidence` feeds the NSA variant only."""
    conf = confidence if SPECS[fmt].nsa else None
    proj_mean, proj_cov = project(fmt, mean, cov, conf)
    hm = update_matrix(mean.device)
    gain = (cov @ hm.T) @ _inv_sym4(proj_cov)
    innovation = measurement - proj_mean
    new_mean = mean + torch.einsum("...ij,...j->...i", gain, innovation)
    new_cov = cov - gain @ proj_cov @ gain.transpose(-1, -2)
    return new_mean, new_cov


def gating_distance(fmt: str, mean, cov, measurements,
                    only_position: bool = False):
    """Squared Mahalanobis distance, mean (..., T, 8) x measurements
    (..., D, 4) -> (..., T, D), through the closed-form inverse of the
    projected covariance."""
    proj_mean, proj_cov = project(fmt, mean, cov)
    if only_position:
        proj_mean = proj_mean[..., :2]
        inv = _inv_sym2(proj_cov[..., :2, :2])
        measurements = measurements[..., :2]
    else:
        inv = _inv_sym4(proj_cov)
    d = measurements[..., None, :, :] - proj_mean[..., :, None, :]
    return torch.einsum("...tdi,...tij,...tdj->...td", d, inv, d)


def zero_stale_velocity(fmt: str, mean, tracked):
    idx = 6 if fmt == "naive" else 7
    out = mean.clone()
    out[..., idx] = torch.where(tracked, mean[..., idx],
                                torch.zeros_like(mean[..., idx]))
    return out


def measurement_from_tlwh(fmt: str, tlwh):
    if fmt in ("default", "strongsort"):
        return boxes.tlwh_to_xyah(tlwh)
    if fmt == "naive":
        return boxes.tlwh_to_xyar(tlwh)
    if fmt == "botsort":
        return boxes.tlwh_to_xywh(tlwh)
    raise ValueError(fmt)


def tlwh_from_mean(fmt: str, mean):
    if fmt in ("default", "strongsort"):
        return boxes.xyah_to_tlwh(mean[..., :4])
    if fmt == "naive":
        return boxes.xyar_to_cxcywh(mean[..., :4])
    if fmt == "botsort":
        xywh = mean[..., :4]
        xy = xywh[..., :2] - xywh[..., 2:] / 2.0
        return torch.cat([xy, xywh[..., 2:]], dim=-1)
    raise ValueError(fmt)
