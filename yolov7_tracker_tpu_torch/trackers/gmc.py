"""Global (camera) motion compensation for BoT-SORT and StrongSORT (port of
yolov7_tracker_tpu/trackers/gmc.py; the reference's
tracker/botsort.py:13-269).

Each estimator gives a 2x3 affine warp from the previous frame to this
one:

- 'ecc'  : on the frame's device. Grayscale and the 2x downscale are
           torch integer arithmetic equal to OpenCV's bit for bit at
           every frame size (``to_gray``, ``downscale2``), then
           ``ecc_affine``: 50 forward-additive Gauss-Newton steps on the
           ECC objective, the JAX package's replacement of
           cv2.findTransformECC. A warp that is not finite becomes
           identity (the reference's failure semantics), decided on the
           device: no host sync.
- 'orb'  : OpenCV FAST + ORB keypoints, ratio + spatial filtered matches
           and a RANSAC partial affine, on the host. OpenCV is imported
           when the estimator first runs, and its absence is an error
           (a machine without it takes 'ecc' or 'none').
- 'none' : identity.

The warp is applied to the Kalman states by trackers.appearance.apply_gmc.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from .slab import IDENTITY_WARP, identity_warp

IDENTITY = IDENTITY_WARP.numpy()
DOWNSCALE = 2          # both estimators work on the half-size gray frame
ECC_STEPS = 50

# cv2.cvtColor(BGR2GRAY) for uint8: R, G, B weights in 15-bit fixed point
_GRAY_R, _GRAY_G, _GRAY_B = 9798, 19235, 3735
# cv2.resize's fixed-point weight of 1 for uint8 (INTER_RESIZE_COEF_SCALE)
_COEF_ONE = 2048


def to_gray(frame_bgr: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 BGR -> (H, W) uint8, equal to cv2.cvtColor(frame,
    COLOR_BGR2GRAY): (9798 R + 19235 G + 3735 B + 2^14) >> 15."""
    f = frame_bgr.to(torch.int32)
    gray = (_GRAY_R * f[..., 2] + _GRAY_G * f[..., 1] + _GRAY_B * f[..., 0]
            + 16384) >> 15
    return gray.to(torch.uint8)


def _linear_taps(n: int, m: int, device):
    """cv2.resize's INTER_LINEAR taps for uint8 along one axis of n source
    and m destination pixels: (first source index, second source index,
    weight of the first, weight of the second), the weights in 11-bit fixed
    point. The position (d + 0.5) * scale - 0.5 is taken in float64 and
    rounded to float32, as OpenCV does, then clamped to the image."""
    scale = 1.0 / (m / n)
    fx = ((torch.arange(m, dtype=torch.float64, device=device) + 0.5)
          * scale - 0.5).float()
    sx = torch.floor(fx)
    f = fx - sx
    sx = sx.long()
    edge = (sx < 0) | (sx >= n - 1)
    f = torch.where(edge, torch.zeros_like(f), f)
    sx = sx.clamp(0, n - 1)
    a0 = torch.round((1.0 - f) * _COEF_ONE).to(torch.int32)
    a1 = torch.round(f * _COEF_ONE).to(torch.int32)
    return sx, (sx + 1).clamp(max=n - 1), a0, a1


def downscale2(gray: torch.Tensor) -> torch.Tensor:
    """(H, W) uint8 -> (H // 2, W // 2) uint8, equal to cv2.resize(gray,
    (W // 2, H // 2)) with INTER_LINEAR. At exactly half size (H and W
    even) OpenCV takes its area path, the rounded mean of each 2x2 block,
    (a + b + c + d + 2) >> 2. Otherwise it samples bilinearly at a scale a
    little above 2 in fixed point: 11-bit weights, a horizontal pass in
    int32, and a vertical pass rounded as its vector code rounds,
    (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2."""
    hgt, wid = gray.shape[-2], gray.shape[-1]
    g = gray.to(torch.int32)
    if hgt % 2 == 0 and wid % 2 == 0:
        s = g[..., 0::2, 0::2] + g[..., 0::2, 1::2] + g[..., 1::2, 0::2] \
            + g[..., 1::2, 1::2]
        return ((s + 2) >> 2).to(torch.uint8)
    x0, x1, a0, a1 = _linear_taps(wid, wid // 2, gray.device)
    y0, y1, b0, b1 = _linear_taps(hgt, hgt // 2, gray.device)
    rows = g[..., x0] * a0 + g[..., x1] * a1            # (H, W // 2)
    r0, r1 = rows[..., y0, :] >> 4, rows[..., y1, :] >> 4
    out = (((b0[:, None] * r0) >> 16) + ((b1[:, None] * r1) >> 16) + 2) >> 2
    return out.to(torch.uint8)


def _sample(img, x, y):
    """Bilinear sample of img (H, W) at (x, y), clamped inside. A NaN
    position (the steps diverged) reads pixel 0 and stays NaN through its
    weights, as the JAX package's clamped gather does: the warp then comes
    out non-finite and becomes identity."""
    hgt, wid = img.shape
    x = x.clamp(0.0, wid - 1.001)
    y = y.clamp(0.0, hgt - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    i = (torch.nan_to_num(y0).long() * wid
         + torch.nan_to_num(x0).long())
    flat = img.reshape(-1)
    v00, v01 = flat[i], flat[i + 1]
    v10, v11 = flat[i + wid], flat[i + wid + 1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def ecc_affine(ref: torch.Tensor, cur: torch.Tensor):
    """ECC alignment ref -> cur on the tensors' device (the JAX package's
    replacement of cv2.findTransformECC with MOTION_EUCLIDEAN): a
    4-parameter similarity warp [1+a, -b, tx; b, 1+a, ty], forward-additive
    Gauss-Newton steps (ECC_STEPS of them, no early exit: no host sync)
    with the correlation-optimal lambda of Evangelidis and Psarakis, each
    step clamped to [-10, 10]. ref, cur (H, W) float32.
    Returns the 6 parameters [1+a, -b, tx, b, 1+a, ty] (float32)."""
    hgt, wid = ref.shape
    dev = ref.device
    gy, gx = torch.meshgrid(torch.arange(hgt, dtype=torch.float32, device=dev),
                            torch.arange(wid, dtype=torch.float32, device=dev),
                            indexing="ij")
    # gradient images of cur (central differences, wrapping)
    cx = (torch.roll(cur, -1, 1) - torch.roll(cur, 1, 1)) * 0.5
    cy = (torch.roll(cur, -1, 0) - torch.roll(cur, 1, 0)) * 0.5
    eye4 = torch.eye(4, device=dev)
    p = torch.zeros(4, device=dev)
    for _ in range(ECC_STEPS):
        a, b, tx, ty = p
        x = (1 + a) * gx - b * gy + tx
        y = b * gx + (1 + a) * gy + ty
        w = _sample(cur, x, y)
        ix = _sample(cx, x, y)
        iy = _sample(cy, x, y)
        m = ((x >= 1.0) & (x <= wid - 2.0) & (y >= 1.0)
             & (y <= hgt - 2.0)).float()
        n = m.sum() + 1e-6
        wz = (w - (w * m).sum() / n) * m
        tz = (ref - (ref * m).sum() / n) * m
        # steepest-descent images for p = (a, b, tx, ty)
        g = torch.stack([(ix * gx + iy * gy) * m, (-ix * gy + iy * gx) * m,
                         ix * m, iy * m], dim=-1).reshape(-1, 4)
        wf, tf = wz.reshape(-1), tz.reshape(-1)
        hess = g.T @ g + 1e-6 * eye4
        gw = g.T @ wf
        gt = g.T @ tf
        hi_gw = torch.linalg.solve_ex(hess, gw)[0]
        num = wf @ wf - gw @ hi_gw
        den = tf @ wf - gt @ hi_gw
        lam = num / torch.where(den.abs() < 1e-6,
                                torch.full_like(den, 1e-6), den)
        dp = torch.linalg.solve_ex(hess, g.T @ (lam * tf - wf))[0]
        p = p + dp.clamp(-10.0, 10.0)
    a, b, tx, ty = p
    return torch.stack([1 + a, -b, tx, b, 1 + a, ty])


class GMC:
    """Per-stream estimator with the previous frame's state. ``apply``
    takes an (H, W, 3) uint8 BGR frame: for 'ecc' a tensor (on the device
    the pipeline already moved it to) and returns a (2, 3) float32 tensor
    there; for 'orb' a numpy array or tensor, on the host."""

    def __init__(self, method: str = "orb"):
        if method not in ("orb", "ecc", "none"):
            raise ValueError(f"unknown GMC method {method!r}")
        self.method = method
        self.prev_gray = None
        self.prev_kp = None
        self.prev_desc = None

    def get_state(self) -> dict:
        """The previous frame's state as numpy arrays (the JAX package's
        keys), so a checkpointed stream resumes with the same first
        warp."""
        st = {}
        if self.prev_gray is not None:
            gray = self.prev_gray
            if isinstance(gray, torch.Tensor):
                trace.count("host_syncs.state_save")
                gray = gray.cpu()
            st["gray"] = np.asarray(gray)
        if self.prev_kp is not None and len(self.prev_kp):
            st["kp"] = np.asarray(self.prev_kp, np.float32)
        if self.prev_desc is not None:
            st["desc"] = np.asarray(self.prev_desc)
        return st

    def set_state(self, st: dict) -> None:
        self.prev_gray = st.get("gray")
        self.prev_kp = st.get("kp")
        self.prev_desc = st.get("desc")

    def apply(self, frame):
        """frame: (H, W, 3) uint8 BGR -> 2x3 affine warp prev -> curr."""
        if self.method == "none":
            return identity_warp(getattr(frame, "device", None))
        if self.method == "ecc":
            return self._ecc(torch.as_tensor(frame))
        if isinstance(frame, torch.Tensor):
            trace.count("host_syncs.gmc")
            return self._orb(frame.cpu().numpy())
        return self._orb(np.asarray(frame))

    def _ecc(self, frame: torch.Tensor) -> torch.Tensor:
        gray = downscale2(to_gray(frame))
        prev = self.prev_gray
        self.prev_gray = gray
        identity = identity_warp(gray.device)
        if prev is None or tuple(prev.shape) != tuple(gray.shape):
            return identity
        prev = torch.as_tensor(prev, device=gray.device)
        warp = ecc_affine(prev.float(), gray.float()).reshape(2, 3)
        warp = torch.cat([warp[:, :2], warp[:, 2:] * DOWNSCALE], dim=1)
        return torch.where(torch.isfinite(warp).all(), warp, identity)

    def _orb(self, frame: np.ndarray) -> torch.Tensor:
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "GMC method 'orb' needs OpenCV (cv2), which is not "
                "installed; use --gmc ecc (on the device) or --gmc none"
            ) from e
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        gray = cv2.resize(gray, (gray.shape[1] // DOWNSCALE,
                                 gray.shape[0] // DOWNSCALE))
        detector = cv2.FastFeatureDetector_create(threshold=20)
        extractor = cv2.ORB_create()
        kp = detector.detect(gray, None)
        kp, desc = extractor.compute(gray, kp)
        warp = IDENTITY.copy()
        if self.prev_desc is not None and desc is not None and len(kp) >= 4:
            knn = cv2.BFMatcher(cv2.NORM_HAMMING).knnMatch(self.prev_desc,
                                                           desc, 2)
            good_prev, good_curr = [], []
            w = gray.shape[1]
            for pair in knn:
                if len(pair) != 2:
                    continue
                m, n = pair
                if m.distance < 0.9 * n.distance:
                    p = tuple(self.prev_kp[m.queryIdx])
                    c = kp[m.trainIdx].pt
                    if abs(p[0] - c[0]) < 0.25 * w:
                        good_prev.append(p)
                        good_curr.append(c)
            if len(good_prev) >= 4:
                h, _ = cv2.estimateAffinePartial2D(
                    np.asarray(good_prev), np.asarray(good_curr),
                    method=cv2.RANSAC)
                if h is not None:
                    warp = h.astype(np.float32)
                    warp[:, 2] *= DOWNSCALE
        self.prev_kp = np.float32([k.pt for k in kp]) if kp else None
        self.prev_desc = desc
        self.prev_gray = gray
        return torch.from_numpy(warp)
