"""Anchor fitness checking + k-means/GA anchor evolution (the port's copy
of yolov7_tracker_tpu/train/autoanchor.py, numpy and scipy; reference
utils/autoanchor.py:12-160). Host code only, as in JAX: no CLI wires it.
kmean_anchors' k-means draws its initial centroids from numpy's global
random state (scipy's default), its mutations from ``seed``."""

from __future__ import annotations

import numpy as np


def _metric(wh: np.ndarray, anchors: np.ndarray):
    """Per-label best anchor ratio metric (autoanchor.py:40-46)."""
    r = wh[:, None] / anchors[None]
    x = np.minimum(r, 1.0 / r).min(2)  # ratio metric
    best = x.max(1)
    return x, best


def check_anchors(label_whs: np.ndarray, anchors: np.ndarray,
                  thr: float = 4.0) -> dict:
    """Best-possible-recall check (autoanchor.py:12-39).

    label_whs: (N, 2) pixel label sizes at train resolution (with the
    reference's random scale jitter applied by the caller if desired).
    anchors: (A, 2) pixel anchors.
    """
    x, best = _metric(label_whs, anchors)
    aat = (x > 1 / thr).sum(1).mean()
    bpr = (best > 1 / thr).mean()
    return {"bpr": float(bpr), "aat": float(aat)}


def kmean_anchors(label_whs: np.ndarray, n: int = 9, thr: float = 4.0,
                  gen: int = 1000, seed: int = 0) -> np.ndarray:
    """k-means anchors + genetic mutation refinement
    (autoanchor.py:62-160). Returns (n, 2) anchors sorted by area."""
    from scipy.cluster.vq import kmeans

    rng = np.random.default_rng(seed)
    wh = label_whs[(label_whs >= 2.0).all(1)]
    std = wh.std(0)
    k, _ = kmeans(wh / std, n, iter=30)
    k = k * std

    def fitness(k):
        _, best = _metric(wh, k)
        return (best * (best > 1 / thr)).mean()

    f = fitness(k)
    shape = k.shape
    mp, s = 0.9, 0.1
    for _ in range(gen):
        v = np.ones(shape)
        while (v == 1).all():
            v = (
                (rng.random(shape) < mp) * rng.random()
                * rng.normal(size=shape) * s + 1
            ).clip(0.3, 3.0)
        kg = (k * v).clip(min=2.0)
        fg = fitness(kg)
        if fg > f:
            f, k = fg, kg.copy()
    return k[np.argsort(k.prod(1))]
