"""AFLink offline track linking and GSI interpolation, the StrongSORT++
post-processing of MOT result rows (port of
yolov7_tracker_tpu/trackers/aflink_post.py; the reference ships the
PostLinker net but never calls it, tracker/strongsort.py:34-36).

``link_tracks`` scores candidate fragment pairs with the PostLinker
(reid/aflink.py, on its own device) and merges the ids whose link
probability clears the threshold, best first, one successor and one
predecessor a track. ``gsi_interpolation`` fills short gaps linearly and
smooths each track by Gaussian-process regression. The rest is numpy on
the host, the port's own copy of the JAX package's.

Snippet protocol (training and inference share it): 30-step (frame, cx,
cy) windows from each fragment's tail / head, zero-padded at the far end,
frames relative to the gap's start over 30, coordinates over 1000.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..reid import float32_exact

SNIPPET = 30
COORD_SCALE = 1e-3


def _tracklets(rows: np.ndarray) -> Dict[int, np.ndarray]:
    """rows (N, >=6) [frame, id, x, y, w, h] -> {id: (T, 3) [f, cx, cy]}
    sorted by frame."""
    out: Dict[int, np.ndarray] = {}
    for tid in np.unique(rows[:, 1]).astype(int):
        r = rows[rows[:, 1] == tid]
        r = r[np.argsort(r[:, 0])]
        cx = r[:, 2] + r[:, 4] / 2.0
        cy = r[:, 3] + r[:, 5] / 2.0
        out[tid] = np.stack([r[:, 0], cx, cy], axis=1)
    return out


def _snippet(track: np.ndarray, tail: bool, f_ref: float) -> np.ndarray:
    """(SNIPPET, 3) window from the tail (True) or head of a tracklet,
    zero-padded at the far end; frames relative to f_ref, coords scaled."""
    seg = track[-SNIPPET:] if tail else track[:SNIPPET]
    out = np.zeros((SNIPPET, 3), np.float32)
    k = len(seg)
    sl = slice(SNIPPET - k, None) if tail else slice(0, k)
    out[sl, 0] = (seg[:, 0] - f_ref) / SNIPPET
    out[sl, 1:] = seg[:, 1:] * COORD_SCALE
    return out


@torch.no_grad()
def link_tracks(rows: np.ndarray, linker, thr: float = 0.95,
                max_gap: int = 30, max_dist: float = 75.0,
                batch: int = 256) -> np.ndarray:
    """Merge fragment ids in MOT rows by PostLinker scores.

    rows: (N, >=6) [frame, id, x, y, w, h, ...]; linker: a PostLinker
    (reid.aflink.load_postlinker) on its device; thr: the link probability
    threshold (StrongSORT's 0.95); max_gap / max_dist: the temporal and
    spatial gates of a candidate pair. Returns a copy of rows with the
    merged ids."""
    rows = np.array(rows, float)
    if len(rows) == 0:
        return rows
    tracks = _tracklets(rows)
    ids = sorted(tracks)

    cands: List[Tuple[int, int]] = []
    x1s, x2s = [], []
    for i in ids:
        ti = tracks[i]
        for j in ids:
            if i == j:
                continue
            tj = tracks[j]
            gap = tj[0, 0] - ti[-1, 0]
            if not (0 < gap <= max_gap):
                continue
            if np.hypot(*(tj[0, 1:] - ti[-1, 1:])) > max_dist:
                continue
            f_ref = ti[-1, 0]
            cands.append((i, j))
            x1s.append(_snippet(ti, True, f_ref))
            x2s.append(_snippet(tj, False, f_ref))
    if not cands:
        return rows

    dev = next(linker.parameters()).device
    scores = []
    with float32_exact():
        for k in range(0, len(cands), batch):
            p = linker(torch.from_numpy(np.stack(x1s[k:k + batch])).to(dev),
                       torch.from_numpy(np.stack(x2s[k:k + batch])).to(dev))
            scores.append(p[:, 1].cpu().numpy())
    scores = np.concatenate(scores)

    # greedy one-to-one linking, best score first
    parent = {i: i for i in ids}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    used_pred, used_succ = set(), set()
    for k in np.argsort(-scores):
        if scores[k] < thr:
            break
        i, j = cands[k]
        if i in used_pred or j in used_succ:
            continue
        used_pred.add(i)
        used_succ.add(j)
        parent[find(j)] = find(i)

    out = rows.copy()
    for tid in ids:
        root = find(tid)
        if root != tid:
            out[rows[:, 1] == tid, 1] = root
    return out


def gsi_interpolation(rows: np.ndarray, interval: int = 20,
                      tau: float = 10.0, noise: float = 1.0) -> np.ndarray:
    """Gaussian-smoothed interpolation (StrongSORT++'s GSI, Du et al. 2023
    section III-E). Per track id: gaps shorter than ``interval`` frames
    are filled linearly, then each of (x, y, w, h) is smoothed by RBF-kernel
    Gaussian-process regression over time (length scale ``tau``) around a
    linear trend, in closed form on the host.

    rows: (N, >=6) [frame, id, x, y, w, h]; returns new rows (possibly
    more of them), sorted by frame then id."""
    rows = np.asarray(rows, float)
    if len(rows) == 0:
        return rows
    out = []
    for tid in np.unique(rows[:, 1]).astype(int):
        r = rows[rows[:, 1] == tid]
        r = r[np.argsort(r[:, 0])]
        filled = [r[0]]
        for k in range(1, len(r)):
            gap = int(r[k, 0] - r[k - 1, 0])
            if 1 < gap < interval:
                for g in range(1, gap):
                    w = g / gap
                    row = r[k - 1] * (1 - w) + r[k] * w
                    row[0] = r[k - 1, 0] + g
                    row[1] = tid
                    filled.append(row)
            filled.append(r[k])
        r = np.stack(filled)
        t = r[:, 0:1]
        d2 = (t - t.T) ** 2
        K = np.exp(-d2 / (2.0 * tau * tau))
        A = K + noise * np.eye(len(r))
        y = r[:, 2:6]
        # a zero-mean GP around the linear trend: constant-motion tracks
        # pass through unshrunk, only the jitter is smoothed
        X = np.column_stack([np.ones(len(r)), r[:, 0]])
        beta, *_ = np.linalg.lstsq(X, y, rcond=None)
        trend = X @ beta
        smooth = trend + K @ np.linalg.solve(A, y - trend)
        r = r.copy()
        r[:, 2:6] = smooth
        out.append(r)
    out = np.concatenate(out)
    return out[np.lexsort((out[:, 1], out[:, 0]))]
