"""Public detections of pedestrians, sequence after sequence: MOT17's
layout (``width`` x ``height`` at ``fps``), ``frames`` frames a sequence,
each with a number of pedestrians drawn from ``pedestrians`` (both ends
included) walking straight paths at constant speed, ``crossings`` pairs
of them on paths that cross, and detections made from their boxes: every
corner jittered uniformly by up to ``jitter_px``, a share ``miss_rate``
left out, scores uniform in ``score``, class 0 (the MOT detection txt a
tracker reads with ``track.py --detections``).

A pedestrian is 70-320 px tall at aspect 0.41 (MOT17's range), walks at
0.5-3 px a frame, for a span of 25% to all of the sequence, through a
point of the frame drawn uniformly at the middle of its span; it is
detected while the centre of its box is inside the frame, its box
clipped to the frame. In a crossing, the second walker passes
through the first walker's position at a frame both are on screen.
Sequence ``k`` of a seed is a function of the seed and ``k`` alone."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.harness.seeds import sub_seed


def _sequence(rng: np.random.Generator, p: dict) -> Dict[int, np.ndarray]:
    n_f, wid, hgt = p["frames"], p["width"], p["height"]
    lo, hi = p["pedestrians"]
    n = int(rng.integers(lo, hi + 1))
    h = rng.uniform(70.0, 320.0, n)
    w = 0.41 * h
    start = rng.integers(0, n_f // 2, n)
    stop = np.minimum(n_f, start + rng.integers(n_f // 4, n_f + 1, n))
    speed = rng.uniform(0.5, 3.0, n)
    angle = rng.uniform(0.0, 2.0 * np.pi, n)
    vel = np.stack([np.cos(angle), np.sin(angle)], 1) * speed[:, None]
    # the centre at frame ``start``, from one drawn in the frame at the
    # middle of the span
    mid = np.stack([rng.uniform(0, wid, n), rng.uniform(0, hgt, n)], 1)
    c0 = mid - vel * ((stop - start) / 2.0)[:, None]
    pairs = rng.permutation(n)[:2 * p["crossings"]].reshape(-1, 2)
    for a, b in pairs:
        lo_t, hi_t = max(start[a], start[b]), min(stop[a], stop[b])
        if hi_t <= lo_t:                 # give b a span that meets a's
            start[b], stop[b] = start[a], stop[a]
            lo_t, hi_t = start[a], stop[a]
        t = rng.integers(lo_t, hi_t)
        meet = c0[a] + vel[a] * (t - start[a])
        c0[b] = meet - vel[b] * (t - start[b])
    t = np.arange(n_f)
    c = c0[:, None, :] + vel[:, None, :] * (t[None, :, None]
                                            - start[:, None, None])
    on = ((t[None, :] >= start[:, None]) & (t[None, :] < stop[:, None])
          & (c[..., 0] >= 0) & (c[..., 0] < wid)
          & (c[..., 1] >= 0) & (c[..., 1] < hgt))
    on &= rng.random(on.shape) >= p["miss_rate"]
    half = np.stack([w, h], 1)[:, None, :] / 2.0
    box = np.concatenate([c - half, c + half], -1)
    box += rng.uniform(-p["jitter_px"], p["jitter_px"], box.shape)
    box[..., 0::2] = box[..., 0::2].clip(0.0, wid)
    box[..., 1::2] = box[..., 1::2].clip(0.0, hgt)
    score = rng.uniform(p["score"][0], p["score"][1], on.shape)
    rows = np.concatenate([box, score[..., None],
                           np.zeros(on.shape + (1,))], -1).astype(np.float32)
    return {f + 1: rows[on[:, f], f] for f in range(n_f)}


class Sequences:
    """The detections of sequence ``k``: {frame (1-based): (N, 6) float32
    [x1, y1, x2, y2, score, cls]}, made once and kept."""

    def __init__(self, seed: int, p: dict, made: int):
        self.seed, self.p, self.frames = seed, p, p["frames"]
        self.made: List[Dict[int, np.ndarray]] = []
        while len(self.made) < made:
            self.sequence(len(self.made))

    def sequence(self, k: int) -> Dict[int, np.ndarray]:
        while len(self.made) <= k:
            rng = np.random.default_rng(sub_seed(self.seed, 10,
                                                 len(self.made)))
            self.made.append(_sequence(rng, self.p))
        return self.made[k]


def make(seed: int, p: dict) -> Sequences:
    """The sequences of a seed; the first ``made`` (enough for the window)
    are made now, as set-up."""
    return Sequences(seed, p, p["made"])
