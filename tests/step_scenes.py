"""Seeded detection scenes for the tracker step's tests (CPU and card),
a bitwise comparison of step results, and the graph path of
trackers/graphed.py on the CPU (a stand-in capture). Imports no JAX.

A scene: ``n_obj`` walkers on straight paths, two of them crossing
mid-scene; one object leaves for good early (its track is lost, then
removed past the track buffer), others are occluded for a few frames
(lost and refound), two enter late (births); scores dip below the
high threshold at times (ByteTrack's second stage); false positives
appear at random, and on one frame so many that the frame's detections
overflow ``det_capacity``. Each object carries its own appearance (a
unit vector plus small noise) for the trackers with features, and the
frames carry a slowly turning camera warp for the GMC trackers.
"""

from __future__ import annotations

import numpy as np
import torch

from yolov7_tracker_tpu_torch.trackers import graphed
from yolov7_tracker_tpu_torch.trackers import slab as S
from yolov7_tracker_tpu_torch.utils import trace


def scene(seed: int, n_frames: int = 60, n_obj: int = 10,
          feat: int = 16, overflow_at: int = 17):
    """Per frame: (tlbr (N, 4), score (N,), feature (N, feat), warp (2, 3))
    float32 numpy arrays, N varying."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(100, 900, (n_obj, 2))
    vel = rng.uniform(-4, 4, (n_obj, 2))
    wh = np.stack([rng.uniform(30, 60, n_obj), rng.uniform(70, 140, n_obj)],
                  1)
    # objects 0 and 1 meet at (600, 500) at frame n_frames // 2
    vel[0], vel[1] = (4.0, 0.5), (-4.0, 0.5)
    pos[:2] = np.array([600.0, 500.0]) - vel[:2] * (n_frames // 2)
    start = np.zeros(n_obj, int)
    end = np.full(n_obj, n_frames)
    end[2] = 8                                  # leaves for good
    start[3], start[4] = 12, 25                 # enters late
    occluded = {5: (20, 26), 6: (33, 37)}       # lost, then refound
    app = rng.normal(size=(n_obj + 8, feat))
    app /= np.linalg.norm(app, axis=1, keepdims=True)
    frames = []
    for t in range(n_frames):
        rows, scores, feats = [], [], []
        for i in range(n_obj):
            a, b = occluded.get(i, (-1, -1))
            if not start[i] <= t < end[i] or a <= t < b:
                continue
            xy = pos[i] + vel[i] * t + rng.normal(0, 1.0, 2)
            rows.append(np.r_[xy, xy + wh[i]])
            scores.append(rng.uniform(0.7, 0.95) if rng.random() > 0.2
                          else rng.uniform(0.25, 0.45))
            feats.append(app[i] + rng.normal(0, 0.01, feat))
        n_fp = 40 if t == overflow_at else int(rng.integers(0, 3))
        for _ in range(n_fp):
            xy = rng.uniform(0, 1200, 2)
            rows.append(np.r_[xy, xy + rng.uniform(20, 60, 2)])
            scores.append(rng.uniform(0.2, 0.8))
            feats.append(app[rng.integers(n_obj, n_obj + 8)]
                         + rng.normal(0, 0.01, feat))
        angle = 0.002 * np.sin(t / 7.0)
        warp = np.array([[np.cos(angle), -np.sin(angle), 0.5 * t % 3],
                         [np.sin(angle), np.cos(angle), -0.3]])
        frames.append((np.asarray(rows, np.float32).reshape(-1, 4),
                       np.asarray(scores, np.float32),
                       np.asarray(feats, np.float32).reshape(-1, feat),
                       warp.astype(np.float32)))
    return frames


def det_slabs(cfg: S.TrackerConfig, frames, device, warps: bool = True):
    """The scene's frames as DetSlabs of ``cfg`` on ``device`` (cut or
    padded to det_capacity; features only where ``cfg`` has them)."""
    out = []
    for tlbr, score, feature, warp in frames:
        n = len(score)
        f = None
        if cfg.feature_dim:
            f = np.zeros((n, cfg.feature_dim), np.float32)
            k = min(cfg.feature_dim, feature.shape[1])
            f[:, :k] = feature[:, :k]
        out.append(S.make_det_slab(cfg, tlbr, score, np.zeros(n),
                                   np.ones(n, bool), device, feature=f,
                                   warp=warp if warps else None))
    return out


def stacked(items):
    """NamedTuples of one stream each -> one with a leading stream axis."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def same(a, b) -> bool:
    """Bit for bit: the same dtype, shape and bits (floats compared as
    integers of their width, so -0.0 differs from 0.0 and NaNs compare)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        as_int = {torch.float32: torch.int32, torch.float64: torch.int64,
                  torch.float16: torch.int16, torch.bfloat16: torch.int16}
        a = a.contiguous().view(as_int[a.dtype])
        b = b.contiguous().view(as_int[b.dtype])
    return torch.equal(a.cpu(), b.cpu())


def differing(x, y) -> list:
    """The names of the fields of two NamedTuples that differ."""
    return [n for n, a, b in zip(x._fields, x, y) if not same(a, b)]


def stand_in_capture(dev, body):
    """trackers/graphed.py's capture as the CPU can run it: the warm-up,
    then ``body`` once (its counts and outputs kept), and a replay that
    runs ``body`` again and writes what it gives over those outputs, as a
    graph's replay writes its outputs."""
    with trace.aside():
        for _ in range(graphed.WARMUP):
            body()
    with trace.aside() as counts:
        outputs = body()

    def replay():
        with trace.aside():
            new = body()
        for out, got in zip(outputs, new):
            for t, v in zip(out, got):
                t.copy_(v)

    return counts, outputs, replay


def graphs_on_the_cpu(monkeypatch):
    """The graph path of trackers/graphed.py on CPU tensors, with the
    stand-in capture, while ``monkeypatch`` holds."""
    monkeypatch.setattr(graphed, "_on_card", lambda key: True)
    monkeypatch.setattr(graphed._Graph, "_capture",
                        staticmethod(stand_in_capture))
