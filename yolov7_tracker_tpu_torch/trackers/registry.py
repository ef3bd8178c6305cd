"""Tracker registry: name -> (step function, config overrides) (port of
yolov7_tracker_tpu/trackers/registry.py).

botsort and strongsort force their own Kalman format (the reference's
track.py:67-71), and a tracker's overrides (deepsort's feature ring
buffer, C-BIoU's Kalman-free state, ...) apply only where the caller left
the field at its default. deepmot's DHN weights are loaded when the step
is built. Every step built here, a tracker's or the predict-only one,
is a span ``tracker`` (utils/trace.py), timed on the slab's device, and
inside it replays as one CUDA graph on the card (trackers/graphed.py).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Tuple

from ..ops.assignment import masked_assignment
from ..utils import trace
from . import slab as S
from .graphed import graphed

_STEPS: Dict[str, Tuple[Callable, dict]] = {}
_MODULES = ("sort", "bytetrack", "c_biou", "deepsort", "botsort", "uavmot",
            "strongsort", "deepmot")
_FORCED_KALMAN = {"botsort": "botsort", "strongsort": "strongsort"}


def _slab_frame(*args, **kwargs):
    return (args[0] if args else kwargs["slab"]).frame


def _spanned(step: Callable) -> Callable:
    """The step as built: its graphs inside the span ``tracker``; one
    wrapper, with its own graphs, each build."""
    return trace.traced("tracker", _slab_frame)(graphed(step))


def register(name: str, **cfg_overrides):
    def deco(fn):
        _STEPS[name] = (fn, cfg_overrides)
        return fn

    return deco


def resolve_config(cfg: S.TrackerConfig) -> S.TrackerConfig:
    """cfg with the tracker's forced Kalman format and its overrides."""
    for m in _MODULES:
        importlib.import_module(f".{m}", __package__)
    if cfg.tracker not in _STEPS:
        raise KeyError(
            f"unknown tracker {cfg.tracker!r}; have {sorted(_STEPS)}")
    forced = _FORCED_KALMAN.get(cfg.tracker)
    if forced:
        cfg = dataclasses.replace(cfg, kalman_format=forced)
    default = S.TrackerConfig()
    for k, v in _STEPS[cfg.tracker][1].items():
        if getattr(cfg, k) == getattr(default, k):
            cfg = dataclasses.replace(cfg, **{k: v})
    return cfg


def build_tracker(cfg: S.TrackerConfig, device=None
                  ) -> Tuple[Callable, S.TrackerConfig]:
    """Return (step fn ``(slab, det_slab) -> (slab, FrameOutput)``, the
    resolved config). Every step also takes ``solve_stage1``: the solver
    of its first association stage (deepsort: of every cascade level).
    deepmot with ``cfg.dhn_weights`` loads its DHN here, once, onto
    ``device`` (the pipeline passes its own; None: the card, and without
    one this raises); without them it matches on the raw cost, as the JAX
    package does. The step is a ``functools.partial`` of the wrapped step
    over ``cfg`` (and ``dhn``); on the card it replays as CUDA graphs."""
    from .. import resolve_device

    device = resolve_device(device)
    cfg = resolve_config(cfg)
    kw = {}
    if cfg.tracker == "deepmot" and cfg.dhn_weights:
        from ..reid.dhn import load_dhn

        kw["dhn"] = load_dhn(cfg.dhn_weights, cfg.dhn_arch, cfg.dhn_hidden,
                             device)
    return functools.partial(_spanned(_STEPS[cfg.tracker][0]), cfg=cfg,
                             **kw), cfg


def build_predict_only(cfg: S.TrackerConfig) -> Callable:
    """The step of a frame without detections, for --detect_per_frame's
    skipped frames (update_without_detection, the reference's
    basetrack.py:489-537): bump the frame counter, Kalman-predict the pool
    (C-BIoU has no Kalman state: no prediction), drop tracked/lost
    duplicates, emit. ``cfg``: the resolved config. The step is
    ``slab -> (slab, FrameOutput)`` and makes no host sync."""
    fmt = cfg.kalman_format

    def step(slab: S.TrackSlab):
        slab = slab._replace(frame=slab.frame + 1)
        if fmt != "none":
            slab = S.predict_pool(slab, fmt)
        slab = S.remove_duplicates(slab, fmt)
        return slab, S.frame_output(slab, fmt, cfg)

    return _spanned(step)


def stream_step(step: Callable, slab: S.TrackSlab, dets: S.DetSlab):
    """``step`` as the streaming modes run it: stage 1 by the exact square
    auction (K1 for one stream, K3 for S), as the JAX package's streaming
    entry points on every backend but a TPU: the same algorithm lets the
    two packages be held against each other through ties."""
    return step(slab, dets, solve_stage1=masked_assignment)


def scan(step: Callable, slab: S.TrackSlab, dets):
    """Step ``slab`` through the DetSlabs ``dets`` in order; returns (slab,
    FrameOutput stacked over the frames)."""
    outs = []
    for det in dets:
        slab, out = step(slab, det)
        outs.append(out)
    return slab, S.stacked(outs)


def scan_streams(step: Callable, slabs: S.TrackSlab, det_streams: S.DetSlab):
    """:func:`scan` of S stacked streams by :func:`stream_step`: every
    field of det_streams (T, S, D, ...), the warp (T, S, 2, 3) or (2, 3)."""
    warp = det_streams.warp
    frames = (S.DetSlab(*(x[t] for x in det_streams[:-1]),
                        warp[t] if warp.dim() > 2 else warp)
              for t in range(det_streams.valid.shape[0]))
    return scan(functools.partial(stream_step, step), slabs, frames)
