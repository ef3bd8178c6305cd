"""Tracker registry: name -> (step function, config overrides) (port of
yolov7_tracker_tpu/trackers/registry.py).

botsort and strongsort force their own Kalman format (the reference's
track.py:67-71), and a tracker's overrides (deepsort's feature ring
buffer, C-BIoU's Kalman-free state, ...) apply only where the caller left
the field at its default. deepmot's DHN weights are loaded when the step
is built.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Tuple

from . import slab as S

_STEPS: Dict[str, Tuple[Callable, dict]] = {}
_MODULES = ("sort", "bytetrack", "c_biou", "deepsort", "botsort", "uavmot",
            "strongsort", "deepmot")
_FORCED_KALMAN = {"botsort": "botsort", "strongsort": "strongsort"}


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


def build_tracker(cfg: S.TrackerConfig, device="cpu"
                  ) -> Tuple[Callable, S.TrackerConfig]:
    """Return (step fn ``(slab, det_slab) -> (slab, FrameOutput)``, the
    resolved config). Every step also takes ``solve_stage1``: the solver
    of its first association stage (deepsort: of every cascade level).
    deepmot with ``cfg.dhn_weights`` loads its DHN here, once, onto
    ``device`` (the pipeline passes its own); without them it matches on
    the raw cost, as the JAX package does."""
    cfg = resolve_config(cfg)
    kw = {}
    if cfg.tracker == "deepmot" and cfg.dhn_weights:
        from ..reid.dhn import load_dhn

        kw["dhn"] = load_dhn(cfg.dhn_weights, cfg.dhn_arch, cfg.dhn_hidden,
                             device)
    return functools.partial(_STEPS[cfg.tracker][0], cfg=cfg, **kw), cfg


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

    return step
