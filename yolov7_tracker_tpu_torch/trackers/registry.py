"""Tracker registry: name -> (step function, config overrides) (port of
yolov7_tracker_tpu/trackers/registry.py).

botsort and strongsort force their own Kalman format (the reference's
track.py:67-71), and a tracker's overrides (deepsort's feature ring
buffer, C-BIoU's Kalman-free state, ...) apply only where the caller left
the field at its default.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Tuple

from . import slab as S

_STEPS: Dict[str, Tuple[Callable, dict]] = {}
_MODULES = ("sort", "bytetrack", "c_biou", "deepsort", "botsort", "uavmot",
            "strongsort")
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
    if cfg.tracker == "deepmot":
        raise KeyError("tracker 'deepmot' (the DHN) is not ported yet; the "
                       f"port has {sorted(_STEPS)}")
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


def build_tracker(cfg: S.TrackerConfig) -> Tuple[Callable, S.TrackerConfig]:
    """Return (step fn ``(slab, det_slab) -> (slab, FrameOutput)``, the
    resolved config). Every step also takes ``solve_stage1``: the solver
    of its first association stage (deepsort: of every cascade level)."""
    cfg = resolve_config(cfg)
    return functools.partial(_STEPS[cfg.tracker][0], cfg=cfg), cfg
