"""Tracker registry: name -> step function (port of
yolov7_tracker_tpu/trackers/registry.py). This slice of the port has
ByteTrack only."""

from __future__ import annotations

import functools
import importlib
from typing import Callable, Dict, Tuple

from . import slab as S

_STEPS: Dict[str, Callable] = {}
_MODULES = ("bytetrack",)


def register(name: str):
    def deco(fn):
        _STEPS[name] = fn
        return fn

    return deco


def build_tracker(cfg: S.TrackerConfig) -> Tuple[Callable, S.TrackerConfig]:
    """Return (step fn ``(slab, det_slab) -> (slab, FrameOutput)``, config)."""
    for m in _MODULES:
        importlib.import_module(f".{m}", __package__)
    if cfg.tracker not in _STEPS:
        raise KeyError(
            f"unknown tracker {cfg.tracker!r}; this port has {sorted(_STEPS)}")
    return functools.partial(_STEPS[cfg.tracker], cfg=cfg), cfg
