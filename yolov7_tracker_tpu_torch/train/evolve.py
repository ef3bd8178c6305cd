"""Hyperparameter evolution: a GA over loss / augmentation hyps (the
port's copy of yolov7_tracker_tpu/train/evolve.py, numpy only; reference
train.py:617-695: mutation meta table with per-hyp gains and bounds,
80%-mutate/20%-elite parent selection, fitness-weighted). Host code only,
as in JAX: no CLI wires it."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

# {name: (gain, min, max)} — train.py meta table values for the hyps this
# framework consumes
META: Dict[str, Tuple[float, float, float]] = {
    "lr0": (1.0, 1e-5, 0.1),
    "lrf": (1.0, 0.01, 1.0),
    "momentum": (0.3, 0.6, 0.98),
    "weight_decay": (1.0, 0.0, 0.001),
    "warmup_epochs": (1.0, 0.0, 5.0),
    "warmup_momentum": (1.0, 0.0, 0.95),
    "box": (1.0, 0.02, 0.2),
    "cls": (1.0, 0.2, 4.0),
    "cls_pw": (1.0, 0.5, 2.0),
    "obj": (1.0, 0.2, 4.0),
    "obj_pw": (1.0, 0.5, 2.0),
    "anchor_t": (1.0, 2.0, 8.0),
    "hsv_h": (1.0, 0.0, 0.1),
    "hsv_s": (1.0, 0.0, 0.9),
    "hsv_v": (1.0, 0.0, 0.9),
    "degrees": (1.0, 0.0, 45.0),
    "translate": (1.0, 0.0, 0.9),
    "scale": (1.0, 0.0, 0.9),
    "shear": (1.0, 0.0, 10.0),
    "perspective": (0.0, 0.0, 0.001),
    "flipud": (1.0, 0.0, 1.0),
    "fliplr": (0.0, 0.0, 1.0),
    "mosaic": (1.0, 0.0, 1.0),
    "mixup": (1.0, 0.0, 1.0),
}


def mutate(hyp: Dict[str, float], history: List[Tuple[float, Dict]],
           rng: np.random.Generator, mp: float = 0.8,
           sigma: float = 0.2) -> Dict[str, float]:
    """One GA mutation step (train.py:650-676): parent = fitness-weighted
    choice of top-5 previous results, multiplicative gaussian mutation
    with per-hyp gains, clipped to bounds."""
    if history:
        top = sorted(history, key=lambda t: -t[0])[:5]
        w = np.array([max(t[0], 1e-6) for t in top])
        if rng.random() < 0.5 and len(top) > 1:  # weighted combination
            parent = {
                k: float(np.average([t[1][k] for t in top], weights=w))
                for k in hyp
            }
        else:  # weighted selection
            parent = top[rng.choice(len(top), p=w / w.sum())][1]
        hyp = dict(parent)
    keys = [k for k in hyp if k in META]
    g = np.array([META[k][0] for k in keys])
    v = np.ones(len(keys))
    while (v == 1).all():
        v = (
            (rng.random(len(keys)) < mp) * rng.standard_normal(len(keys))
            * rng.random() * g * sigma + 1
        ).clip(0.3, 3.0)
    out = dict(hyp)
    for k, vi in zip(keys, v):
        lo, hi = META[k][1], META[k][2]
        out[k] = float(np.clip(hyp[k] * vi, lo, hi))
    return out


def evolve(train_fn: Callable[[Dict[str, float]], float],
           base_hyp: Dict[str, float], generations: int = 300,
           seed: int = 0, log_path: str = "evolve.txt"):
    """Run the GA: train_fn(hyp) -> fitness. Returns best (fitness, hyp)."""
    rng = np.random.default_rng(seed)
    history: List[Tuple[float, Dict]] = []
    hyp = dict(base_hyp)
    for gen in range(generations):
        hyp = mutate(hyp, history, rng)
        fit = train_fn(hyp)
        history.append((fit, dict(hyp)))
        with open(log_path, "a") as f:
            f.write(f"{gen},{fit}," +
                    ",".join(f"{k}={v:.5g}" for k, v in hyp.items()) + "\n")
    return max(history, key=lambda t: t[0])
