"""Checkpoint save/load (port of yolov7_tracker_tpu/utils/checkpoint.py,
with torch files where the JAX module writes Flax msgpack and orbax).

``save_variables`` writes a detector state_dict in the port's names (the
EMA parameters with the live BN statistics, what train.py keeps as
``best.pt`` / ``last.pt``): models/convert.load_detector_weights reads it
back, so ``cli/track.py --model_path run/last.pt`` tracks with a trained
model. ``save_train_state`` writes ``step_N/state.pt`` (the TrainState's
state_dict: parameters, BN statistics, EMA, momentum buffers, gradient
sum, step, ema_count) and ``meta.json`` into a temporary sibling
``step_N.partial-<pid>`` and renames it into place, so a kill mid-save
leaves no ``step_*`` directory without its ``meta.json``. Orbax
checkpoints of the JAX CLI are not read.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Mapping, Optional

import torch

# the marker of a save in progress, which --resume auto skips
PARTIAL = ".partial-"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, Mapping):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def save_variables(path: str, state_dict: Mapping) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}{PARTIAL}{os.getpid()}"
    torch.save(_to_cpu(state_dict), tmp)
    os.replace(tmp, path)
    return path


def load_variables(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_train_state(ckpt_dir: str, state, step: int,
                     metadata: Optional[dict] = None) -> str:
    """``state`` (parallel/train_step.TrainState) as ``ckpt_dir``/step_N,
    replacing a directory of that name, as orbax's force=True does."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step}"))
    tmp = f"{path}{PARTIAL}{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_cpu(state.state_dict()), os.path.join(tmp, "state.pt"))
    if metadata:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(metadata, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def load_train_state(path: str, template):
    """Load ``path``/state.pt into ``template`` (a TrainState of the same
    model and optimizer configuration) and return it."""
    sd = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                    weights_only=True)
    template.load_state_dict(sd)
    return template
